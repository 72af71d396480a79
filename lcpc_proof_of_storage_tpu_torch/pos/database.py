"""Metadata store: sqlite-backed replacement for the reference's
SurrealDB/RocksDB store (proof-of-storage/src/databases/*).

Tables mirror the reference's namespaces: server metadata + users, client
metadata + hosts (databases/constants.rs:6-15).  Records are stored as JSON
documents keyed by ulid/name, like the reference's document store.
"""

from __future__ import annotations

import json
import sqlite3
from dataclasses import dataclass, field, asdict
from pathlib import Path

from ..crypto.blake3_ref import blake3

DATABASE_ADDRESS = "PoR_Database"


@dataclass
class ServerHost:
    """databases/server_host.rs:5-10."""
    server_name: str | None = None
    server_ip: str = ""
    server_port: int = 0


@dataclass
class FileMetadata:
    """databases/file_metadata.rs:9-20."""
    id_ulid: str
    filename: str
    num_rows: int
    num_columns: int
    num_encoded_columns: int
    filesize_in_bytes: int
    stored_server: ServerHost = field(default_factory=ServerHost)
    root: bytes = b"\x00" * 32

    def to_json(self) -> dict:
        d = asdict(self)
        d["root"] = self.root.hex()
        return d

    @classmethod
    def from_json(cls, obj: dict) -> "FileMetadata":
        obj = dict(obj)
        obj["root"] = bytes.fromhex(obj["root"])
        obj["stored_server"] = ServerHost(**obj["stored_server"])
        return cls(**obj)


@dataclass
class ClientRecord:
    """databases/client_record.rs:7-12: the client's record of a file it
    stored remotely — which server hosts it and the full metadata.  The CLI
    resolves a file's server address from this record when no --server
    flag is given."""
    id_ulid: str
    hosted_on: ServerHost
    metadata: FileMetadata

    def to_json(self) -> dict:
        return {"id_ulid": self.id_ulid,
                "hosted_on": asdict(self.hosted_on),
                "metadata": self.metadata.to_json()}

    @classmethod
    def from_json(cls, obj: dict) -> "ClientRecord":
        return cls(id_ulid=obj["id_ulid"],
                   hosted_on=ServerHost(**obj["hosted_on"]),
                   metadata=FileMetadata.from_json(obj["metadata"]))


class MetadataStore:
    """One sqlite file holding all namespaces."""

    def __init__(self, path: str | Path = DATABASE_ADDRESS):
        p = Path(path)
        if p.suffix != ".sqlite":
            p = p.with_suffix(".sqlite")
        p.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(p))
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS records"
            " (tbl TEXT, key TEXT, value TEXT, PRIMARY KEY (tbl, key))")
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # -- generic document ops ------------------------------------------------
    def create(self, table: str, key: str, value: dict) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO records (tbl, key, value) VALUES (?,?,?)",
            (table, key, json.dumps(value)))
        self._conn.commit()

    def select(self, table: str, key: str) -> dict | None:
        row = self._conn.execute(
            "SELECT value FROM records WHERE tbl=? AND key=?", (table, key)
        ).fetchone()
        return json.loads(row[0]) if row else None

    def select_all(self, table: str) -> list[dict]:
        rows = self._conn.execute(
            "SELECT value FROM records WHERE tbl=?", (table,)).fetchall()
        return [json.loads(r[0]) for r in rows]

    def delete(self, table: str, key: str) -> bool:
        cur = self._conn.execute(
            "DELETE FROM records WHERE tbl=? AND key=?", (table, key))
        self._conn.commit()
        return cur.rowcount > 0

    # -- file metadata -------------------------------------------------------
    def put_file_metadata(self, table: str, meta: FileMetadata) -> None:
        self.create(table, meta.id_ulid, meta.to_json())

    def get_file_metadata(self, table: str, ulid: str) -> FileMetadata | None:
        obj = self.select(table, ulid)
        return FileMetadata.from_json(obj) if obj else None

    def list_file_metadata(self, table: str) -> list[FileMetadata]:
        return [FileMetadata.from_json(o) for o in self.select_all(table)]

    def find_by_filename(self, table: str, filename: str) -> FileMetadata | None:
        """client.rs:1445-1469 lookup-by-filename."""
        for meta in self.list_file_metadata(table):
            if meta.filename == filename:
                return meta
        return None

    # -- client records (client_record.rs) -----------------------------------
    def put_client_record(self, record: ClientRecord) -> None:
        self.create(CLIENT_RECORDS_TABLE, record.id_ulid, record.to_json())

    def get_client_record(self, ulid: str) -> ClientRecord | None:
        obj = self.select(CLIENT_RECORDS_TABLE, ulid)
        return ClientRecord.from_json(obj) if obj else None

    def list_client_records(self) -> list[ClientRecord]:
        return [ClientRecord.from_json(o)
                for o in self.select_all(CLIENT_RECORDS_TABLE)]

    def delete_client_record(self, ulid: str) -> bool:
        return self.delete(CLIENT_RECORDS_TABLE, ulid)

    # -- users (server.rs:285-309: blake3-hashed passwords) ------------------
    def create_user(self, username: str, password: str) -> bool:
        if self.select("users", username) is not None:
            return False
        self.create("users", username,
                    {"username": username,
                     "password_hash": blake3(password.encode()).hex()})
        return True

    def check_login(self, username: str, password: str) -> bool:
        rec = self.select("users", username)
        return (rec is not None
                and rec["password_hash"] == blake3(password.encode()).hex())


SERVER_METADATA_TABLE = "server_metadata"
CLIENT_METADATA_TABLE = "client_metadata"
CLIENT_HOSTS_TABLE = "client_hosts"
CLIENT_RECORDS_TABLE = "client_records"
