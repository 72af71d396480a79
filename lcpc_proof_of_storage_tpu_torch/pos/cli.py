"""`pos` command-line interface of the port (reference:
proof-of-storage/src/bin/pos.rs; counterpart of
``lcpc_proof_of_storage_tpu/pos/cli.py``).

Subcommands with the reference's aliases: upload(up), download(down),
proof(pf), append(ap), edit(ed), reshape(rs), delete(rm), list(ls),
server(s).  The reference left Append/Edit dispatch as todo!()
(bin/pos.rs:342,370); they are implemented here.

Usage: python -m lcpc_proof_of_storage_tpu_torch.pos.cli [--device D] <subcommand> ...

The server's and the client's device work runs on --device: the card where
there is one by default, `--device cpu` for the plain versions.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from pathlib import Path

from ..core.commit import ProverError, VerifierError
from .database import CLIENT_METADATA_TABLE, MetadataStore
from .networking.client import ClientSession
from .networking.server import server_main
from .online import VerificationError


def _db(args) -> MetadataStore:
    return MetadataStore(args.db)


def _find_meta(db: MetadataStore, name_or_ulid: str):
    meta = db.get_file_metadata(CLIENT_METADATA_TABLE, name_or_ulid)
    if meta is None:
        meta = db.find_by_filename(CLIENT_METADATA_TABLE, name_or_ulid)
    if meta is None:
        sys.exit(f"error: no known file {name_or_ulid!r} (try `pos list`)")
    return meta


DEFAULT_SERVER = "127.0.0.1:8080"


def _resolve_server(args, db: MetadataStore, meta=None) -> str:
    """--server if given, else the file's stored ClientRecord host
    (client_record.rs:7-12), else the default address."""
    if args.server:
        return args.server
    if meta is not None:
        rec = db.get_client_record(meta.id_ulid)
        if rec is not None and rec.hosted_on.server_ip:
            return f"{rec.hosted_on.server_ip}:{rec.hosted_on.server_port}"
    return DEFAULT_SERVER


async def _with_session(args, fn, file_arg: str | None = None):
    db = _db(args)
    meta = _find_meta(db, file_arg) if file_arg is not None else None
    addr = _resolve_server(args, db, meta)
    session = await ClientSession.connect(addr, db, device=args.device)
    try:
        return await fn(session, db, meta)
    finally:
        await session.close()


def cmd_upload(args):
    async def run(session, db, _):
        meta = await session.upload_file(
            Path(args.file), args.columns, args.encoded_columns,
            use_chunks=args.chunks)
        print(f"uploaded {args.file}: ulid={meta.id_ulid} "
              f"dims=({meta.num_rows},{meta.num_columns},{meta.num_encoded_columns}) "
              f"root={meta.root.hex()}")
    asyncio.run(_with_session(args, run))


def cmd_download(args):
    async def run(session, db, meta):
        data = await session.download_file(meta)
        out = Path(args.output or meta.filename).name
        Path(out).write_bytes(data)
        print(f"downloaded and verified {len(data)} bytes -> {out}")
    asyncio.run(_with_session(args, run, args.file))


def cmd_proof(args):
    async def run(session, db, meta):
        await session.request_and_verify_proof(meta)
        print(f"proof verified for {meta.filename} (root {meta.root.hex()[:16]}...)")
        if args.evaluate:
            await session.request_and_verify_polynomial(meta)
            print("polynomial evaluation verified")
    asyncio.run(_with_session(args, run, args.file))


def cmd_append(args):
    async def run(session, db, meta):
        data = Path(args.data_file).read_bytes() if args.data_file \
            else args.data.encode()
        new_meta = await session.append_to_file(meta, data)
        print(f"append verified; new root {new_meta.root.hex()[:16]}... "
              f"ulid={new_meta.id_ulid}")
    asyncio.run(_with_session(args, run, args.file))


def cmd_edit(args):
    async def run(session, db, meta):
        data = Path(args.data_file).read_bytes() if args.data_file \
            else args.data.encode()
        new_meta = await session.edit_file(meta, args.start, data)
        print(f"edit verified; new root {new_meta.root.hex()[:16]}... "
              f"ulid={new_meta.id_ulid}")
    asyncio.run(_with_session(args, run, args.file))


def cmd_reshape(args):
    async def run(session, db, meta):
        new_meta = await session.reshape_file(
            meta, args.columns, args.encoded_columns)
        print(f"reshape verified; dims now "
              f"({new_meta.num_rows},{new_meta.num_columns},"
              f"{new_meta.num_encoded_columns})")
    asyncio.run(_with_session(args, run, args.file))


def cmd_delete(args):
    async def run(session, db, meta):
        await session.delete_file(meta)
        print(f"deleted {meta.filename}")
    asyncio.run(_with_session(args, run, args.file))


def cmd_list(args):
    db = _db(args)
    if args.servers:
        recs = db.list_client_records()
        if not recs:
            print("no stored hosts")
            return
        for r in recs:
            host = r.hosted_on
            print(f"{r.id_ulid}  {r.metadata.filename:30s} "
                  f"@ {host.server_ip}:{host.server_port}")
        return
    rows = db.list_file_metadata(CLIENT_METADATA_TABLE)
    if not rows:
        print("no files known")
        return
    for m in rows:
        print(f"{m.id_ulid}  {m.filename:30s} {m.filesize_in_bytes:>10d}B "
              f"({m.num_rows}x{m.num_columns}->{m.num_encoded_columns}) "
              f"root={m.root.hex()[:16]}...")


def cmd_server(args):
    print(f"serving on 0.0.0.0:{args.port}")
    server_main(args.port, base=Path(args.dir) if args.dir else None, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pos",
                                description="proof-of-storage client/server")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="increase log verbosity (repeatable)")
    p.add_argument("--db", default="PoR_Database", help="metadata database path")
    p.add_argument("--server", default=None,
                   help="server address host:port (default: the file's "
                        "stored host record, else 127.0.0.1:8080)")
    p.add_argument("--device", default=None,
                   help="torch device of the server's or client's device work "
                        "(default: the current CUDA card; raises without one, pass "
                        "--device cpu for the host)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("upload", aliases=["up"], help="upload + verify a file")
    sp.add_argument("file")
    sp.add_argument("--columns", type=int)
    sp.add_argument("--encoded-columns", type=int, dest="encoded_columns")
    sp.add_argument("--chunks", action="store_true", help="streamed chunked upload")
    sp.set_defaults(fn=cmd_upload)

    sp = sub.add_parser("download", aliases=["down"], help="download + verify")
    sp.add_argument("file")
    sp.add_argument("-o", "--output")
    sp.set_defaults(fn=cmd_download)

    sp = sub.add_parser("proof", aliases=["pf"], help="request + verify a proof")
    sp.add_argument("file")
    sp.add_argument("--evaluate", action="store_true",
                    help="also verify a polynomial evaluation")
    sp.set_defaults(fn=cmd_proof)

    sp = sub.add_parser("append", aliases=["ap"], help="append data (verified)")
    sp.add_argument("file")
    sp.add_argument("--data", default="")
    sp.add_argument("--data-file", dest="data_file")
    sp.set_defaults(fn=cmd_append)

    sp = sub.add_parser("edit", aliases=["ed"], help="edit bytes (verified)")
    sp.add_argument("file")
    sp.add_argument("--start", type=int, required=True)
    sp.add_argument("--data", default="")
    sp.add_argument("--data-file", dest="data_file")
    sp.set_defaults(fn=cmd_edit)

    sp = sub.add_parser("reshape", aliases=["rs"], help="reshape matrix dims")
    sp.add_argument("file")
    sp.add_argument("--columns", type=int, required=True)
    sp.add_argument("--encoded-columns", type=int, dest="encoded_columns",
                    required=True)
    sp.set_defaults(fn=cmd_reshape)

    sp = sub.add_parser("delete", aliases=["rm"], help="delete a stored file")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_delete)

    sp = sub.add_parser("list", aliases=["ls"], help="list known files")
    sp.add_argument("--servers", action="store_true",
                    help="list stored host records instead of files")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("server", aliases=["s"], help="run the PoR server")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--dir", help="server storage directory")
    sp.set_defaults(fn=cmd_server)

    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)]
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    try:
        args.fn(args)
    except (VerificationError, VerifierError, ProverError) as exc:
        # protocol-level audit failure, not a crash: the server's data or
        # proof did not check out against the committed root
        sys.exit(f"error: verification failed: {exc}")
    except ConnectionError as exc:
        sys.exit(f"error: cannot reach server: {exc}")
    finally:
        if args.verbose >= 2:
            # phase-attribution report (the reference client's benchmark
            # {bottleneck=disk|cpu|network} spans, client.rs:61-81)
            from ..utils.profiling import GLOBAL_PHASES
            report = GLOBAL_PHASES.report()
            if report:
                print("-- phase report --", file=sys.stderr)
                for k, v in report.items():
                    print(f"  {k}: {v['seconds']:.4f}s x{v['count']}",
                          file=sys.stderr)


if __name__ == "__main__":
    main()
