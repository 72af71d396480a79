"""The port's TCP server and client on the CPU, and across packages.

The scenarios of tests/test_networking.py run against one in-process port
server (its own thread and event loop, ``device="cpu"``) driven by the
port's client; then the JAX package's client talks to the port's server and
the port's client to the JAX package's server (upload, proof, polynomial
evaluation, download): the wire format and the stored quadruples are the
same.
"""

import asyncio
import random
import threading

import pytest

from lcpc_proof_of_storage_tpu.pos.database import MetadataStore as JaxStore
from lcpc_proof_of_storage_tpu.pos.networking.client import ClientSession as JaxClient
from lcpc_proof_of_storage_tpu.pos.networking.server import serve as jax_serve
from lcpc_proof_of_storage_tpu.pos.online import VerificationError as JaxVerificationError
from lcpc_proof_of_storage_tpu_torch.fields import limbs_to_ints
from lcpc_proof_of_storage_tpu_torch.pos import online
from lcpc_proof_of_storage_tpu_torch.pos.database import CLIENT_METADATA_TABLE, MetadataStore
from lcpc_proof_of_storage_tpu_torch.pos.networking import shared
from lcpc_proof_of_storage_tpu_torch.pos.networking.client import ClientSession
from lcpc_proof_of_storage_tpu_torch.pos.networking.server import serve
from lcpc_proof_of_storage_tpu_torch.pos.online import VerificationError
from lcpc_proof_of_storage_tpu_torch.pos.storage import file_paths


class _ServerThread:
    """A server coroutine factory run on its own event loop and thread."""

    def __init__(self, start):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = asyncio.run_coroutine_threadsafe(start(), self.loop).result(timeout=60)
        self.port = self.server.sockets[0].getsockname()[1]

    def close(self):
        async def stop():
            self.server.close()
            await self.server.wait_closed()
        asyncio.run_coroutine_threadsafe(stop(), self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        self.loop.close()


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_server")
    srv = _ServerThread(lambda: serve(0, base=base, db_path=str(base / "db"), device="cpu"))
    yield srv.port, base
    srv.close()


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_server")
    srv = _ServerThread(lambda: jax_serve(0, base=base, db_path=str(base / "db")))
    yield srv.port
    srv.close()


@pytest.fixture()
def run(port_server, tmp_path):
    """Run an async client scenario against the module's port server."""
    port, base = port_server

    def _run(scenario):
        async def main():
            db = MetadataStore(tmp_path / "client_db")
            session = await ClientSession.connect(f"127.0.0.1:{port}", db, device="cpu")
            try:
                return await scenario(session, db, base)
            finally:
                await session.close()
        return asyncio.run(main())
    return _run


def _mkfile(tmp_path, n=2000, seed=0, name="data.bin"):
    rnd = random.Random(seed)
    p = tmp_path / name
    data = bytes(rnd.randrange(256) for _ in range(n))
    p.write_bytes(data)
    return p, data


def test_upload_proof_delete(run, tmp_path):
    path, data = _mkfile(tmp_path)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        assert meta.filesize_in_bytes == len(data)
        assert db.get_file_metadata(CLIENT_METADATA_TABLE, meta.id_ulid)
        await session.request_and_verify_proof(meta)
        await session.delete_file(meta)
        assert db.get_file_metadata(CLIENT_METADATA_TABLE, meta.id_ulid) is None

    run(scenario)


def test_upload_download_roundtrip(run, tmp_path):
    path, data = _mkfile(tmp_path, n=3333, seed=1)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        assert await session.download_file(meta) == data

    run(scenario)


def test_chunked_upload(run, tmp_path):
    """200000 bytes: 4 rows past 3567, so the writer's and the client's
    batches end on chunk boundaries and one partial batch follows."""
    path, data = _mkfile(tmp_path, n=200_000, seed=2)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32, use_chunks=True)
        assert meta.filesize_in_bytes == len(data)
        assert meta.root == online.commit_file_data(data, 8, 32, device="cpu").get_root().root
        assert await session.download_file(meta) == data

    run(scenario)


def test_polynomial_evaluation(run, tmp_path):
    path, _ = _mkfile(tmp_path, n=1500, seed=3)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        await session.request_and_verify_polynomial(meta)

    run(scenario)


def test_reshape(run, tmp_path):
    path, data = _mkfile(tmp_path, n=2000, seed=4)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        new_meta = await session.reshape_file(meta, 16, 64)
        assert (new_meta.num_columns, new_meta.num_encoded_columns) == (16, 64)
        assert await session.download_file(new_meta) == data

    run(scenario)


def test_append_with_download_check(run, tmp_path):
    path, data = _mkfile(tmp_path, n=1000, seed=5)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        add = bytes(random.Random(6).randrange(256) for _ in range(137))
        new_meta = await session.append_to_file(meta, add)
        assert await session.download_file(new_meta) == data + add
        add2 = b"hello world, this is more appended data"
        new_meta2 = await session.append_to_file(new_meta, add2)
        assert await session.download_file(new_meta2) == data + add + add2

    run(scenario)


def test_edit_with_spliced_contents(run, tmp_path):
    path, data = _mkfile(tmp_path, n=1800, seed=7)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        replacement = bytes(random.Random(8).randrange(256) for _ in range(100))
        new_meta = await session.edit_file(meta, 531, replacement)
        expect = bytearray(data)
        expect[531: 531 + len(replacement)] = replacement
        assert await session.download_file(new_meta) == bytes(expect)

    run(scenario)


def test_server_side_corruption_fails_proof(run, tmp_path):
    """networking/tests.rs:696-780: a 2-byte corruption of the stored raw
    file fails the download check; one flipped byte of a challenged column
    in the stored encoded file fails the next proof."""
    path, data = _mkfile(tmp_path, n=2000, seed=9)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        raw = file_paths(meta.id_ulid, base)["raw"]
        blob = bytearray(raw.read_bytes())
        blob[100] ^= 0xFF
        blob[101] ^= 0xFF
        raw.write_bytes(bytes(blob))
        with pytest.raises(VerificationError):
            await session.download_file(meta)
        enc = file_paths(meta.id_ulid, base)["enc"]
        col = online.get_column_indices_from_random_seed(
            online.FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(8, 32), 32)[0]
        row_capacity = enc.stat().st_size // (32 * 8)
        with open(enc, "r+b") as f:
            f.seek(col * row_capacity * 8 + 3)
            b = f.read(1)
            f.seek(col * row_capacity * 8 + 3)
            f.write(bytes([b[0] ^ 1]))
        with pytest.raises(VerificationError):
            await session.request_and_verify_proof(meta)

    run(scenario)


def test_user_creation_and_login(run, tmp_path):
    async def scenario(session, db, base):
        assert (await session.rpc(shared.new_user("alice", "hunter2")))["success"]
        assert not (await session.rpc(shared.new_user("alice", "hunter2")))["success"]
        assert (await session.rpc(shared.user_login("alice", "hunter2")))["success"]
        assert not (await session.rpc(shared.user_login("alice", "wrong")))["success"]
        assert (await session.rpc(shared.client_keep_alive()))["type"] == "ServerKeepAlive"

    run(scenario)


def test_tall_vs_wide_eval_equivalence(run, tmp_path):
    path, data = _mkfile(tmp_path, n=2500, seed=10)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 4, 32)
        new_meta = await session.reshape_file(meta, 16, 64)
        assert new_meta.num_columns == 16

    run(scenario)


def test_request_encoded_column(run, tmp_path):
    path, data = _mkfile(tmp_path, n=2000, seed=11)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        comm = online.commit_file_data(data, 8, 32, device="cpu")
        for col in (0, 5, meta.num_encoded_columns - 1):
            vals = await session.request_encoded_column(meta, col)
            assert vals == limbs_to_ints(comm.comm[:, col, :].numpy())
        with pytest.raises(VerificationError, match="out of range"):
            await session.request_encoded_column(meta, meta.num_encoded_columns)

    run(scenario)


def test_client_record_round_trip(run, tmp_path):
    path, data = _mkfile(tmp_path, n=900, seed=12)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        rec = db.get_client_record(meta.id_ulid)
        assert rec.hosted_on.server_ip == "127.0.0.1" and rec.hosted_on.server_port > 0
        assert rec.metadata.root == meta.root
        await session.delete_file(meta)
        assert db.get_client_record(meta.id_ulid) is None

    run(scenario)


def test_server_files_stored_as_quadruple(run, tmp_path):
    path, data = _mkfile(tmp_path, n=2400, seed=13)

    async def scenario(session, db, base):
        meta = await session.upload_file(path, 8, 32)
        paths = file_paths(meta.id_ulid, base)
        for k in ("raw", "enc", "tree", "meta"):
            assert paths[k].is_file(), k
        paths["raw"].unlink()
        await session.request_and_verify_proof(meta)
        with pytest.raises((VerificationError, ConnectionError)):
            await session.download_file(meta)

    run(scenario)


async def _round_trip(session, path, data, chunks):
    meta = await session.upload_file(path, 8, 32, use_chunks=chunks)
    await session.request_and_verify_proof(meta)
    await session.request_and_verify_polynomial(meta)
    assert await session.download_file(meta) == data
    return meta


@pytest.mark.parametrize("chunks", [False, True], ids=["whole", "chunked"])
def test_reference_client_against_port_server(port_server, tmp_path, chunks):
    port, _ = port_server
    path, data = _mkfile(tmp_path, n=7000, seed=20)

    async def main():
        session = await JaxClient.connect(f"127.0.0.1:{port}", JaxStore(tmp_path / "db"))
        try:
            meta = await _round_trip(session, path, data, chunks)
            want = online.commit_file_data(data, 8, 32, device="cpu").get_root().root
            assert meta.root == want
            bad = type(meta)(**{**meta.__dict__, "root": bytes(32)})
            with pytest.raises(JaxVerificationError):
                await session.request_and_verify_proof(bad)
        finally:
            await session.close()
    asyncio.run(main())


@pytest.mark.parametrize("chunks", [False, True], ids=["whole", "chunked"])
def test_port_client_against_reference_server(jax_server, tmp_path, chunks):
    path, data = _mkfile(tmp_path, n=7000, seed=21)

    async def main():
        session = await ClientSession.connect(f"127.0.0.1:{jax_server}",
                                              MetadataStore(tmp_path / "db"), device="cpu")
        try:
            meta = await _round_trip(session, path, data, chunks)
            new_meta = await session.append_to_file(meta, b"appended across packages")
            new_meta = await session.edit_file(new_meta, 70, b"edited")
            expect = bytearray(data + b"appended across packages")
            expect[70:76] = b"edited"
            assert await session.download_file(new_meta) == bytes(expect)
        finally:
            await session.close()
    asyncio.run(main())
