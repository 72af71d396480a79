"""The port's `pos` CLI end to end: real subprocesses driving a real TCP
server of the port, both on the CPU (`--device cpu`).

Covers upload -> list -> proof (+evaluate) -> append -> edit -> download ->
delete through `python -m lcpc_proof_of_storage_tpu_torch.pos.cli`, the
lifecycle of tests/test_cli.py.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "lcpc_proof_of_storage_tpu_torch.pos.cli", "--device", "cpu"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


def _cli(args, cwd, port):
    return subprocess.run(CLI + ["--server", f"127.0.0.1:{port}", "--db", "client_db"] + args,
                          cwd=cwd, env=_env(), capture_output=True, text=True, timeout=180)


@pytest.fixture()
def server(tmp_path):
    port = _free_port()
    srv_dir = tmp_path / "srv"
    srv_dir.mkdir()
    proc = subprocess.Popen(CLI + ["server", "--port", str(port), "--dir", str(srv_dir)],
                            cwd=srv_dir, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(f"server died: {proc.stdout.read().decode()}")
            time.sleep(0.3)
    else:
        proc.kill()
        raise RuntimeError("server never came up")
    yield port
    proc.terminate()
    proc.wait(timeout=10)


def test_cli_full_lifecycle(server, tmp_path):
    port = server
    cw = tmp_path / "client"
    cw.mkdir()
    data = bytes((i * 37 + 11) % 256 for i in range(5000))
    (cw / "blob.bin").write_bytes(data)

    r = _cli(["upload", "blob.bin"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "uploaded blob.bin" in r.stdout

    r = _cli(["list"], cw, port)
    assert "blob.bin" in r.stdout

    r = _cli(["proof", "blob.bin", "--evaluate"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "proof verified" in r.stdout
    assert "polynomial evaluation verified" in r.stdout

    r = _cli(["append", "blob.bin", "--data", "tail-bytes!"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "append verified" in r.stdout

    r = _cli(["edit", "blob.bin", "--start", "100", "--data", "EDITED"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "edit verified" in r.stdout

    r = _cli(["download", "blob.bin", "-o", "copy.bin"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    expect = bytearray(data)
    expect[100:106] = b"EDITED"
    expect += b"tail-bytes!"
    assert (cw / "copy.bin").read_bytes() == bytes(expect)

    r = _cli(["delete", "blob.bin"], cw, port)
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli(["proof", "blob.bin"], cw, port)
    assert r.returncode != 0
