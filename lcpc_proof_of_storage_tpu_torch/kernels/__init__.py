"""Build and load the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu`` (with the shared ``csrc/*.cuh``): plain C
entry points, compiled by ``nvcc`` for sm_90a into one shared library and
loaded with ``ctypes``.  Nothing is built or loaded when this module is
imported: the first kernel call builds the library into
``build/torch_kernels/<hash of the sources>/`` at the root of the checkout
(listed in ``.gitignore``), so a fresh checkout on a machine with a card
builds everything on its first run.

Every entry point returns the ``cudaGetLastError()`` code after its
launches; :class:`Kernel` raises on a non-zero code and counts launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu into the library for the current sources, unless it
    is already there; returns its path.  One nvcc per source, all started
    together, then one link; ptxas's register and spill report of every
    kernel goes to ``nvcc.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "liblcpc_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        nvcc = _nvcc()
        cus = [s for s in _sources() if s.suffix == ".cu"]
        objs = [tmp_dir / (s.stem + ".o") for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        errors, logs = [], []
        for src, proc in zip(cus, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{out}")
        (out_dir / "nvcc.log").write_text("".join(logs))
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp_so = tmp_dir / so.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.lcpc_error_string.argtypes = [ctypes.c_int]
        lib.lcpc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` counts the calls that launched the kernel; a caller that
    wants the launches of one run sets it to 0 first.  An entry that
    launches another entry's kernels (``counts_as``) adds to that entry's
    count instead."""

    def __init__(self, symbol: str, argtypes: list, counts_as: "Kernel | None" = None):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.counts_as = counts_as
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library().lcpc_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        (self.counts_as or self).launches += 1


class TreeKernel(Kernel):
    """K2's tree entry, which also counts the Merkle arrays its launches
    built: a launch from layer 0 (its third argument) starts one."""

    def __init__(self, symbol: str, argtypes: list):
        super().__init__(symbol, argtypes)
        self.arrays = 0

    def __call__(self, *args) -> None:
        super().__call__(*args)
        if args[2] == 0:
            self.arrays += 1


# csrc/ntt.cu: in, out, work, tw, batch, log_n, n_nonzero, W, p_host, stream
NTT_FORWARD = Kernel("lcpc_ntt_forward", [P, P, P, P, I, I, I, I, P, P])
# csrc/ntt.cu: in, out, out16, work, tw, batch, log_n, n_in, n_nonzero, in16, W, p_host,
# stream.  K1 on rows as they are stored (int32 or 16-bit limbs, n_in wide), writing
# the 16-bit rows too where out16 is given: counted as K1.
NTT_FORWARD_ROWS = Kernel("lcpc_ntt_forward_rows", [P, P, P, P, P, I, I, I, I, I, I, P, P],
                          counts_as=NTT_FORWARD)
# csrc/ntt.cu: in, out, work, tw_inv, batch, log_n, W, p_host, n_inv_mont, stream
NTT_INVERSE = Kernel("lcpc_ntt_inverse", [P, P, P, P, I, I, I, P, P, P])
# csrc/ntt.cu: work, out, tw, batch, log_n, s0, W, p_host, stream.  K1's own passes
# from stage s0 on, unpacking in the last, for the fused_small route: counted as K1.
NTT_STAGES = Kernel("lcpc_ntt_stages", [P, P, P, I, I, I, I, P, P], counts_as=NTT_FORWARD)
# csrc/ntt_tile.cu: in, out, tw, diag, count, log_n, s0, s1, log_span (ops/ntt.py tile_plan),
# in_limbs, out_limbs, W, p_host, stream
NTT_TILE = Kernel("lcpc_ntt_tile", [P, P, P, P, I, I, I, I, I, I, I, I, P, P])
# csrc/ntt_tile.cu: a, b, out, n, b_rows, W, p_host, r2_host, stream
MUL_MOD = Kernel("lcpc_mul_mod", [P, P, P, I, I, I, P, P, P])
# csrc/blake3.cu: in, out, n_rows, n_cols, W, big_endian, stream
BLAKE3_LEAVES = Kernel("lcpc_blake3_leaves", [P, P, I, I, I, I, P])
# csrc/blake3.cu: nodes, np2, level0, levels, stream.  One launch: up to 10 Merkle
# layers; ops/blake3.py merkle_tree makes one or two of them a tree up to 2^20 leaves.
BLAKE3_TREE = TreeKernel("lcpc_blake3_tree", [P, ctypes.c_longlong, I, I, P])
# csrc/blake3.cu: batch, cvs, rows_b, n_cols, k, ld, chunk0, first, tail_len, W, big_endian,
# stream
BLAKE3_CHUNK_CVS = Kernel("lcpc_blake3_chunk_cvs",
                          [P, P, I, I, I, I, ctypes.c_longlong, I, I, I, I, P])
# csrc/blake3.cu: cvs, out, n_cols, nchunks, stream
BLAKE3_MERGE_CVS = Kernel("lcpc_blake3_merge_cvs", [P, P, I, I, P])
# csrc/collapse.cu: coeffs, coeff_bits, t, acc, out, rows, npr, T, L, p_host, mu_host, mu_len,
# stream.  One entry, two counters: K3 (acc null) and K3p (an accumulator, the
# streamed collapse's step), counted by ops/collapse.py.
_COLLAPSE_ARGS = [P, I, P, P, P, I, I, I, I, P, P, I, P]
COLLAPSE = Kernel("lcpc_collapse", _COLLAPSE_ARGS)
COLLAPSE_ACC = Kernel("lcpc_collapse", _COLLAPSE_ARGS)
# csrc/expander.cu: x, idx, vals, counts, order, out, b, cols, rows, L, p_host, mu_host,
# mu_len, stream
EXPANDER = Kernel("lcpc_expander_matvec", [P, P, P, P, P, P, I, I, I, I, P, P, I, P])

KERNELS = {"ntt": NTT_FORWARD, "ntt_inverse": NTT_INVERSE, "blake3_leaves": BLAKE3_LEAVES,
           "blake3_tree": BLAKE3_TREE, "blake3_chunk_cvs": BLAKE3_CHUNK_CVS,
           "blake3_merge_cvs": BLAKE3_MERGE_CVS, "collapse": COLLAPSE,
           "collapse_acc": COLLAPSE_ACC, "expander": EXPANDER, "ntt_tile": NTT_TILE,
           "mul_mod": MUL_MOD}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    BLAKE3_TREE.arrays = 0


def ptr(t) -> ctypes.c_void_p:
    """A tensor's (or numpy array's) data pointer as a c_void_p."""
    return ctypes.c_void_p(t.data_ptr() if hasattr(t, "data_ptr") else t.ctypes.data)


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor t's device, as a c_void_p."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, t, dtype) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
