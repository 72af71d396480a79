"""PyTorch / CUDA port of the Ligero commit -> prove -> verify path.

The JAX package ``lcpc_proof_of_storage_tpu`` is the reference; this
package reproduces its outputs bit for bit.  On CUDA tensors the row
encode, column hash, Merkle layers and collapse run as hand-written sm_90a
kernels (``csrc/``, built at first use by ``kernels``); on CPU tensors they
run as plain PyTorch.  Typical entry points:

    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, Transcript, commit,
                                                 prove, verify, serialize_proof)

The transcript, ChaCha, path fold and proof serialization are the
reference's own JAX-free host modules, re-exported here.  Importing any of
them runs the reference package's ``__init__``, which tunes glibc malloc
for the whole process (``utils/hostmem.py``: 1 GiB mmap and trim
thresholds).
"""

__version__ = "0.1.0"

_LAZY = {
    "LigeroEncoding": ".codes.ligero",
    "commit": ".core.commit",
    "prove": ".core.commit",
    "verify": ".core.commit",
    "LcCommit": ".core.commit",
    "LcEvalProof": ".core.commit",
    "VerifierError": ".core.commit",
    "ProverError": ".core.commit",
    "Transcript": ".core.commit",
    "serialize_proof": "lcpc_proof_of_storage_tpu.utils.serde",
    "proof_to_json": "lcpc_proof_of_storage_tpu.utils.serde",
}


def __getattr__(name):
    # lazy: a bare `import lcpc_proof_of_storage_tpu_torch` stays light
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(name)
