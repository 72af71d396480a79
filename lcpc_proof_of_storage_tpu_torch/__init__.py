"""PyTorch / CUDA port of the Ligero and Brakedown commit -> prove -> verify
paths, one-shot and streamed (out-of-core).

The JAX package ``lcpc_proof_of_storage_tpu`` is the reference; this
package reproduces its outputs bit for bit and imports nothing of it.  On
CUDA tensors the row encodes (NTT, expander mat-vec), column hash (whole or
as streamed chunk chaining values), Merkle layers and collapse run as
hand-written sm_90a kernels (``csrc/``, built at
first use by ``kernels``); on CPU tensors they run as plain PyTorch.
Typical entry points:

    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, LigeroEncoding,
                                                 Transcript, commit, commit_streamed,
                                                 prove, verify, serialize_proof)

``commit(..., digest="blake2b")`` (and ``verify(..., digest=)``) hash on the
host instead (``crypto/digest.py``).  ``make_mesh``, ``sharded_commit`` and
``wide_commit`` run the multi-device paths on a mesh of devices in one
process (``parallel/``); ``serialize_commit`` / ``deserialize_commit`` carry
a whole commitment.

The transcript, ChaCha, path folds, matgen walk and serialization are host
code: the port's own copies of the reference's JAX-free modules
(``crypto/``, ``fields/field.py``, ``utils/serde.py``) and of its C++ host
library (``native/``).
"""

__version__ = "0.1.0"

_LAZY = {
    "BrakedownEncoding": ".codes.brakedown",
    "LigeroEncoding": ".codes.ligero",
    "commit": ".core.commit",
    "commit_streamed": ".core.streamed",
    "SyntheticCoeffs": ".core.streamed",
    "prove": ".core.commit",
    "verify": ".core.commit",
    "LcCommit": ".core.commit",
    "LcEvalProof": ".core.commit",
    "VerifierError": ".core.commit",
    "ProverError": ".core.commit",
    "Transcript": ".core.commit",
    "serialize_proof": ".utils.serde",
    "deserialize_proof": ".utils.serde",
    "proof_to_json": ".utils.serde",
    "serialize_commit": ".utils.serde",
    "deserialize_commit": ".utils.serde",
    "serialize_root": ".utils.serde",
    "deserialize_root": ".utils.serde",
    "make_mesh": ".parallel.mesh",
    "sharded_commit": ".parallel.sharded",
    "wide_commit": ".parallel.wide",
}


def __getattr__(name):
    # lazy: a bare `import lcpc_proof_of_storage_tpu_torch` stays light
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(name)
