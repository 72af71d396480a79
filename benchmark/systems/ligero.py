"""Ligero over the program's encoding: the streamed commit (row batches
through K1 and K2's chunk CVs, the encoded matrix kept as the configuration
says) or the one-shot commit, as the configuration's ``commit_entry`` names."""

from __future__ import annotations

import torch

COEFF_DTYPE = torch.int16        # 16-bit limbs: what the streamed commit keeps on the card


def encoding(cfg: dict, spec, device):
    from lcpc_proof_of_storage_tpu_torch import LigeroEncoding
    enc = LigeroEncoding.new(1 << cfg["log2_coeffs"], spec, rho=tuple(cfg["rho"]))
    enc.tables(device)
    return enc


def commit(coeffs: torch.Tensor, enc, device, cfg: dict):
    if cfg["commit_entry"] == "commit_streamed":
        from lcpc_proof_of_storage_tpu_torch import commit_streamed
        return commit_streamed(coeffs, enc, keep_comm=cfg["keep_comm"], device=device)
    from lcpc_proof_of_storage_tpu_torch import commit as one_shot
    return one_shot(coeffs, enc, device=device)
