"""Brakedown over the program's encoding: the one-shot commit (K5's levels,
the plain-torch glue, K2's leaves and tree), the encoded matrix kept on the
card as int32 limbs."""

from __future__ import annotations

import torch

COEFF_DTYPE = torch.int32


def encoding(cfg: dict, spec, device):
    from lcpc_proof_of_storage_tpu_torch import BrakedownEncoding
    enc = BrakedownEncoding.new(1 << cfg["log2_coeffs"], seed=cfg["code_seed"], field=spec)
    enc.encoder.on(device)
    return enc


def commit(coeffs: torch.Tensor, enc, device, cfg: dict):
    from lcpc_proof_of_storage_tpu_torch import commit as one_shot
    return one_shot(coeffs, enc, device=device)
