"""Decode attention in the model's layout, over the hand-written kernel.

The counterpart of the JAX package's
``kernels/swa_attn/ops.py::decode_attention_pallas``: the model keeps one
query token as (B, 1, H, D) and its caches un-repeated as (B, S, KV, D), and
may give ``valid_len`` as one length for the whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attn.swa_attn import swa_decode_attention


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len,
                     softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, H, D); caches (B, S, KV, D); ``valid_len`` an int or (B,)
    lengths. Returns (B, 1, H, D). On CUDA through the kernel, on the CPU
    through its plain version. An int length is written on the device, not
    copied from the host: a blocking copy would make the host wait for the
    device at every layer of a decode step."""
    b = q.shape[0]
    if isinstance(valid_len, torch.Tensor):
        vl = valid_len.to(device=q.device, dtype=torch.int32).reshape(-1)
        vl = vl.expand(b).contiguous()
    else:
        vl = torch.full((b,), int(valid_len), dtype=torch.int32,
                        device=q.device)
    return swa_decode_attention(q[:, 0].contiguous(), k_cache.contiguous(),
                                v_cache.contiguous(), vl, softcap)[:, None]
