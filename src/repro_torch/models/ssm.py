"""The piece of the JAX package's ``models/ssm.py`` that the RG-LRU block
needs: the depthwise causal conv1d. The Mamba-2 SSD block and its chunked
scan (kernel ``ssd_scan``) are ROADMAP.md B9."""
from __future__ import annotations

from typing import Optional

import torch


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B,S,C); w: (W,C). Returns (y, new_state)
    where state is the last (W-1) inputs (for decode)."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, S+W-1, C)
    y = xp[:, 0:x.shape[1], :] * w[0][None, None, :].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype)
    y = y + b[None, None, :].to(x.dtype)
    new_state = xp[:, -(width - 1):, :]
    return y, new_state
