"""Where the port runs: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA; it raises when CUDA is missing rather than moving
    to the CPU on its own. On CUDA, TF32 is switched off for matmuls and
    cuDNN convolutions, so f32 work stays f32 as in the reference.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to "
                               "run the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def as_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy batch array on ``device``: integers as int64 (indices,
    labels), floats as f32."""
    a = np.asarray(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dtype)
