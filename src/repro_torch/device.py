"""Device resolution and the numpy -> torch bridge.

Entry points take ``device=None``, which means the card (``"cuda"``).
Asking for the card where there is none raises: nothing falls back to
the CPU.  The CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           f"device (pass device='cpu' to run on the CPU)")
    return dev


def from_numpy(arr, device=None) -> torch.Tensor:
    """numpy array -> tensor on ``device``, bit for bit.

    JAX's bfloat16 leaves come out of ``np.asarray`` as ``ml_dtypes``'
    bfloat16, which ``torch.from_numpy`` rejects: their bits are viewed as
    int16 and reinterpreted as ``torch.bfloat16``.
    """
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve(device))
