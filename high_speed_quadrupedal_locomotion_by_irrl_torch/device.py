"""Device and dtype policy of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
request for CUDA on a machine without a GPU raises instead of silently
running on the CPU. Everything is float32, and TF32 is off for both matmuls
and cuDNN: the stiff 4 kHz contact dynamics diverge under reduced-precision
products (docs/DESIGN.md).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def tensor(x, device: torch.device) -> torch.Tensor:
    """float32 tensor on ``device`` from numpy/array-like/scalars (copies
    read-only numpy arrays, which torch cannot wrap)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=DTYPE, device=device)
