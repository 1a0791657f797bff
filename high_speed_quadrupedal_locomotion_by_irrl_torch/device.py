"""Device and dtype policy of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
request for CUDA on a machine without a GPU raises instead of silently
running on the CPU. Everything is float32, and TF32 is off for both matmuls
and cuDNN: the stiff 4 kHz contact dynamics diverge under reduced-precision
products (docs/DESIGN.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling

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
    read-only numpy arrays, which torch cannot wrap). Host data counts as one
    ``host_copies`` (:mod:`.utils.profiling`)."""
    if not isinstance(x, torch.Tensor) or x.is_cpu:
        profiling.count("host_copies")
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=DTYPE, device=device)


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """Rows ``[lo, hi)`` of draws over ``total`` envs from the shared ``gen``."""
    gen: torch.Generator
    lo: int
    hi: int
    total: int

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def global_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if not shape or shape[0] != self.hi - self.lo:
            raise ValueError(f"a draw of shape {shape} on the block [{self.lo}, {self.hi}) of "
                             f"{self.total} envs must lead with its {self.hi - self.lo} envs")
        return (self.total,) + shape[1:]


def rand(gen: torch.Generator | RankBlock, shape, device=None, dtype=DTYPE) -> torch.Tensor:
    """Uniform [0, 1) of ``shape``; on a block, its rows of the global draw."""
    if isinstance(gen, RankBlock):
        return torch.rand(gen.global_shape(shape), generator=gen.gen, device=device,
                          dtype=dtype)[gen.lo:gen.hi]
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def randn(gen: torch.Generator | RankBlock, shape, device=None, dtype=DTYPE) -> torch.Tensor:
    """Standard normal of ``shape``; on a block, its rows of the global draw."""
    if isinstance(gen, RankBlock):
        return torch.randn(gen.global_shape(shape), generator=gen.gen, device=device,
                           dtype=dtype)[gen.lo:gen.hi]
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def randperm(gen: torch.Generator | RankBlock, n: int, device=None) -> torch.Tensor:
    """A permutation of ``range(n)``; on a block ``n`` must be its ``total``:
    the global permutation, whole on every rank."""
    if isinstance(gen, RankBlock):
        if n != gen.total:
            raise ValueError(f"a permutation on a block of {gen.total} envs must be of "
                             f"{gen.total}, not {n}")
        gen = gen.gen
    return torch.randperm(n, generator=gen, device=device)
