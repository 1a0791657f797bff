"""The reference's matrix products, in float32 or, for the control, in TF32.

TF32 keeps 10 of float32's 23 mantissa bits of each product's operands and
accumulates in float32. The control rounds the operands so (to nearest)
before every product of the reference, whatever kernel the library picks: on
the card cuBLAS runs small batched products on float32 cores even with its
TF32 switch on, and the CPU has no TF32 at all.
"""

from __future__ import annotations

import contextlib

import torch

_state = {"tf32": False}


@contextlib.contextmanager
def tf32(on: bool):
    saved = _state["tf32"]
    _state["tf32"] = on
    try:
        yield
    finally:
        _state["tf32"] = saved


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its mantissa rounded to TF32's 10 bits under the control."""
    if not _state["tf32"] or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _MatMul(torch.autograd.Function):
    """A 2-D product whose backward products round their operands too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = rounded(a), rounded(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = rounded(g)
        return g @ b.T, a.T @ g


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _state["tf32"] and (a.requires_grad or b.requires_grad):
        if a.dim() != 2 or b.dim() != 2:
            raise ValueError("the control differentiates 2-D products only")
        with tf32(True):
            return _MatMul.apply(a, b)
    return torch.matmul(rounded(a), rounded(b))


def ein(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    return torch.einsum(equation, *(rounded(x) for x in operands))
