"""The precision the reference computes its products in.

The reference computes in float32 with TF32 off.  Its control, the step
below the bfloat16 that the configurations state, rounds every operand of
a product to float8 e4m3 with a scale per tensor (the largest magnitude
maps to 448, e4m3's largest finite value), as an fp8 serving or training
path would.  The rounding passes gradients through unchanged, so autograd
of the control's loss is the same computation with the rounded operands.
"""
from __future__ import annotations

from typing import Callable

import torch

FP8_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    """float32, unrounded."""
    return x.float()


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32."""
    return _RoundFp8.apply(x)


ROUNDINGS = {"float32": exact, "fp8": fp8}


def rounding(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding called ``name`` (float32 or fp8)."""
    return ROUNDINGS[name]


def no_tf32() -> None:
    """Keep float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
