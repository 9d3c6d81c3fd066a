"""Rounding through a precision, for the control that computes the
reference one precision below what the configuration states.

Each value is carried in float64 and rounded through the named format
after every operation the control makes: float32, tf32 (float32 with a
10-bit mantissa, what a float32 matrix product becomes with TF32 on),
bfloat16 and float8 (e4m3).
"""

from __future__ import annotations

import torch

F64 = torch.float64
LOWER = {"float64": "float32", "float32-tf32-off": "tf32",
         "float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def lower(name: str) -> str:
    """The nearest precision below `name`."""
    return LOWER[name]


def rnd(x: torch.Tensor, name: str | None) -> torch.Tensor:
    """x rounded through precision `name` (None or float64: unchanged)."""
    x = x.to(F64)
    if name in (None, "float64"):
        return x
    if name == "tf32":
        b = x.to(torch.float32).view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF     # to nearest even
        return b.view(torch.float32).to(F64)
    if name == "float32":
        return x.to(torch.float32).to(F64)
    return x.to(getattr(torch, name)).to(F64)


def dot(a, b, name):
    """sum(a * b) with the operands, products and sum rounded."""
    return rnd(rnd(rnd(a, name) * rnd(b, name), name).sum(), name)
