"""Rounding a tensor to a lower precision and reading it back as float32:
``fp8_e4m3``, the precision below bfloat16, for the control of
``correct`` (one scale per tensor, its largest magnitude mapped to e4m3's
largest finite value, 448; the gradient rounded likewise to e5m2); and
``bf16``, the configurations' own precision, with the gradient passed
straight through, and ``bf16_grad``, with the gradient rounded to
bfloat16 as well, which read how far its rounding alone moves a
result."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x, dtype, top):
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Forward rounded to e4m3, gradient rounded to e5m2 (the usual float8
    training recipe), each with one scale per tensor."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def fp8_e4m3(x):
    return _Fp8.apply(x)


def bf16(x):
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


class _Bf16(torch.autograd.Function):
    """Forward and gradient each rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_grad(x):
    return _Bf16.apply(x)
