"""The lower-precision control: the reference with every convolution in
float8, the step below the bfloat16 the configurations state. Each
convolution's input and weight are rounded to e4m3 in the forward, and the
gradients that flow back into them to e5m2 in the backward, each at one
scale a tensor that maps its largest magnitude to the format's largest, as
float8 training recipes scale them.

``correct`` has to come out false for this control: it shows that the
comparison's limits separate the program from a lower precision.
"""

from __future__ import annotations

import torch

from benchmark.reference.model import Conv

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = FORMATS[fmt] / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3; its gradient rounded to e5m2."""
    return _Fp8.apply(x)


def set_quant(model: torch.nn.Module, fn) -> torch.nn.Module:
    """Route every ``Conv`` of ``model`` through ``fn`` (None: exact)."""
    for m in model.modules():
        if isinstance(m, Conv):
            m.quant = fn
    return model
