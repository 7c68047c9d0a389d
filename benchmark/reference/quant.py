"""Roundings the reference can apply to what a program stores (each
convolution's input, weight and output and each BatchNorm output).

``fp8`` is the control's precision: e4m3, one scale a tensor, amax to 448,
the step below the bfloat16 that the configurations state.  The rounding
passes the gradient straight through, as fp8 training recipes do.  A
comparison that this control does not fail cannot tell a lower precision
from the program's.

``bf16`` is the configurations' own precision.  The serve check reads the
program's gap in units of the gap this rounding gives on the same frames,
since how far rounding moves a served answer differs from seed to seed."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = FP8_MAX / t.abs().amax().clamp(min=1e-30)
        q = (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach() if t.requires_grad else q


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)
