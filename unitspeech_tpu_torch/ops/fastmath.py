"""The polynomial f32 transcendentals of the JAX package's Pallas kernels,
in PyTorch (counterpart of unitspeech_tpu/ops/fastmath.py `fast_sin` and
`fast_exp`), operation for operation, so that they give the JAX values bit
for bit. The port's kernels use CUDA's own sinf / expf; these serve the
plain version of the transcendental microbenchmark P1
(ops/probes.py, tools/bench_transcendental.py).
"""

from __future__ import annotations

import numpy as np
import torch

_LOG2E = float(np.float32(1.4426950408889634))
_INV_PI = float(np.float32(1.0 / np.pi))
_PI = float(np.float32(np.pi))


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) for f32 x up to a factor (-1)^n (callers square it): range
    reduction r = x - round(x / pi) * pi, then the odd degree-7
    least-squares polynomial on [-pi/2, pi/2]."""
    n = torch.round(x * _INV_PI)
    r = x - n * _PI
    r2 = r * r
    return r * (0.99999749 + r2 * (-0.16665168 + r2 * (8.3095146e-3 + r2 * -1.8447153e-4)))


def fast_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for f32 x as 2^n * p(f): z = clip(x, -87, 30) * log2(e),
    n = round(z) placed in the exponent field, p the degree-5 polynomial of
    the fraction f = z - n."""
    z = torch.clamp(x, -87.0, 30.0) * _LOG2E
    n = torch.round(z)
    f = z - n
    p = 1.0 + f * (0.69314718 + f * (0.24022211 + f * (0.05550341 + f * (
        0.00967077 + f * 0.00133953))))
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale
