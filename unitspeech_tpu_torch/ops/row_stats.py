"""Per-channel row reductions: the statistics for GroupNorm (kernel K3;
counterpart of unitspeech_tpu/ops/pallas_stats.py `row_stats` and
`group_mean_inv`) and the abs-max for the int8 activation scale (kernel K7;
counterpart of `row_absmax`).

CUDA source: csrc/row_stats.cu, which also states what bounds the kernels
and how they are laid out. The custom VJP of the JAX row_stats waits for
the training slice.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda


def row_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """x (B, n, C) -> (B, 2, C) f32: [:, 0] sum over rows, [:, 1] sum of
    squares (the kernel's plain version)."""
    xf = x.to(torch.float32)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def _row_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"row_stats: expected (B, n, C) bf16/f32, got {x.dtype} {tuple(x.shape)}")
    b, n, c = x.shape
    if c % 2:
        raise ValueError(f"row_stats: channel count {c} must be even")
    _cuda.require(x, "row_stats x")
    lib = _cuda.lib()
    chunks = lib.us_row_stats_chunks(n)
    part = torch.empty((b, chunks, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    _cuda.check(
        lib.us_row_stats(x.data_ptr(), int(x.dtype == torch.bfloat16), part.data_ptr(),
                         out.data_ptr(), b, n, c, _cuda.stream(x)),
        "row_stats",
    )
    row_stats.launches += 1
    return out


def row_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel row statistics, (B, n, C) -> (B, 2, C) f32. CUDA tensors
    launch the kernel, CPU tensors take row_stats_plain."""
    if _cuda.route(x, "row_stats"):
        return _row_stats_cuda(x)
    return row_stats_plain(x)


row_stats.launches = 0


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """x (B, n, C) -> (B, C) f32 max |x| over rows (the kernel's plain
    version)."""
    return x.to(torch.float32).abs().amax(dim=1)


def _row_absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"row_absmax: expected (B, n, C) bf16/f32, got {x.dtype} {tuple(x.shape)}")
    b, n, c = x.shape
    if c % 8 or n == 0:
        raise ValueError(f"row_absmax: channel count {c} must be a multiple of 8, rows > 0")
    _cuda.require(x, "row_absmax x")
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    _cuda.check(
        _cuda.lib().us_row_absmax(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
                                  b, n, c, _cuda.stream(x)),
        "row_absmax",
    )
    row_absmax.launches += 1
    return out


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-channel max |x| over rows, (B, n, C) -> (B, C) f32. CUDA tensors
    launch the kernel, CPU tensors take row_absmax_plain; the two agree bit
    for bit (a max does not depend on the order)."""
    if _cuda.route(x, "row_absmax"):
        return _row_absmax_cuda(x)
    return row_absmax_plain(x)


row_absmax.launches = 0


def group_mean_inv(x2: torch.Tensor, groups: int, eps: float = 1e-5, stats=row_stats):
    """GroupNorm statistics of a row-flattened activation x2 (B, n, C):
    per-channel f32 (mean, inv_std), each (B, C), constant within a group.
    They pool over ALL rows, padding included (torch GroupNorm)."""
    b, n, c = x2.shape
    cg = c // groups
    st = stats(x2)
    m = float(n * cg)
    mean_g = st[:, 0].reshape(b, groups, cg).sum(-1) / m
    var_g = st[:, 1].reshape(b, groups, cg).sum(-1) / m - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(cg, dim=1), inv_g.repeat_interleave(cg, dim=1)
