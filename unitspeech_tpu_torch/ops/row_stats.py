"""Per-channel row reductions: the statistics for GroupNorm (kernel K3;
counterpart of unitspeech_tpu/ops/pallas_stats.py `row_stats` and
`group_mean_inv`) and the abs-max for the int8 activation scale (kernel K7;
counterpart of `row_absmax`).

K3 is one launch in either of two forms: the sums (`row_stats`, (B, 2, C))
or, for `group_mean_inv` on the card, the group fold in the same launch
(per-channel mean and inv_std), where each group lies in one cluster's
slice of channels (`fold_takes`); elsewhere `group_mean_inv` folds the
sums in PyTorch. On a frame slice of the seq axis (`seq`, a
parallel.FrameSlice) `group_mean_inv` runs the sums form, sums them over
the axis and folds them with the global row count. CUDA source:
csrc/row_stats.cu, which also states what
bounds the kernels and how they are laid out. The custom VJP of the JAX
row_stats waits for the training slice.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda


def row_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """x (B, n, C) -> (B, 2, C) f32: [:, 0] sum over rows, [:, 1] sum of
    squares (the kernel's plain version)."""
    xf = x.to(torch.float32)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


# The channels of one cluster's slice in K3 (csrc/row_stats.cu RS_CPB): the
# fold form needs every group inside one slice
SLICE_CHANNELS = 128


def takes(c: int, n: int) -> bool:
    """The widths K3 takes on the card, in both forms: any even C (C % 8 ==
    0 in 16-byte loads, other C in channel pairs) and any n >= 1."""
    return c % 2 == 0 and n >= 1


def fold_takes(c: int, groups: int) -> bool:
    """Where K3's fold form takes a GroupNorm of `groups` groups over C
    channels: the widths K3 takes, and groups of cg = C / groups channels
    that never straddle two slices (cg divides SLICE_CHANNELS)."""
    return (takes(c, 1) and groups >= 1 and c % groups == 0
            and SLICE_CHANNELS % (c // groups) == 0)


def _check(x: torch.Tensor, what: str):
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: expected (B, n, C) bf16/f32, got {x.dtype} {tuple(x.shape)}")
    b, n, c = x.shape
    if not takes(c, n):
        raise ValueError(f"{what}: C={c} must be even and n={n} at least 1")
    _cuda.require(x, f"{what} x")
    return b, n, c


def _row_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    b, n, c = _check(x, "row_stats")
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    _cuda.check(
        _cuda.lib().us_row_stats(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
                                 b, n, c, _cuda.stream(x)),
        "row_stats",
    )
    row_stats.launches += 1
    return out


def _group_mean_inv_cuda(x: torch.Tensor, groups: int, eps: float):
    """K3's fold form: one launch, (mean, inv) each (B, C) f32. Counted
    with row_stats: it is the same kernel."""
    b, n, c = _check(x, "group_mean_inv")
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    _cuda.check(
        _cuda.lib().us_group_mean_inv(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                      out[0].data_ptr(), out[1].data_ptr(), b, n, c, groups,
                                      eps, _cuda.stream(x)),
        "group_mean_inv",
    )
    row_stats.launches += 1
    return out[0], out[1]


def row_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel row statistics, (B, n, C) -> (B, 2, C) f32. CUDA tensors
    launch the kernel (widths: `takes`), CPU tensors take row_stats_plain."""
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


def fold_stats(st: torch.Tensor, groups: int, n: int, eps: float = 1e-5):
    """Row statistics st (B, 2, C) of n rows -> per-channel f32 (mean,
    inv_std), each (B, C), constant within a group."""
    b, _, c = st.shape
    cg = c // groups
    m = float(n * cg)
    mean_g = st[:, 0].reshape(b, groups, cg).sum(-1) / m
    var_g = st[:, 1].reshape(b, groups, cg).sum(-1) / m - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(cg, dim=1), inv_g.repeat_interleave(cg, dim=1)


def group_mean_inv_plain(x2: torch.Tensor, groups: int, eps: float = 1e-5,
                         stats=row_stats_plain):
    """The fold's plain version: GroupNorm statistics of a row-flattened
    activation x2 (B, n, C) from its row statistics `stats(x2)`: per-channel
    f32 (mean, inv_std), each (B, C), constant within a group. They pool
    over ALL rows, padding included (torch GroupNorm)."""
    return fold_stats(stats(x2), groups, x2.shape[1], eps)


def slice_groups(groups: int, model) -> int:
    """The GroupNorm groups in one model rank's channel slice, 0 where a
    group straddles two ranks (the axis's size does not divide the groups);
    `groups` without a model axis."""
    if model is None:
        return groups
    return groups // model.size if groups % model.size == 0 else 0


def fold_slice(st: torch.Tensor, groups: int, n: int, eps: float = 1e-5, model=None):
    """fold_stats of a model rank's channel slice: st (B, 2, C / size) its
    channels' row sums over n rows -> (mean, inv) of those channels. Whole
    groups fold alone; where a group straddles two ranks every rank's sums
    are gathered over the axis first (one collective) and the rank keeps
    its channels of the whole fold."""
    g = slice_groups(groups, model)
    if g:
        return fold_stats(st, g, n, eps)
    mean, inv = fold_stats(model.enter(model.gather(st, dim=-1)), groups, n, eps)
    return model.take(mean), model.take(inv)


def group_mean_inv(x2: torch.Tensor, groups: int, eps: float = 1e-5, stats=None, seq=None,
                   model=None):
    """GroupNorm statistics of a row-flattened activation x2 (B, n, C):
    per-channel f32 (mean, inv_std), each (B, C), constant within a group,
    pooled over ALL rows, padding included (torch GroupNorm). A CUDA tensor
    with no `stats` given launches K3's fold form where `fold_takes`, else
    K3's sums and the plain fold; a CPU tensor, or a `stats` function
    passed in, takes group_mean_inv_plain over `stats` (row_stats when
    none). seq: x2's rows are one frame slice of the seq axis (a
    parallel.FrameSlice): the sums (K3's sums form, or `stats`) are summed
    over the axis and folded with the global row count, so every rank gets
    the unsharded statistics. model: x2's channels are one rank's slice of
    the model axis (a parallel.ModelShard) of a GroupNorm of `groups`
    groups over them all: the statistics of the slice's whole groups (as
    above, at groups / size), or, where a group straddles two ranks, the
    sums gathered over the axis before the fold (fold_slice)."""
    c = x2.shape[-1]
    g = slice_groups(groups, model)
    if seq is not None or not g:
        st = (row_stats if stats is None else stats)(x2)
        n = x2.shape[1]
        if seq is not None:
            st, n = seq.all_sum(st), seq.rows(n)
        return fold_slice(st, groups, n, eps, model)
    if stats is None and _cuda.route(x2, "group_mean_inv") and fold_takes(c, g):
        return _group_mean_inv_cuda(x2, g, eps)
    return group_mean_inv_plain(x2, g, eps, row_stats if stats is None else stats)
