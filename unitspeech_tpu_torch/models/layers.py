"""Parameter-holding layers that keep flax's tensor layouts.

Every parameter is named by its flax path (state-dict keys such as
`down_0_res1.block1.conv.kernel`) and stored in flax layout: Dense kernels
(in, out), conv kernels (*spatial, in, out), ConvTranspose kernels not
spatially flipped. The forward functions permute to torch's layouts at the
call, so a JAX parameter tree loads with no transposes
(utils/params.params_from_jax).

`dtype` follows flax's `dtype=` knob: inputs and parameters are cast to it
and the op runs in it.

Tensor parallelism (parallel/tp.py shard_params_tp): a layer whose kernel
holds this rank's output-channel columns, and its bias the same, has its
ModelShard in `tp`; it computes its columns of the output from the whole
input and gathers them over the model axis (Dense's `gather=False`: the
columns alone, for a caller that gathers later). Under autograd its input passes
ModelShard.enter, whose backward sums the input's gradient over the axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.parallel.mesh import SINGLE


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


def _tp_in(layer, x):
    return x if layer.tp is None else layer.tp.enter(x)


def _tp_out(layer, y, dim: int, gather: bool = True):
    return y if layer.tp is None or not gather else layer.tp.gather(y, dim)


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(din, dout)
        self.bias = _param(dout) if bias else None
        self.tp = None  # the model axis's ModelShard when sharded

    def forward(self, x, dtype=None, gather: bool = True):
        dt = dtype or x.dtype
        y = _tp_in(self, x).to(dt) @ self.kernel.to(dt)
        return _tp_out(self, y if self.bias is None else y + self.bias.to(dt), -1, gather)


class Conv1d(nn.Module):
    """flax nn.Conv over (B, T, C) with kernel (k, in, out)."""

    def __init__(self, din: int, dout: int, k: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(k, din, dout)
        self.bias = _param(dout) if bias else None
        self.tp = None

    def ncw(self, x, padding: int, dilation: int = 1, dtype=None):
        """Conv on a (B, C, T) tensor, returning (B, C, T)."""
        dt = dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv1d(_tp_in(self, x).to(dt), self.kernel.to(dt).permute(2, 1, 0), b,
                     padding=padding, dilation=dilation)
        return _tp_out(self, y, 1)

    def forward(self, x, dtype=None):
        """SAME conv (odd kernel) on (B, T, C)."""
        k = self.kernel.shape[0]
        return self.ncw(x.transpose(1, 2), k // 2, dtype=dtype).transpose(1, 2)


class Conv2d(nn.Module):
    """flax nn.Conv over NHWC with kernel (kh, kw, in, out)."""

    def __init__(self, din: int, dout: int, k: int = 3, bias: bool = True):
        super().__init__()
        self.kernel = _param(k, k, din, dout)
        self.bias = _param(dout) if bias else None
        self.tp = None

    def forward(self, x, stride: int = 1, dtype=None, padding=None):
        """padding: torch's (H, W) padding, SAME's k // 2 on both when None
        (a halo'd input of the seq axis pads W alone)."""
        dt = dtype or x.dtype
        k = self.kernel.shape[0]
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(_tp_in(self, x).to(dt).permute(0, 3, 1, 2),
                     self.kernel.to(dt).permute(3, 2, 0, 1), b,
                     stride=stride, padding=k // 2 if padding is None else padding)
        return _tp_out(self, y.permute(0, 2, 3, 1), -1)


def conv_transpose_weight(kernel: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (*k, in, out), which correlates, -> torch
    (in, out, *k), which convolves: flip every spatial axis."""
    nd = kernel.dim() - 2
    w = kernel.flip(dims=tuple(range(nd)))
    return w.permute(nd, nd + 1, *range(nd))


class ConvTranspose2d(nn.Module):
    """flax nn.ConvTranspose over NHWC, kernel (k, k, in, out), explicit
    padding p_flax on both sides (torch padding = k - 1 - p_flax)."""

    def __init__(self, din: int, dout: int, k: int, stride: int, pad_flax: int):
        super().__init__()
        self.kernel = _param(k, k, din, dout)
        self.bias = _param(dout)
        self.stride, self.pad = stride, k - 1 - pad_flax
        self.tp = None

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        y = F.conv_transpose2d(_tp_in(self, x).to(dt).permute(0, 3, 1, 2),
                               conv_transpose_weight(self.kernel.to(dt)), self.bias.to(dt),
                               stride=self.stride, padding=self.pad)
        return _tp_out(self, y.permute(0, 2, 3, 1), -1)


class ConvTranspose1d(nn.Module):
    """flax nn.ConvTranspose over (B, T, C), kernel (k, in, out); applied
    here to (B, C, T) tensors."""

    def __init__(self, din: int, dout: int, k: int, stride: int, pad_flax: int):
        super().__init__()
        self.kernel = _param(k, din, dout)
        self.bias = _param(dout)
        self.stride, self.pad = stride, k - 1 - pad_flax
        self.tp = None

    def ncw(self, x, dtype=None):
        dt = dtype or x.dtype
        y = F.conv_transpose1d(_tp_in(self, x).to(dt), conv_transpose_weight(self.kernel.to(dt)),
                               self.bias.to(dt), stride=self.stride, padding=self.pad)
        return _tp_out(self, y, 1)


class Affine(nn.Module):
    """Per-channel scale/shift parameters under flax's names: GroupNorm
    and LayerNorm (`scale`, `bias`) or the encoder's LayerNorm (`gamma`,
    `beta`)."""

    def __init__(self, channels: int, names=("scale", "bias")):
        super().__init__()
        self.names = names
        for n in names:
            setattr(self, n, _param(channels))

    def params(self):
        return tuple(getattr(self, n) for n in self.names)


class Dropout:
    """Training-mode dropout with explicit randomness, flax nn.Dropout's
    arithmetic: kept elements divided by 1 - p, the others zero. Each call
    with p > 0 takes the next mask: from `masks`, a sequence of bool
    tensors in call order (injected draws, e.g. another framework's), or
    drawn from `generator` on the input's device (and kept in `drawn`, so
    that a run can be replayed elsewhere). p = 0 returns x and takes no
    mask, as flax does. Modules take one as their `dropout=` argument; None
    (the default, every inference path) means no dropout. With `shard` (a
    parallel.DataShard: x holds its rows of a data-parallel batch) each mask
    is the global batch's, drawn or injected, and the rank keeps its rows."""

    def __init__(self, generator=None, masks=None, shard=None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.shard = shard or SINGLE
        self.calls = 0
        self.drawn = []

    def __call__(self, x, p: float):
        if p == 0.0:
            return x
        keep = 1.0 - p
        if self.masks is not None:
            mask = self.shard.take(self.masks[self.calls].to(x.device))
        else:
            mask = self.shard.rand(x.shape, self.generator, x.device) < keep
            self.drawn.append(mask)
        self.calls += 1
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(drop, x, p: float):
    """x through `drop` (a Dropout) at rate p; x itself when drop is None."""
    return x if drop is None else drop(x, p)
