"""Parameter-holding layers that keep flax's tensor layouts.

Every parameter is named by its flax path (state-dict keys such as
`down_0_res1.block1.conv.kernel`) and stored in flax layout: Dense kernels
(in, out), conv kernels (*spatial, in, out), ConvTranspose kernels not
spatially flipped. The forward functions permute to torch's layouts at the
call, so a JAX parameter tree loads with no transposes
(utils/params.params_from_jax).

`dtype` follows flax's `dtype=` knob: inputs and parameters are cast to it
and the op runs in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(din, dout)
        self.bias = _param(dout) if bias else None

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class Conv1d(nn.Module):
    """flax nn.Conv over (B, T, C) with kernel (k, in, out)."""

    def __init__(self, din: int, dout: int, k: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(k, din, dout)
        self.bias = _param(dout) if bias else None

    def ncw(self, x, padding: int, dilation: int = 1, dtype=None):
        """Conv on a (B, C, T) tensor, returning (B, C, T)."""
        dt = dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x.to(dt), self.kernel.to(dt).permute(2, 1, 0), b,
                        padding=padding, dilation=dilation)

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

    def forward(self, x, stride: int = 1, dtype=None):
        dt = dtype or x.dtype
        k = self.kernel.shape[0]
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.kernel.to(dt).permute(3, 2, 0, 1), b,
                     stride=stride, padding=k // 2)
        return y.permute(0, 2, 3, 1)


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

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               conv_transpose_weight(self.kernel.to(dt)), self.bias.to(dt),
                               stride=self.stride, padding=self.pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose1d(nn.Module):
    """flax nn.ConvTranspose over (B, T, C), kernel (k, in, out); applied
    here to (B, C, T) tensors."""

    def __init__(self, din: int, dout: int, k: int, stride: int, pad_flax: int):
        super().__init__()
        self.kernel = _param(k, din, dout)
        self.bias = _param(dout)
        self.stride, self.pad = stride, k - 1 - pad_flax

    def ncw(self, x, dtype=None):
        dt = dtype or x.dtype
        return F.conv_transpose1d(x.to(dt), conv_transpose_weight(self.kernel.to(dt)),
                                  self.bias.to(dt), stride=self.stride, padding=self.pad)


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
