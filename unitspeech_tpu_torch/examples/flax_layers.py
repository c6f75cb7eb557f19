"""flax's Dense / DenseGeneral, LayerNorm and SelfAttention as PyTorch
modules with flax's parameter names and layouts (kernel (*in, *out), bias
(*out); LayerNorm scale / bias, eps 1e-6; SelfAttention's query / key /
value / out with a heads axis), so utils/params.params_from_jax carries a
flax tree across. The examples' small transformers (speaker_probing.Probe,
gslm.UnitLM) are built from them; attention is plain PyTorch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated to 2 std, std sqrt(1 / fan_in)."""
    with torch.no_grad():
        x = torch.randn(t.shape, generator=generator)
        while bool((bad := x.abs() > 2).any()):
            x[bad] = torch.randn(int(bad.sum()), generator=generator)
        return t.copy_(x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


class Dense(nn.Module):
    """flax Dense / DenseGeneral: kernel (*in, *out), bias (*out)."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        self.n_in = len(in_shape)

    def reset(self, generator):
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:self.n_in]), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return torch.tensordot(x, self.kernel, dims=self.n_in) + self.bias


class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def reset(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return nn.functional.layer_norm(x, x.shape[-1:], self.scale, self.bias, eps=1e-6)


class SelfAttention(nn.Module):
    """flax SelfAttention (MultiHeadDotProductAttention): per-head q / k /
    v projections, softmax(q k^T / sqrt(head_dim)) with masked scores at
    the dtype's minimum, the heads merged by `out`."""

    def __init__(self, d, heads):
        super().__init__()
        hd = d // heads
        self.query, self.key, self.value = (Dense((d,), (heads, hd)) for _ in range(3))
        self.out = Dense((heads, hd), (d,))

    def reset(self, generator):
        for m in (self.query, self.key, self.value, self.out):
            m.reset(generator)

    def forward(self, x, mask):
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, T, H, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v))
