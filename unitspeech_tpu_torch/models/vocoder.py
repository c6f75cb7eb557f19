"""BigVGAN generator (counterpart of unitspeech_tpu/models/vocoder.py
`BigVGAN`; reference vocoder/models.py:121-201): mel (B, T, num_mels) ->
wav (B, T * prod(upsample_rates)).

Weight norm is folded into plain kernels, as in the JAX package. The
anti-aliased snake activation is 2x kaiser-sinc upsample -> snake /
snakebeta -> 2x kaiser-sinc downsample with replicate padding at the edges
(reference alias_free_torch/act.py:8-27; ops/aa_snake.py). Internally the
generator runs in torch's (B, C, T) layout; parameters keep flax's layout
and names.

`use_kernels=True` mirrors the JAX `use_pallas=True` routing
(vocoder.py:171-203, 259-277, 375-381): every AMP-block activation runs
fused with the conv after it (kernel K5; the second one of each pair also
adds the residual), and the final activation runs alone (kernel K6).
`use_kernels=False` is the plain path (the JAX XLA twin). A kernel wrapper
given a CPU tensor runs its plain version, so both paths run on the CPU.
With the kernels, what they read of the weights (snake coefficients, f32
biases, the conv kernels in K5's tiles) is packed by a load_state_dict
post-hook (`BigVGAN.pack`), so no call casts or exponentiates; weights
changed in place afterwards need another load_state_dict or `pack()`.
"""

from __future__ import annotations

import torch
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d, ConvTranspose1d
from unitspeech_tpu_torch.ops.aa_snake import (
    aa_snake_conv_plain,
    aa_snake_plain,
    fused_aa_snake,
    fused_aa_snake_conv,
    pack_aa_conv,
    pack_snake,
)
from unitspeech_tpu_torch.ops.aa_snake import takes as aa_snake_takes


def _pack_after_load(vocoder, _incompatible_keys):
    """load_state_dict post-hook of a BigVGAN with the kernels: pack once
    the weights are in."""
    vocoder.pack()


class Snake(nn.Module):
    """The parameters of x + 1/(alpha + 1e-9) sin^2(alpha x), per-channel
    alpha (the math is ops/aa_snake.snake)."""

    def __init__(self, channels: int, logscale: bool = True):
        super().__init__()
        self.logscale = logscale
        self.alpha = nn.Parameter(torch.empty(channels))

    def params_ab(self):
        """(alpha, beta) raw parameters; Snake reuses alpha as beta."""
        return self.alpha, self.alpha


class SnakeBeta(Snake):
    """The parameters of x + 1/(beta + 1e-9) sin^2(alpha x), separate
    magnitude parameter."""

    def __init__(self, channels: int, logscale: bool = True):
        super().__init__(channels, logscale)
        self.beta = nn.Parameter(torch.empty(channels))

    def params_ab(self):
        return self.alpha, self.beta


class AntiAliasedActivation(nn.Module):
    def __init__(self, channels: int, activation: str = "snakebeta", logscale: bool = True):
        super().__init__()
        self.act = (SnakeBeta if activation == "snakebeta" else Snake)(channels, logscale)
        self.packed = None  # what K5 reads of it and its conv (pack_aa_conv), set by pack

    def pack(self, conv, dilation: int):
        """Pack this activation's snake coefficients and the conv after it
        for K5, where K5 takes the widths."""
        k, c = conv.kernel.shape[:2]
        self.packed = (pack_aa_conv(*self.act.params_ab(), conv.kernel, conv.bias,
                                    self.act.logscale)
                       if aa_snake_takes(c, k, dilation) else None)

    def forward(self, x, conv, dilation: int, residual=None, use_kernels=False):
        """(B, C, T) -> (B, C, T): the activation, then the SAME dilated
        `conv` (a Conv1d of odd k), then + residual; with `use_kernels` one
        call of K5 where it takes the widths, else the plain version (the
        JAX route's fallback)."""
        args = (x, *self.act.params_ab(), conv.kernel, conv.bias, dilation, residual,
                self.act.logscale)
        if use_kernels and aa_snake_takes(x.shape[1], conv.kernel.shape[0], dilation):
            return fused_aa_snake_conv(*args, packed=self.packed)
        return aa_snake_conv_plain(*args)


class AMPBlock1(nn.Module):
    """3x (aa-act -> dilated conv -> aa-act -> conv) with residuals
    (reference models.py:18-76)."""

    def __init__(self, channels: int, kernel_size: int, dilation, activation="snakebeta",
                 logscale=True):
        super().__init__()
        self.dilation = tuple(dilation)
        for i in range(len(self.dilation)):
            self.add_module(f"act1_{i}", AntiAliasedActivation(channels, activation, logscale))
            self.add_module(f"conv1_{i}", Conv1d(channels, channels, kernel_size))
            self.add_module(f"act2_{i}", AntiAliasedActivation(channels, activation, logscale))
            self.add_module(f"conv2_{i}", Conv1d(channels, channels, kernel_size))

    def pack(self):
        for i, d in enumerate(self.dilation):
            getattr(self, f"act1_{i}").pack(getattr(self, f"conv1_{i}"), d)
            getattr(self, f"act2_{i}").pack(getattr(self, f"conv2_{i}"), 1)

    def forward(self, x, use_kernels=False):
        for i, d in enumerate(self.dilation):
            xt = getattr(self, f"act1_{i}")(x, getattr(self, f"conv1_{i}"), d,
                                            use_kernels=use_kernels)
            x = getattr(self, f"act2_{i}")(xt, getattr(self, f"conv2_{i}"), 1, residual=x,
                                           use_kernels=use_kernels)
        return x


class AMPBlock2(nn.Module):
    """2x (aa-act -> dilated conv) with residuals (reference
    models.py:78-118)."""

    def __init__(self, channels: int, kernel_size: int, dilation, activation="snakebeta",
                 logscale=True):
        super().__init__()
        self.dilation = tuple(dilation)
        for i in range(len(self.dilation)):
            self.add_module(f"act_{i}", AntiAliasedActivation(channels, activation, logscale))
            self.add_module(f"conv_{i}", Conv1d(channels, channels, kernel_size))

    def pack(self):
        for i, d in enumerate(self.dilation):
            getattr(self, f"act_{i}").pack(getattr(self, f"conv_{i}"), d)

    def forward(self, x, use_kernels=False):
        for i, d in enumerate(self.dilation):
            x = getattr(self, f"act_{i}")(x, getattr(self, f"conv_{i}"), d, residual=x,
                                          use_kernels=use_kernels)
        return x


class BigVGAN(nn.Module):
    def __init__(self, num_mels=80, upsample_rates=(8, 8, 2, 2),
                 upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=512,
                 resblock="1", resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3, activation="snakebeta",
                 snake_logscale=True, dtype=torch.float32, use_kernels=False):
        super().__init__()
        if resblock not in ("1", "2") or activation not in ("snake", "snakebeta"):
            raise ValueError(f"unknown resblock {resblock!r} or activation {activation!r}")
        self.dtype, self.use_kernels = dtype, use_kernels
        self.n_up, self.num_kernels = len(upsample_rates), len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(num_mels, upsample_initial_channel, 7)
        block_cls = AMPBlock1 if resblock == "1" else AMPBlock2
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            cin, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            # torch ConvTranspose1d(k, u, padding=(k-u)//2): T -> T*u
            self.add_module(f"up_{i}", ConvTranspose1d(cin, ch, k, u, (k - 1) - (k - u) // 2))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}",
                                block_cls(ch, rk, rd, activation, snake_logscale))
        self.act_post = (SnakeBeta if activation == "snakebeta" else Snake)(ch, snake_logscale)
        self.conv_post = Conv1d(ch, 1, 7)
        self.post_packed = None  # act_post's coefficients for K6, set by pack
        if use_kernels:
            self.register_load_state_dict_post_hook(_pack_after_load)

    def pack(self):
        """Make what the kernels read of the weights, once: each AMP-block
        activation's snake coefficients, its conv's f32 bias and kernel in
        K5's tiles (where K5 takes the widths), and the final activation's
        coefficients for K6. The plain path reads the raw parameters."""
        for m in self.modules():
            if isinstance(m, (AMPBlock1, AMPBlock2)):
                m.pack()
        self.post_packed = pack_snake(*self.act_post.params_ab(), self.act_post.logscale)

    def forward(self, mel):
        uk = self.use_kernels
        x = self.conv_pre.ncw(mel.to(self.dtype).transpose(1, 2), 3)
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}").ncw(x)
            xs = None
            for j in range(self.num_kernels):
                y = getattr(self, f"resblock_{i}_{j}")(x, use_kernels=uk)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        # the final activation alone: one launch of K6 with the kernels
        post = (x, *self.act_post.params_ab(), self.act_post.logscale)
        x = fused_aa_snake(*post, packed=self.post_packed) if uk else aa_snake_plain(*post)
        x = self.conv_post.ncw(x, 3)
        return torch.tanh(x)[:, 0, :].to(torch.float32)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32, use_kernels=False):
        return cls(cfg.num_mels, tuple(cfg.upsample_rates), tuple(cfg.upsample_kernel_sizes),
                   cfg.upsample_initial_channel, cfg.resblock, tuple(cfg.resblock_kernel_sizes),
                   tuple(tuple(d) for d in cfg.resblock_dilation_sizes), cfg.activation,
                   cfg.snake_logscale, dtype=dtype, use_kernels=use_kernels)
