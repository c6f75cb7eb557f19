"""U-Net score estimator of the diffusion decoder (counterpart of
unitspeech_tpu/models/unet.py `GradLogPEstimator2d`; reference
unitspeech.py:124-201).

Layout (B, T, F, C), time-major and channels-last. With dim=128 and
mults (1, 2, 4, 8) the stages are (F, C) = (80, 128), (40, 256),
(20, 512), (10, 1024).

`use_kernels=True` mirrors the JAX serving routing with the estimator
kernels on (use_pallas_resnet and use_pallas_attention, unet.py:316-413,
525-550, 773-789):
  * ResnetBlock at F % 8 == 0 (F = 80, 40): the fused kernel K1;
  * ResnetBlocks at the deep stages (F = 20, 10): library GEMM convs with
    GroupNorm statistics from the row-statistics kernel K3; with
    `use_int8_deep` (the JAX serving default) int8 GEMMs whose activation
    scale comes from the row-absmax kernel K7;
  * Rezero attention at T*F >= PALLAS_MIN_TOKENS: the fused kernel K4;
  * the final block + final_conv: the fused kernel K2.
These gates are the TPU measurements the JAX package chose them from; they
are kept so that every kernel runs and the kernel path computes what the
JAX fast path computes. `use_kernels=False` is the plain path (the JAX
XLA twin: use_pallas_*=False). A kernel wrapper given a CPU tensor runs its
plain version, so both paths run on the CPU.

The fused deep-stage configuration (JAX use_pallas_deep,
use_pallas_resample, use_i8pre_deep; unet.py:321-383, 682-771) adds three
switches, each independent of `use_kernels` as in JAX:
  * `use_deep`: a deep-stage block whose whole layer fits the 4 MiB gate
    runs the whole-layer kernel K8 (bf16, even with int8 on);
  * `use_i8pre_deep` (with `use_int8_deep`): such a block with Cout <= 512
    runs K9 instead, int8 convs on pre-quantized activations;
  * `use_resample`: Downsample / Upsample at the sites the JAX gates admit
    (F = 80/40 down, F = 40 up) run K11 on the unmasked activation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Conv2d, ConvTranspose2d, Dense
from unitspeech_tpu_torch.ops.conv_matmul import (
    choose_conv_impl,
    conv3x3_int8,
    conv3x3_rows,
    matmul_f32,
    quantize_weight,
)
from unitspeech_tpu_torch.ops.fused_attention import fused_rezero_attention
from unitspeech_tpu_torch.ops.fused_resnet import (
    fused_final_block,
    fused_resnet_block,
    lens_rows_from_mask,
    mish_one_exp,
)
from unitspeech_tpu_torch.ops.fused_resnet_deep import (
    deep_route,
    fused_resnet_block_deep,
    fused_resnet_block_deep_i8,
)
from unitspeech_tpu_torch.ops.resample import (
    fused_downsample_conv,
    fused_upsample_conv,
    supports_downsample,
    supports_upsample,
)
from unitspeech_tpu_torch.ops.row_stats import (
    group_mean_inv,
    row_absmax,
    row_absmax_plain,
    row_stats,
    row_stats_plain,
)

PALLAS_MIN_TOKENS = 1024  # attention gate (unet.py RezeroAttention)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t, dim: int, scale: float = 1000.0):
    """(B,) -> (B, dim) (reference SinusoidalPosEmb, unitspeech.py:109-121)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = scale * t[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def fused_kernel_shape(f: int) -> bool:
    """The F % 8 == 0 gate of the fused ResnetBlock (pallas_resnet.py
    supports_shape): F = 80, 40 in the estimator."""
    return f % 8 == 0


def _group_norm_lowmem(x, groups, scale, bias, stats, eps=1e-5):
    """GroupNorm keeping the activation in its dtype; f32 statistics over
    all rows, padding included (unet.py _group_norm_lowmem)."""
    b, t, f, c = x.shape
    x2 = x.reshape(b, t * f, c)
    mean_f, inv_f = group_mean_inv(x2, groups, eps, stats=stats)
    y = (x2 - mean_f.to(x.dtype)[:, None, :]) * inv_f.to(x.dtype)[:, None, :]
    return y.reshape(b, t, f, c) * scale.to(x.dtype) + bias.to(x.dtype)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> mish, masked in and out (reference
    unitspeech.py:46-55). Parameters: conv, norm."""

    def __init__(self, din: int, dout: int, groups: int):
        super().__init__()
        self.conv = Conv2d(din, dout, 3)
        self.norm = Affine(dout)
        self.groups = groups

    def forward(self, x, mask, dtype, stats, pre_masked=False):
        if not pre_masked:
            x = x * mask
        x = self.conv(x, dtype=dtype)
        x = _group_norm_lowmem(x, self.groups, *self.norm.params(), stats)
        return mish(x) * mask


class ResnetBlock(nn.Module):
    """Two Blocks with a time/speaker FiLM bias between them plus a residual
    (1x1 conv when the width changes); the output is fully masked
    (reference unitspeech.py:58-75; unet.py ResnetBlock)."""

    def __init__(self, din: int, dout: int, t_dim: int, groups: int):
        super().__init__()
        self.block1 = Block(din, dout, groups)
        self.mlp = Dense(t_dim, dout)
        self.block2 = Block(dout, dout, groups)
        self.res_conv = Conv2d(din, dout, 1) if din != dout else None
        self.groups = groups
        self.flat = choose_conv_impl(din, dout) == "flat"
        # quantize_weight of conv1 and conv2 (the flat int8 route), and
        # quant_w of them (K9), set by quantize_int8
        self.int8_weights = self.i8pre_weights = None

    def quantize_int8(self):
        """Quantize both conv kernels once for the int8 routes: inference
        weights are frozen, so every call reuses them."""
        self.int8_weights = tuple(quantize_weight(b.conv.kernel.detach())
                                  for b in (self.block1, self.block2))
        # quant_w's form: the same int8 weights, reciprocal scales
        self.i8pre_weights = tuple((w8t, 1.0 / sw) for w8t, sw in self.int8_weights)

    def route(self, t, f, use_kernels, use_int8=False, use_deep=False, use_i8pre=False):
        """The JAX ResnetBlock's routing (unet.py:321-401): "k1" (the fused
        kernel at F % 8 == 0), "k9" / "k8" (the whole-layer deep kernels),
        "flat" (deep-stage rows), or "blocks" (plain Blocks)."""
        if use_kernels and fused_kernel_shape(f):
            return "k1"
        if not self.flat:
            return "blocks"
        cin, cout = self.block1.conv.kernel.shape[2:]
        deep = deep_route(t, f, cin, cout, use_int8, use_deep, use_i8pre)
        return {"i8": "k9", "bf16": "k8", None: "flat"}[deep]

    def forward(self, x, mask, t_emb, dtype, use_kernels, pre_masked=False, use_int8=False,
                use_deep=False, use_i8pre=False):
        """use_int8: int8 convs on the deep-stage (flat) route only, as the
        JAX ResnetBlock(use_int8=True) routes them; use_deep, use_i8pre: the
        whole-layer deep kernels K8 / K9 (route())."""
        b, t, f, cin = x.shape
        bias_t = self.mlp(mish(t_emb), dtype=dtype)
        stats = row_stats if use_kernels else row_stats_plain
        route = self.route(t, f, use_kernels, use_int8, use_deep, use_i8pre)
        if route == "flat":
            return self._flat(x, mask, bias_t, dtype, use_kernels, pre_masked, use_int8)
        if route in ("k1", "k8", "k9"):
            c1, c2 = self.block1.conv, self.block2.conv
            fn, extra = fused_resnet_block, {}
            if route == "k8":
                fn = fused_resnet_block_deep
            elif route == "k9":
                fn, extra = fused_resnet_block_deep_i8, {"wq": self.i8pre_weights}
            return fn(
                x.to(dtype), mask, bias_t, c1.kernel, c1.bias, *self.block1.norm.params(),
                c2.kernel, c2.bias, *self.block2.norm.params(),
                wres=None if self.res_conv is None else self.res_conv.kernel,
                bres=None if self.res_conv is None else self.res_conv.bias,
                groups=self.groups, **extra,
            )
        h = self.block1(x, mask, dtype, stats, pre_masked)
        h = h + bias_t[:, None, None, :]
        h = self.block2(h, mask, dtype, stats)
        x_masked = x if pre_masked else x * mask
        if self.res_conv is not None:
            return h + self.res_conv(x_masked, dtype=dtype) * mask
        return h + x_masked

    def _flat(self, x, mask, bias_t, dtype, use_kernels, pre_masked, use_int8):
        """Deep-stage block on flattened rows with f32 GroupNorm glue
        (unet.py _flat_matmul_block). The conv outputs c1/c2 stay f32
        accumulators; in int8 mode they are rounded to `dtype` after the
        bias add, where JAX rounds them (unet.py:270-283)."""
        b, t, f, cin = x.shape
        stats = row_stats if use_kernels else row_stats_plain
        absmax = row_absmax if use_kernels else row_absmax_plain
        n = t * f
        dout = bias_t.shape[-1]
        mask_rows = mask.expand(b, t, f, 1).reshape(b, n, 1)
        m32 = mask_rows.to(torch.float32)
        xf = x.to(dtype).reshape(b, n, cin)
        if not pre_masked:
            xf = xf * mask_rows.to(dtype)

        def gn_mish(acc, norm):
            scale, shift = norm.params()
            mean, inv = group_mean_inv(acc, self.groups, stats=stats)
            h = (acc.to(torch.float32) - mean[:, None, :]) * inv[:, None, :]
            return mish_one_exp(h * scale + shift)

        def conv(h, i):
            c = (self.block1, self.block2)[i].conv
            if use_int8:
                wq = None if self.int8_weights is None else self.int8_weights[i]
                y = conv3x3_int8(h, c.kernel, f, wq=wq, absmax=absmax)
                return (y + c.bias).to(dtype)
            return conv3x3_rows(h, c.kernel, f) + c.bias

        c1 = conv(xf, 0)
        h = gn_mish(c1, self.block1.norm) * m32
        h = (h + bias_t[:, None, :].to(torch.float32)).to(dtype)
        c2 = conv(h * mask_rows.to(dtype), 1)
        h2 = gn_mish(c2, self.block2.norm) * m32
        xv = xf * mask_rows.to(dtype)
        if self.res_conv is not None:
            res = (matmul_f32(xv, self.res_conv.kernel.reshape(cin, dout))
                   + self.res_conv.bias) * m32
        else:
            res = xv
        return (h2 + res).to(dtype).reshape(b, t, f, dout)


def _quantize_after_load(estimator, _incompatible_keys):
    """load_state_dict post-hook of an int8 estimator: quantize the flat
    blocks' conv kernels (the flat int8 route and K9) once the weights are
    in."""
    for m in estimator.modules():
        if isinstance(m, ResnetBlock) and m.flat:
            m.quantize_int8()


class LinearAttention(nn.Module):
    """Softmax-over-keys linear attention over flattened tokens (reference
    unitspeech.py:78-96). Parameters: to_qkv (no bias), to_out."""

    def __init__(self, c: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Dense(c, 3 * hidden, bias=False)
        self.to_out = Dense(hidden, c)

    def forward(self, x, dtype):
        b, t, f, c = x.shape
        n, h, d = t * f, self.heads, self.dim_head
        qkv = x.reshape(b, n, c).to(dtype) @ self.to_qkv.kernel.to(dtype)
        q, k, v = (z.reshape(b, n, h, d) for z in qkv.chunk(3, dim=-1))
        k_exp = torch.exp(k - k.amax(dim=1, keepdim=True))
        k_sum = k_exp.sum(dim=1, dtype=torch.float32)
        context = torch.einsum("bnhd,bnhe->bhde", k_exp, v)
        context = context / k_sum[..., None].to(context.dtype)
        out = torch.einsum("bnhd,bhde->bnhe", q, context).reshape(b, t, f, h * d)
        return self.to_out(out, dtype=dtype)


class RezeroAttention(nn.Module):
    """Residual(Rezero(LinearAttention)) (reference unitspeech.py:36-43,
    99-106). Parameters: g, fn."""

    def __init__(self, c: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.g = nn.Parameter(torch.empty(1))
        self.fn = LinearAttention(c, heads, dim_head)

    def uses_kernel(self, x, use_kernels: bool) -> bool:
        return use_kernels and x.shape[1] * x.shape[2] >= PALLAS_MIN_TOKENS

    def forward(self, x, mask, dtype, use_kernels):
        """With the kernel the output rows past the length come out zeroed,
        so the caller can skip its own mask multiply."""
        if self.uses_kernel(x, use_kernels):
            b, t, f, c = x.shape
            y = fused_rezero_attention(
                x.reshape(b, t * f, c).to(dtype), self.fn.to_qkv.kernel,
                self.fn.to_out.kernel, self.fn.to_out.bias, self.g,
                lens_rows=lens_rows_from_mask(mask, f),
                heads=self.fn.heads, dim_head=self.fn.dim_head,
            )
            return y.reshape(b, t, f, c)
        return x + self.fn(x, dtype) * self.g.to(dtype)


class Downsample(nn.Module):
    """conv3x3 stride 2 (reference unitspeech.py:27-33)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3)

    def forward(self, x, dtype):
        return self.conv(x, stride=2, dtype=dtype)


class Upsample(nn.Module):
    """ConvTranspose 4x4 stride 2, flax padding 2 (reference
    unitspeech.py:18-24)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = ConvTranspose2d(c, c, 4, 2, 2)

    def forward(self, x, dtype):
        return self.conv(x, dtype=dtype)


class GradLogPEstimator2d(nn.Module):
    """(x_t (B, T, F), mask (B, T), mu (B, T, F), t (B,), spk (B, S))
    -> score (B, T, F) f32. T must be a multiple of 2**(len(mults)-1)."""

    def __init__(self, dim=128, dim_mults=(1, 2, 4, 8), groups=8, pe_scale=1000.0,
                 spk_emb_dim=256, dtype=torch.float32, use_kernels=False,
                 use_int8_deep=False, use_deep=False, use_resample=False,
                 use_i8pre_deep=False):
        super().__init__()
        self.dim, self.groups, self.pe_scale = dim, groups, pe_scale
        self.dtype, self.use_kernels = dtype, use_kernels
        # int8 deep-stage convs; the early stages (K1) stay in `dtype`, as
        # the JAX estimator hard-codes (unet.py:394-400)
        self.use_int8_deep = use_int8_deep
        self.use_deep, self.use_resample, self.use_i8pre_deep = (
            use_deep, use_resample, use_i8pre_deep)
        if use_int8_deep:
            self.register_load_state_dict_post_hook(_quantize_after_load)
        t_dim = dim + spk_emb_dim
        self.mlp_0 = Dense(dim, dim * 4)
        self.mlp_1 = Dense(dim * 4, dim)
        dims = [dim * m for m in dim_mults]
        self.dims = dims
        cin = 2
        for i, d in enumerate(dims):
            self.add_module(f"down_{i}_res1", ResnetBlock(cin, d, t_dim, groups))
            self.add_module(f"down_{i}_res2", ResnetBlock(d, d, t_dim, groups))
            self.add_module(f"down_{i}_attn", RezeroAttention(d))
            if i < len(dims) - 1:
                self.add_module(f"down_{i}_down", Downsample(d))
            cin = d
        mid = dims[-1]
        self.mid_res1 = ResnetBlock(mid, mid, t_dim, groups)
        self.mid_attn = RezeroAttention(mid)
        self.mid_res2 = ResnetBlock(mid, mid, t_dim, groups)
        for i, (d_in, d_out) in reversed(list(enumerate(zip(dims[:-1], dims[1:])))):
            self.add_module(f"up_{i}_res1", ResnetBlock(2 * d_out, d_in, t_dim, groups))
            self.add_module(f"up_{i}_res2", ResnetBlock(d_in, d_in, t_dim, groups))
            self.add_module(f"up_{i}_attn", RezeroAttention(d_in))
            self.add_module(f"up_{i}_up", Upsample(d_in))
        self.final_block = Block(dim, dim, groups)
        self.final_conv = Conv2d(dim, 1, 1)

    def forward(self, x, mask, mu, t, spk_emb):
        dt, uk = self.dtype, self.use_kernels
        flags = dict(use_int8=self.use_int8_deep, use_deep=self.use_deep,
                     use_i8pre=self.use_i8pre_deep)
        t_emb = sinusoidal_pos_emb(t, self.dim, self.pe_scale)
        t_emb = self.mlp_0(t_emb, dtype=dt)
        t_emb = self.mlp_1(mish(t_emb), dtype=dt)
        t_emb = torch.cat([t_emb, spk_emb.to(dt)], dim=-1)

        h = torch.stack([mu, x], dim=-1).to(dt)
        m = mask[:, :, None, None].to(dt)
        hiddens, masks = [], [m]
        n_res = len(self.dims)
        for i in range(n_res):
            mk = masks[-1]
            h = getattr(self, f"down_{i}_res1")(h, mk, t_emb, dt, uk, **flags)
            # res1's output is masked: res2 skips its input mask
            h = getattr(self, f"down_{i}_res2")(h, mk, t_emb, dt, uk, pre_masked=True, **flags)
            attn = getattr(self, f"down_{i}_attn")
            h_in = h
            h = attn(h, mk, dt, uk)
            hiddens.append(h)
            if i < n_res - 1:
                down = getattr(self, f"down_{i}_down")
                if self.use_resample and supports_downsample(h.shape[1], h.shape[2],
                                                             self.dims[i]):
                    # the kernel masks its input rows: no h * mk pass
                    h = fused_downsample_conv(h.to(dt), mk, down.conv.kernel, down.conv.bias)
                else:
                    hin = h if attn.uses_kernel(h_in, uk) else h * mk
                    h = down(hin, dt)
            masks.append(mk[:, ::2])

        masks = masks[:-1]
        mk = masks[-1]
        h = self.mid_res1(h, mk, t_emb, dt, uk, **flags)
        h = self.mid_attn(h, mk, dt, uk)
        h = self.mid_res2(h, mk, t_emb, dt, uk, **flags)

        for i in reversed(range(n_res - 1)):
            mk = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=-1)
            h = getattr(self, f"up_{i}_res1")(h, mk, t_emb, dt, uk, **flags)
            h = getattr(self, f"up_{i}_res2")(h, mk, t_emb, dt, uk, pre_masked=True, **flags)
            attn = getattr(self, f"up_{i}_attn")
            h_in = h
            h = attn(h, mk, dt, uk)
            up = getattr(self, f"up_{i}_up")
            if self.use_resample and supports_upsample(h.shape[1], h.shape[2], self.dims[i]):
                h = fused_upsample_conv(h.to(dt), mk, up.conv.kernel, up.conv.bias)
            else:
                hin = h if attn.uses_kernel(h_in, uk) else h * mk
                h = up(hin, dt)

        if uk and fused_kernel_shape(h.shape[2]):
            fb, fc = self.final_block, self.final_conv
            return fused_final_block(h.to(dt), m, fb.conv.kernel, fb.conv.bias,
                                     *fb.norm.params(), fc.kernel, fc.bias,
                                     groups=self.groups)
        h = self.final_block(h, m, dt, row_stats_plain)
        out = self.final_conv(h * m, dtype=dt)
        return (out * m)[..., 0].to(torch.float32)
