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
JAX fast path computes. Beside each gate the route tests the kernel's own
`takes` predicate (the widths its CUDA kernel accepts): a site that fails it
takes the route JAX's code takes when its gate fails (plain Blocks, the XLA
attention, the library resample, the flat route), on the CPU as on the
card, so the route depends on shapes alone. The kernels' weights are packed
once when the estimator's weights load (`pack`, a load_state_dict
post-hook). `use_kernels=False` is the plain path (the JAX
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

Sequence sharding (`forward(..., seq=)`, a parallel.FrameSlice: this
rank's frames of the sample on the mesh's seq axis, boundaries on whole
8-frame pieces, so each level's slice is the one above halved): every
site takes its sharded form. A 3x3 conv reads the neighbours' edge frame
on each side (K1's and K2's halo'd kernels, the flat convs, the plain
Blocks), the stride-2 Downsample the one frame before its slice and the
4x4 Upsample one a side; GroupNorm statistics are summed over the axis
(K3's sums form, K1's and K2's gathered tile sums) and folded with the
global row count; K7's maxima and the attention's partials (K4's, or the
plain one's max, sums and context) are reduced over it. Every route gate
reads the global frames (`seq.t`), so all ranks and the unsharded
program take the same routes; the masks and valid-row counts are the
slice's. The fused deep-stage configuration takes its sharded forms too:
K8 is K1's chain at F = 20/10, K9 its own chain with the one activation
scale a batch element over the global rows (the maxima reduced over the
axis) and its int8 convs over halo'd int8 rows, and K11 reads its halo'd
frames (ops/fused_resnet_deep.py, ops/resample.py); the deep gate reads
the global frames and K9 the slice's valid rows.

Tensor parallelism (parallel/tp.py shard_params_tp: every conv and dense
kernel holds this rank's Cout columns of the mesh's model axis, `tp` its
ModelShard): each plain layer gathers its output columns (models/layers.py),
so the plain Blocks, the time MLP, the plain attention and the library
resample convs compute the replicated program. The kernel sites keep their
kernels on the slice: K1 and K2 run their chains on the rank's columns
(ops/fused_resnet.py: K1 gathers h and its output, K2 sums the ranks'
partial final dots), the flat blocks run their convs on the rank's
columns with K3's statistics on the slice's groups and K7's scale over the
whole input, gathering h before conv2 and the block's output, and the
FiLM bias stays the rank's columns. K4 runs whole on every rank: its site
gathers the two projections' columns once when it packs (GSPMD's treatment
of a pallas_call's sharded operands). Routes are taken at the global
widths; a kernel runs where its `takes` also accepts the rank's slice
(K1 and K2: Cout / size in whole 64-column tiles and the groups split over
the axis), else the site takes the route JAX's code takes when its gate
fails (the plain Blocks). The fused deep-stage configuration keeps its
kernels on the rank's columns: K8 runs K1's chain, K9 its chain with h's
maxima reduced over the axis and h8 (int8) gathered before conv2, the FiLM
bias the rank's columns, the weights quantized and packed from the rank's
columns (per-output-channel scales are column-local: the whole's columns);
K11 writes the rank's Cout columns and gathers them. A deep site whose
slice K8 / K9 do not take (slice_takes) takes the flat route, a resample
whose slice K11 does not take (kernel_takes) the library resample.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Conv2d, ConvTranspose2d, Dense
from unitspeech_tpu_torch.ops import fused_attention, fused_resnet
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
    pack_block_weights,
    pack_conv_weight,
)
from unitspeech_tpu_torch.ops.fused_resnet_deep import (
    deep_route,
    fused_resnet_block_deep,
    fused_resnet_block_deep_i8,
    pack_block_weights_i8,
    slice_takes,
)
from unitspeech_tpu_torch.ops.masking import frames_from_mask
from unitspeech_tpu_torch.ops.resample import (
    fused_downsample_conv,
    fused_upsample_conv,
    kernel_takes,
    pack_downsample_weight,
    pack_upsample_weight,
    supports_downsample,
    supports_upsample,
)
from unitspeech_tpu_torch.ops.row_stats import (
    group_mean_inv,
    row_absmax,
    row_absmax_plain,
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


def fused_takes(cout: int, groups: int, tp=None) -> bool:
    """Whether K1 / K2 take a block of Cout (global) channels in `groups`
    groups: fused_resnet.takes at the global width and, on a model axis
    (tp, a parallel.ModelShard), at the rank's slice too (whole groups a
    rank)."""
    return fused_resnet.takes(cout, groups) and slice_takes(cout, groups, tp)


def _group_norm_lowmem(x, groups, scale, bias, stats, eps=1e-5, seq=None):
    """GroupNorm keeping the activation in its dtype; f32 statistics over
    all rows, padding included (unet.py _group_norm_lowmem). stats: None for
    K3 (its fold form on the card), or the row statistics function of the
    plain fold; seq: x is a frame slice, the statistics the whole
    sequence's (group_mean_inv)."""
    b, t, f, c = x.shape
    x2 = x.reshape(b, t * f, c)
    mean_f, inv_f = group_mean_inv(x2, groups, eps, stats=stats, seq=seq)
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

    def forward(self, x, mask, dtype, stats, pre_masked=False, seq=None):
        """seq: x is a frame slice; the conv reads the neighbours' edge
        frames (their masked input) and the statistics are the whole
        sequence's."""
        if not pre_masked:
            x = x * mask
        if seq is None:
            x = self.conv(x, dtype=dtype)
        else:
            x = self.conv(seq.halo(x), dtype=dtype, padding=(0, 1))
        x = _group_norm_lowmem(x, self.groups, *self.norm.params(), stats, seq=seq)
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
        # the kernels' packed conv weights (K1 / K8 / K9) and the route they
        # were packed for, set by pack; those of another route, packed at
        # its first call (spot_pack) and dropped by pack
        self.packed = self.packed_for = None
        self.spot_packs = {}

    @property
    def tp(self):
        """The model axis's ModelShard when the block's kernels are sharded."""
        return self.block1.conv.tp

    def widths(self):
        """(Cin, Cout) of the block, the global widths on a model axis."""
        cin, cout = self.block1.conv.kernel.shape[2:]
        return cin, cout * (1 if self.tp is None else self.tp.size)

    def pack(self, f, use_kernels, use_int8=False, use_deep=False, use_i8pre=False):
        """Pack, once, the conv kernels that this block's route at F = f reads
        (inference weights are frozen, so every call reuses them): all three
        for K1 and K8, K9's int8 convs (conv1 in bf16 for Cin > Cout) and 1x1
        residual, none for the flat and Blocks routes. With use_int8 a flat
        block first quantizes its convs (quantize_int8): K9's int8 tiles are
        packed from those weights, whose scales its epilogue reads, so the
        two always agree. The route is taken at one frame, a length every
        deep gate passes; a longer input takes the same kernel or the flat
        route. A call at another F packs what it reads at its first call
        (spot_pack)."""
        if use_int8 and self.flat:
            self.quantize_int8()
        route = self.route(1, f, use_kernels, use_int8, use_deep, use_i8pre)
        self.packed, self.packed_for, self.spot_packs = self._pack_route(route), route, {}

    def _pack_route(self, route):
        """The packed conv weights that `route` reads (None for flat and
        Blocks)."""
        w1, w2 = self.block1.conv.kernel, self.block2.conv.kernel
        wres = None if self.res_conv is None else self.res_conv.kernel
        if route in ("k1", "k8"):
            return pack_block_weights(w1, w2, wres)
        if route == "k9":
            # conv1 in bf16 where the block's global Cin > Cout (JAX's hybrid)
            cin, cout = self.widths()
            return pack_block_weights_i8(w1, self.i8pre_weights, wres, cin > cout)
        return None

    def spot_pack(self, route, x):
        """The packed weights of a kernel route other than the one pack
        chose (a call at another F), made at its first call on the card and
        kept until the next pack; None on the CPU, whose plain versions read
        the raw kernels. Never made inside a CUDA graph capture: the warm-up
        step before each capture makes it (infer/graphs.py)."""
        if not x.is_cuda:
            return None
        if route not in self.spot_packs:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"ResnetBlock: packing the {route} route's weights inside "
                                   "a CUDA graph capture (the warm-up step packs them)")
            self.spot_packs[route] = self._pack_route(route)
        return self.spot_packs[route]

    def quantize_int8(self):
        """Quantize both conv kernels once for the int8 routes: inference
        weights are frozen, so every call reuses them."""
        self.int8_weights = tuple(quantize_weight(b.conv.kernel.detach())
                                  for b in (self.block1, self.block2))
        # quant_w's form: the same int8 weights, reciprocal scales
        self.i8pre_weights = tuple((w8t, 1.0 / sw) for w8t, sw in self.int8_weights)

    def route(self, t, f, use_kernels, use_int8=False, use_deep=False, use_i8pre=False):
        """The JAX ResnetBlock's routing (unet.py:321-401): "k1" (the fused
        kernel at F % 8 == 0 where it takes the widths), "k9" / "k8" (the
        whole-layer deep kernels), "flat" (deep-stage rows), or "blocks"
        (plain Blocks); T the global frames; on a model axis at the global
        widths, K1, K8 and K9 where they also take the rank's slice
        (fused_takes, slice_takes)."""
        cin, cout = self.widths()
        if use_kernels and fused_kernel_shape(f) and fused_takes(cout, self.groups, self.tp):
            return "k1"
        if not self.flat:
            return "blocks"
        deep = deep_route(t, f, cin, cout, use_int8, use_deep, use_i8pre, self.groups, self.tp)
        return {"i8": "k9", "bf16": "k8", None: "flat"}[deep]

    def forward(self, x, mask, t_emb, dtype, use_kernels, pre_masked=False, use_int8=False,
                use_deep=False, use_i8pre=False, lens_rows=None, seq=None):
        """use_int8: int8 convs on the deep-stage (flat) route only, as the
        JAX ResnetBlock(use_int8=True) routes them; use_deep, use_i8pre: the
        whole-layer deep kernels K8 / K9 (route()); lens_rows: a callable
        giving the mask's valid rows (the estimator counts them once a
        level), which K9 reads; seq: x is a frame slice (the route taken at
        the global frames, each route's sharded form)."""
        b, t, f, cin = x.shape
        tp = self.tp
        stats = None if use_kernels else row_stats_plain
        route = self.route(t if seq is None else seq.t, f, use_kernels, use_int8, use_deep,
                           use_i8pre)
        # the FiLM bias: the rank's columns where the route works on them
        bias_t = self.mlp(mish(t_emb), dtype=dtype,
                          gather=route not in ("k1", "k8", "k9", "flat"))
        if route == "flat":
            return self._flat(x, mask, bias_t, dtype, use_kernels, pre_masked, use_int8, seq)
        if route in ("k1", "k8", "k9"):
            c1, c2 = self.block1.conv, self.block2.conv
            fn, extra = fused_resnet_block, {"seq": seq, "model": tp}
            if route == "k8":
                fn = fused_resnet_block_deep
            elif route == "k9":
                fn = fused_resnet_block_deep_i8
                extra.update(wq=self.i8pre_weights,
                             lens_rows=None if lens_rows is None else lens_rows())
            # K1 and K8 read one packing, K9 its own: a call that routes
            # elsewhere (at another F than packed for) reads its spot pack
            same = ("k9",) if route == "k9" else ("k1", "k8")
            packed = self.packed if self.packed_for in same else self.spot_pack(route, x)
            return fn(
                x.to(dtype), mask, bias_t, c1.kernel, c1.bias, *self.block1.norm.params(),
                c2.kernel, c2.bias, *self.block2.norm.params(),
                wres=None if self.res_conv is None else self.res_conv.kernel,
                bres=None if self.res_conv is None else self.res_conv.bias,
                groups=self.groups, packed=packed, **extra,
            )
        h = self.block1(x, mask, dtype, stats, pre_masked, seq)
        h = h + bias_t[:, None, None, :]
        h = self.block2(h, mask, dtype, stats, seq=seq)
        x_masked = x if pre_masked else x * mask
        if self.res_conv is not None:
            return h + self.res_conv(x_masked, dtype=dtype) * mask
        return h + x_masked

    def _flat(self, x, mask, bias_t, dtype, use_kernels, pre_masked, use_int8, seq=None):
        """Deep-stage block on flattened rows with f32 GroupNorm glue
        (unet.py _flat_matmul_block). The conv outputs c1/c2 stay f32
        accumulators; in int8 mode they are rounded to `dtype` after the
        bias add, where JAX rounds them (unet.py:270-283). seq: x is a
        frame slice (halo'd convs, the int8 scale and the statistics over
        the axis). On a model axis the convs, GroupNorm and residual work on
        the rank's output columns (bias_t is its columns), h is gathered
        before conv2 and the output at the end; under autograd the whole
        tensors that feed column-local work (x, the gathered h, the
        GroupNorm vectors) pass ModelShard.enter, so that their gradients
        sum every rank's share."""
        b, t, f, cin = x.shape
        tp = self.tp
        stats = None if use_kernels else row_stats_plain
        absmax = row_absmax if use_kernels else row_absmax_plain
        n = t * f
        dout = bias_t.shape[-1]
        mask_rows = mask.expand(b, t, f, 1).reshape(b, n, 1)
        m32 = mask_rows.to(torch.float32)
        xf = x.to(dtype).reshape(b, n, cin)
        if tp is not None:
            xf = tp.enter(xf)
        if not pre_masked:
            xf = xf * mask_rows.to(dtype)

        def gn_mish(acc, norm):
            scale, shift = norm.params()
            if tp is not None:
                scale, shift = tp.take(tp.enter(scale), 0), tp.take(tp.enter(shift), 0)
            mean, inv = group_mean_inv(acc, self.groups, stats=stats, seq=seq, model=tp)
            h = (acc.to(torch.float32) - mean[:, None, :]) * inv[:, None, :]
            return mish_one_exp(h * scale + shift)

        def conv(h, i):
            c = (self.block1, self.block2)[i].conv
            if use_int8:
                wq = None if self.int8_weights is None else self.int8_weights[i]
                y = conv3x3_int8(h, c.kernel, f, wq=wq, absmax=absmax, seq=seq)
                return (y + c.bias).to(dtype)
            return conv3x3_rows(h, c.kernel, f, seq) + c.bias

        c1 = conv(xf, 0)
        h = gn_mish(c1, self.block1.norm) * m32
        h = (h + bias_t[:, None, :].to(torch.float32)).to(dtype)
        if tp is not None:
            h = tp.enter(tp.gather(h))
        c2 = conv(h * mask_rows.to(dtype), 1)
        h2 = gn_mish(c2, self.block2.norm) * m32
        xv = xf * mask_rows.to(dtype)
        if self.res_conv is not None:
            res = (matmul_f32(xv, self.res_conv.kernel.reshape(cin, dout))
                   + self.res_conv.bias) * m32
        else:
            res = xv if tp is None else tp.take(xv)
        out = (h2 + res).to(dtype).reshape(b, t, f, dout)
        return out if tp is None else tp.gather(out)


def _pack_after_load(estimator, _incompatible_keys):
    """load_state_dict post-hook: with kernels or int8 convs, quantize the
    flat blocks' conv kernels (the flat int8 route and K9) and pack the
    kernels' weights (K1 / K2 / K8 / K9 convs, K4, K11's resample convs)
    once the weights are in, so that no call casts or reshapes them.
    Weights changed in place afterwards need another load_state_dict (or
    `pack`). Either way the pack generation moves on (CUDA graphs captured
    before are dropped, infer/graphs.py)."""
    if estimator.packs():
        estimator.pack()
    else:
        estimator.pack_generation += 1


class LinearAttention(nn.Module):
    """Softmax-over-keys linear attention over flattened tokens (reference
    unitspeech.py:78-96). Parameters: to_qkv (no bias), to_out."""

    def __init__(self, c: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Dense(c, 3 * hidden, bias=False)
        self.to_out = Dense(hidden, c)

    def forward(self, x, dtype, seq=None):
        """seq: x is a frame slice; the key maxima, the softmax sums and the
        context are reduced over the axis (two collectives), so every rank
        gets the whole sequence's context."""
        b, t, f, c = x.shape
        n, h, d = t * f, self.heads, self.dim_head
        qkv = self.to_qkv(x.reshape(b, n, c), dtype=dtype)
        q, k, v = (z.reshape(b, n, h, d) for z in qkv.chunk(3, dim=-1))
        k_max = k.amax(dim=1, keepdim=True)
        if seq is not None:
            k_max = seq.all_max(k_max)
        k_exp = torch.exp(k - k_max)
        k_sum = k_exp.sum(dim=1, dtype=torch.float32)
        context = torch.einsum("bnhd,bnhe->bhde", k_exp, v)
        if seq is not None:
            both = seq.all_sum(torch.cat([k_sum[..., None], context.to(torch.float32)], -1))
            k_sum, context = both[..., 0], both[..., 1:].to(context.dtype)
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
        self.packed = None  # the kernel's packed weights (K4), set by pack
        # on a model axis: the whole (w_qkv, w_out, b_out) K4 reads, set by pack
        self.whole = None

    def weights(self):
        """(w_qkv, w_out, b_out) whole, as K4 reads them."""
        if self.whole is not None:
            return self.whole
        return self.fn.to_qkv.kernel, self.fn.to_out.kernel, self.fn.to_out.bias

    def pack(self):
        """Pack the projections once for the kernel, where it takes the
        widths; on a model axis first gather their columns (K4 runs whole
        on every rank: C x 384 + 128 x C + C entries a site, f32, beside its
        bf16 pack)."""
        c = self.fn.to_qkv.kernel.shape[0]
        self.packed = self.whole = None
        if not fused_attention.takes(c, self.fn.heads, self.fn.dim_head):
            return
        qkv, out = self.fn.to_qkv, self.fn.to_out
        if qkv.tp is not None or out.tp is not None:
            self.whole = tuple(p.detach() if layer.tp is None else layer.tp.gather(p.detach())
                               for layer, p in ((qkv, qkv.kernel), (out, out.kernel),
                                                (out, out.bias)))
        self.packed = fused_attention.pack_attention_weights(*self.weights()[:2])

    def uses_kernel(self, x, use_kernels: bool, seq=None) -> bool:
        """The kernel's gate at the global tokens (seq: x is a frame slice,
        whose global frames are seq.t)."""
        t = x.shape[1] if seq is None else seq.t
        return (use_kernels and t * x.shape[2] >= PALLAS_MIN_TOKENS
                and fused_attention.takes(x.shape[3], self.fn.heads, self.fn.dim_head))

    def forward(self, x, mask, dtype, use_kernels, seq=None):
        """With the kernel the output rows past the length come out zeroed,
        so the caller can skip its own mask multiply. seq: x is a frame
        slice (the context over the whole sequence)."""
        if self.uses_kernel(x, use_kernels, seq):
            b, t, f, c = x.shape
            y = fused_rezero_attention(
                x.reshape(b, t * f, c).to(dtype), *self.weights(), self.g,
                lens_rows=lens_rows_from_mask(mask, f),
                heads=self.fn.heads, dim_head=self.fn.dim_head, packed=self.packed, seq=seq,
            )
            return y.reshape(b, t, f, c)
        return x + self.fn(x, dtype, seq) * self.g.to(dtype)


class Downsample(nn.Module):
    """conv3x3 stride 2 (reference unitspeech.py:27-33). `packed`: the
    kernel in K11a's layout, made once at load on the use_resample route."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3)
        self.packed = None

    def pack(self):
        """On a model axis the rank's columns, where K11a takes them."""
        self.packed = None
        if kernel_takes(*self.conv.kernel.shape[2:]):
            self.packed = pack_downsample_weight(self.conv.kernel)

    def forward(self, x, dtype, seq=None):
        """seq: x (masked) is a frame slice starting at an even frame: output
        frame j reads input frames 2 j - 1 .. 2 j + 1, so the slice reads the
        one frame before it and no padding on the frame axis."""
        if seq is None:
            return self.conv(x, stride=2, dtype=dtype)
        return self.conv(seq.halo(x, 1, 0), stride=2, dtype=dtype, padding=(0, 1))


class Upsample(nn.Module):
    """ConvTranspose 4x4 stride 2, flax padding 2 (reference
    unitspeech.py:18-24). `packed`: the kernel in K11b's layout, made once at
    load on the use_resample route."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = ConvTranspose2d(c, c, 4, 2, 2)
        self.packed = None

    def pack(self):
        """On a model axis the rank's columns, where K11b takes them."""
        self.packed = None
        if kernel_takes(*self.conv.kernel.shape[2:]):
            self.packed = pack_upsample_weight(self.conv.kernel)

    def forward(self, x, dtype, seq=None):
        """seq: x (masked) is a frame slice of t frames: output frame o reads
        input frames (o - 2) / 2 .. (o + 1) / 2, so the slice's 2 t output
        frames read one frame a side; the transposed conv over the halo'd
        t + 2 frames gives 2 t + 4, of which the middle 2 t are the slice's."""
        if seq is None:
            return self.conv(x, dtype=dtype)
        t = x.shape[1]
        return self.conv(seq.halo(x), dtype=dtype)[:, 2:2 + 2 * t]


class GradLogPEstimator2d(nn.Module):
    """(x_t (B, T, F), mask (B, T), mu (B, T, F), t (B,), spk (B, S))
    -> score (B, T, F) f32. T must be a multiple of 2**(len(mults)-1)."""

    def __init__(self, dim=128, dim_mults=(1, 2, 4, 8), groups=8, pe_scale=1000.0,
                 spk_emb_dim=256, dtype=torch.float32, use_kernels=False,
                 use_int8_deep=False, use_deep=False, use_resample=False,
                 use_i8pre_deep=False, n_feats=80):
        super().__init__()
        self.dim, self.groups, self.pe_scale = dim, groups, pe_scale
        self.n_feats = n_feats  # F of the input, which `pack` packs the routes of
        self.dtype, self.use_kernels = dtype, use_kernels
        # int8 deep-stage convs; the early stages (K1) stay in `dtype`, as
        # the JAX estimator hard-codes (unet.py:394-400)
        self.use_int8_deep = use_int8_deep
        self.use_deep, self.use_resample, self.use_i8pre_deep = (
            use_deep, use_resample, use_i8pre_deep)
        self.register_load_state_dict_post_hook(_pack_after_load)
        # moves on at every pack and load: the sampler's CUDA graphs read
        # the packed tensors, so a graph of an older generation is stale
        self.pack_generation = 0
        self.final_packed = None  # the final block's packed conv (K2), set by pack
        self.tp = None  # the model axis's ModelShard, set by parallel.shard_params_tp
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

    def packs(self) -> bool:
        """Whether a switch routes to weights that `pack` prepares."""
        return bool(self.use_kernels or self.use_int8_deep or self.use_deep
                    or self.use_i8pre_deep or self.use_resample)

    def pack(self):
        """Quantize the flat blocks' convs with use_int8_deep and pack the
        weights of the kernels this estimator routes to at F = n_feats,
        where they take the widths: the ResnetBlocks' convs that their routes
        read (ResnetBlock.pack, at the F of their stage), the final block's
        (K2) and the attention projections (K4) with the kernels, the
        resample convs (K11) with use_resample. Moves the pack generation on:
        every tensor it makes is new."""
        self.pack_generation += 1
        for m in self.modules():
            if isinstance(m, (Downsample, Upsample)) and self.use_resample:
                m.pack()
            if isinstance(m, RezeroAttention) and self.use_kernels:
                m.pack()
        n = len(self.dims)
        stages = [(f"down_{i}_{r}", i) for i in range(n) for r in ("res1", "res2")]
        stages += [("mid_res1", n - 1), ("mid_res2", n - 1)]
        # up stage i runs one level deeper than down stage i
        stages += [(f"up_{i}_{r}", i + 1) for i in range(n - 1) for r in ("res1", "res2")]
        for name, i in stages:
            getattr(self, name).pack(-(-self.n_feats // 2 ** i), self.use_kernels,
                                     self.use_int8_deep, self.use_deep, self.use_i8pre_deep)
        fb = self.final_block.conv.kernel
        self.final_packed = None
        if self.use_kernels and fused_takes(self.dim, self.groups, self.final_block.conv.tp):
            self.final_packed = pack_conv_weight(fb)

    def packed_tensors(self) -> dict:
        """Every tensor that `pack` made (the kernels' packed weights, the
        int8 weights and scales), by module and position, beside the
        parameters they were made from: what goes stale when a weight
        changes in place."""
        out = {}

        def walk(name, v):
            if isinstance(v, torch.Tensor):
                out[name] = v
            elif isinstance(v, (tuple, list)):
                for i, x in enumerate(v):
                    walk(f"{name}.{i}", x)

        for name, m in self.named_modules():
            for attr in ("packed", "int8_weights", "i8pre_weights"):
                walk(f"{name}.{attr}", getattr(m, attr, None))
        walk("final_packed", self.final_packed)
        return out

    def resamples(self, layer, h, i, seq, gate) -> bool:
        """Whether the Downsample / Upsample `layer` of stage i (C =
        dims[i]) on input h runs K11: use_resample, the JAX gate at the
        global frames (seq: h is a frame slice) and the kernel's widths, on
        a model axis at the rank's columns too; else the library resample."""
        c = self.dims[i]
        t = h.shape[1] if seq is None else seq.t
        tp = layer.conv.tp
        return bool(self.use_resample and gate(t, h.shape[2], c) and kernel_takes(c, c)
                    and (tp is None or (c % tp.size == 0 and kernel_takes(c, c // tp.size))))

    def forward(self, x, mask, mu, t, spk_emb, seq=None):
        """seq: a parallel.FrameSlice; x, mask and mu hold this rank's frames
        of the sample (the module docstring), the score too. A model-sharded
        estimator (shard_params_tp) takes every input and gives every
        output whole."""
        dt, uk = self.dtype, self.use_kernels
        seqs = [seq]  # the frame slice of every level
        for _ in self.dims[1:]:
            seqs.append(None if seq is None else seqs[-1].down())
        flags = dict(use_int8=self.use_int8_deep, use_deep=self.use_deep,
                     use_i8pre=self.use_i8pre_deep)
        t_emb = sinusoidal_pos_emb(t, self.dim, self.pe_scale)
        t_emb = self.mlp_0(t_emb, dtype=dt)
        t_emb = self.mlp_1(mish(t_emb), dtype=dt)
        t_emb = torch.cat([t_emb, spk_emb.to(dt)], dim=-1)

        h = torch.stack([mu, x], dim=-1).to(dt)
        m = mask[:, :, None, None].to(dt)
        hiddens, masks = [], [m]
        level_frames = {}  # K11's valid input frames by U-Net level, once per call
        level_rows = {}  # K9's valid rows (frames x F) by level, once per call

        def frames(level, mk):
            """The valid frames of `mk`, the mask of `level` (masks[level])."""
            if level not in level_frames:
                level_frames[level] = frames_from_mask(mk)
            return level_frames[level]

        def rows(level, mk, f):
            """A callable giving the valid rows of `level` at F = f."""
            def get():
                if level not in level_rows:
                    level_rows[level] = frames(level, mk) * f
                return level_rows[level]
            return get
        n_res = len(self.dims)
        for i in range(n_res):
            mk = masks[-1]
            lr = rows(i, mk, h.shape[2])
            sq = seqs[i]
            h = getattr(self, f"down_{i}_res1")(h, mk, t_emb, dt, uk, lens_rows=lr, seq=sq,
                                                **flags)
            # res1's output is masked: res2 skips its input mask
            h = getattr(self, f"down_{i}_res2")(h, mk, t_emb, dt, uk, pre_masked=True,
                                                lens_rows=lr, seq=sq, **flags)
            attn = getattr(self, f"down_{i}_attn")
            h_in = h
            h = attn(h, mk, dt, uk, sq)
            hiddens.append(h)
            if i < n_res - 1:
                down = getattr(self, f"down_{i}_down")
                if self.resamples(down, h, i, sq, supports_downsample):
                    # the kernel masks its input rows: no h * mk pass
                    h = fused_downsample_conv(h.to(dt), mk, down.conv.kernel, down.conv.bias,
                                              packed=down.packed, lens=frames(i, mk), seq=sq,
                                              model=down.conv.tp)
                else:
                    hin = h if attn.uses_kernel(h_in, uk, sq) else h * mk
                    h = down(hin, dt, sq)
            masks.append(mk[:, ::2])

        masks = masks[:-1]
        mk = masks[-1]
        lr = rows(n_res - 1, mk, h.shape[2])
        sq = seqs[-1]
        h = self.mid_res1(h, mk, t_emb, dt, uk, lens_rows=lr, seq=sq, **flags)
        h = self.mid_attn(h, mk, dt, uk, sq)
        h = self.mid_res2(h, mk, t_emb, dt, uk, lens_rows=lr, seq=sq, **flags)

        for i in reversed(range(n_res - 1)):
            mk = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=-1)
            lr = rows(i + 1, mk, h.shape[2])
            sq = seqs[i + 1]  # up stage i runs at level i + 1
            h = getattr(self, f"up_{i}_res1")(h, mk, t_emb, dt, uk, lens_rows=lr, seq=sq,
                                              **flags)
            h = getattr(self, f"up_{i}_res2")(h, mk, t_emb, dt, uk, pre_masked=True,
                                              lens_rows=lr, seq=sq, **flags)
            attn = getattr(self, f"up_{i}_attn")
            h_in = h
            h = attn(h, mk, dt, uk, sq)
            up = getattr(self, f"up_{i}_up")
            if self.resamples(up, h, i, sq, supports_upsample):
                # up stage i's input is one level deeper than down stage i's:
                # its mask is that of level i + 1
                h = fused_upsample_conv(h.to(dt), mk, up.conv.kernel, up.conv.bias,
                                        packed=up.packed, lens=frames(i + 1, mk), seq=sq,
                                        model=up.conv.tp)
            else:
                hin = h if attn.uses_kernel(h_in, uk, sq) else h * mk
                h = up(hin, dt, sq)

        fb, fc = self.final_block, self.final_conv
        if (uk and fused_kernel_shape(h.shape[2])
                and fused_takes(self.dim, self.groups, fb.conv.tp)):
            return fused_final_block(h.to(dt), m, fb.conv.kernel, fb.conv.bias,
                                     *fb.norm.params(), fc.kernel, fc.bias,
                                     groups=self.groups, packed=self.final_packed, seq=seq,
                                     model=fb.conv.tp)
        h = self.final_block(h, m, dt, row_stats_plain, seq=seq)
        out = self.final_conv(h * m, dtype=dt)
        return (out * m)[..., 0].to(torch.float32)
