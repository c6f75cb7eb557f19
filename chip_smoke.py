"""Quickest proof that the PyTorch port runs on the GPU: build the CUDA
kernels, hold each against its plain PyTorch version at the main-path
shapes (with its time, the least time the card could take for the same
work, and the time of one library call computing the same function where
there is one; under each ResnetBlock site kernel A alone at the block's
conv shapes with its launch plan, beside one F.conv2d in bf16 as the main
loop's yardstick, which the port never calls), then serve adaptive-TTS
requests through the port's CLI at full model width (random weights from a
seed): with its serving defaults
(every kernel, int8 deep-stage convs), and with the fused deep-stage
configuration (`--deep --i8pre --resample`: K8, K9, K11). K9's int8 convs
are also held alone, bit-equal to the plain int8 product and dequantize,
K5 beside one F.conv1d in bf16 on a ready activation (the yardstick of its
conv part) with its conv's launch plan, K3 in both its forms (the sums and
the served fold) beside one torch.var_mean over the groups, and the
launches inside K4, K9, K7, K5, K6, K3 and K2 are timed one by one
(tools/kernel_breakdown.py; K3's served call must be one kernel launch and
K2's two). Then check what
comes out: each kernel path against the plain path, the int8 gates and the
kernel vocoder, each run with the exact kernel launches its path makes.
Then the adapt path: `cli finetune` at full width on the card (a synthetic
6 s reference with sidecar units and speaker embedding, no kernel launched:
the fine-tune trains the plain estimator), the adapted decoder served
through `cli inference --decoder` on the serving defaults and on the plain
path, its mels held to the same bounds, and its packed kernel weights equal
to a fresh pack of the adapted weights. Then the frontends: random
full-width SSL checkpoints in the reference's formats (WavLM-Large + ECAPA,
mHuBERT-base, 1000 k-means centroids) through `cli convert`, `cli finetune`
from the reference wav alone (no sidecar; no kernel launched), the card's
speaker embedding, HuBERT features and units against the same modules on
the CPU in f32, and a grapheme request (`--text ... --split-sentences`,
espeak or the rule G2P) served with that adapted decoder on the kernels.
Then voice conversion and the sampler specs: random full-width checkpoints
in the reference's formats (a contentvec encoder through `cli convert
contentvec-encoder`, an HF-named contentvec HuBERT-base), `cli
voice-conversion` with the adapted decoder with ddpm, dpm2 and dpm2:cs2 on
the kernels beside the plain path (the guidance stride's cheap steps are
the estimator's first one-row calls), forced 344-frame requests with
ddpm:cs2 and dpm2:cs2, each with exact launches and its mel within the TTS
bounds, and one seed of the sampler gate (tools/sampler_gate.py).
Last, the paths of the kernels that no request runs, the port's four tools
at full size (unitspeech_tpu_torch/tools): the kernel benchmark with
--int8 --deep (the in-kernel int8 blocks K10a, K10b), the transcendental
microbenchmark (P1), the stride probe (P2) and the compile bisection's 14
shapes (P3: kernel A and kernel C alone); each must launch its kernels.

    python3 chip_smoke.py [--out FILE]

Needs one CUDA device; exits non-zero (and prints no result) without one.
The last line of standard output is the JSON result; --out also writes the
per-site records and the path comparisons to FILE as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import wave

import numpy as np

from unitspeech_tpu_torch.tools import kernel_breakdown

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes: 3 CFG rows at the 344-frame bucket; one padded row
FRAMES, PADDED = 344, 301
# The estimator's kernel paths: the CLI default (int8 deep convs), --no-int8,
# and the fused deep-stage configuration without and with int8
# (--deep --resample --no-int8, --deep --i8pre --resample)
PATHS = ("int8", "bf16", "deep", "deep_i8")


# The tools' paths (unitspeech_tpu_torch/tools): the kernel benchmark run
# with --int8 --deep (K10a, K10b), the transcendental microbenchmark (P1),
# the stride probe (P2) and the compile bisection's shapes (P3)
TOOL_PATHS = ("bench", "transcendental", "probe_stride", "bisect")


def counts(int8, bf16=None, deep=None, deep_i8=None, **tools):
    """Launches of a kernel site per estimator call at the 344-frame bucket
    on each path (the vocoder kernels: per vocoder call); a path not given
    launches it as often as the int8 path. `tools`: launches per call of
    the site on a tool's path (TOOL_PATHS), 0 where not given."""
    return {"int8": int8, **{k: int8 if v is None else v
                             for k, v in (("bf16", bf16), ("deep", deep), ("deep_i8", deep_i8))},
            **{p: tools.get(p, 0) for p in TOOL_PATHS}}


# Every kernel site of one estimator call at the 344-frame bucket
K1_SITES = [  # (F, Cin, Cout), each once per call on every path
    (80, 2, 128), (80, 128, 128),
    (40, 128, 256), (40, 256, 256), (40, 512, 128), (40, 128, 128),
]
# (rows, C, input dtype, launches): GroupNorm statistics of the flat deep
# blocks and of up_1_res2's plain Blocks (tools/kernel_breakdown.py), each
# one K3 launch in its fold form (group_mean_inv)
K3_SITES = [(n, c, dt, counts(i8, bf, deep, deep))
            for n, c, dt, i8, bf, deep in kernel_breakdown.K3_SITES]
# (rows, C, launches): the int8 activation scale of every flat deep-stage
# conv input (nine blocks, two convs each; K9 finds its conv1 input's scale
# itself), on the int8 path only
K7_SITES = [(n, c, counts(per_call, 0, 0, 0)) for n, c, per_call in kernel_breakdown.K7_SITES]
# The deep blocks (F, T, Cin, Cout, launches): down_2 res1/res2, down_3
# res1, down_3 res2 + mid res1/res2, up_2 res1/res2, up_1 res1. K8 takes all
# nine on the deep path; with --i8pre K9 takes those with Cout <= 512
K8_SITES = [
    (20, 86, 256, 512, counts(0, 0, 1, 0)), (20, 86, 512, 512, counts(0, 0, 1, 0)),
    (10, 43, 512, 1024, counts(0, 0, 1, 1)), (10, 43, 1024, 1024, counts(0, 0, 3, 3)),
    (10, 43, 2048, 512, counts(0, 0, 1, 0)), (10, 43, 512, 512, counts(0, 0, 1, 0)),
    (20, 86, 1024, 256, counts(0, 0, 1, 0)),
]
K9_SITES = [(f, t, cin, cout, counts(0, 0, 0, 1)) for f, t, cin, cout, _ in K8_SITES
            if cout <= 512]
# K11 (T, F, C): the F = 80, 40 downsamples and the F = 40 upsample
K11_DOWN_SITES = [(344, 80, 128), (172, 40, 256)]
K11_UP_SITES = [(172, 40, 128)]
# BigVGAN at the 344-frame bucket (tools/kernel_breakdown.py): K5's 24
# sites (T, C, k, d, residual, launches), 72 launches per vocoder call, and
# K6's one (T, C)
K5_SITES, K6_SITE = kernel_breakdown.K5_SITES, kernel_breakdown.K6_SITE
# The fused deep path at the 552-frame bucket (the 498-frame request): as at
# 344, except that up_1_res1 (1024 -> 256 at F = 20, T = 138) fails K9's
# 4 MiB gate and runs the flat int8 route (K3 and K7 twice each)
DEEP_I8_552 = {"fused_resnet_block": 6, "fused_final_block": 1, "row_stats": 4,
               "fused_rezero_attention": 5, "row_absmax": 2, "fused_resnet_block_deep": 4,
               "fused_resnet_block_deep_i8": 4, "fused_downsample_conv": 2,
               "fused_upsample_conv": 1}
AA_REL = 2.0 ** -7  # K5/K6 vs f32: one bf16 rounding of the output plus f32 order
K4_SITES = kernel_breakdown.K4_SITES
# bound on max|kernel - plain| relative to max|plain|: both round to bf16 at
# the same points, so they differ where f32 sums taken in another order
# round to neighbouring bf16 values (one bf16 step is 2^-8..2^-7 relative)
BF16_REL = 2.0 ** -6
# K9 on top of that: its GroupNorm statistics are summed in another order
# than the plain version's, so a glue value within f32 round-off of a .5
# int8 boundary may round the other way (a few in a layer). One int8 step
# of one conv2 input moves the outputs it reaches by at most
# max|w2| * max|h| / 127 before GroupNorm, which normalises by about
# rms(w2) * sqrt(9 * C) * rms(h): with random full-width weights
# (max|w| / (rms(w) sqrt(9 C)) < 0.08, max|h| / rms(h) < 8) that is < 0.005
# of a unit-scale output, under 2^-7 of max|plain| (max|plain| >= 1)
I8_REL = 2.0 ** -6 + 2.0 ** -7
F32_REL = 1e-4  # K3's sums: f32 sums in another order
# K3's fold form (mean, inv): var = E[x^2] - mean^2 cancels mean^2, at most a
# fifth of E[x^2] at these inputs (N(0.5, 1)), so var keeps the sums'
# relative error within 1.25x and inv (rsqrt) half of that; mean and inv
# are held to twice F32_REL of max(|ref|, 1)
FOLD_REL = 2 * F32_REL
# P1: the accurate bodies may differ by an ulp where the kernel's sinf /
# expf / tanhf / rsqrtf and PyTorch's differ; the exp chain amplifies such a
# difference by up to e^8 / 2 a round until it saturates at e^8
P1_REL = 2.0 ** -12
# Kernel path vs plain path mel after 50 steps, both bf16, in units of the
# plain mel's dynamic range (max - min). With random weights the sampler
# state grows ~136x (the product of the schedule's c_x) and a rounding
# difference grows with it. The JAX package's own bf16 mel differs from its
# f32 mel by an L1 of 6.6e-4..7.1e-4 of that range at this size (full
# widths, 344 frames, random weights; INT8_GATE.json). The two bf16 paths
# round at different points (the kernels keep GroupNorm math in f32, the
# plain path in bf16), so their L1 is held to 3x that band, and the largest
# difference to 10x the L1 bound.
MEL_L1_BOUND = 2e-3
MEL_MAX_BOUND = 2e-2
# The port-side int8 gate: the int8 path's mel L1 against the plain f32 run
# is held to INT8_GATE_RATIO x the bf16 kernel path's (INT8_GATE.json
# gate_ratio; the JAX package measured 1.25-1.28); the fused deep path's
# int8 (K9) likewise against the fused deep bf16 path
INT8_GATE_RATIO = 2.0
# Published H100 SXM peaks (dense): the least time for a site's work is the
# larger of its bytes over the memory rate and its operations over the
# rates of their types
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "i8": 1979e12, "f32": 67e12}
# f32 operations per output element of a ResnetBlock around its products:
# bias and statistics of both convs (6), GroupNorm + affine + mish + FiLM +
# mask of c1 (~14), GroupNorm + affine + mish + mask + residual of c2 (~16);
# K9 adds its quantize passes (~4)
EW_BLOCK = 40
# The kernel benchmark's in-kernel int8 blocks against the plain block (bf16
# at F = 80/40, the flat int8 route at F = 20/10): each int8 conv is ~1%
# off its float value (JAX's int8 error band), the two sides quantize with
# different scales, so their relative difference stays under 10%
INT8_BENCH_REL = 0.1
# The kernel vocoder's waveform L1 against the plain f32 vocoder, on the same
# f32 mel, is held to VOC_RATIO x the plain bf16 vocoder's
VOC_RATIO = 1.5


def _lens_mask(torch, t, dev):
    lens = torch.tensor([t, -(-PADDED * t // FRAMES), t], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    return mask[:, :, None, None]


def _time_ms(torch, fn, reps=20, warmup=3):
    """Median device milliseconds of one call (tools.median_ms: CUDA events
    recorded behind a spin of the card, so the host's launch cost is not
    timed)."""
    from unitspeech_tpu_torch.tools import median_ms

    return median_ms(fn, torch.device("cuda"), reps, warmup)


def bound_ms(work):
    """The least time (ms) the card could take for a site's work, and what
    bounds it: `work` holds the bytes moved (each input read once, each
    output written once) and the operations by type."""
    t_bytes = work.get("bytes", 0) / PEAK["bytes"]
    t_ops = sum(work.get(k, 0) / PEAK[k] for k in ("bf16", "i8", "f32"))
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def block_work(b, n, cin, cout, i8_conv1=False, i8_conv2=False):
    """One ResnetBlock on (b, n, cin) bf16 rows: two conv3x3, the 1x1
    residual when cin != cout (bf16 or int8 products, int8 weights one byte
    each), EW_BLOCK f32 operations per output element."""
    conv1, conv2 = 2 * b * n * 9 * cin * cout, 2 * b * n * 9 * cout * cout
    res = 2 * b * n * cin * cout if cin != cout else 0
    w_bytes = (9 * cin * cout * (1 if i8_conv1 else 2) + 9 * cout * cout * (1 if i8_conv2 else 2)
               + (2 * cin * cout if res else 0) + 4 * 7 * cout + 2 * b * cout)
    return {"bytes": 2 * b * n * (cin + cout) + w_bytes,
            "bf16": (0 if i8_conv1 else conv1) + (0 if i8_conv2 else conv2) + res,
            "i8": (conv1 if i8_conv1 else 0) + (conv2 if i8_conv2 else 0),
            "f32": EW_BLOCK * b * n * cout}


def check_kernels(torch, dev):
    """Each kernel against its plain version on the same inputs, bf16 on the
    card (K5/K6 against theirs in f32). Returns one record per (kernel,
    site); raises on a mismatch."""
    import torch.nn.functional as F

    from unitspeech_tpu_torch.models.layers import conv_transpose_weight
    from unitspeech_tpu_torch.ops import (
        aa_snake,
        fused_attention,
        fused_resnet,
        fused_resnet_deep,
        probes,
        resample,
        row_stats,
    )
    from unitspeech_tpu_torch.tools import bisect_deep_compile, probe_stride

    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    records = []

    def compare(name, src, replaces, site, kern, plain, rel, per_call, work, lib=None,
                ref32=None, timed=None):
        """per_call: launches per call on each path (counts()). work: the
        site's bytes and operations (bound_ms). lib: one PyTorch call that
        computes the same function, timed as a yardstick only. ref32: an
        f32 reference on the same (bf16-rounded) inputs; the error is taken
        against it, and the bf16 plain version's distance to the kernel is
        printed beside it. timed: the (kernel, plain) calls to time where
        kern and plain wrap them for the comparison."""
        got = kern()
        want = plain() if ref32 is None else ref32()
        torch.cuda.synchronize()
        err = (got.float().reshape(want.shape) - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        tol = rel * max(ref, 1.0)
        ok = bool(np.isfinite(err) and err <= tol)
        extra = ""
        if ref32 is not None:
            d_plain = (got.float() - plain().float()).abs().max().item()
            extra = f", vs the bf16 plain version {d_plain:.3e}"
            del want
        b_ms, b_bytes, b_ops = bound_ms(work)
        rec = dict(name=name, route="cuda", source=src, replaces=replaces, site=site,
                   counts=per_call, max_abs_err=err, tol=tol,
                   ms=_time_ms(torch, (timed or (kern, plain))[0]),
                   plain_ms=_time_ms(torch, (timed or (kern, plain))[1]),
                   bound_ms=b_ms, bytes_ms=b_bytes, ops_ms=b_ops,
                   lib_ms=None if lib is None else _time_ms(torch, lib))
        lib_txt = "" if lib is None else f", library {rec['lib_ms']:.4f} ms"
        print(f"  {name} {site}: max_abs_err {err:.3e} (bound {tol:.3e}, max|ref| "
              f"{ref:.3e}{extra}) kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"least {b_ms:.4f} ms{lib_txt}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {site}: {err} exceeds {tol}")
        records.append(rec)

    def block_inputs(t, f, cin, cout):
        x = rand(3, t, f, cin).to(torch.bfloat16)
        p = dict(t_bias=rand(3, cout), w1=rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                 b1=rand(cout, scale=0.1), gn1_scale=1 + rand(cout, scale=0.1),
                 gn1_bias=rand(cout, scale=0.1),
                 w2=rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5), b2=rand(cout, scale=0.1),
                 gn2_scale=1 + rand(cout, scale=0.1), gn2_bias=rand(cout, scale=0.1))
        if cin != cout:
            p.update(wres=rand(1, 1, cin, cout, scale=cin ** -0.5), bres=rand(cout, scale=0.1))
        mask = _lens_mask(torch, t, dev)
        lens = fused_resnet.lens_rows_from_mask(mask, f)
        return x, mask, lens, p

    def rows_args(x, lens, p, t, f, cin, cout):
        return (x.reshape(3, t * f, cin), lens, p["t_bias"], p["w1"].reshape(9 * cin, cout),
                p["b1"], p["gn1_scale"], p["gn1_bias"], p["w2"].reshape(9 * cout, cout),
                p["b2"], p["gn2_scale"], p["gn2_bias"],
                p["wres"].reshape(cin, cout) if cin != cout else None, p.get("bres"))

    def conv_sites(t, f, cin, cout, p, packed):
        """Kernel A alone at a block's two conv shapes (conv1 on x, conv2 on
        a (3, T*F, Cout) input) with the weights packed as at load, beside one
        F.conv2d of the same shape in bf16, channels-last, TF32 off (the
        yardstick of the main loop alone; the port never calls it), with
        each conv's launch plan (csrc/resnet_block.cu conv_plan) and, where
        the block has one, the 1x1 residual's. Returns the records."""
        out = []
        n = t * f
        lens = fused_resnet.lens_rows_from_mask(_lens_mask(torch, t, dev), f)
        for name, ci, w, pk in (("conv1", cin, p["w1"], packed[0]),
                                ("conv2", cout, p["w2"], packed[1])):
            xin = rand(3, n, ci).to(torch.bfloat16)
            wr = w.reshape(9 * ci, cout)
            kern = lambda: fused_resnet.resnet_conv3x3(xin, lens, wr, p["b1"], f, packed=pk)
            xn = xin.reshape(3, t, f, ci).permute(0, 3, 1, 2)  # NCHW view, channels-last
            wn = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b_ms = bound_ms({"bytes": 2 * 3 * n * (ci + cout) + 2 * 9 * ci * cout,
                             "bf16": 2 * 3 * n * 9 * ci * cout, "f32": 3 * 3 * n * cout})[0]
            rec = {"conv": name, "cin": ci, "cout": cout, "ms": _time_ms(torch, kern),
                   "conv2d_ms": _time_ms(torch, lambda: F.conv2d(xn, wn, padding=1)),
                   "bound_ms": b_ms,
                   "plan": fused_resnet.conv_plan(9, 3, t, f, ci, cout) if ci % 8 == 0 else None}
            pl = rec["plan"]
            how = ("element loads on mma.sync (Cin % 8 != 0)" if pl is None else
                   f"tile {pl['tt']} x {pl['tf']} rows, Cout tile {pl['bn']}, {pl['blocks']} "
                   f"blocks ({pl['blocks_per_sm']} an SM), {pl['smem']} B shared")
            print(f"    kernel A {name} {ci}->{cout}: {rec['ms']:.4f} ms, F.conv2d (bf16, "
                  f"channels-last) {rec['conv2d_ms']:.4f} ms, least {b_ms:.4f} ms; {how}",
                  flush=True)
            out.append(rec)
        if cin != cout and cin % 8 == 0:
            pl = fused_resnet.conv_plan(1, 3, t, f, cin, cout)
            print(f"    kernel C 1x1 {cin}->{cout}: {pl['tt']} rows a tile, Cout tile "
                  f"{pl['bn']}, {pl['blocks']} blocks, {pl['smem']} B shared", flush=True)
            out.append({"conv": "res1x1", "cin": cin, "cout": cout, "plan": pl})
        return out

    def packed_of(p):
        # packed once, as the estimator packs them when its weights load
        return fused_resnet.pack_block_weights(p["w1"], p["w2"], p.get("wres"))

    src_res = "unitspeech_tpu_torch/csrc/resnet_block.cu"
    for f, cin, cout in K1_SITES:
        t = FRAMES * f // 80
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        args = rows_args(x, lens, p, t, f, cin, cout)
        packed = packed_of(p)
        compare("fused_resnet_block", src_res,
                "unitspeech_tpu/ops/pallas_resnet.py:1243",
                f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet.fused_resnet_block(x, mask, groups=8, packed=packed, **p),
                lambda: fused_resnet.resnet_block_plain(*args, f=f, groups=8), BF16_REL,
                counts(1), block_work(3, t * f, cin, cout))
        records[-1]["convs"] = conv_sites(t, f, cin, cout, p, packed)

    t, f, c = FRAMES, 80, 128
    x = rand(3, t, f, c).to(torch.bfloat16)
    mask = _lens_mask(torch, t, dev)
    lens = fused_resnet.lens_rows_from_mask(mask, f)
    w1, b1 = rand(3, 3, c, c, scale=(9 * c) ** -0.5), rand(c, scale=0.1)
    s1, be1 = 1 + rand(c, scale=0.1), rand(c, scale=0.1)
    wo, bo = rand(1, 1, c, 1, scale=c ** -0.5), rand(1, scale=0.1)
    n = t * f
    w1p = fused_resnet.pack_conv_weight(w1)
    compare("fused_final_block", src_res, "unitspeech_tpu/ops/pallas_resnet.py:778",
            f"F={f} T={t} {c}->1",
            lambda: fused_resnet.fused_final_block(x, mask, w1, b1, s1, be1, wo, bo, groups=8,
                                                   packed=w1p),
            lambda: fused_resnet.final_block_plain(x.reshape(3, t * f, c), lens,
                                                   w1.reshape(9 * c, c), b1, s1, be1,
                                                   wo.reshape(c), bo, f=f, groups=8),
            BF16_REL, counts(1),
            {"bytes": 2 * 3 * n * c + 2 * 9 * c * c + 4 * 3 * n, "bf16": 2 * 3 * n * 9 * c * c,
             "f32": 22 * 3 * n * c})

    src_rs3 = "unitspeech_tpu_torch/csrc/row_stats.cu"
    for n, c, dt, per_call in K3_SITES:
        x = (rand(3, n, c) + 0.5).to(getattr(torch, dt))
        groups = kernel_breakdown.K3_GROUPS
        # the sums form (no served call: the line's row is the fold form)
        compare("row_stats_sums", src_rs3, "unitspeech_tpu/ops/pallas_stats.py:96",
                f"n={n} C={c} {dt}", lambda: row_stats.row_stats(x),
                lambda: row_stats.row_stats_plain(x), F32_REL, counts(0),
                {"bytes": x.element_size() * 3 * n * c + 4 * 3 * 2 * c, "f32": 3 * 3 * n * c})
        # the fold form, timed as the estimator calls it, beside one var_mean
        # over the groups (the library call computing the same statistics)
        fold = lambda: row_stats.group_mean_inv(x, groups)  # noqa: E731
        fold_plain = lambda: row_stats.group_mean_inv_plain(  # noqa: E731
            x, groups, stats=row_stats.row_stats_plain)
        compare("row_stats", src_rs3, "unitspeech_tpu/ops/pallas_stats.py:96",
                f"n={n} C={c} {dt} fold", lambda: torch.stack(fold()),
                lambda: torch.stack(fold_plain()), FOLD_REL, per_call,
                {"bytes": x.element_size() * 3 * n * c + 4 * 2 * 3 * c, "f32": 3 * 3 * n * c},
                lib=lambda: torch.var_mean(x.unflatten(2, (groups, c // groups)), dim=(1, 3),
                                           correction=0), timed=(fold, fold_plain))

    for n, c, per_call in K7_SITES:
        x = rand(3, n, c).to(torch.bfloat16)
        compare("row_absmax", "unitspeech_tpu_torch/csrc/row_stats.cu",
                "unitspeech_tpu/ops/pallas_stats.py:119", f"n={n} C={c} bf16",
                lambda: row_stats.row_absmax(x), lambda: row_stats.row_absmax_plain(x),
                0.0, per_call, {"bytes": 2 * 3 * n * c + 4 * 3 * c, "f32": 2 * 3 * n * c},
                lib=lambda: torch.linalg.vector_norm(x, ord=float("inf"), dim=1,
                                                     dtype=torch.float32))

    for n, c in K4_SITES:
        x = rand(3, n, c).to(torch.bfloat16)
        w_qkv, w_out = rand(c, 384, scale=c ** -0.5), rand(128, c, scale=128 ** -0.5)
        b_out, gate = rand(c, scale=0.1), torch.tensor([0.7], device=dev)
        lens = torch.tensor([n, n * PADDED // FRAMES, n], dtype=torch.int32, device=dev)
        # packed once, as the estimator packs them when its weights load
        packed = fused_attention.pack_attention_weights(w_qkv, w_out)
        compare("fused_rezero_attention", "unitspeech_tpu_torch/csrc/rezero_attention.cu",
                "unitspeech_tpu/ops/pallas_attention.py:183", f"N={n} C={c}",
                lambda: fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, gate,
                                                               lens, packed=packed),
                lambda: fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, gate,
                                                               lens, 4, 32),
                BF16_REL, counts(1),
                {"bytes": 2 * 2 * 3 * n * c + 2 * 512 * c,
                 "bf16": 3 * (2 * n * c * 384 + 4 * n * 4 * 32 * 32 + 2 * n * 128 * c),
                 "f32": 3 * (4 * n * 128 + 2 * n * c)})

    src_aa = "unitspeech_tpu_torch/csrc/aa_snake.cu"
    for t, c, k, d, res, count in K5_SITES:
        x = rand(1, c, t, scale=0.5).to(torch.bfloat16)
        alpha, beta = rand(c, scale=0.3), rand(c, scale=0.3)
        w, bias = rand(k, c, c, scale=(k * c) ** -0.5).to(torch.bfloat16), rand(c, scale=0.1)
        r = rand(1, c, t, scale=0.5).to(torch.bfloat16) if res else None
        # packed once, as the vocoder packs them when its weights load
        packed = aa_snake.pack_aa_conv(alpha, beta, w, bias)
        # the library yardstick of the conv part alone: F.conv1d in bf16 on a
        # ready activation (the port never calls it)
        y_aa = aa_snake.aa_snake_plain(x, alpha, beta)
        w_lib, b_lib = w.permute(2, 1, 0).contiguous(), bias.to(torch.bfloat16)
        compare("fused_aa_snake_conv", src_aa, "unitspeech_tpu/ops/pallas_kernels.py:289",
                f"T={t} C={c} k={k} d={d}{' +res' if res else ''}",
                lambda: aa_snake.fused_aa_snake_conv(x, alpha, beta, w, bias, d, r,
                                                     packed=packed),
                lambda: aa_snake.aa_snake_conv_plain(x, alpha, beta, w, bias, d, r),
                AA_REL, counts(count),
                {"bytes": 2 * c * t * (3 if res else 2) + 2 * k * c * c + 12 * c,
                 "bf16": 2 * k * c * c * t, "f32": 60 * c * t},
                lib=lambda: F.conv1d(y_aa, w_lib, b_lib, padding=(k - 1) // 2 * d, dilation=d),
                ref32=lambda: aa_snake.aa_snake_conv_plain(
                    x.float(), alpha, beta, w.float(), bias, d, None if r is None else r.float()))
        rec = records[-1]
        rec["plan"] = pl = aa_snake.conv_plan(1, c, t, k, d)
        form = "resident weights, persistent" if pl["resident"] else "weight ring"
        print(f"    conv ({form}): {pl['box_rows']}-row boxes ({pl['boxes']} slots), Cout "
              f"tile {aa_snake.conv_cols(c)}, {pl['blocks']} blocks ({pl['blocks_per_sm']} an "
              f"SM), {pl['smem']} B shared; {rec['bound_ms'] / rec['ms']:.1%} of the bound",
              flush=True)
    t, c = K6_SITE
    x = rand(1, c, t, scale=0.5).to(torch.bfloat16)
    alpha, beta = rand(c, scale=0.3), rand(c, scale=0.3)
    sp = aa_snake.pack_snake(alpha, beta)  # packed once, as at load
    compare("fused_aa_snake", src_aa, "unitspeech_tpu/ops/pallas_kernels.py:388",
            f"T={t} C={c}", lambda: aa_snake.fused_aa_snake(x, alpha, beta, packed=sp),
            lambda: aa_snake.aa_snake_plain(x, alpha, beta), AA_REL, counts(1),
            {"bytes": 2 * 2 * c * t + 8 * c, "f32": 60 * c * t},
            ref32=lambda: aa_snake.aa_snake_plain(x.float(), alpha, beta))

    for f, t, cin, cout, per_call in K8_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        args = rows_args(x, lens, p, t, f, cin, cout)
        packed = packed_of(p)
        compare("fused_resnet_block_deep", src_res,
                "unitspeech_tpu/ops/pallas_resnet.py:643", f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet_deep.fused_resnet_block_deep(x, mask, groups=8,
                                                                  packed=packed, **p),
                lambda: fused_resnet.resnet_block_plain(*args, f=f, groups=8), BF16_REL,
                per_call, block_work(3, t * f, cin, cout))
        records[-1]["convs"] = conv_sites(t, f, cin, cout, p, packed)

    for f, t, cin, cout, per_call in K9_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        # the FiLM bias in the activation dtype, as the estimator's MLP gives it
        p["t_bias"] = p["t_bias"].to(torch.bfloat16)
        # weights quantized and packed once, as the estimator does when they load
        wq = (fused_resnet_deep.quant_w(p["w1"]), fused_resnet_deep.quant_w(p["w2"]))
        packed = fused_resnet_deep.pack_block_weights_i8(p["w1"], wq, p.get("wres"))
        a = rows_args(x, lens, p, t, f, cin, cout)
        args = (*a[:4], wq[0], *a[4:7], wq[1], *a[8:])
        compare("fused_resnet_block_deep_i8", "unitspeech_tpu_torch/csrc/resnet_deep_i8.cu",
                "unitspeech_tpu/ops/pallas_resnet.py:1106", f"F={f} T={t} {cin}->{cout}",
                # the valid rows counted once, as the estimator counts them a level
                lambda: fused_resnet_deep.fused_resnet_block_deep_i8(x, mask, groups=8, wq=wq,
                                                                     packed=packed,
                                                                     lens_rows=lens, **p),
                lambda: fused_resnet_deep.resnet_block_deep_i8_plain(*args, f=f, groups=8),
                I8_REL, per_call,
                block_work(3, t * f, cin, cout, i8_conv1=cin <= cout, i8_conv2=True))
        # K9's int8 convs alone (conv1 where Cin <= Cout, conv2), bit-equal
        # to the plain int8 product and dequantize on the same int8 inputs
        for conv, ci, pk, q in (("conv1", cin, packed[0], wq[0]),
                                ("conv2", cout, packed[1], wq[1])):
            if ci > cout:
                continue
            x8 = torch.randint(-127, 128, (3, t * f, ci), generator=g).to(torch.int8).to(dev)
            x8[1, int(lens[1]):] = 0
            sx = (torch.rand(3, generator=g) * 40 + 10).to(dev)
            n = t * f
            compare("resnet_conv3x3_i8", "unitspeech_tpu_torch/csrc/resnet_block.cu",
                    "unitspeech_tpu/ops/pallas_resnet.py:1106", f"F={f} T={t} {conv} {ci}->{cout}",
                    lambda: fused_resnet_deep.resnet_conv3x3_i8(x8, sx, q, p["b1"], lens, f,
                                                                packed=pk),
                    lambda: fused_resnet_deep._dequant(
                        fused_resnet_deep._conv3x3_i8_plain(x8, q, f), sx, q[1],
                        p["b1"]).to(torch.bfloat16),
                    0.0, counts(0),
                    {"bytes": 3 * n * ci + 9 * ci * cout + 2 * 3 * n * cout + 4 * 3 * cout,
                     "i8": 2 * 3 * n * 9 * ci * cout, "f32": 3 * 3 * n * cout})

    # K10a / K10b: one launch per block call of the kernel benchmark; the
    # same int8 bound as K9 (both quantize conv2's input after GroupNorm
    # statistics summed in another order; the int8 products are exact)
    src_i8 = "unitspeech_tpu_torch/csrc/resnet_block_i8.cu"
    for f, cin, cout in K1_SITES:
        t = FRAMES * f // 80
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
        a = rows_args(x, lens, p, t, f, cin, cout)
        fpt = fused_resnet.pick_frames_per_tile(t, f, max(cin, cout))
        compare("fused_resnet_block_int8", src_i8, "unitspeech_tpu/ops/pallas_resnet.py:1243",
                f"F={f} T={t} {cin}->{cout} tiles of {fpt} frames",
                lambda: fused_resnet.fused_resnet_block(x, mask, groups=8, int8=True, wq=wq, **p),
                lambda: fused_resnet.resnet_block_i8_plain(*a[:4], wq[0], *a[4:7], wq[1], *a[8:],
                                                           f=f, groups=8, fpt=fpt),
                I8_REL, counts(0, bench=1),
                block_work(3, t * f, cin, cout, i8_conv1=True, i8_conv2=True))
    for f, t, cin, cout, _ in K8_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
        a = rows_args(x, lens, p, t, f, cin, cout)
        compare("fused_resnet_block_deep_int8", src_i8,
                "unitspeech_tpu/ops/pallas_resnet.py:643", f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet_deep.fused_resnet_block_deep(x, mask, groups=8, int8=True,
                                                                  wq=wq, **p),
                lambda: fused_resnet_deep.resnet_block_deep_int8_plain(
                    *a[:4], wq[0], *a[4:7], wq[1], *a[8:], f=f, groups=8),
                I8_REL, counts(0, bench=1),
                block_work(3, t * f, cin, cout, i8_conv1=cin <= cout, i8_conv2=True))

    # P1: the eight bodies at the microbenchmark's defaults
    src_pr = "unitspeech_tpu_torch/csrc/probes.cu"
    xt = rand(4096, 128)
    for body in probes.BODIES:
        compare("transcendental_chain", src_pr, "tools/bench_transcendental.py:29",
                f"body={body} (4096, 128) k=64",
                lambda: probes.transcendental_chain(xt, 64, body),
                lambda: probes.transcendental_chain_plain(xt, 64, body), P1_REL,
                counts(0, transcendental=1),
                {"bytes": 2 * 4 * xt.numel(), "f32": xt.numel() * 64 * probes.ROUND_OPS[body]})
    # P2: the six cases of the stride probe, each against its plain version
    # bit for bit
    xs = rand(probe_stride.R, probe_stride.C).to(torch.bfloat16)
    libs = probe_stride.library_calls(xs)
    for case, kern, k_args, key in probe_stride.FORMS:
        y = kern(xs, *k_args)
        work = {"bytes": probe_stride.needed_bytes(key, y)}
        if kern is probes.selection_matmul:
            work["bf16"] = 2 * y.shape[0] * xs.shape[0] * xs.shape[1]
        compare(kern.__name__, src_pr, "tools/probe_stride.py:36", case,
                lambda: kern(xs, *k_args), lambda: probe_stride.PLAIN[kern](xs, *k_args), 0.0,
                counts(0, probe_stride=1), work, lib=libs[case])
    # P3: kernel A alone and kernel C alone at the bisection's 14 shapes
    for name, (t, f, cin, cout) in bisect_deep_compile.CASES.items():
        q = bisect_deep_compile.case_inputs(name, dev)
        n = t * f
        x_rows = q["x"].reshape(1, n, cin)
        w1 = q["w1"].reshape(9 * cin, cout)
        # packed once, as the tool packs them
        w1p = fused_resnet.pack_conv_weight(q["w1"])
        wrp = fused_resnet.pack_conv_weight(q["wres_c"].reshape(1, 1, cin, cout))
        compare("resnet_conv3x3", src_res, "tools/bisect_deep_compile.py:152",
                f"{name} {cin}->{cout}",
                lambda: fused_resnet.resnet_conv3x3(x_rows, q["lens"], w1, q["b1"], f,
                                                    packed=w1p)[0],
                lambda: fused_resnet.resnet_conv3x3_plain(x_rows, q["lens"], w1, q["b1"], f,
                                                          8)[0],
                BF16_REL, counts(0, bisect=1),
                {"bytes": 2 * n * (cin + cout) + 2 * 9 * cin * cout + 4 * 3 * cout,
                 "bf16": 2 * n * 9 * cin * cout, "f32": 3 * n * cout})
        for mode in fused_resnet.OUT_MODES:
            if mode == "identity" and cin != cout:
                continue
            wres = (q["wres_c"], q["bres_c"]) if mode == "matmul" else (None, None)
            c_args = (q["c2"], x_rows, q["mean"], q["inv"], q["s2"], q["be2"], q["lens"], mode,
                      *wres)
            out_bytes = 4 if mode == "none" else 2
            compare("resnet_out", src_res, "tools/bisect_deep_compile.py:179",
                    f"{name} {cin}->{cout} {mode}",
                    lambda: fused_resnet.resnet_out(*c_args,
                                                    packed=wrp if mode == "matmul" else None),
                    lambda: fused_resnet.resnet_out_plain(*c_args), BF16_REL,
                    counts(0, bisect=1),
                    {"bytes": n * cout * (2 + out_bytes) + (0 if mode == "none" else 2 * n * cin)
                     + (2 * cin * cout if mode == "matmul" else 0) + 4 * 4 * cout,
                     "bf16": 2 * n * cin * cout if mode == "matmul" else 0,
                     "f32": 16 * n * cout})

    src_rs = "unitspeech_tpu_torch/csrc/resample.cu"
    for (t, f, c), up in [(s, False) for s in K11_DOWN_SITES] + [(s, True) for s in K11_UP_SITES]:
        x = rand(3, t, f, c).to(torch.bfloat16)
        mask = _lens_mask(torch, t, dev)
        taps = 4 if up else 3
        w, bias = rand(taps, taps, c, c, scale=(taps * taps * c) ** -0.5), rand(c, scale=0.1)
        # timed as the estimator calls it: weights packed once at load, the
        # valid frames counted once per estimator call, so each call is the
        # one kernel launch
        packed = (resample.pack_upsample_weight if up else resample.pack_downsample_weight)(w)
        frames = resample.frames_from_mask(mask)
        xm = (x * mask.to(x.dtype)).permute(0, 3, 1, 2)  # masked, NCHW view for the library
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        rows_in = 3 * t * f
        if up:
            wt = conv_transpose_weight(wb).contiguous()
            compare("fused_upsample_conv", src_rs, "unitspeech_tpu/ops/pallas_resample.py:389",
                    f"T={t} F={f} C={c}",
                    lambda: resample.fused_upsample_conv(x, mask, w, bias, packed=packed,
                                                         lens=frames),
                    lambda: resample.upsample_conv_plain(x, mask, w, bias), BF16_REL,
                    counts(0, 0, 1, 1),
                    {"bytes": 2 * rows_in * c * 5 + 2 * 16 * c * c + 4 * c,
                     "bf16": 2 * 4 * rows_in * 4 * c * c, "f32": 4 * rows_in * c},
                    lib=lambda: F.conv_transpose2d(xm, wt, bb, stride=2, padding=1))
        else:
            wt = wb.permute(3, 2, 0, 1).contiguous()
            compare("fused_downsample_conv", src_rs, "unitspeech_tpu/ops/pallas_resample.py:209",
                    f"T={t} F={f} C={c}",
                    lambda: resample.fused_downsample_conv(x, mask, w, bias, packed=packed,
                                                           lens=frames),
                    lambda: resample.downsample_conv_plain(x, mask, w, bias), BF16_REL,
                    counts(0, 0, 1, 1),
                    {"bytes": 2 * rows_in * c * 5 // 4 + 2 * 9 * c * c + 4 * c,
                     "bf16": 2 * (rows_in // 4) * 9 * c * c, "f32": rows_in // 4 * c},
                    lib=lambda: F.conv2d(xm, wt, bb, stride=2, padding=1))
        rec = records[-1]
        rec["plan"] = resample.resample_plan(up, 3, t, f, c, c)
        pl = rec["plan"]
        print(f"    tile {pl['tt']} x {pl['tf']} rows, Cout tile {pl['bn']}, {pl['blocks']} blocks "
              f"({pl['blocks_per_sm']} an SM), {pl['smem']} B shared; "
              f"{rec['bound_ms'] / rec['ms']:.1%} of the bound, "
              f"{rec['ms'] / rec['lib_ms']:.2f}x the library call", flush=True)
    return records


ESTIMATOR_KERNELS = ("fused_resnet_block", "fused_final_block", "row_stats",
                     "fused_rezero_attention", "row_absmax", "fused_resnet_block_deep",
                     "fused_resnet_block_deep_i8", "fused_downsample_conv",
                     "fused_upsample_conv")
VOCODER_KERNELS = ("fused_aa_snake_conv", "fused_aa_snake")
# the kernels that no served request runs, by the tool path that runs them
TOOL_KERNELS = {"fused_resnet_block_int8": "bench", "fused_resnet_block_deep_int8": "bench",
                "transcendental_chain": "transcendental", "row_select": "probe_stride",
                "selection_matmul": "probe_stride", "interleave_rows": "probe_stride",
                "resnet_conv3x3": "bisect", "resnet_out": "bisect"}
KERNELS = ESTIMATOR_KERNELS + VOCODER_KERNELS + tuple(TOOL_KERNELS)
# the path whose per-call launches weigh a kernel's times in the kernels
# line: the serving default, the fused deep configuration, or a tool's path
# (one launch per call at each of its sites)
HOME = {k: TOOL_KERNELS.get(k, "deep_i8" if k in (
    "fused_resnet_block_deep", "fused_resnet_block_deep_i8", "fused_downsample_conv",
    "fused_upsample_conv") else "int8") for k in KERNELS}
# the run whose launch counts stand in the kernels line, by home path
RUN_OF = {"int8": "default"}
STEPS = 50  # DDPM steps of every request: one 3-row estimator call each
# IPA requests of different lengths, then one forced to the 344-frame bucket
REQUESTS = [
    "ðə kwɪk bɹaʊn fɑks.",
    "hɪɹ ɪz ə lɔŋɡɚ sɛntəns ðæt ʃʊd teɪk ə fjʊ sɛkəndz tə seɪ.",
    "wʌns əpɑn ə taɪm, ɪn ə smɔl vɪlɪdʒ baɪ ðə si, ðɛɹ lɪvd ən oʊld fɪʃɚmən hu "
    "spɛnt hɪz deɪz mɛndɪŋ nɛts ənd tɛlɪŋ stɔɹiz tə ðə tʃɪldɹən.",
]
FORCED_TEXT = "ðɪs ɹɪkwɛst ɪz fɔɹst tə ðə θɹi hʌndɹəd ənd fɔɹti fɔɹ fɹeɪm bʌkɪt."
DEEP_FLAGS = ["--deep", "--i8pre", "--resample"]
# the estimator routes of each compared run: (name, path, dtype, kernels, routes)
RUNS = [("kernels", "bf16", "bfloat16", True, {}),
        ("int8", "int8", "bfloat16", True, {"use_int8_deep": True}),
        ("deep", "deep", "bfloat16", True, {"use_deep": True, "use_resample": True}),
        ("deep_i8", "deep_i8", "bfloat16", True,
         {"use_int8_deep": True, "use_deep": True, "use_resample": True,
          "use_i8pre_deep": True}),
        ("plain", None, "bfloat16", False, {}),
        ("plain_f32", None, "float32", False, {})]


def _kernel_wrappers():
    from unitspeech_tpu_torch.ops import (
        aa_snake,
        fused_attention,
        fused_resnet,
        fused_resnet_deep,
        probes,
        resample,
        row_stats,
    )

    return {"fused_resnet_block": fused_resnet.fused_resnet_block,
            "fused_final_block": fused_resnet.fused_final_block,
            "row_stats": row_stats.row_stats,
            "fused_rezero_attention": fused_attention.fused_rezero_attention,
            "row_absmax": row_stats.row_absmax,
            "fused_resnet_block_deep": fused_resnet_deep.fused_resnet_block_deep,
            "fused_resnet_block_deep_i8": fused_resnet_deep.fused_resnet_block_deep_i8,
            "fused_downsample_conv": resample.fused_downsample_conv,
            "fused_upsample_conv": resample.fused_upsample_conv,
            "fused_aa_snake_conv": aa_snake.fused_aa_snake_conv,
            "fused_aa_snake": aa_snake.fused_aa_snake,
            "fused_resnet_block_int8": fused_resnet.fused_resnet_block_int8,
            "fused_resnet_block_deep_int8": fused_resnet_deep.fused_resnet_block_deep_int8,
            "transcendental_chain": probes.transcendental_chain,
            "row_select": probes.row_select, "selection_matmul": probes.selection_matmul,
            "interleave_rows": probes.interleave_rows,
            "resnet_conv3x3": fused_resnet.resnet_conv3x3, "resnet_out": fused_resnet.resnet_out}


def _counted(what, fn, want):
    """Run fn with every launch counter set to 0 just before it; fail
    unless the counts just after equal `want`. Returns fn's result."""
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    got = {name: w.launches for name, w in wrappers.items()}
    print(f"  kernel launches in the {what} run: {got}", flush=True)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    return out


def check_launch_counts(breakdown):
    """The device launches of one call, from the profiler: K3's served call
    (group_mean_inv) is its one kernel at every site, with no PyTorch launch
    beside it; K2 is two kernels, kernel A and the tail (beside the three
    launches of its wrapper's mask-length sum)."""
    for rec in breakdown["K3"]:
        got = [(r["name"], r["launches"]) for r in rec["launches"]]
        if "group_mean_inv" in rec["site"] and (len(got) != 1 or got[0][1] != 1
                                                or not got[0][0].startswith("row_stats_kernel")):
            raise AssertionError(f"K3 {rec['site']}: launches {got}, expected one K3 kernel")
    (rec,) = breakdown["K2"]
    kernels = [(r["name"], r["launches"]) for r in rec["launches"]
               if not r["name"].startswith("torch ")]
    if [n.split("<")[0] for n, _ in kernels] != ["conv_tc", "final_tail"] or any(
            k != 1 for _, k in kernels):
        raise AssertionError(f"K2: kernel launches {kernels}, expected conv_tc and final_tail")


def per_call_counts(records):
    """{path: {kernel: launches per estimator (vocoder) call at 344}}."""
    return {path: {name: sum(r["counts"][path] for r in records if r["name"] == name)
                   for name in KERNELS} for path in PATHS}


def serve_requests(torch, ckpt, tmp, what, runs, flags, routes, hop):
    """`cli inference` on the card for each (text, extra args, expected
    frames) of `runs` with `flags` (50 DDPM steps, dual CFG 1.0/1.0, bf16
    decoder and vocoder, f32 encoder); every request's waveform must have
    its frames' samples and its stats line must report `routes`. Returns
    each kernel's launches over the requests, the counters set to 0 just
    before the first."""
    from unitspeech_tpu_torch import cli

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    print(f"{what} requests through cli inference (50 steps, dual CFG 1.0/1.0, bf16"
          f"{', ' + ' '.join(flags) if flags else ', serving defaults'}):", flush=True)
    for i, (text, extra, frames) in enumerate(runs):
        out = os.path.join(tmp, f"{what}{i}.wav")
        stats = cli.main_inference(
            ["--ipa", "--text", text, "--checkpoint", ckpt, "--output", out,
             "--device", "cuda", "--seed", str(i), "--diffusion-steps", str(STEPS),
             "--text-gradient-scale", "1.0", "--spk-gradient-scale", "1.0", *flags, *extra])
        with wave.open(out, "rb") as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        print(f"  request {i}: {stats['frames']} frames, {stats['seconds']:.3f} s audio, "
              f"wall {stats['wall_s']:.3f} s, RTF {stats['rtf']:.4f}", flush=True)
        if n != frames * hop or pcm.size == 0 or not np.any(pcm):
            raise AssertionError(f"{what} request {i}: {n} samples, expected {frames * hop}")
        got = {k: stats[k] for k in routes}
        if got != routes:
            raise AssertionError(f"{what} request {i}: routes {got}, expected {routes}")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"kernel launches during the {what} requests: {launches}", flush=True)
    return launches


def serve(torch, tmp, per_call):
    """The main paths: a full-width random checkpoint, then the serving
    defaults on four requests (every kernel of the default path must
    launch) and the fused deep configuration on the 498-frame request
    (bucket 552, where up_1_res1 falls back to the flat int8 route) and the
    forced 344-frame request, whose launches must be exactly those of one
    estimator call per step at each bucket plus one vocoder call each.
    Returns the checkpoint's path and each path's launches."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.ops.masking import (
        choose_bucket,
        default_frame_buckets,
        fix_len_compatibility,
    )
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    ckpt = os.path.join(tmp, "ckpt.pt")
    t0 = time.perf_counter()
    cli.main_make_random_checkpoint(["--seed", "0", "--output", ckpt])
    print(f"random full-width checkpoint in {time.perf_counter() - t0:.1f} s", flush=True)
    # expected lengths from the port's own encoder + duration predictor
    enc = Synthesizer(TTSModels.from_checkpoint(
        torch.load(ckpt, map_location="cpu", weights_only=True), device="cuda",
        with_vocoder=False))
    frames = [max(int(enc.encode(phonemes_to_sequence(t))[2].sum().item()), 1)
              for t in REQUESTS] + [FRAMES]
    hop, num_down = enc.models.cfg.data.hop_length, enc.models.cfg.decoder.num_downsamplings
    del enc
    runs = [(t, [], n) for t, n in zip(REQUESTS, frames)]
    runs.append((FORCED_TEXT, ["--frames", str(FRAMES)], FRAMES))

    off = {"deep": False, "i8pre": False, "resample": False}
    default = serve_requests(torch, ckpt, tmp, "default", runs, [],
                             {"kernels": True, "int8": True, **off}, hop)
    missing = [k for k in KERNELS if HOME[k] == "int8" and default[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the default path: {missing}")

    long_run = runs[2]
    bucket = choose_bucket(fix_len_compatibility(long_run[2], num_down),
                           default_frame_buckets(4096))
    if bucket != 552:
        raise AssertionError(f"the long request ({long_run[2]} frames) is at bucket {bucket}")
    deep = serve_requests(torch, ckpt, tmp, "deep", [long_run, runs[-1]], DEEP_FLAGS,
                          {"kernels": True, "int8": True, "deep": True, "i8pre": True,
                           "resample": True}, hop)
    want = {k: STEPS * (DEEP_I8_552.get(k, 0) + per_call["deep_i8"][k])
            if k in ESTIMATOR_KERNELS else 2 * per_call["deep_i8"][k] for k in KERNELS}
    if deep != want:
        raise AssertionError(f"deep requests: kernel launches {deep}, expected {want}")
    return ckpt, {"default": default, "deep_i8": deep}


def compare_paths(torch, dev, ckpt_path, per_call, runs=RUNS, vocoder=True, what=""):
    """The forced 344-frame request on the card with the same injected
    noise, six ways: the bf16 kernel path and the fused deep bf16 path
    (K8, K11) against the plain bf16 path (their mels must agree within
    MEL_L1_BOUND / MEL_MAX_BOUND of the plain mel's dynamic range); the int8
    kernel path (the serving default) and the fused deep int8 path (K9)
    against the plain f32 path, each held to INT8_GATE_RATIO x the distance
    of its bf16 counterpart to it; then the vocoder on the plain f32 mel,
    kernels (bf16) vs plain bf16 vs plain f32, the kernels held to
    VOC_RATIO x the plain bf16 vocoder's waveform L1. Each run's kernel
    launches must be exactly what its path makes at this bucket (the
    per-call counts of the site checks), and none on a plain path. `runs`
    keeps some of RUNS (each comparison runs where both its sides are
    there), `vocoder` False skips the vocoder's, `what` names the weights
    in the printout; ckpt_path may be a checkpoint dict. Returns the
    measured distances."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.utils.artifacts import read
    from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict

    ckpt = read(ckpt_path)
    ids = phonemes_to_sequence(FORCED_TEXT)
    g = torch.Generator(device=dev).manual_seed(1234)
    n_feats = ckpt["mel_min"].numel()
    noise_z = torch.randn((1, FRAMES, n_feats), generator=g, device=dev)
    noises = torch.randn((50, 1, FRAMES, n_feats), generator=g, device=dev)
    mels = {}
    for name, path, dtype, kernels, routes in runs:
        synth = Synthesizer(TTSModels.from_checkpoint(
            ckpt, device=dev, dtype=getattr(torch, dtype), use_kernels=kernels,
            with_vocoder=False, **routes))
        want = {k: STEPS * per_call[path][k] if kernels and k in ESTIMATOR_KERNELS else 0
                for k in KERNELS}
        mel, y_len, _ = _counted(what + name, lambda: synth.synthesize_mel(
            ids, diffusion_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
            durations=forced_durations(len(ids), FRAMES), noise_z=noise_z, noises=noises),
            want)
        mels[name] = mel[:, :y_len].float()
        del synth
    if not all(bool(torch.isfinite(m).all()) for m in mels.values()):
        raise AssertionError("non-finite mel")
    ref = mels["plain"]
    span = (ref.max() - ref.min()).item()

    def dist(a, b):
        d = (mels[a] - mels[b]).abs()
        return d.mean().item() / span, d.max().item() / span

    out = {}
    for a in [a for a in ("kernels", "deep") if a in mels]:
        l1, mx = dist(a, "plain")
        print(f"{what}{a} path vs plain path (bf16), forced {FRAMES} frames: mel L1 {l1:.3e}, "
              f"max |diff| {mx:.3e} of the mel's dynamic range {span:.1f} "
              f"(bounds {MEL_L1_BOUND:.0e}, {MEL_MAX_BOUND:.0e})", flush=True)
        if not (l1 <= MEL_L1_BOUND and mx <= MEL_MAX_BOUND):
            raise AssertionError(f"{a} path mel differs from the plain path: L1 {l1}, max {mx}")
        out[f"{a}_mel_l1"], out[f"{a}_mel_max"] = l1, mx
    for a in [a for a in ("kernels", "int8", "deep", "deep_i8", "plain") if a in mels]:
        out[f"{a}_vs_f32_l1"] = dist(a, "plain_f32")[0]
        print(f"  {a} vs plain f32: mel L1 %.3e, max |diff| %.3e" % dist(a, "plain_f32"),
              flush=True)
    for i8, bf in [p for p in (("int8", "kernels"), ("deep_i8", "deep")) if p[0] in mels]:
        ratio = out[f"{i8}_vs_f32_l1"] / out[f"{bf}_vs_f32_l1"]
        print(f"{what}int8 gate: {i8} path / {bf} path mel L1 vs plain f32 = {ratio:.4f} "
              f"(bound {INT8_GATE_RATIO})", flush=True)
        if not ratio <= INT8_GATE_RATIO:
            raise AssertionError(f"int8 gate failed ({i8}): ratio {ratio} > {INT8_GATE_RATIO}")
        out[f"{i8}_gate_ratio"] = ratio
    if not vocoder:
        return out

    cfg = config_from_dict(ckpt["config"])
    mel = mels["plain_f32"]
    wavs, times = {}, {}
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("plain", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        voc = build_modules(cfg, device=dev, dtype=dtype, use_kernels=kernels)["vocoder"]
        voc.load_state_dict(ckpt["vocoder"])
        voc.eval().requires_grad_(False)
        want = {k: per_call["int8"][k] if kernels and k in VOCODER_KERNELS else 0
                for k in KERNELS}
        with torch.no_grad():
            wavs[name] = _counted(f"{name} vocoder", lambda: voc(mel), want)
            times[name] = _time_ms(torch, lambda: voc(mel), reps=5, warmup=1)
        del voc
    if not all(bool(torch.isfinite(w).all()) for w in wavs.values()):
        raise AssertionError("non-finite waveform")
    wl1 = {k: (wavs[k] - wavs["plain_f32"]).abs().mean().item() for k in ("kernels", "plain")}
    print(f"vocoder on the f32 mel ({FRAMES} frames): waveform L1 vs plain f32: kernels "
          f"{wl1['kernels']:.3e}, plain bf16 {wl1['plain']:.3e} (bound {VOC_RATIO} x); "
          f"ms per call: kernels {times['kernels']:.3f}, plain bf16 {times['plain']:.3f}, "
          f"plain f32 {times['plain_f32']:.3f}", flush=True)
    if not wl1["kernels"] <= VOC_RATIO * wl1["plain"]:
        raise AssertionError(f"kernel vocoder waveform L1 {wl1['kernels']} > {VOC_RATIO} x "
                             f"{wl1['plain']}")
    return {**out, "voc_wave_l1": wl1, "voc_ms": times}


# The adapt path (cli finetune, then the adapted decoder served): ADAPT_ITERS
# fine-tune steps at full width in bf16 on a synthetic 6 s reference, at the
# reference's learning rate (2e-5; at 1e-3 the random-weight decoder
# diverged to NaN within 10 steps, rezero gates of 0.001 moving by 0.001 a
# step), about 140 ms a step on the card
ADAPT_ITERS, ADAPT_SECONDS = 200, 6.0
# the served comparisons of the adapted decoder: the bf16 kernel path and
# the int8 default against the plain paths, as compare_paths holds them
ADAPT_RUNS = [r for r in RUNS if r[0] in ("kernels", "int8", "plain", "plain_f32")]


def adapt(torch, dev, tmp, ckpt_path, per_call, smi):
    """The adapt path: `cli finetune --device cuda` at full width (bf16,
    segment 176) from the random checkpoint's decoder and unit encoder on a
    synthetic 22.05 kHz reference with sidecar units and speaker embedding,
    which must launch no kernel (the fine-tune trains the plain estimator)
    and give finite losses; then the adapted decoder served through `cli
    inference --checkpoint <random> --decoder <adapted>` on one forced
    344-frame request with the serving defaults (exactly the launches of one
    estimator call per step and one vocoder call at this bucket) and one
    with --no-fast-kernels (none); its mels on the kernel paths against the
    plain paths with compare_paths' bounds; and the served estimator's
    packed buffers equal to a fresh pack of the adapted weights bit for bit,
    each different from the base weights' pack. Returns the fine-tune's
    statistics, the distances and the served launches."""
    import argparse

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.tools import synthetic_reference
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.params import config_from_dict

    ckpt = artifacts.read(ckpt_path)
    cfg = config_from_dict(ckpt["config"])
    flags = synthetic_reference(tmp, cfg, ADAPT_SECONDS, seed=10)
    print(f"adapt: cli finetune --device cuda, {ADAPT_ITERS} iterations, lr "
          f"{cfg.finetune.learning_rate}, bf16, segment {cfg.out_size} frames, {ADAPT_SECONDS} s "
          "synthetic reference", flush=True)
    stats = _counted("adapt fine-tune", lambda: cli.main_finetune(
        flags + ["--decoder", ckpt_path, "--unit-encoder", ckpt_path, "--output-dir",
                 os.path.join(tmp, "adapted"), "--n-iters", str(ADAPT_ITERS), "--seed", "0",
                 "--device", "cuda"]),
        {k: 0 for k in KERNELS})
    losses = np.asarray(stats["losses"])
    print("  losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(f"  {stats['ms_per_step']:.3f} ms per step ({stats['seconds']:.2f} s for "
          f"{ADAPT_ITERS}), loss {stats['loss_first10']:.4f} -> {stats['loss_last10']:.4f}; "
          f"{smi}", flush=True)
    if losses.shape != (ADAPT_ITERS,) or not np.isfinite(losses).all():
        raise AssertionError(f"fine-tune losses not all finite: {losses}")

    served_launches = {}
    for name, extra, want in (
            ("kernels", [], {k: STEPS * per_call["int8"][k] if k in ESTIMATOR_KERNELS
                             else per_call["int8"][k] if k in VOCODER_KERNELS else 0
                             for k in KERNELS}),
            ("plain", ["--no-fast-kernels"], {k: 0 for k in KERNELS})):
        out = os.path.join(tmp, f"adapted_{name}.wav")
        res = _counted(f"adapted decoder, {name}", lambda: cli.main_inference(
            ["--ipa", "--text", FORCED_TEXT, "--checkpoint", ckpt_path, "--decoder",
             stats["output"], "--output", out, "--device", "cuda", "--seed", "0",
             "--diffusion-steps", str(STEPS), "--text-gradient-scale", "1.0",
             "--spk-gradient-scale", "1.0", "--frames", str(FRAMES), *extra]), want)
        with wave.open(out, "rb") as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        if n != FRAMES * cfg.data.hop_length or not np.any(pcm):
            raise AssertionError(f"adapted {name} request: {n} samples")
        print(f"  adapted decoder served ({name}): wall {res['wall_s']:.3f} s, "
              f"RTF {res['rtf']:.4f}", flush=True)
        served_launches[name] = want

    bundle = artifacts.load_decoder_bundle(stats["output"], cfg.decoder)
    paths = compare_paths(torch, dev, dict(ckpt, decoder=bundle.state_dict,
                                           spk_emb=bundle.spk_emb),
                          per_call, runs=ADAPT_RUNS, vocoder=False, what="adapted ")

    # the decoder as `cli inference --checkpoint ... --decoder ...` loads it
    args = argparse.Namespace(checkpoint=ckpt_path, decoder=stats["output"], text_encoder=None,
                              duration_predictor=None, vocoder=None, spk_emb=None, config=None)
    routes = dict(use_kernels=True, use_int8_deep=True, use_deep=False, use_resample=False,
                  use_i8pre_deep=False)
    served = cli._load_tts_models(args, dev, torch.bfloat16, routes)
    with dev:
        fresh = UnitSpeech.from_config(cfg.decoder, dtype=torch.bfloat16, use_kernels=True,
                                       use_int8_deep=True)
    fresh.load_state_dict(ckpt["decoder"])
    base = {k: v.clone() for k, v in fresh.estimator.packed_tensors().items()}
    fresh.load_state_dict(bundle.state_dict)
    got, ref = served.decoder.estimator.packed_tensors(), fresh.estimator.packed_tensors()
    stale = sorted(k for k in ref if torch.equal(ref[k], base[k]))
    wrong = sorted(k for k in ref if k not in got or not torch.equal(got[k], ref[k]))
    print(f"  packed buffers of the served estimator: {len(got)}, equal to a fresh pack of "
          f"the adapted weights: {len(ref) - len(wrong)}, equal to the base weights' pack: "
          f"{len(stale)}", flush=True)
    if len(got) != len(ref) or wrong or stale or len(ref) < 100:
        raise AssertionError(f"packs: {len(got)} served, {len(ref)} fresh, differing {wrong}, "
                             f"equal to the base weights' {stale}")
    del served, fresh
    torch.cuda.empty_cache()
    return {"finetune": {k: v for k, v in stats.items() if k != "losses"},
            "losses": losses.tolist(), "paths": paths, "packs": len(got)}, served_launches


# The frontends phase (after adapt): full-width random SSL checkpoints in
# the reference's formats (WavLM-Large + ECAPA, mHuBERT-base, 1000 x 768
# centroids), converted by `cli convert`; `cli finetune` from the synthetic
# reference wav alone for FRONTEND_ITERS steps; the card's frontends held
# to the same modules on the CPU in f32 on the same 16 kHz wav; then a
# grapheme request served with the wav-adapted decoder.
FRONTEND_ITERS, FRONTEND_SECONDS = 20, 6.0  # 6 s at 16 kHz: the 96 000-sample bucket
# card vs CPU, both f32 with TF32 off (utils/precision.strict_f32): the
# unit-normalized speaker embeddings' cosine and largest difference, and
# the relative L2 of HuBERT's layer-6 features (f32 sums in another order
# through 24 / 6 layers)
EMB_COS, EMB_MAX, HUBERT_REL_L2 = 0.99999, 1e-3, 1e-4
# k-means units: equal at every frame whose CPU nearest-vs-second distance
# margin exceeds UNIT_MARGIN of the nearest distance (a closer call may
# flip on f32 order), and at most UNIT_DIFF_FRAC of all frames different
UNIT_MARGIN, UNIT_DIFF_FRAC = 1e-4, 0.01
# cycles the card spins before each queued frontend call (about 100 ms at
# 2 GHz): longer than the host takes to enqueue WavLM-Large's ~1 300 launches
QUEUE_LEAD_CYCLES = 200_000_000
GRAPHEME_TEXT = ("The 2 quick brown foxes jumped over 13 lazy dogs. "
                 "Then all 15 of them ran 40 miles home!")


def _frontend_outputs(torch, cli, spk_path, hub_path, km_path, cfg, wav16, dev):
    """The three frontends on `dev` on a 16 kHz wav, under the CLI's f32
    policy: the unit-normalized speaker embedding (96 000-sample bucket),
    HuBERT's layer-6 features, the k-means distances and units; on the
    card, each one's time (_frontend_times)."""
    from unitspeech_tpu_torch.models.ssl.kmeans import kmeans_distances
    from unitspeech_tpu_torch.utils.precision import strict_f32

    sr = cfg.spk_embedder.sr
    embedder = cli.load_speaker_embedder(spk_path, cfg, dev)
    emb = cli.embed_speaker(embedder, wav16, sr, cfg)[0]
    enc = cli.build_unit_extractor(hub_path, km_path, cfg, dev)
    cent = torch.from_numpy(enc.quantizer.centroids).to(dev)
    with strict_f32(), torch.no_grad():
        feats = enc.dense_model.features(wav16)
        dist = kmeans_distances(feats, cent)
        out = {"emb": emb / np.linalg.norm(emb), "feats": feats.cpu().numpy(),
               "dist": dist.cpu().numpy(), "units": enc.quantizer(feats),
               "dedup": enc(wav16)}
        if dev.type == "cuda":
            x = torch.from_numpy(np.asarray(wav16, np.float32))[None].to(dev)
            out["ms"] = _frontend_times(torch, dev, {
                "speaker_embedder": lambda: embedder(x),
                "hubert": lambda: enc.dense_model.features(wav16),
                "kmeans": lambda: kmeans_distances(feats, cent).argmin(1)})
    del embedder, enc
    return out


def _frontend_times(torch, dev, calls):
    """{name: {busy_ms, sum_ms, launches, queued_ms, event_ms}} for each call.
    From torch.profiler over 5 calls (kernel_breakdown.device_activity),
    per call: the time some device activity (kernel or copy) ran, their
    summed durations and their count. From CUDA events (tools.median_ms,
    5 calls): queued_ms behind QUEUE_LEAD_CYCLES of spinning, long enough
    for the host to enqueue the whole call, so the device runs it back to
    back; event_ms behind the usual 1 ms spin, which a call of hundreds of
    launches outruns: the host's pace."""
    from unitspeech_tpu_torch.tools import median_ms

    out = {}
    for name, fn in calls.items():
        out[name] = dict(kernel_breakdown.device_activity(fn, 5),
                         queued_ms=median_ms(fn, dev, 5, 1, QUEUE_LEAD_CYCLES),
                         event_ms=median_ms(fn, dev, 5, 1))
    return out


def frontends(torch, dev, tmp, ckpt_path, per_call, smi):
    """The SSL frontends and the grapheme frontend on the card: random
    full-width SSL checkpoints (tools/ssl_reference) through `cli convert`;
    `cli finetune --device cuda --speaker-embedder --hubert --kmeans` on the
    synthetic reference with no sidecar, its TF32 left on by the caller
    (the CLI turns it off and gives it back), finite losses and no kernel
    launched; the card's frontends against the CPU's (EMB_COS, EMB_MAX,
    HUBERT_REL_L2, UNIT_MARGIN, UNIT_DIFF_FRAC, equal duration sums); then
    `cli inference --text ... --language en-us --split-sentences` with the
    wav-adapted decoder on the serving defaults, each chunk forced to the
    344-frame bucket: exactly one estimator call per step and one vocoder
    call per chunk. Returns the measurements."""
    import shutil

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.text import get_phonemizer, split_sentences
    from unitspeech_tpu_torch.tools import synthetic_reference
    from unitspeech_tpu_torch.tools.ssl_reference import random_ssl_reference
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.audio import load_wav
    from unitspeech_tpu_torch.utils.params import config_from_dict

    cfg = config_from_dict(artifacts.read(ckpt_path)["config"])
    d = os.path.join(tmp, "frontends")
    os.makedirs(d)
    t0 = time.perf_counter()
    ref = random_ssl_reference(d, cfg, seed=20)
    conv = {k: os.path.join(d, f"port_{k}.pt") for k in ("speaker-embedder", "hubert")}
    conv["kmeans"] = os.path.join(d, "port_kmeans.npz")
    cfg_json = os.path.join(d, "config.json")
    with open(cfg_json, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    for kind, dest in conv.items():
        if cli.main(["convert", kind, ref[kind], dest, "--config", cfg_json]) != 0:
            raise AssertionError(f"cli convert {kind} failed")
    print(f"frontends: random full-width SSL checkpoints written and converted in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wav_path = synthetic_reference(d, cfg, FRONTEND_SECONDS, seed=11)[1]

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        stats = _counted("frontends fine-tune", lambda: cli.main_finetune(
            ["--reference", wav_path, "--decoder", ckpt_path, "--unit-encoder", ckpt_path,
             "--speaker-embedder", conv["speaker-embedder"], "--hubert", conv["hubert"],
             "--kmeans", conv["kmeans"], "--output-dir", os.path.join(d, "adapted"),
             "--n-iters", str(FRONTEND_ITERS), "--seed", "0", "--device", "cuda"]),
            {k: 0 for k in KERNELS})
        if not (torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32):
            raise AssertionError("cli finetune did not give the caller's TF32 settings back")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    losses = np.asarray(stats["losses"])
    print(f"  cli finetune from the wav alone: {stats['units']} units, losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; embedder {stats['speaker_embedder_s']:.2f}"
          f" s, unit extractor {stats['unit_extractor_s']:.2f} s (loading included); {smi}",
          flush=True)
    if losses.shape != (FRONTEND_ITERS,) or not np.isfinite(losses).all():
        raise AssertionError(f"frontends fine-tune losses not all finite: {losses}")

    wav, sr = load_wav(wav_path)
    wav16 = cli.resample_to(wav, sr, cfg.spk_embedder.sr)
    card = _frontend_outputs(torch, cli, conv["speaker-embedder"], conv["hubert"],
                             conv["kmeans"], cfg, wav16, dev)
    cpu = _frontend_outputs(torch, cli, conv["speaker-embedder"], conv["hubert"],
                            conv["kmeans"], cfg, wav16, torch.device("cpu"))
    cos = float(card["emb"] @ cpu["emb"])
    emb_max = float(np.abs(card["emb"] - cpu["emb"]).max())
    rel_l2 = float(np.linalg.norm(card["feats"] - cpu["feats"]) / np.linalg.norm(cpu["feats"]))
    full = np.sort(cpu["dist"] + (cpu["feats"] ** 2).sum(1, keepdims=True), axis=1)
    sure = full[:, 1] - full[:, 0] > UNIT_MARGIN * full[:, 0]
    differ = card["units"] != cpu["units"]
    sums = [int(o["dedup"]["durations"].sum()) for o in (card, cpu)]
    res = {"embedding_cos": cos, "embedding_max_abs": emb_max, "hubert_rel_l2": rel_l2,
           "frames": int(len(differ)), "units_differ": int(differ.sum()),
           "units_differ_where_sure": int((differ & sure).sum()), "sure_frames": int(sure.sum()),
           "duration_sums": sums, "ms": card["ms"], "card": smi,
           "finetune": {k: v for k, v in stats.items() if k != "losses"},
           "losses": losses.tolist()}
    print(f"  card vs CPU (f32): embedding cosine {cos:.8f} (>= {EMB_COS}), max |diff| "
          f"{emb_max:.3e} (<= {EMB_MAX}); HuBERT layer-{cfg.unit_extractor.hubert_layer} "
          f"relative L2 {rel_l2:.3e} (<= {HUBERT_REL_L2}); units differ at "
          f"{res['units_differ']} of {len(differ)} frames, {res['units_differ_where_sure']} "
          f"where the margin exceeds {UNIT_MARGIN} ({res['sure_frames']} frames); duration "
          f"sums {sums}", flush=True)
    print(f"  frontends on the card ({len(wav16)} samples at 16 kHz), ms of one call: profiler "
          f"busy / sum / launches; events queued behind a long spin / behind 1 ms (host "
          f"pace): " + ", ".join(
              f"{k} {v['busy_ms']:.3f} / {v['sum_ms']:.3f} / {v['launches']:.0f}; "
              f"{v['queued_ms']:.3f} / {v['event_ms']:.3f}" for k, v in card["ms"].items())
          + f"; {smi}", flush=True)
    if not (cos >= EMB_COS and emb_max <= EMB_MAX and rel_l2 <= HUBERT_REL_L2
            and res["units_differ_where_sure"] == 0
            and res["units_differ"] <= UNIT_DIFF_FRAC * len(differ) and sums[0] == sums[1]):
        raise AssertionError(f"frontends: card vs CPU {res}")

    espeak = shutil.which("espeak-ng") or shutil.which("espeak")
    ph = get_phonemizer("en-us", fallback=True)
    chunks = len(split_sentences(GRAPHEME_TEXT))
    print(f"  grapheme request through {'espeak (' + espeak + ')' if espeak else 'the rule G2P'}"
          f" ({type(ph).__name__}), {chunks} sentence chunks, each at {FRAMES} frames",
          flush=True)
    want = {k: chunks * (STEPS * per_call["int8"][k] if k in ESTIMATOR_KERNELS
                         else per_call["int8"][k] if k in VOCODER_KERNELS else 0)
            for k in KERNELS}
    out = os.path.join(d, "grapheme.wav")
    served = _counted("grapheme request", lambda: cli.main_inference(
        ["--text", GRAPHEME_TEXT, "--language", "en-us", "--split-sentences", "--checkpoint",
         ckpt_path, "--decoder", stats["output"], "--output", out, "--device", "cuda",
         "--seed", "0", "--diffusion-steps", str(STEPS), "--text-gradient-scale", "1.0",
         "--spk-gradient-scale", "1.0", "--frames", str(FRAMES)]), want)
    with wave.open(out, "rb") as w:
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16)
    if served["chunks"] != chunks or n != chunks * FRAMES * cfg.data.hop_length or not np.any(
            pcm):
        raise AssertionError(f"grapheme request: {served}, {n} samples")
    print(f"  grapheme request served: {served['tokens']} tokens, wall {served['wall_s']:.3f} s,"
          f" RTF {served['rtf']:.4f}", flush=True)
    torch.cuda.empty_cache()
    return {**res, "grapheme": {**served, "g2p": "espeak" if espeak else type(ph).__name__}}, want


# The voice-conversion and sampler phase (after the frontends): full-width
# random reference-format VC checkpoints (a contentvec encoder, converted by
# `cli convert contentvec-encoder`, and an HF-named contentvec HuBERT-base,
# read by --contentvec); `cli voice-conversion` with the adapted decoder on
# the serving defaults for each of VC_SAMPLERS beside the plain bf16 path on
# the same seed; a forced 344-frame Synthesizer request with each of
# TTS_STRIDED; one seed of tools/sampler_gate.py. A 5 s source is 430 mel
# frames, the 432-frame bucket, none of the TTS requests' buckets.
VC_SECONDS = 5.0
VC_BUCKET = 432
VC_SAMPLERS = [("ddpm", 50), ("dpm2", 25), ("dpm2:cs2", 25)]
TTS_STRIDED = [("ddpm:cs2", 50), ("dpm2:cs2", 25)]


@contextlib.contextmanager
def _estimator_rows(torch):
    """Inside: every GradLogPEstimator2d call's batch rows appended to the
    list it yields (a global forward pre-hook, which costs the host a little
    on every module call: the walls it runs under are not the request's)."""
    from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d

    rows = []

    def hook(mod, args):
        if isinstance(mod, GradLogPEstimator2d):
            rows.append(int(args[0].shape[0]))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield rows
    finally:
        handle.remove()


def _spec_rows(sampler, steps):
    """{rows: calls} of one request of `steps` steps with dual CFG: a 3-row
    guidance call on each group's first step and the trailing steps % k,
    1-row calls between (models/diffusion._guided_score)."""
    from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec

    k = min(parse_sampler_spec(sampler)[1], steps)
    full = steps // k + steps % k
    return {3: full, 1: steps - full} if steps > full else {3: full}


def _served_want(per_call, calls):
    """Launches of a served request on the serving default: `calls`
    estimator calls (any rows) and one vocoder call."""
    return {k: calls * per_call["int8"][k] if k in ESTIMATOR_KERNELS
            else per_call["int8"][k] if k in VOCODER_KERNELS else 0 for k in KERNELS}


def _mel_bounds(what, got, ref):
    """got vs ref (frames, F) in units of ref's dynamic range, held to the
    TTS paths' bounds (MEL_L1_BOUND, MEL_MAX_BOUND)."""
    span = float(ref.max() - ref.min())
    d = np.abs(got - ref)
    l1, mx = float(d.mean()) / span, float(d.max()) / span
    print(f"  {what}: kernels vs plain (bf16), mel L1 {l1:.3e}, max |diff| {mx:.3e} of the "
          f"mel's dynamic range {span:.1f} (bounds {MEL_L1_BOUND:.0e}, {MEL_MAX_BOUND:.0e})",
          flush=True)
    if not (np.isfinite(got).all() and np.isfinite(ref).all() and l1 <= MEL_L1_BOUND
            and mx <= MEL_MAX_BOUND):
        raise AssertionError(f"{what}: mel L1 {l1}, max {mx}")
    return {"mel_l1": l1, "mel_max": mx}


def voice_and_samplers(torch, dev, tmp, ckpt_path, adapted_path, per_call, smi):
    """Voice conversion and the sampler specs on the card: random full-width
    VC checkpoints in the reference's formats (tools/vc_reference), the
    encoder through `cli convert contentvec-encoder`; the contentvec
    features of a 5 s source on the card (the HF-named HuBERT-base); `cli
    voice-conversion` with the adapted decoder for each of VC_SAMPLERS (the
    first from --contentvec, the others from the features) on the serving
    defaults and with --no-fast-kernels on the same seed: exact launches
    (one estimator call a step, whatever its rows, and one vocoder call;
    none on the plain path), the estimator's calls by rows, the mels within
    the TTS bounds; each sampler's device time on the kernels; then a
    forced 344-frame Synthesizer request with each of TTS_STRIDED, held the
    same way; last, one seed of tools/sampler_gate.py, which must pass.
    Returns the measurements."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.infer import vc
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.tools import sampler_gate, vc_reference
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.audio import load_wav
    from unitspeech_tpu_torch.utils.params import config_from_dict

    ckpt = artifacts.read(ckpt_path)
    cfg = config_from_dict(ckpt["config"])
    d = os.path.join(tmp, "vc")
    os.makedirs(d)
    t0 = time.perf_counter()
    ref = vc_reference.random_vc_reference(d, cfg, seed=30)
    cfg_json = os.path.join(d, "config.json")
    with open(cfg_json, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    enc_path = os.path.join(d, "port_contentvec_encoder.pt")
    if cli.main(["convert", "contentvec-encoder", ref["contentvec-encoder"], enc_path,
                 "--config", cfg_json]) != 0:
        raise AssertionError("cli convert contentvec-encoder failed")
    src = vc_reference.random_source(os.path.join(d, "src.wav"), cfg, VC_SECONDS, seed=31)
    wav, sr = load_wav(src)
    mel_len = len(wav) // cfg.data.hop_length
    bucket = vc.vc_frames(mel_len, cfg.decoder.num_downsamplings)
    if bucket != VC_BUCKET:
        raise AssertionError(f"the {VC_SECONDS} s source ({mel_len} frames) is at bucket {bucket}")
    t1 = time.perf_counter()
    feats = cli.extract_contentvec(ref["contentvec"], wav, sr, cfg, dev)
    t_cv = time.perf_counter() - t1
    feats_path = os.path.join(d, "feats.npy")
    np.save(feats_path, feats)
    print(f"voice conversion: random full-width VC checkpoints written and converted, contentvec "
          f"features {feats.shape} of a {VC_SECONDS} s source ({mel_len} frames, bucket "
          f"{bucket}) in {time.perf_counter() - t0:.1f} s (the extraction {t_cv:.2f} s, loading "
          "included)", flush=True)
    if feats.shape[1] != 768 or not np.isfinite(feats).all():
        raise AssertionError(f"contentvec features {feats.shape}")

    res = {"frames": mel_len, "bucket": bucket, "contentvec_frames": int(len(feats)),
           "card": smi, "vc": {}, "tts": {}}
    for i, (sampler, steps) in enumerate(VC_SAMPLERS):
        content = (["--contentvec", ref["contentvec"]] if i == 0
                   else ["--content-features", feats_path])
        base = ["--source", src, "--decoder", adapted_path, "--content-encoder", enc_path,
                "--vocoder", ckpt_path, "--sampler", sampler, "--diffusion-steps", str(steps),
                "--seed", "0", "--device", "cuda", *content]
        runs = {}
        for name, extra, want in (("kernels", [], _served_want(per_call, steps)),
                                  ("plain", ["--no-fast-kernels"], {k: 0 for k in KERNELS})):
            with _estimator_rows(torch) as rows:
                runs[name] = _counted(f"voice conversion {sampler} {name}",
                                      lambda: cli.main_voice_conversion(
                                          base + extra + ["--output", os.path.join(
                                              d, f"{sampler}_{name}.wav")]), want)
            got_rows = {r: rows.count(r) for r in sorted(set(rows), reverse=True)}
            if got_rows != _spec_rows(sampler, steps):
                raise AssertionError(f"{sampler} {name}: estimator calls by rows {got_rows}")
        st = runs["kernels"]
        if st["frames"] != mel_len or st["bucket"] != bucket or st["content_frames"] != len(feats):
            raise AssertionError(f"voice conversion {sampler}: {st}")
        print(f"  {sampler}@{steps}: estimator calls by rows {_spec_rows(sampler, steps)}; wall "
              f"{st['wall_s']:.3f} s (plain {runs['plain']['wall_s']:.3f}; the rows hook on)"
              + (f", contentvec {st['contentvec_s']:.2f} s" if "contentvec_s" in st else ""),
              flush=True)
        res["vc"][sampler] = {"steps": steps, "rows": _spec_rows(sampler, steps),
                              **_mel_bounds(f"voice conversion {sampler}", st["mel"],
                                            runs["plain"]["mel"])}

    # each sampler's time on the kernels, the conversion and the vocoder with
    # the modules loaded as the CLI loads them: device busy time
    # (torch.profiler), CUDA events at the host's pace, and the host's wall
    bundle = artifacts.load_decoder_bundle(adapted_path, cfg.decoder)
    routes = dict(use_kernels=True, use_int8_deep=True, use_deep=False, use_resample=False,
                  use_i8pre_deep=False)
    enc, dec, voc = cli.load_vc_modules(cfg, bundle.state_dict, enc_path, ckpt_path, dev,
                                        torch.bfloat16, routes)
    content = torch.from_numpy(feats)[None].to(dev)
    spk = bundle.spk_emb.to(dev) / bundle.spk_emb.norm()
    for sampler, steps in VC_SAMPLERS:
        def convert(sampler=sampler, steps=steps):
            with torch.no_grad():
                mel = vc.voice_conversion(
                    enc, dec, content, mel_len, spk, bundle.mel_min.to(dev),
                    bundle.mel_max.to(dev), n_timesteps=steps, sampler=sampler,
                    generator=torch.Generator(device=dev).manual_seed(0))
                return voc(mel)

        act = kernel_breakdown.device_activity(convert, 1)
        ev = _time_ms(torch, convert, reps=3, warmup=1)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        convert()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t1
        res["vc"][sampler].update(device_ms=act["busy_ms"], device_sum_ms=act["sum_ms"],
                                  device_launches=act["launches"], event_ms=ev, wall_s=wall,
                                  rtf=wall / VC_SECONDS)
        print(f"  {sampler}@{steps} on the kernels: device busy {act['busy_ms']:.3f} ms, "
              f"{act['launches']:.0f} launches (profiler); {ev:.3f} ms under CUDA events, "
              f"wall {wall:.3f} s, RTF {wall / VC_SECONDS:.4f} (the host's pace); {smi}",
              flush=True)
    del enc, dec, voc

    ids = phonemes_to_sequence(FORCED_TEXT)
    synths = {name: Synthesizer(TTSModels.from_checkpoint(
        ckpt, device=dev, use_kernels=kernels, use_int8_deep=kernels))
        for name, kernels in (("kernels", True), ("plain", False))}
    for sampler, steps in TTS_STRIDED:
        mels = {}
        for name, synth in synths.items():
            want = _served_want(per_call, steps) if name == "kernels" else {k: 0 for k in KERNELS}
            with _estimator_rows(torch) as rows:
                wav_out, _, mel = _counted(
                    f"forced {FRAMES}-frame request {sampler} {name}", lambda synth=synth: synth(
                        ids, torch.Generator(device=dev).manual_seed(0),
                        forced_total_frames=FRAMES, diffusion_steps=steps,
                        text_gradient_scale=1.0, spk_gradient_scale=1.0, sampler=sampler), want)
            got_rows = {r: rows.count(r) for r in sorted(set(rows), reverse=True)}
            if got_rows != _spec_rows(sampler, steps) or len(wav_out) != FRAMES * \
                    cfg.data.hop_length:
                raise AssertionError(f"{sampler} {name}: rows {got_rows}, {len(wav_out)} samples")
            mels[name] = mel.float().cpu().numpy()
        res["tts"][sampler] = {"steps": steps, "rows": _spec_rows(sampler, steps),
                               **_mel_bounds(f"forced {FRAMES}-frame {sampler}@{steps}",
                                             mels["kernels"], mels["plain"])}
    del synths
    torch.cuda.empty_cache()

    print("one seed of python -m unitspeech_tpu_torch.tools.sampler_gate (full width, "
          f"{FRAMES} frames):", flush=True)
    gate = sampler_gate.main(["--seeds", "0", "--noise-keys", "0", "--device", "cuda"])
    res["sampler_gate"] = {k: gate[k] for k in ("max_frac", "gate", "pass")}
    res["sampler_gate"]["ms"] = gate["runs"][0]["ms"]
    if not gate["pass"]:
        raise AssertionError(f"sampler gate failed: {gate['max_frac']}")
    torch.cuda.empty_cache()
    return res


def run_tools():
    """This slice's paths: the port's four tools at full size, each run
    with every launch counter set to 0 just before it and read just after.
    Every kernel of a tool's path must launch in its run and no other
    kernel may (the compile bisection also runs K8, whose kernels it
    probes). Returns each run's launches and results."""
    from unitspeech_tpu_torch.tools import (
        bench_resnet_kernel,
        bench_transcendental,
        bisect_deep_compile,
        probe_stride,
    )

    runs = {"bench": (lambda: bench_resnet_kernel.main(["--int8", "--deep", "--reps", "5"]),
                      set()),
            "transcendental": (lambda: bench_transcendental.main(["--reps", "3"]), set()),
            "probe_stride": (lambda: probe_stride.main(["--reps", "20"]), set()),
            "bisect": (lambda: bisect_deep_compile.main(["--reps", "3"]),
                       {"fused_resnet_block_deep"})}
    wrappers = _kernel_wrappers()
    launches, results = {}, {}
    for path, (fn, also) in runs.items():
        own = {k for k, p in TOOL_KERNELS.items() if p == path}
        print(f"the {path} path (python -m unitspeech_tpu_torch.tools): kernels {sorted(own)}",
              flush=True)
        for w in wrappers.values():
            w.launches = 0
        results[path] = fn()
        got = {name: w.launches for name, w in wrappers.items()}
        print(f"  kernel launches in the {path} run: { {k: v for k, v in got.items() if v} }",
              flush=True)
        missing = sorted(k for k in own if got[k] == 0)
        stray = sorted(k for k, v in got.items() if v and k not in own | also)
        if missing or stray:
            raise AssertionError(f"{path}: kernels not launched {missing}, stray launches {stray}")
        launches[path] = got
    bench = results["bench"]["stages"]
    if [r["kernel"] for r in bench] != ["K10a", "K10a", "K10b", "K10b"] or not all(
            np.isfinite(r["relerr"]) and r["relerr"] < INT8_BENCH_REL for r in bench):
        raise AssertionError(f"bench_resnet_kernel --int8 --deep: {bench}")
    if not all(r["correct"] for r in results["probe_stride"].values()):
        raise AssertionError(f"probe_stride: {results['probe_stride']}")
    if len(results["bisect"]) != 14:
        raise AssertionError("bisect_deep_compile: not every case ran")
    return launches, results


def kernels_line(records, launches):
    """One entry per kernel: its launches on its home path's served
    requests, and per call on that path (HOME) at the 344-frame bucket the
    sums over its sites of time x launches per call: kernel, plain, least
    (bound_ms) and library (library_ms, null without one PyTorch call that
    computes the same function); the same sums for every path in by_path."""
    out = []
    for name in KERNELS:
        sites = [r for r in records if r["name"] == name]
        home = HOME[name]

        def per_call(key, path=home):
            return sum(r[key] * r["counts"][path] for r in sites)

        lib = per_call("lib_ms") if all(r["lib_ms"] is not None for r in sites) else None
        out.append({
            "name": name, "route": "cuda", "source": sites[0]["source"],
            "replaces": sites[0]["replaces"],
            "launches": launches[RUN_OF.get(home, home)][name],
            "max_abs_err": max(r["max_abs_err"] for r in sites),
            "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
            "bound_ms": per_call("bound_ms"),
            "bound_by": "bytes" if per_call("bytes_ms") >= per_call("ops_ms") else "operations",
            "library_ms": lib, "lib_ms": lib, "path": home,
            "per_call": sum(r["counts"][home] for r in sites),
            "launches_by_path": {k: v[name] for k, v in launches.items()},
            "by_path": {p: {"per_call": sum(r["counts"][p] for r in sites),
                            "ms": per_call("ms", p), "plain_ms": per_call("plain_ms", p),
                            "bound_ms": per_call("bound_ms", p)} for p in PATHS},
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("chip_smoke")
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # f32 comparisons on the card in full f32 (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from unitspeech_tpu_torch.ops import _cuda
    from unitspeech_tpu_torch.tools import device_line

    smi = device_line(dev)  # nvidia-smi's name and power limit
    print(smi, flush=True)

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    print(_cuda.build_log.strip(), flush=True)

    print("kernel vs plain (bf16, B=3, lengths 344/301/344 of the bucket):", flush=True)
    records = check_kernels(torch, dev)
    per_call = per_call_counts(records)
    print("per-launch device time inside K4, K9, K7, K5, K6, K3 and K2 at their sites "
          "(torch.profiler; python -m unitspeech_tpu_torch.tools.kernel_breakdown):",
          flush=True)
    breakdown = kernel_breakdown.breakdown(dev)
    check_launch_counts(breakdown)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = serve(torch, tmp, per_call)
        paths = compare_paths(torch, dev, ckpt, per_call)
        adapted, adapted_launches = adapt(torch, dev, tmp, ckpt, per_call, smi)
        front, launches["grapheme"] = frontends(torch, dev, tmp, ckpt, per_call, smi)
        voice = voice_and_samplers(torch, dev, tmp, ckpt, adapted["finetune"]["output"],
                                   per_call, smi)
    launches["adapted"] = adapted_launches["kernels"]
    tool_launches, tools = run_tools()
    launches.update(tool_launches)

    kernels = kernels_line(records, launches)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "paths": paths, "adapt": adapted,
                       "frontends": front, "voice": voice, "kernels": kernels,
                       "launches": launches, "tools": tools, "breakdown": breakdown}, f,
                      indent=1)
    print(json.dumps({"paths": paths}))
    print(json.dumps({"adapt": {k: v for k, v in adapted.items() if k != "losses"}}))
    print(json.dumps({"frontends": {k: v for k, v in front.items() if k != "losses"}}))
    print(json.dumps({"voice": voice}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
