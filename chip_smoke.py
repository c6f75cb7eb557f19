"""Quickest proof that the PyTorch port runs on the GPU: build the CUDA
kernels, hold each against its plain PyTorch version at the main-path
shapes (with its time, the least time the card could take for the same
work, and the time of one library call computing the same function where
there is one), then serve adaptive-TTS requests through the port's CLI at
full model width (random weights from a seed): with its serving defaults
(every kernel, int8 deep-stage convs), and with the fused deep-stage
configuration (`--deep --i8pre --resample`: K8, K9, K11). Then check what
comes out: each kernel path against the plain path, the int8 gates and the
kernel vocoder, each run with the exact kernel launches its path makes.

    python3 chip_smoke.py [--out FILE]

Needs one CUDA device; exits non-zero (and prints no result) without one.
The last line of standard output is the JSON result; --out also writes the
per-site records and the path comparisons to FILE as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes: 3 CFG rows at the 344-frame bucket; one padded row
FRAMES, PADDED = 344, 301
# The estimator's kernel paths: the CLI default (int8 deep convs), --no-int8,
# and the fused deep-stage configuration without and with int8
# (--deep --resample --no-int8, --deep --i8pre --resample)
PATHS = ("int8", "bf16", "deep", "deep_i8")


def counts(int8, bf16=None, deep=None, deep_i8=None):
    """Launches of a kernel site per estimator call at the 344-frame bucket
    on each path (the vocoder kernels: per vocoder call); a path not given
    launches it as often as the int8 path."""
    return {"int8": int8, **{k: int8 if v is None else v
                             for k, v in (("bf16", bf16), ("deep", deep), ("deep_i8", deep_i8))}}


# Every kernel site of one estimator call at the 344-frame bucket
K1_SITES = [  # (F, Cin, Cout), each once per call on every path
    (80, 2, 128), (80, 128, 128),
    (40, 128, 256), (40, 256, 256), (40, 512, 128), (40, 128, 128),
]
K3_SITES = [  # (rows, C, input dtype, launches): GroupNorm statistics of the
    # flat deep blocks, on their conv outputs (rounded to bf16 in int8 mode,
    # the serving default; f32 accumulators with --no-int8) and on the bf16
    # output of the one deep block that runs as plain Blocks (up_1_res2, on
    # every path; the fused deep paths have no flat block at this bucket)
    (1720, 512, "bfloat16", counts(4, 0, 0, 0)),
    (430, 1024, "bfloat16", counts(8, 0, 0, 0)),
    (430, 512, "bfloat16", counts(4, 0, 0, 0)), (1720, 256, "bfloat16", counts(4, 2, 2, 2)),
    (1720, 512, "float32", counts(0, 4, 0, 0)), (430, 1024, "float32", counts(0, 8, 0, 0)),
    (430, 512, "float32", counts(0, 4, 0, 0)), (1720, 256, "float32", counts(0, 2, 0, 0)),
]
K7_SITES = [  # (rows, C, launches): the int8 activation scale of every flat
    # deep-stage conv input (nine blocks, two convs each), and of K9's conv1
    # input where Cin <= Cout (down_2_res1, down_2_res2, up_2_res2)
    (1720, 256, counts(2, 0, 0, 1)), (1720, 512, counts(3, 0, 0, 1)),
    (1720, 1024, counts(1, 0, 0, 0)), (430, 512, counts(4, 0, 0, 1)),
    (430, 1024, counts(7, 0, 0, 0)), (430, 2048, counts(1, 0, 0, 0)),
]
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
# BigVGAN at the 344-frame bucket: (T, C) after each upsample stage; every
# AMP block (k = 3, 7, 11) runs K5 for act1 + conv1 at d = 1, 3, 5 and for
# act2 + conv2 (d = 1, + residual) three times: 72 launches per vocoder call
VOC_STAGES = [(2752, 256), (22016, 128), (44032, 64), (88064, 32)]
K5_SITES = [(t, c, k, d, res, 3 if res else 1) for t, c in VOC_STAGES for k in (3, 7, 11)
            for d, res in ((1, False), (3, False), (5, False), (1, True))]
# The fused deep path at the 552-frame bucket (the 498-frame request): as at
# 344, except that up_1_res1 (1024 -> 256 at F = 20, T = 138) fails K9's
# 4 MiB gate and runs the flat int8 route (K3 and K7 twice each)
DEEP_I8_552 = {"fused_resnet_block": 6, "fused_final_block": 1, "row_stats": 4,
               "fused_rezero_attention": 5, "row_absmax": 5, "fused_resnet_block_deep": 4,
               "fused_resnet_block_deep_i8": 4, "fused_downsample_conv": 2,
               "fused_upsample_conv": 1}
K6_SITE = (88064, 32)
AA_REL = 2.0 ** -7  # K5/K6 vs f32: one bf16 rounding of the output plus f32 order
K4_SITES = [(27520, 128), (6880, 256), (6880, 128), (1720, 512), (1720, 256)]
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
F32_REL = 1e-4  # K3: f32 sums in another order
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
# The kernel vocoder's waveform L1 against the plain f32 vocoder, on the same
# f32 mel, is held to VOC_RATIO x the plain bf16 vocoder's
VOC_RATIO = 1.5


def _lens_mask(torch, t, dev):
    lens = torch.tensor([t, -(-PADDED * t // FRAMES), t], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    return mask[:, :, None, None]


def _time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
        resample,
        row_stats,
    )

    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    records = []

    def compare(name, src, replaces, site, kern, plain, rel, per_call, work, lib=None,
                ref32=None):
        """per_call: launches per call on each path (counts()). work: the
        site's bytes and operations (bound_ms). lib: one PyTorch call that
        computes the same function, timed as a yardstick only. ref32: an
        f32 reference on the same (bf16-rounded) inputs; the error is taken
        against it, and the bf16 plain version's distance to the kernel is
        printed beside it."""
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
                   ms=_time_ms(torch, kern), plain_ms=_time_ms(torch, plain),
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

    src_res = "unitspeech_tpu_torch/csrc/resnet_block.cu"
    for f, cin, cout in K1_SITES:
        t = FRAMES * f // 80
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        args = rows_args(x, lens, p, t, f, cin, cout)
        compare("fused_resnet_block", src_res,
                "unitspeech_tpu/ops/pallas_resnet.py:1243",
                f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet.fused_resnet_block(x, mask, groups=8, **p),
                lambda: fused_resnet.resnet_block_plain(*args, f=f, groups=8), BF16_REL,
                counts(1), block_work(3, t * f, cin, cout))

    t, f, c = FRAMES, 80, 128
    x = rand(3, t, f, c).to(torch.bfloat16)
    mask = _lens_mask(torch, t, dev)
    lens = fused_resnet.lens_rows_from_mask(mask, f)
    w1, b1 = rand(3, 3, c, c, scale=(9 * c) ** -0.5), rand(c, scale=0.1)
    s1, be1 = 1 + rand(c, scale=0.1), rand(c, scale=0.1)
    wo, bo = rand(1, 1, c, 1, scale=c ** -0.5), rand(1, scale=0.1)
    n = t * f
    compare("fused_final_block", src_res, "unitspeech_tpu/ops/pallas_resnet.py:778",
            f"F={f} T={t} {c}->1",
            lambda: fused_resnet.fused_final_block(x, mask, w1, b1, s1, be1, wo, bo, groups=8),
            lambda: fused_resnet.final_block_plain(x.reshape(3, t * f, c), lens,
                                                   w1.reshape(9 * c, c), b1, s1, be1,
                                                   wo.reshape(c), bo, f=f, groups=8),
            BF16_REL, counts(1),
            {"bytes": 2 * 3 * n * c + 2 * 9 * c * c + 4 * 3 * n, "bf16": 2 * 3 * n * 9 * c * c,
             "f32": 22 * 3 * n * c})

    for n, c, dt, per_call in K3_SITES:
        x = (rand(3, n, c) + 0.5).to(getattr(torch, dt))
        compare("row_stats", "unitspeech_tpu_torch/csrc/row_stats.cu",
                "unitspeech_tpu/ops/pallas_stats.py:96", f"n={n} C={c} {dt}",
                lambda: row_stats.row_stats(x), lambda: row_stats.row_stats_plain(x),
                F32_REL, per_call,
                {"bytes": x.element_size() * 3 * n * c + 4 * 3 * 2 * c, "f32": 3 * 3 * n * c})

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
        compare("fused_rezero_attention", "unitspeech_tpu_torch/csrc/rezero_attention.cu",
                "unitspeech_tpu/ops/pallas_attention.py:183", f"N={n} C={c}",
                lambda: fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, gate,
                                                               lens),
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
        compare("fused_aa_snake_conv", src_aa, "unitspeech_tpu/ops/pallas_kernels.py:289",
                f"T={t} C={c} k={k} d={d}{' +res' if res else ''}",
                lambda: aa_snake.fused_aa_snake_conv(x, alpha, beta, w, bias, d, r),
                lambda: aa_snake.aa_snake_conv_plain(x, alpha, beta, w, bias, d, r),
                AA_REL, counts(count),
                {"bytes": 2 * c * t * (3 if res else 2) + 2 * k * c * c + 12 * c,
                 "bf16": 2 * k * c * c * t, "f32": 60 * c * t},
                ref32=lambda: aa_snake.aa_snake_conv_plain(
                    x.float(), alpha, beta, w.float(), bias, d, None if r is None else r.float()))
    t, c = K6_SITE
    x = rand(1, c, t, scale=0.5).to(torch.bfloat16)
    alpha, beta = rand(c, scale=0.3), rand(c, scale=0.3)
    compare("fused_aa_snake", src_aa, "unitspeech_tpu/ops/pallas_kernels.py:388",
            f"T={t} C={c}", lambda: aa_snake.fused_aa_snake(x, alpha, beta),
            lambda: aa_snake.aa_snake_plain(x, alpha, beta), AA_REL, counts(1),
            {"bytes": 2 * 2 * c * t + 8 * c, "f32": 60 * c * t},
            ref32=lambda: aa_snake.aa_snake_plain(x.float(), alpha, beta))

    for f, t, cin, cout, per_call in K8_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        args = rows_args(x, lens, p, t, f, cin, cout)
        compare("fused_resnet_block_deep", src_res,
                "unitspeech_tpu/ops/pallas_resnet.py:643", f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet_deep.fused_resnet_block_deep(x, mask, groups=8, **p),
                lambda: fused_resnet.resnet_block_plain(*args, f=f, groups=8), BF16_REL,
                per_call, block_work(3, t * f, cin, cout))

    for f, t, cin, cout, per_call in K9_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        # weights quantized once, as the estimator does when they load
        wq = (fused_resnet_deep.quant_w(p["w1"]), fused_resnet_deep.quant_w(p["w2"]))
        a = rows_args(x, lens, p, t, f, cin, cout)
        args = (*a[:4], wq[0], *a[4:7], wq[1], *a[8:])
        compare("fused_resnet_block_deep_i8", "unitspeech_tpu_torch/csrc/resnet_deep_i8.cu",
                "unitspeech_tpu/ops/pallas_resnet.py:1106", f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet_deep.fused_resnet_block_deep_i8(x, mask, groups=8, wq=wq,
                                                                     **p),
                lambda: fused_resnet_deep.resnet_block_deep_i8_plain(*args, f=f, groups=8),
                I8_REL, per_call,
                block_work(3, t * f, cin, cout, i8_conv1=cin <= cout, i8_conv2=True))

    src_rs = "unitspeech_tpu_torch/csrc/resample.cu"
    for (t, f, c), up in [(s, False) for s in K11_DOWN_SITES] + [(s, True) for s in K11_UP_SITES]:
        x = rand(3, t, f, c).to(torch.bfloat16)
        mask = _lens_mask(torch, t, dev)
        taps = 4 if up else 3
        w, bias = rand(taps, taps, c, c, scale=(taps * taps * c) ** -0.5), rand(c, scale=0.1)
        xm = (x * mask.to(x.dtype)).permute(0, 3, 1, 2)  # masked, NCHW view for the library
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        rows_in = 3 * t * f
        if up:
            wt = conv_transpose_weight(wb).contiguous()
            compare("fused_upsample_conv", src_rs, "unitspeech_tpu/ops/pallas_resample.py:389",
                    f"T={t} F={f} C={c}",
                    lambda: resample.fused_upsample_conv(x, mask, w, bias),
                    lambda: resample.upsample_conv_plain(x, mask, w, bias), BF16_REL,
                    counts(0, 0, 1, 1),
                    {"bytes": 2 * rows_in * c * 5 + 2 * 16 * c * c + 4 * c,
                     "bf16": 2 * 4 * rows_in * 4 * c * c, "f32": 4 * rows_in * c},
                    lib=lambda: F.conv_transpose2d(xm, wt, bb, stride=2, padding=1))
        else:
            wt = wb.permute(3, 2, 0, 1).contiguous()
            compare("fused_downsample_conv", src_rs, "unitspeech_tpu/ops/pallas_resample.py:209",
                    f"T={t} F={f} C={c}",
                    lambda: resample.fused_downsample_conv(x, mask, w, bias),
                    lambda: resample.downsample_conv_plain(x, mask, w, bias), BF16_REL,
                    counts(0, 0, 1, 1),
                    {"bytes": 2 * rows_in * c * 5 // 4 + 2 * 9 * c * c + 4 * c,
                     "bf16": 2 * (rows_in // 4) * 9 * c * c, "f32": rows_in // 4 * c},
                    lib=lambda: F.conv2d(xm, wt, bb, stride=2, padding=1))
    return records


ESTIMATOR_KERNELS = ("fused_resnet_block", "fused_final_block", "row_stats",
                     "fused_rezero_attention", "row_absmax", "fused_resnet_block_deep",
                     "fused_resnet_block_deep_i8", "fused_downsample_conv",
                     "fused_upsample_conv")
VOCODER_KERNELS = ("fused_aa_snake_conv", "fused_aa_snake")
KERNELS = ESTIMATOR_KERNELS + VOCODER_KERNELS
# the path whose per-call launches weigh a kernel's times in the kernels
# line: the serving default, or the fused deep configuration
HOME = {k: ("deep_i8" if k in ("fused_resnet_block_deep", "fused_resnet_block_deep_i8",
                               "fused_downsample_conv", "fused_upsample_conv") else "int8")
        for k in KERNELS}
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
            "fused_aa_snake": aa_snake.fused_aa_snake}


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


def compare_paths(torch, dev, ckpt_path, per_call):
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
    per-call counts of the site checks), and none on a plain path. Returns
    the measured distances."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    ids = phonemes_to_sequence(FORCED_TEXT)
    g = torch.Generator(device=dev).manual_seed(1234)
    n_feats = ckpt["mel_min"].numel()
    noise_z = torch.randn((1, FRAMES, n_feats), generator=g, device=dev)
    noises = torch.randn((50, 1, FRAMES, n_feats), generator=g, device=dev)
    mels = {}
    for name, path, dtype, kernels, routes in RUNS:
        synth = Synthesizer(TTSModels.from_checkpoint(
            ckpt, device=dev, dtype=getattr(torch, dtype), use_kernels=kernels,
            with_vocoder=False, **routes))
        want = {k: STEPS * per_call[path][k] if kernels and k in ESTIMATOR_KERNELS else 0
                for k in KERNELS}
        mel, y_len, _ = _counted(name, lambda: synth.synthesize_mel(
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
    for a in ("kernels", "deep"):
        l1, mx = dist(a, "plain")
        print(f"{a} path vs plain path (bf16), forced {FRAMES} frames: mel L1 {l1:.3e}, "
              f"max |diff| {mx:.3e} of the mel's dynamic range {span:.1f} "
              f"(bounds {MEL_L1_BOUND:.0e}, {MEL_MAX_BOUND:.0e})", flush=True)
        if not (l1 <= MEL_L1_BOUND and mx <= MEL_MAX_BOUND):
            raise AssertionError(f"{a} path mel differs from the plain path: L1 {l1}, max {mx}")
        out[f"{a}_mel_l1"], out[f"{a}_mel_max"] = l1, mx
    for a in ("kernels", "int8", "deep", "deep_i8", "plain"):
        out[f"{a}_vs_f32_l1"] = dist(a, "plain_f32")[0]
        print(f"  {a} vs plain f32: mel L1 %.3e, max |diff| %.3e" % dist(a, "plain_f32"),
              flush=True)
    for i8, bf in (("int8", "kernels"), ("deep_i8", "deep")):
        ratio = out[f"{i8}_vs_f32_l1"] / out[f"{bf}_vs_f32_l1"]
        print(f"int8 gate: {i8} path / {bf} path mel L1 vs plain f32 = {ratio:.4f} "
              f"(bound {INT8_GATE_RATIO})", flush=True)
        if not ratio <= INT8_GATE_RATIO:
            raise AssertionError(f"int8 gate failed ({i8}): ratio {ratio} > {INT8_GATE_RATIO}")
        out[f"{i8}_gate_ratio"] = ratio

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
            "launches": launches["deep_i8" if home == "deep_i8" else "default"][name],
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from unitspeech_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    print(_cuda.build_log.strip(), flush=True)

    print("kernel vs plain (bf16, B=3, lengths 344/301/344 of the bucket):", flush=True)
    records = check_kernels(torch, dev)
    per_call = per_call_counts(records)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = serve(torch, tmp, per_call)
        paths = compare_paths(torch, dev, ckpt, per_call)

    kernels = kernels_line(records, launches)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "paths": paths, "kernels": kernels,
                       "launches": launches}, f, indent=1)
    print(json.dumps({"paths": paths}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
