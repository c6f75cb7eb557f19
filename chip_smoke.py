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
the served fold) beside one torch.var_mean over the groups, K10a's
per-tile copy and its int8 conv over the copy alone (bit-equal to their
plain versions, with the conv's launch plan and its rows' useful share),
and the launches inside K4, K9, K10a, K7, K5, K6, K3 and K2 are timed one
by one (tools/kernel_breakdown.py; K3's served call must be one kernel
launch, K2's two, K10a's nine with no element-load conv). Then check what
comes out: each kernel path against the plain path, the int8 gates and the
kernel vocoder, each run with the exact kernel launches its path makes;
then K4 at C = 1024 (its weights streamed through the ring) alone and in a
forced 880-frame request, the first bucket whose F = 10 stage passes the
attention gate, against the plain path with exact K4 launches.
On the card every request at world 1 runs its sampler as CUDA graphs, one
replay a step (infer/graphs.py), and the fine-tune as one replay an
optimizer step. A replay calls no kernel wrapper, so the launch counts are
counted at capture and multiplied by the replays: a capture takes the
launches its wrappers counted back off the counters (it ran nothing) and
every replay adds them again, so every exact-launch check below counts the
launches that ran, eager or replayed; a replay hook counts the estimator's
calls by rows as the forward pre-hook counts an eager call. Then the graphs
phase: on the serving default and on the fused deep configuration, a batch
forced to the 344-frame bucket at B = 1 and 8 with ddpm@50 and
dpm2:cs2@25, graphed against the eager steps (Synthesizer(graphs=False)):
the mels bit-equal, the launches exact on both, one estimator call a step
by rows, two seeds apart; per request, eager and graphed, the host's
launch calls (kernel and graph launches, copies, sets: torch.profiler's
runtime records), device busy time and records, the median wall of 3 and
the idle share; the captures' host seconds and the graphs' share of the
card's reserved memory; then 25 full-width fine-tune steps graphed and
eager, their losses and weights bit-equal, and each one's ms a step.
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
Then the serving path (`cli serve`'s): build_batcher on the full-width
checkpoint (the int8 default, the cost window from the card's measured
curves, the batch ladder 1/2/4/8 x every window bucket warmed), its HTTP front end on
127.0.0.1:0, a burst of 8 concurrent POST /synthesize of mixed lengths
batched on the kernels (every waveform its length, exact estimator calls
by rows), one overflow and one streamed request; a B = 8 batch of mixed
lengths on the kernels against the plain paths row by row, with exact
launches; and the device time, launches and wall a request of a forced
344-frame batch at B = 1, 2, 4 and 8.
Then STEP1 training (`cli train-step1`'s path): a 32-utterance corpus made
from a seed at 22.05 kHz (4 speakers, 1.5-4 s, IPA texts that the audio
follows), `cli preprocess-mel-stats` and `preprocess-uncond`, `cli
train-step1` at full width (batch 16, 2 s segments) for 2 epochs saving
each, then `--resume` for a third (it must start at epoch 2, step 4, its
restored parameters and Adam moments equal to the saved ones), every loss
finite and kernel M1 (csrc/mas.cu, the alignment search; the port's only
kernel with no Pallas counterpart) launched once a step; M1 bit for bit
against its plain version at the run's batch shapes (forced ties, ragged
lengths), with its time and bound; a small f32 step on the card against
the CPU's (tools/step_check.py); one step's device time, launches and idle
share under torch.profiler and the peak memory; and the trained
checkpoint served by `cli inference --checkpoint --spk-emb` on the serving
defaults and on the plain path (exact launches), its mels on the kernel
paths held to the plain paths' as the adapt phase holds them.
Then STEP2 (`cli train-step2`'s path): a second 32-utterance corpus tree
(texts beside the wavs) through `cli make-filelist --corpus generic`,
`preprocess-mel-stats`, `preprocess-spk-embs` and `preprocess-units
--device cuda` with the frontends phase's full-width SSL models, `cli
train-step2` against the trained STEP1 decoder for 2 epochs and a resumed
third (no kernel launched), whole steps under torch.profiler, the decoder
bit-unchanged and outside the optimizer, a small f32 STEP2 step on the card
against the CPU's, and the trained unit encoder served through `cli
finetune --unit-encoder` and the adapted decoder through `cli inference`
(exact launches, the adapt phase's bounds). Then BigVGAN's GAN training:
`cli train-vocoder` at the published 22 kHz widths with the full MPD and
MRD (batch 16 x 8192 samples), 4 steps and 2 more after --resume (no
kernel launched), whole steps under torch.profiler, a small f32 GAN step
on the card against the CPU's, and the trained generator served by `cli
inference --vocoder` on K5 / K6 (exact launches) and held to the plain
vocoder within compare_paths' vocoder bound.
Then evaluation (`eval.generate_samples`, `cli evaluate`): per speaker on
two speakers of that corpus tree (`cli finetune` from each speaker's wav
with the frontends' SSL files, then two of its texts on the serving
defaults) and flat on the base checkpoint (two sentences), every request
with exactly its bucket's launches and its waveform y_length x hop long,
the timings agreeing with the samples, one sample of each mode within the
TTS bounds of the plain path on the same seed; `cli evaluate --device
cuda` with stub ASR / MOS hooks, the port's speaker embedder as the
speaker hook and mHuBERT + k-means (a full row; each sample against itself
UER 0; two samples' unit streams against the CPU's);
finetune_decoder_batched at full width equal to single fine-tunes on the
same draws; the demo and speaker-probing examples; and one request's
device time, launches and idle share.
Then the textlesslib extras (no kernel may launch): random full-width
checkpoints in the reference's formats (tools/extras_reference: Tacotron2,
WaveGlow with weight norm, CPC), `examples.resynthesis` with the checkpoint
stack (the frontends' mHuBERT-base, 100 centroids) and the CPC stack
(`build_unit_extractor`, cpc-big-ll6k at depth 2) on a 4 s wav, the CPC
depth error at the default config, the Tacotron2 decoder for 1 000 steps
(ms and launches a step) and WaveGlow's ms a second of audio, Tacotron2,
WaveGlow, the denoiser, CPC features and the F0 track against the CPU in
strict f32, a quantized filelist with the F0 stream, and `examples.gslm`.
Then the operator tools (unitspeech_tpu_torch/tools, each main called in
this process): bench_server (8 closed-loop clients in a child process, 16
~344-frame requests, ddpm@50, --max-batch 8, the TTFA probe), bench_serving
(the exact and speculative paths), refresh_under_load (a stale window
refreshed live under 16 + 16 requests), bucket_policy_ab (the quantile and
cost windows on 9 short and 1 long request, OPS_AB_TRAFFIC, the tool's
27 + 3 cut for the time limit; dpm2:cs2@16), bench_train
(STEP1 at batch 32, 72 tokens, 688 frames), bench_ssl (WavLM-Large + ECAPA,
mHuBERT + k-means, adapting a voice end to end, cold and warm, and the
adapted voice served), then capacity_plan and analyze_buckets on
bench_server's /stats snapshot; each path with exactly its kernels
launched, every request answered, the refresh swapped, the losses and the
adapted mel finite; the plan's ms a request beside the measured one and the
measured throughput over the plan's bound (the plan's default utilization).
Then the multi-device paths (unitspeech_tpu_torch/parallel), in spawned
ranks that import only the port and load the kernels built above: one rank
over NCCL (a real process group, every collective through it), then two
ranks, one a card over NCCL where there are two cards or more, else both on
card 0 over gloo (NCCL refuses two ranks on one card). Each group takes one
data-parallel STEP1 step at full width on its rows of a global batch of 32
whose shards' lengths differ (strict f32; world 2 held to world 1's losses
and parameters), samples a data-sharded batch of 4 forced 344-frame
requests on the serving default with injected noise (each request's mel
within the TTS bounds of the single-rank batch's, each rank's launches
those of one request), adapts 2 speakers one a rank (bit-equal to the
sequential run under deterministic algorithms) and transcribes 4 wavs with
the frontends' mHuBERT + k-means (the merged file equal to one rank's);
then the sequence-sharded sampler: a forced 344-frame request through the
Synthesizer on a (data 1, seq = world) mesh, its frames split 176 + 168
at world 2, on the serving default and the bf16 kernel path, ddpm with
injected noise and dpm2:cs2 at SEQ_STEPS steps, and ddpm on the fused deep
configuration (deep_i8: K8, K9 and K11 on their sharded forms; SEQ_RUNS)
(world 1: equal bit for bit
to the unsharded request; world 2: within the bounds against world 1, the
launches a request those of the unsharded request, the seq axis's
collectives exactly the per-site formula's), and at world 2 the halo'd
kernel A, K1's and K2's sharded chains, the split K4, K8's and K9's
sharded chains (K9's split quantize and halo'd int8 conv bit for bit) and
K11a / K11b halo'd each held to its plain version on the slices of the
344-frame sites; then tensor
parallelism (parallel/tp.py, the decoder sharded over 'model'): at world
2 on a (1, 1, 2) mesh the kernels' model forms (K1's and K2's chains on a
Cout slice, K3 on the slice's groups, the flat bf16 and int8 convs with
K7's scale over the whole input, K4 whole from its gathered weights, K8's
and K9's chains and K11 on the rank's columns) each held to its plain
version, and the same request and draws on the int8 default with ddpm,
on the bf16 kernels with dpm2:cs2 and on deep_i8 with ddpm (TP2_RUNS); a
third group of four ranks (one a card where there are
four, else all on card 0 over gloo) on JAX's full-size (1, 2, 2) layout,
the serving default with ddpm, then one strict-f32 DP x TP STEP1 step on
(2, 1, 2) at a global batch of 4 against world 1's (the DP step's
bounds); every TP mel within the TTS bounds of world 1's, its launches a
request world 1's, the model and seq axes' collectives exactly the
per-call formulas';
the phase prints its seconds, the DP step's ms a rank, the all-reduce's
share of a profiled step, the batch's wall and each seq request's wall.
Last, the paths of the kernels that no request runs, the port's four tools
at full size (unitspeech_tpu_torch/tools): the kernel benchmark with
--int8 --deep (the in-kernel int8 blocks K10a, K10b), the transcendental
microbenchmark (P1, with each body's instructions a round counted in the
built kernels' SASS and its issue-slot least time), the stride probe (P2)
and the compile bisection's 14 shapes (P3: kernel A and kernel C alone);
each must launch its kernels.

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
        # quantized and packed once, as the benchmark does before it times
        wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
        packed = fused_resnet.pack_block_weights_int8(wq, p.get("wres"))
        a = rows_args(x, lens, p, t, f, cin, cout)
        fpt = fused_resnet.pick_frames_per_tile(t, f, max(cin, cout))
        compare("fused_resnet_block_int8", src_i8, "unitspeech_tpu/ops/pallas_resnet.py:1243",
                f"F={f} T={t} {cin}->{cout} tiles of {fpt} frames",
                lambda: fused_resnet.fused_resnet_block(x, mask, groups=8, int8=True, wq=wq,
                                                        packed=packed, **p),
                lambda: fused_resnet.resnet_block_i8_plain(*a[:4], wq[0], *a[4:7], wq[1], *a[8:],
                                                           f=f, groups=8, fpt=fpt),
                I8_REL, counts(0, bench=1),
                block_work(3, t * f, cin, cout, i8_conv1=True, i8_conv2=True))
        # its first two launches (the per-tile copy of x) and conv1 over the
        # copy alone, each bit-equal to its plain version
        n, nt, cp = t * f, t // fpt, -(-cin // 16) * 16
        x_rows = a[0]
        compare("quantize_tiles", src_i8, "unitspeech_tpu/ops/pallas_resnet.py:228",
                f"F={f} T={t} C={cin} tiles of {fpt} frames",
                lambda: fused_resnet.quantize_tiles(x_rows, lens, f, fpt)[0],
                lambda: fused_resnet.tile_copy_plain(
                    x_rows.float() * fused_resnet._valid(lens, n), f, fpt)[0], 0.0, counts(0),
                {"bytes": 2 * 3 * n * cin + 3 * nt * (fpt + 2) * f * cp + 4 * 3 * nt,
                 "f32": 3 * 3 * n * cin})
        x8t, sx = fused_resnet.quantize_tiles(x_rows, lens, f, fpt)
        plan = fused_resnet.conv_plan_i8_tiles(3, t, f, cp, cout, fpt)
        compare("resnet_conv3x3_i8_tiles", "unitspeech_tpu_torch/csrc/resnet_block.cu",
                "unitspeech_tpu/ops/pallas_resnet.py:228", f"F={f} T={t} conv1 {cin}->{cout}",
                lambda: fused_resnet.resnet_conv3x3_i8_tiles(x8t, sx, wq[0], p["b1"],
                                                             packed=packed[0]),
                lambda: (fused_resnet.conv3x3_i8_copy(x8t, wq[0], sx)
                         + p["b1"]).to(torch.bfloat16), 0.0, counts(0),
                {"bytes": x8t.numel() + 9 * cin * cout + 2 * 3 * n * cout + 4 * 3 * cout,
                 "i8": 2 * 3 * n * 9 * cin * cout, "f32": 3 * 3 * n * cout})
        records[-1]["plan"] = plan
        print(f"    conv plan: tile {plan['tt']} x {plan['tf']} rows ({plan['sub']} a TPU tile "
              f"of {fpt} frames; {fpt * f / (plan['sub'] * (f // plan['tf']) * 128):.1%} of "
              f"the rows useful), Cout tile {plan['bn']}, {plan['blocks']} blocks "
              f"({plan['blocks_per_sm']} an SM), {plan['smem']} B shared", flush=True)
    # K10b runs K9's chain with its own roundings, at every K8 site
    for f, t, cin, cout, _ in K8_SITES:
        x, mask, lens, p = block_inputs(t, f, cin, cout)
        # quantized and packed once, as the benchmark does before it times
        wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
        packed = fused_resnet_deep.pack_block_weights_i8(p["w1"], wq, p.get("wres"))
        a = rows_args(x, lens, p, t, f, cin, cout)
        compare("fused_resnet_block_deep_int8", "unitspeech_tpu_torch/csrc/resnet_deep_i8.cu",
                "unitspeech_tpu/ops/pallas_resnet.py:643", f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet_deep.fused_resnet_block_deep(x, mask, groups=8, int8=True,
                                                                  wq=wq, packed=packed, **p),
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
    # P2's band product keeps the full product's non-finite rule: an inf or
    # NaN in a row the band skips makes its column NaN (0 * inf), bit for bit
    # with the plain product elsewhere
    xs_bad = xs.clone()
    xs_bad[3, 5], xs_bad[301, 70], xs_bad[130, 8] = float("inf"), float("nan"), float("-inf")
    got, want = probes.selection_matmul(xs_bad), probes.selection_matmul_plain(xs_bad)
    torch.cuda.synchronize()
    same_nan = torch.equal(got.isnan(), want.isnan())
    if not (same_nan and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
            and int(want.isnan().any(0).sum()) == 3):
        raise AssertionError("selection_matmul with non-finite rows differs from its plain "
                             "version")
    print(f"  selection_matmul non-finite rows 3, 130, 301: NaN in columns "
          f"{got.isnan().any(0).nonzero().flatten().tolist()}, bit-equal to the plain version",
          flush=True)
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
# the training path's kernel (M1, the alignment search of a STEP1 step)
TRAIN_KERNELS = ("maximum_path",)
KERNELS = ESTIMATOR_KERNELS + VOCODER_KERNELS + tuple(TOOL_KERNELS) + TRAIN_KERNELS
# the path whose per-call launches weigh a kernel's times in the kernels
# line: the serving default, the fused deep configuration, or a tool's path
# (one launch per call at each of its sites)
HOME = {k: "train" if k in TRAIN_KERNELS else TOOL_KERNELS.get(k, "deep_i8" if k in (
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
    """The wrappers of KERNELS by name (ops.kernel_wrappers), each with its
    launch counter."""
    from unitspeech_tpu_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    return {name: wrappers[name] for name in KERNELS}


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
    launches of its wrapper's mask-length sum); K10a is its chain's nine
    (two frame maxima, two per-tile copies, the two int8 convs on conv_tc,
    two GroupNorms and kernel C)."""
    for rec in breakdown["K3"]:
        got = [(r["name"], r["launches"]) for r in rec["launches"]]
        if "group_mean_inv" in rec["site"] and (len(got) != 1 or got[0][1] != 1
                                                or not got[0][0].startswith("row_stats_kernel")):
            raise AssertionError(f"K3 {rec['site']}: launches {got}, expected one K3 kernel")
    for rec in breakdown["K10a"]:
        kernels = [(r["name"].split("<")[0], r["launches"]) for r in rec["launches"]
                   if not r["name"].startswith("torch ")]
        names = [n for n, k in kernels for _ in range(round(k))]
        if (len(names) != 9 or any(names.count(k) != 2 for k in ("frame_absmax", "tile_copy",
                                                                  "gn_finalize"))
                or names.count("conv_tc") < 2 or "conv3x3_i8q" in names):
            raise AssertionError(f"K10a {rec['site']}: kernel launches {kernels}, expected the "
                                 "nine of its chain")
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


# A forced request at the 880-frame bucket, the ladder's first whose F = 10
# stage (110 x 10 tokens) passes the attention gate (a request of 785
# frames or more): down_3, mid and up_2 run K4 (the first two at C = 1024,
# whose weights stream through the ring) beside the five sites of the 344
# bucket
LONG_FRAMES = 880


def _k4_per_call(cfg, bucket):
    """K4 launches of one estimator call at a frame bucket: the attention
    sites (down_i at level i, mid at the last level, up_i at level i + 1)
    whose T * F passes the gate (models/unet.py PALLAS_MIN_TOKENS)."""
    from unitspeech_tpu_torch.models.unet import PALLAS_MIN_TOKENS

    n = len(cfg.decoder.dim_mults)
    tokens = [(bucket >> i) * (cfg.data.n_feats >> i) for i in range(n)]
    sites = tokens + [tokens[-1]] + tokens[1:]
    return sum(t >= PALLAS_MIN_TOKENS for t in sites)


def long_bucket(torch, dev, ckpt_path, per_call):
    """K4 at C = 1024 on the served path: its wrapper at the F = 10 site of
    the LONG_FRAMES bucket (B = 3, lengths full, 7/9 and full) against its
    plain version, then a forced LONG_FRAMES-frame request with the same
    injected noise on the bf16 kernels against the plain bf16 path (TTS
    bounds), the kernel run's K4 launches exactly STEPS x _k4_per_call
    and every other estimator kernel of the bf16 path launched. Returns the
    measurements."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.ops import fused_attention
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.utils.artifacts import read
    from unitspeech_tpu_torch.utils.params import config_from_dict

    t0 = time.perf_counter()
    ckpt = read(ckpt_path)
    cfg = config_from_dict(ckpt["config"])
    g = torch.Generator(device=dev).manual_seed(LONG_FRAMES)
    n, c = (LONG_FRAMES >> 3) * (cfg.data.n_feats >> 3), cfg.decoder.dim * cfg.decoder.dim_mults[-1]
    x = torch.randn((3, n, c), generator=g, device=dev).to(torch.bfloat16)
    w_qkv = torch.randn((c, 384), generator=g, device=dev) * c ** -0.5
    w_out = torch.randn((128, c), generator=g, device=dev) * 128 ** -0.5
    b_out, gate = torch.randn((c,), generator=g, device=dev) * 0.1, torch.tensor([0.7], device=dev)
    lens = torch.tensor([n, n * 7 // 9, n], dtype=torch.int32, device=dev)
    got = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, gate, lens)
    want = fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, gate, lens, 4, 32)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_REL * max(want.float().abs().max().item(), 1.0)
    print(f"long bucket: K4 at N={n} C={c} (B = 3): max_abs_err {err:.3e} (bound {tol:.3e})",
          flush=True)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"K4 at C = {c}: {err} exceeds {tol}")
    # its time at the C = 1024 sites of the 880- and 1256-frame buckets
    # (inputs from their own generator: the request below keeps its noise)
    gt = torch.Generator(device=dev).manual_seed(1256)
    packed = fused_attention.pack_attention_weights(w_qkv, w_out)
    k4_times = {}
    for bucket in (LONG_FRAMES, 1256):
        nb = (bucket >> 3) * (cfg.data.n_feats >> 3)
        xb = torch.randn((3, nb, c), generator=gt, device=dev).to(torch.bfloat16)
        lb = torch.tensor([nb, nb * 7 // 9, nb], dtype=torch.int32, device=dev)
        b_ms, by_ms, op_ms = bound_ms(
            {"bytes": 2 * 2 * 3 * nb * c + 2 * 512 * c,
             "bf16": 3 * (2 * nb * c * 384 + 4 * nb * 4 * 32 * 32 + 2 * nb * 128 * c),
             "f32": 3 * (4 * nb * 128 + 2 * nb * c)})
        k4_times[bucket] = {
            "n": nb, "ms": _time_ms(torch, lambda: fused_attention.fused_rezero_attention(
                xb, w_qkv, w_out, b_out, gate, lb, packed=packed)),
            "plain_ms": _time_ms(torch, lambda: fused_attention.rezero_attention_plain(
                xb, w_qkv, w_out, b_out, gate, lb, 4, 32), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": "bytes" if by_ms >= op_ms else "operations"}
        print(f"  K4 at the {bucket}-frame bucket's F = 10 site (B = 3, N = {nb}, C = {c}, "
              f"packed): {k4_times[bucket]['ms']:.4f} ms, plain {k4_times[bucket]['plain_ms']:.3f}"
              f" ms, least {b_ms:.4f} ms ({k4_times[bucket]['bound_by']})", flush=True)

    ids = phonemes_to_sequence(FORCED_TEXT)
    noise_z = torch.randn((1, LONG_FRAMES, cfg.data.n_feats), generator=g, device=dev)
    noises = torch.randn((STEPS, 1, LONG_FRAMES, cfg.data.n_feats), generator=g, device=dev)
    k4 = STEPS * _k4_per_call(cfg, LONG_FRAMES)
    mels, launches = {}, {}
    for name, path, dtype, kernels, routes in [r for r in RUNS if r[0] in ("kernels", "plain")]:
        synth = Synthesizer(TTSModels.from_checkpoint(
            ckpt, device=dev, dtype=getattr(torch, dtype), use_kernels=kernels,
            with_vocoder=False, **routes))
        wrappers = _kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        mel, y_len, _ = synth.synthesize_mel(
            ids, diffusion_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
            durations=forced_durations(len(ids), LONG_FRAMES), noise_z=noise_z, noises=noises)
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        print(f"  kernel launches in the forced {LONG_FRAMES}-frame {name} run: "
              f"{launches[name]}", flush=True)
        if y_len != LONG_FRAMES or mel.shape[1] != LONG_FRAMES:
            raise AssertionError(f"long bucket {name}: length {y_len}, bucket {mel.shape[1]}")
        mels[name] = mel[:, :y_len].float()
        del synth
    lk = launches["kernels"]
    off = [k for k in ESTIMATOR_KERNELS if per_call["bf16"][k] and not lk[k]]
    if lk["fused_rezero_attention"] != k4 or off or any(launches["plain"].values()):
        raise AssertionError(f"long bucket launches: K4 {lk['fused_rezero_attention']}, "
                             f"expected {k4}; not launched {off}; plain {launches['plain']}")
    ref = mels["plain"]
    span = (ref.max() - ref.min()).item()
    d = (mels["kernels"] - ref).abs()
    l1, mx = d.mean().item() / span, d.max().item() / span
    res = {"frames": LONG_FRAMES, "k4_site": {"n": n, "c": c, "max_abs_err": err, "tol": tol},
           "k4_c1024_ms": k4_times,
           "k4_launches": lk["fused_rezero_attention"], "mel_l1": l1, "mel_max": mx,
           "seconds": time.perf_counter() - t0}
    print(f"  forced {LONG_FRAMES} frames: kernels vs plain (bf16), mel L1 {l1:.3e}, max |diff| "
          f"{mx:.3e} of the mel's dynamic range {span:.1f} (bounds {MEL_L1_BOUND:.0e}, "
          f"{MEL_MAX_BOUND:.0e}); K4 launched {lk['fused_rezero_attention']} times "
          f"({res['seconds']:.1f} s)", flush=True)
    if not (bool(torch.isfinite(mels["kernels"]).all()) and l1 <= MEL_L1_BOUND
            and mx <= MEL_MAX_BOUND):
        raise AssertionError(f"long bucket mel: L1 {l1}, max {mx}")
    return res


# The adapt path (cli finetune, then the adapted decoder served): ADAPT_ITERS
# fine-tune steps at full width in bf16 on a synthetic 6 s reference, at the
# reference's learning rate (2e-5; at 1e-3 the random-weight decoder
# diverged to NaN within 10 steps, rezero gates of 0.001 moving by 0.001 a
# step), about 140 ms a step on the card; 25 steps (200 until the eval
# phase joined the script, 100 until the tensor-parallel groups did, 50
# until the deep configuration's sharded checks did, to keep its time)
ADAPT_ITERS, ADAPT_SECONDS = 25, 6.0
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

    served_launches = _served_request(torch, cli, "adapted decoder served",
                                      ["--checkpoint", ckpt_path, "--decoder", stats["output"]],
                                      per_call, os.path.join(tmp, "adapted"), cfg.data.hop_length)

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
FRONTEND_ITERS, FRONTEND_SECONDS = 10, 6.0  # 6 s at 16 kHz: the 96 000-sample bucket
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
VC_SAMPLERS = [("ddpm", 25), ("dpm2", 25), ("dpm2:cs2", 25)]
TTS_STRIDED = [("ddpm:cs2", 50), ("dpm2:cs2", 25)]


@contextlib.contextmanager
def _estimator_rows(torch):
    """Inside: every GradLogPEstimator2d call's batch rows appended to the
    list it yields, in order: an eager call's by a global forward pre-hook
    (which costs the host a little on every module call: the walls it runs
    under are not the request's), a CUDA graph replay's by a replay hook
    (infer/graphs.py)."""
    from unitspeech_tpu_torch.infer.graphs import register_replay_hook
    from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d

    rows = []

    def hook(mod, args):
        # a capture records the call and runs nothing: its replays count
        if isinstance(mod, GradLogPEstimator2d) and not torch.cuda.is_current_stream_capturing():
            rows.append(int(args[0].shape[0]))

    handles = (torch.nn.modules.module.register_module_forward_pre_hook(hook),
               register_replay_hook(rows.append))
    try:
        yield rows
    finally:
        for h in handles:
            h.remove()


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


# The serving phase (after the VC-and-sampler phase), `cli serve`'s path:
# build_batcher on the full-width random checkpoint (the int8 default, the
# cost policy on infer/cost_anchors_h100.json, max_batch 8) calibrated from
# SERVE_CAL seeded IPA sentences, its HTTP front end on 127.0.0.1:0, a
# burst of SERVE_REQUESTS concurrent POST /synthesize (one client thread
# each, all released at once), one overflow, one streamed request; then a
# B = 8 batch forced to the mixed lengths SERVE_FRAMES (bucket 344) on the
# kernels against the plain paths, and the device time a request of a
# forced 344-frame batch at B = 1, 2, 4, 8.
SERVE_WORDS = ("ðə", "kwɪk", "bɹaʊn", "fɑks", "dʒʌmpt", "oʊvɚ", "leɪzi", "dɑɡ", "wʌns",
               "əpɑn", "taɪm", "smɔl", "vɪlɪdʒ", "si", "oʊld", "fɪʃɚmən", "spɛnt", "hɪz",
               "deɪz", "mɛndɪŋ", "nɛts", "ənd", "tɛlɪŋ", "stɔɹiz", "tʃɪldɹən", "ɪn", "bʌt")
SERVE_SEED, SERVE_CAL, SERVE_REQUESTS = 40, 24, 8
SERVE_FRAMES = (344, 301, 280, 256, 230, 200, 150, 120)
SERVE_LADDER = (1, 2, 4, 8)


def _ipa_sentences(rng, n, lo, hi):
    """n sentences of lo..hi-1 IPA words drawn from SERVE_WORDS."""
    return [" ".join(rng.choice(SERVE_WORDS, int(rng.integers(lo, hi)))) + "."
            for _ in range(n)]


def _http(url, payload=None, stream=False):
    """One request with its own time limit: (status, headers, body)."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


# kernels that one wrapper call launches once each (K4's three phases, K3
# and K7 one kernel a call): a profiled batch's trace must hold as many
# records of each as the wrapper's counter counted in that call
TRACE_CHECK = {"attn_kv": "fused_rezero_attention", "attn_merge": "fused_rezero_attention",
               "attn_out": "fused_rezero_attention", "row_stats_kernel": "row_stats",
               "row_absmax_kernel": "row_absmax"}


def _batch_ms(fn, tries=3):
    """(median wall ms of the 3 unprofiled calls before torch.profiler's;
    the profiled call's device busy ms and launches; the traces discarded).
    The trace is held to the launch counters of the same call: each kernel
    of TRACE_CHECK must have as many records as its wrapper counted. A
    trace that lost records is discarded and the profiled call run again,
    `tries` times in all; then the phase fails. Each call ends with its
    waveforms on the host."""
    walls = []
    wrappers = _kernel_wrappers()

    def timed():
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)

    lost = []
    for _ in range(tries):
        act = kernel_breakdown.device_activity(timed, 1, names=True)
        got = dict.fromkeys(TRACE_CHECK, 0)
        for name, k in act["by_name"].items():
            if name.split("<")[0] in got:
                got[name.split("<")[0]] += k
        want = {k: wrappers[w].launches for k, w in TRACE_CHECK.items()}
        if got == want:
            return float(np.median(walls[:3])), act, lost
        lost.append({"records": got, "counters": want, "launches": act["launches"]})
        print(f"  trace lost records: {got} against the counters {want} "
              f"({act['launches']:.0f} records); discarded, profiled again", flush=True)
    raise AssertionError(f"serving: every trace lost records: {lost}")


def serving(torch, dev, tmp, ckpt_path, per_call, smi):
    """The serving path on the card: build_batcher (calibrate, the cost
    window, the batch ladder x token bucket x window bucket warm-up) and
    make_http_server;
    SERVE_REQUESTS concurrent POST /synthesize of mixed lengths: every
    waveform y_length * hop samples, /stats a dispatch of n >= 2, the
    estimator's calls exactly STEPS a dispatch at 3 b rows (b the ladder
    size the dispatch pads to; a forward pre-hook), K1-K4, K7 and K5/K6
    launched; one overflow (a one-bucket window below the request) at its
    true length; one streamed two-sentence request, its PCM the chunks'
    lengths; a B = 8 batch forced to SERVE_FRAMES with injected noise on
    the bf16 kernels and the int8 default against the plain bf16 and f32
    paths, row by row (TTS bounds; int8 gate), exact launches; then each B
    of SERVE_LADDER at a forced 344-frame batch: wall, device busy time and
    launches, per request. Returns the measurements."""
    import threading

    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.serve import DynamicBatcher, build_batcher, make_http_server
    from unitspeech_tpu_torch.text import phonemes_to_sequence, split_sentences
    from unitspeech_tpu_torch.utils import artifacts

    t_phase = time.perf_counter()
    ckpt = artifacts.read(ckpt_path)
    synth = Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, use_kernels=True,
                                                  use_int8_deep=True))
    hop = synth.models.cfg.data.hop_length
    rng = np.random.default_rng(SERVE_SEED)
    cal = [phonemes_to_sequence(t) for t in _ipa_sentences(rng, SERVE_CAL, 3, 14)]
    texts = _ipa_sentences(rng, SERVE_REQUESTS, 2, 12)
    ids = [phonemes_to_sequence(t) for t in texts]
    frames = [max(int(synth.encode(i)[2].sum().item()), 1) for i in ids]
    guidance = dict(default_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0)
    t0 = time.perf_counter()
    batcher = build_batcher(synth, calibration_texts=cal, max_batch=8, max_wait_ms=500.0,
                            warmup_token_lengths=(max(len(i) for i in ids),), **guidance)
    warm_s = time.perf_counter() - t0
    res = {"card": smi, "load_s": t0 - t_phase, "window": list(batcher.synth.switch_buckets),
           "ladder": batcher.batch_ladder, "warmup_s": warm_s, "tokens": [len(i) for i in ids],
           "frames": frames}
    print(f"serving: build_batcher (calibrated on {SERVE_CAL} IPA sentences, cost window "
          f"{res['window']}, ladder {res['ladder']}, warm-up {warm_s:.1f} s, load "
          f"{res['load_s']:.1f} s); {SERVE_REQUESTS} "
          f"requests of {res['tokens']} tokens, {frames} frames", flush=True)
    if tuple(batcher.batch_ladder) != SERVE_LADDER:
        raise AssertionError(f"batch ladder {batcher.batch_ladder}")
    t_http = time.perf_counter()
    dispatched = []
    real_run = batcher._run
    batcher._run = lambda s, batch: (dispatched.append(len(batch)), real_run(s, batch))[1]
    srv = make_http_server(batcher, "127.0.0.1", 0, text_to_ids=phonemes_to_sequence)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    wrappers = _kernel_wrappers()
    try:
        outs, errors = [None] * SERVE_REQUESTS, []
        go = threading.Barrier(SERVE_REQUESTS)

        def client(i):
            try:
                go.wait(60)
                t1 = time.perf_counter()
                out = json.loads(_http(url + "/synthesize", {"text": texts[i],
                                                             "format": "json"})[2])
                outs[i] = (out, time.perf_counter() - t1)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        for w in wrappers.values():
            w.launches = 0
        with _estimator_rows(torch) as rows:
            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_REQUESTS)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(600)
            burst = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"serving burst: {errors}")
        stats = json.loads(_http(url + "/stats")[2])
        sizes = [next(b for b in SERVE_LADDER if b >= n) for n in dispatched]
        want_rows = [3 * b for b in sizes for _ in range(STEPS)]
        lat = [o[1] for o in outs]
        res["burst"] = {"wall_s": burst, "latency_s": lat, "dispatches": list(dispatched),
                        "rows": sizes, "launches": launches,
                        "stats": {k: stats[k] for k in ("batches", "batch_sizes",
                                                        "mean_dispatch_s", "padding_waste")}}
        print(f"  burst of {SERVE_REQUESTS} concurrent POST /synthesize: wall {burst:.3f} s, "
              f"latency {min(lat):.3f}-{max(lat):.3f} s; dispatches of {dispatched} requests "
              f"(padded to {sizes}); /stats batch_sizes {stats['batch_sizes']}, mean dispatch "
              f"{stats['mean_dispatch_s']:.3f} s; launches {launches}", flush=True)
        got = [o[0]["n_samples"] for o in outs]
        if got != [f * hop for f in frames] or not all(o[0]["sr"] == 22050 for o in outs):
            raise AssertionError(f"serving: samples {got}, expected {[f * hop for f in frames]}")
        if max(int(k) for k in stats["batch_sizes"]) < 2:
            raise AssertionError(f"serving: no dispatch of 2 or more: {stats['batch_sizes']}")
        if rows != want_rows:
            raise AssertionError(f"serving: estimator rows {rows[:8]}... ({len(rows)} calls), "
                                 f"expected {STEPS} calls at {[3 * b for b in sizes]}")
        off = [k for k in ESTIMATOR_KERNELS[:5] + VOCODER_KERNELS if launches[k] == 0]
        stray = [k for k, v in launches.items() if v and k not in ESTIMATOR_KERNELS[:5]
                 + VOCODER_KERNELS]
        if off or stray:
            raise AssertionError(f"serving: not launched {off}, stray {stray}")

        # one overflow: a one-bucket window below the longest request
        i = int(np.argmax(frames))
        small = [b for b in synth.frame_buckets if b < frames[i]][-1]
        ov = DynamicBatcher(dataclasses.replace(batcher.synth, switch_buckets=(small,)),
                            max_batch=8, max_wait_ms=1.0, **guidance)
        try:
            wav, _ = ov.submit(ids[i]).result(timeout=300)
            if len(wav) != frames[i] * hop or ov.stats.overflows != 1:
                raise AssertionError(f"overflow: {len(wav)} samples, {ov.stats.overflows}")
        finally:
            ov.shutdown(60)
        print(f"  overflow of window ({small},) by a {frames[i]}-frame request: fell back to its "
              f"length ({len(wav)} samples)", flush=True)

        # one streamed request of two sentences: the first chunk solo
        text = texts[0] + " " + texts[1]
        chunks = [phonemes_to_sequence(c) for c in split_sentences(text)]
        want = sum(max(int(synth.encode(c)[2].sum().item()), 1) for c in chunks) * hop
        t0 = time.perf_counter()
        code, headers, body = _http(url + "/synthesize", {"text": text, "stream": True})
        res["stream"] = {"wall_s": time.perf_counter() - t0, "chunks": len(chunks),
                         "samples": (len(body) - 44) // 2}
        if (code != 200 or headers.get("Transfer-Encoding") != "chunked" or body[:4] != b"RIFF"
                or len(body) != 44 + 2 * want):
            raise AssertionError(f"stream: {code} {headers} {len(body)} bytes, want {want} "
                                 "samples")
        print(f"  streamed request ({len(chunks)} chunks): {want} samples in "
              f"{res['stream']['wall_s']:.3f} s (the HTTP part {time.perf_counter() - t_http:.1f}"
              " s)", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(60)
        batcher.shutdown(60)
    del batcher, srv
    res["http_s"] = time.perf_counter() - t_http

    # B = 8 forced to SERVE_FRAMES on the kernels against the plain paths
    dur = [forced_durations(len(i), f)[0] for i, f in zip(ids, SERVE_FRAMES)]
    g = torch.Generator(device=dev).manual_seed(4321)
    n_feats = synth.models.cfg.data.n_feats
    noise_z = torch.randn((8, FRAMES, n_feats), generator=g, device=dev)
    noises = torch.randn((STEPS, 8, FRAMES, n_feats), generator=g, device=dev)
    mels = {}
    t0 = time.perf_counter()
    for name, path, dtype, kernels, routes in [r for r in RUNS if r[0] in (
            "kernels", "int8", "plain", "plain_f32")]:
        # the served synthesizer is the int8 default's
        s = synth if name == "int8" else Synthesizer(TTSModels.from_checkpoint(
            ckpt, device=dev, dtype=getattr(torch, dtype), use_kernels=kernels,
            with_vocoder=False, **routes))
        want = {k: (STEPS * per_call[path][k] if kernels and k in ESTIMATOR_KERNELS else 0)
                for k in KERNELS}
        mel, y_len = _counted(f"B = 8 batch {name}", lambda s=s: s.synthesize_mel_batch(
            ids, durations=dur, diffusion_steps=STEPS, text_gradient_scale=1.0,
            spk_gradient_scale=1.0, noise_z=noise_z, noises=noises), want)
        if list(y_len) != list(SERVE_FRAMES) or mel.shape[1] != FRAMES:
            raise AssertionError(f"B = 8 batch {name}: lengths {y_len}, bucket {mel.shape[1]}")
        mels[name] = [mel[i, :f].float().cpu().numpy() for i, f in enumerate(SERVE_FRAMES)]
        del s
    rows_out = []
    for i, f in enumerate(SERVE_FRAMES):
        ref, f32 = mels["plain"][i], mels["plain_f32"][i]
        span = float(ref.max() - ref.min())
        d = np.abs(mels["kernels"][i] - ref)
        l1_k, l1_i = (float(np.abs(mels[k][i] - f32).mean()) for k in ("kernels", "int8"))
        row = {"frames": f, "mel_l1": float(d.mean()) / span, "mel_max": float(d.max()) / span,
               "int8_gate_ratio": l1_i / l1_k}
        rows_out.append(row)
        if not (np.isfinite(mels["kernels"][i]).all() and row["mel_l1"] <= MEL_L1_BOUND
                and row["mel_max"] <= MEL_MAX_BOUND and row["int8_gate_ratio"] <= INT8_GATE_RATIO):
            raise AssertionError(f"B = 8 batch row {i}: {row}")
    res["batch8"] = rows_out
    res["batch8_s"] = time.perf_counter() - t0
    print("  B = 8 batch forced to " + "/".join(map(str, SERVE_FRAMES)) + " frames (bucket "
          f"{FRAMES}), row by row: bf16 kernels vs plain bf16 mel L1 "
          + ", ".join(f"{r['mel_l1']:.2e}" for r in rows_out) + "; max "
          + ", ".join(f"{r['mel_max']:.2e}" for r in rows_out) + "; int8 gate "
          + ", ".join(f"{r['int8_gate_ratio']:.3f}" for r in rows_out)
          + f" (bounds {MEL_L1_BOUND:.0e}, {MEL_MAX_BOUND:.0e}, {INT8_GATE_RATIO}; "
          f"{res['batch8_s']:.1f} s)", flush=True)
    del mels

    # per request at B = 1, 2, 4, 8: a forced 344-frame batch, vocoded
    res["per_b"] = {}
    for b in SERVE_LADDER:
        def batch(b=b):
            return synth.synthesize_batch(
                ids[:b], torch.Generator(device=dev).manual_seed(b),
                durations=[forced_durations(len(i), FRAMES)[0] for i in ids[:b]],
                diffusion_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0)

        t0 = time.perf_counter()
        wall, act, lost = _batch_ms(batch)
        r = {"wall_ms": wall, "device_ms": act["busy_ms"], "launches": act["launches"],
             "traces_discarded": lost,
             "wall_ms_per_request": wall / b, "device_ms_per_request": act["busy_ms"] / b,
             "launches_per_request": act["launches"] / b,
             "idle_share": 1.0 - act["busy_ms"] / wall, "measure_s": time.perf_counter() - t0}
        res["per_b"][b] = r
        print(f"  forced {FRAMES}-frame batch at B = {b}: per request wall "
              f"{r['wall_ms_per_request']:.1f} ms, device busy {r['device_ms_per_request']:.1f} "
              f"ms, {r['launches_per_request']:.0f} launches; idle share {r['idle_share']:.3f} "
              f"(trace held to the counters; {len(lost)} discarded; {r['measure_s']:.1f} s); "
              f"{smi}", flush=True)
    del synth
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"serving phase: {res['phase_s']:.1f} s", flush=True)
    return res


# The graphs phase: the sampler as CUDA graph replays (infer/graphs.py)
# against its eager steps (Synthesizer(graphs=False)) on the serving default
# and the fused deep configuration, a batch forced to the 344-frame bucket
# at B = 1 and 8 with each of GRAPH_SPECS, and the fine-tune's captured step
# (train/finetune.py FinetuneLoop) against its eager steps at full width
GRAPH_MODES = [("int8", {"use_int8_deep": True}),
               ("deep_i8", {"use_int8_deep": True, "use_deep": True, "use_resample": True,
                            "use_i8pre_deep": True})]
GRAPH_SPECS = [("ddpm", STEPS), ("dpm2:cs2", 25)]
GRAPH_BATCHES = (1, 8)
GRAPH_FT_ITERS = 25
GRAPH_SEED = 90


def _graph_times(torch, dev, request, b):
    """Per request of a batch of b: the median wall of 3 calls (each ends
    with its waveforms on the host), then one call under torch.profiler:
    device busy ms, device records, the host's calls that put work on the
    card (kernel and graph launches, copies, sets) and its graph launches;
    the idle share is 1 - busy / wall."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        request()
        walls.append((time.perf_counter() - t0) * 1e3)
    act = kernel_breakdown.device_activity(request, 1, host=True, warmup=0)
    wall = float(np.median(walls))
    return {"wall_ms": wall / b, "device_ms": act["busy_ms"] / b,
            "device_launches": act["launches"] / b, "host_calls": act["host_calls"] / b,
            "graph_launches": act["graph_launches"] / b,
            "idle_share": 1.0 - act["busy_ms"] / wall}


def _graphs_finetune(torch, dev, cfg, base, smi):
    """GRAPH_FT_ITERS fine-tune steps at full width (bf16, random inputs
    at the 344-frame bucket, the parallel phase's shapes) eager and graphed
    on one seed, under deterministic algorithms (cuDNN's nondeterministic
    convs would part any two runs): the losses and adapted weights
    bit-equal; each run's wall and its median ms a step from step 6 on
    (CUDA events in the step hook)."""
    from unitspeech_tpu_torch.ops.masking import generate_path, sequence_mask
    from unitspeech_tpu_torch.train.finetune import finetune_decoder

    n_feats = cfg.decoder.n_feats
    t_y, t_x = FRAMES, FRAMES // 4
    frng = np.random.default_rng(GRAPH_SEED)
    cond_x = torch.from_numpy((0.1 * frng.standard_normal((1, t_x, n_feats)))
                              .astype(np.float32)).to(dev)
    y = torch.from_numpy(np.tanh(frng.standard_normal((1, t_y, n_feats)))
                         .astype(np.float32)).to(dev)
    y_len = torch.tensor([t_y - 20], device=dev)
    spk = frng.standard_normal((1, cfg.decoder.spk_emb_dim)).astype(np.float32)
    spk = torch.from_numpy(spk / np.linalg.norm(spk)).to(dev)
    attn = generate_path(torch.full((1, t_x), 4.0, device=dev),
                         sequence_mask(torch.tensor([t_x], device=dev), t_x)[:, :, None]
                         * sequence_mask(y_len, t_y)[:, None, :])
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name, graphed in (("eager", False), ("graphed", True)):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(GRAPH_FT_ITERS)]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, losses = _counted(f"fine-tune {name}", lambda: finetune_decoder(
                cfg.decoder, base, cond_x, y, y_len, attn, spk, segment_size=cfg.out_size,
                n_iters=GRAPH_FT_ITERS, learning_rate=cfg.finetune.learning_rate,
                grad_clip=cfg.finetune.grad_clip, graphs=graphed,
                generator=torch.Generator(device=dev).manual_seed(GRAPH_SEED),
                step_hook=lambda i: events[i].record()), {k: 0 for k in KERNELS})
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            steps = [events[i - 1].elapsed_time(events[i]) for i in range(6, GRAPH_FT_ITERS)]
            runs[name] = (state, losses, {"wall_s": wall, "ms_per_step": float(np.median(steps))})
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[2:]
    (se, le, te), (sg, lg, tg) = runs["eager"], runs["graphed"]
    equal = bool(np.array_equal(le, lg)) and all(torch.equal(se[k], sg[k]) for k in se)
    moved = float(max((sg[k] - base[k].to(dev)).abs().max() for k in base))
    out = {"iters": GRAPH_FT_ITERS, "bit_equal": equal, "eager": te, "graphed": tg,
           "losses": lg.tolist(), "max_moved": moved, "card": smi}
    print(f"  fine-tune, {GRAPH_FT_ITERS} steps at full width (bf16, deterministic "
          f"algorithms): graphed vs eager losses and weights bit-equal: {equal}; ms a step "
          f"(median from step 6) eager {te['ms_per_step']:.2f}, graphed "
          f"{tg['ms_per_step']:.2f}; wall {te['wall_s']:.2f} / {tg['wall_s']:.2f} s "
          f"(the graphed run's includes its 3 eager steps and the capture); {smi}", flush=True)
    if not equal or not np.isfinite(lg).all() or moved == 0.0:
        raise AssertionError(f"fine-tune graphs: bit-equal {equal}, moved {moved}, losses {lg}")
    return out


def graphs(torch, dev, tmp, ckpt_path, per_call, smi):
    """The sampler as CUDA graph replays on the card: for each mode of
    GRAPH_MODES a Synthesizer (graphs on, its eager twin graphs=False on the
    same modules); for each spec of GRAPH_SPECS and B of GRAPH_BATCHES a
    batch forced to the 344-frame bucket: the eager mel and the graphed mel
    (the first graphed request captures each step kind of its shape), each
    with exactly steps x the path's per-call launches (the captures'
    launches taken back, the replays' added) and the graphed one with one
    estimator call a step by rows (3B full, B cheap; a replay hook), bit
    for bit equal; a second seed's mel differs; then per request, eager and
    graphed, with the vocoder: the host's launch calls, device busy time
    and records, the median wall of 3 and the idle share (_graph_times);
    the captures' host seconds and the graph pool's memory (the card's
    reserved memory with the mode's graphs less without). Last the
    fine-tune (_graphs_finetune). Returns the measurements."""
    import gc

    from unitspeech_tpu_torch.infer import graphs as tgraphs
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.params import config_from_dict

    t_phase = time.perf_counter()
    ckpt = artifacts.read(ckpt_path)
    cfg = config_from_dict(ckpt["config"])
    ids = [phonemes_to_sequence(t) for t in _ipa_sentences(np.random.default_rng(GRAPH_SEED),
                                                             max(GRAPH_BATCHES), 4, 12)]
    dur = [forced_durations(len(i), FRAMES)[0] for i in ids]
    res = {"card": smi, "modes": {}}
    print(f"graphs: the sampler as CUDA graph replays against its eager steps, a batch forced "
          f"to {FRAMES} frames, dual CFG 1.0/1.0; {smi}", flush=True)
    for mode, routes in GRAPH_MODES:
        synth = Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, **routes))
        eager = dataclasses.replace(synth, graphs=False)
        cache = tgraphs.graphs_for(synth.models.decoder, synth.models.spk_emb)
        if cache is None:
            raise AssertionError("graphs: the Synthesizer takes no CUDA graphs on the card")
        out = res["modes"][mode] = {}
        for spec, steps in GRAPH_SPECS:
            for b in GRAPH_BATCHES:
                what = f"{mode} {spec}@{steps} B = {b}"
                kw = dict(durations=dur[:b], diffusion_steps=steps, text_gradient_scale=1.0,
                          spk_gradient_scale=1.0, sampler=spec)
                want = {k: steps * per_call[mode][k] if k in ESTIMATOR_KERNELS else 0
                        for k in KERNELS}
                want_rows = {r * b: n for r, n in _spec_rows(spec, steps).items()}

                def mel(s, seed, b=b, kw=kw):
                    return s.synthesize_mel_batch(
                        ids[:b], torch.Generator(device=dev).manual_seed(seed), **kw)[0]

                ref = _counted(f"{what} eager", lambda: mel(eager, GRAPH_SEED), want)
                captures, capture_s = cache.captures, cache.capture_s
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with _estimator_rows(torch) as rows:
                    got = _counted(f"{what} graphed", lambda: mel(synth, GRAPH_SEED), want)
                torch.cuda.synchronize(dev)
                first_s = time.perf_counter() - t0
                got_rows = {r: rows.count(r) for r in sorted(set(rows), reverse=True)}
                if got_rows != want_rows:
                    raise AssertionError(f"{what}: estimator calls by rows {got_rows}, expected "
                                         f"{want_rows}")
                if not torch.equal(got, ref):
                    raise AssertionError(f"{what}: the graphed mel differs from the eager one "
                                         f"(max |diff| {(got - ref).abs().max().item()})")
                if torch.equal(mel(synth, GRAPH_SEED + 1), ref):
                    raise AssertionError(f"{what}: two seeds gave one mel")
                rec = {"steps": steps, "batch": b, "bit_equal": True, "rows": want_rows,
                       "launches": {k: v for k, v in want.items() if v},
                       "captures": cache.captures - captures,
                       "capture_s": cache.capture_s - capture_s, "first_request_s": first_s}
                for name, s in (("eager", eager), ("graphed", synth)):
                    rec[name] = _graph_times(torch, dev, lambda s=s, b=b, kw=kw: s.synthesize_batch(
                        ids[:b], torch.Generator(device=dev).manual_seed(GRAPH_SEED), **kw), b)
                out[f"{spec} B={b}"] = rec
                e, g = rec["eager"], rec["graphed"]
                print(f"  {what}: graphed mel bit-equal to eager, launches exact "
                      f"({sum(want.values())}), {rec['captures']} captures in "
                      f"{rec['capture_s']:.3f} s (first request {first_s:.2f} s); per request, "
                      f"eager / graphed: host launch calls {e['host_calls']:.0f} / "
                      f"{g['host_calls']:.0f} ({g['graph_launches']:.1f} graph launches), device "
                      f"{e['device_ms']:.1f} / {g['device_ms']:.1f} ms ({e['device_launches']:.0f}"
                      f" / {g['device_launches']:.0f} records), wall (median of 3) "
                      f"{e['wall_ms']:.1f} / {g['wall_ms']:.1f} ms, idle "
                      f"{e['idle_share']:.3f} / {g['idle_share']:.3f}; {smi}", flush=True)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        with_graphs = torch.cuda.memory_reserved(dev)
        out["graphs"] = sum(len(e.graphs) for e in cache.entries.values())
        out["captures"], out["capture_s"] = cache.captures, cache.capture_s
        cache.clear()
        gc.collect()
        torch.cuda.empty_cache()
        out["pool_mib"] = (with_graphs - torch.cuda.memory_reserved(dev)) / 2 ** 20
        print(f"  {mode}: {out['graphs']} graphs from {out['captures']} captures in "
              f"{out['capture_s']:.2f} s; the graphs and their static state hold "
              f"{out['pool_mib']:.1f} MiB of the card's reserved memory; {smi}", flush=True)
        del synth, cache
        gc.collect()
        torch.cuda.empty_cache()
    res["finetune"] = _graphs_finetune(torch, dev, cfg, ckpt["decoder"], smi)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"graphs phase: {res['phase_s']:.1f} s", flush=True)
    return res


# The STEP1 training phase: TRAIN_UTTS utterances of TRAIN_SECONDS at the
# reference's rate from TRAIN_SPEAKERS speakers, batches of TRAIN_BATCH (2
# steps an epoch), 2 epochs saving each, then a third resumed
TRAIN_UTTS, TRAIN_SPEAKERS, TRAIN_SECONDS, TRAIN_BATCH, TRAIN_SEED = 32, 4, (1.5, 4.0), 16, 50
PROFILED_STEPS = 3  # whole loop steps under torch.profiler
M1_REPLACES = "unitspeech_tpu/ops/mas.py::maximum_path (lax.scan, no Pallas)"


def _m1_case(torch, kind, b, t_x, t_y, dev, seed):
    """(log_prior, mask) on dev at a batch shape: integer log-priors (ties
    at every cell) with every length full, or random ones with ragged
    lengths (a one-token row, a row with fewer frames than tokens)."""
    rng = np.random.default_rng(seed)
    xl, yl = np.full(b, t_x), np.full(b, t_y)
    if kind == "ties":
        lp = rng.integers(-2, 1, (b, t_x, t_y)).astype(np.float32)
    else:
        lp = (rng.standard_normal((b, t_x, t_y)) * 3).astype(np.float32)
        xl = rng.integers(1, t_x + 1, b)
        yl = np.clip(xl + rng.integers(-3, t_y, b), 1, t_y)
        xl[0], yl[-1] = 1, max(1, min(t_y, int(xl[-1]) - 1))
    mask = ((np.arange(t_x)[None, :, None] < xl[:, None, None])
            & (np.arange(t_y)[None, None, :] < yl[:, None, None])).astype(np.float32)
    return torch.from_numpy(lp).to(dev), torch.from_numpy(mask).to(dev)


def train(torch, dev, tmp, ckpt_path, per_call, smi):
    """STEP1 training on the card through the CLIs at full width (the module
    docstring says what is checked). Returns the measurements, M1's
    records (one a batch shape of the run), the served request's launches
    and the training runs' launches."""
    import shutil

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.data.dataset import iterate_batches
    from unitspeech_tpu_torch.ops import mas
    from unitspeech_tpu_torch.tools import step_check, synthetic_corpus
    from unitspeech_tpu_torch.utils import artifacts, checkpoint

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "train")
    base = MainConfig()
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, save_every=1))
    os.makedirs(d, exist_ok=True)
    cfg_path = os.path.join(d, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    texts = _ipa_sentences(np.random.default_rng(TRAIN_SEED), TRAIN_UTTS, 4, 10)
    corp = synthetic_corpus(d, cfg, texts, TRAIN_SPEAKERS, TRAIN_SECONDS, seed=TRAIN_SEED)
    ms, un = os.path.join(d, "mel_stats.npz"), os.path.join(d, "uncond_stats.npz")
    dev_flags = ["--config", cfg_path, "--device", "cuda"]
    t0 = time.perf_counter()
    cli.main(["preprocess-mel-stats", "--filelist", corp["filelist"], "--out", ms, *dev_flags])
    cli.main(["preprocess-uncond", "--filelist", corp["filelist"], "--mel-stats", ms,
              "--spk-embs", corp["spk_embs"], "--out", un, *dev_flags])
    prep_s = time.perf_counter() - t0
    ck = os.path.join(d, "ckpt")
    flags = ["--filelist", corp["filelist"], "--spk-embs", corp["spk_embs"], "--mel-stats", ms,
             "--uncond-stats", un, "--checkpoint-dir", ck, "--log-dir", os.path.join(d, "log"),
             "--batch-size", str(TRAIN_BATCH), *dev_flags]
    per_epoch = TRAIN_UTTS // TRAIN_BATCH
    print(f"train: cli train-step1 --device cuda, full width, batch {TRAIN_BATCH}, "
          f"{TRAIN_UTTS} utterances of {TRAIN_SECONDS[0]}-{TRAIN_SECONDS[1]} s, segments of "
          f"{cfg.out_size} frames (preprocessing {prep_s:.1f} s)", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for name, extra, epochs in (("train", [], 2), ("train_resume", ["--resume"], 3)):
        if extra:  # the saved epoch-2 state, for the restore check below
            os.makedirs(os.path.join(d, "restore"))
            shutil.copy(os.path.join(ck, "step_2"), os.path.join(d, "restore", "step_2"))
        steps = per_epoch * (1 if extra else epochs)
        res = _counted(f"cli train-step1{' --resume' if extra else ''}",
                       lambda: cli.main_train_step1(flags + ["--n-epochs", str(epochs), *extra]),
                       {k: steps if k == "maximum_path" else 0 for k in KERNELS})
        losses = np.array([[m[k] for k in ("dur_loss", "prior_loss", "diff_loss")]
                           for m in res["metrics"]])
        print(f"  {name}: epochs {res['start_epoch']}..{epochs - 1} from step "
              f"{res['first_step']}, {res['steps']} steps, {res['ms_per_step']:.1f} ms a step "
              "after the first (host clock, each step's metrics on the host); dur / prior / "
              "diff losses " + " ".join("/".join(f"{x:.4f}" for x in r) for r in losses)
              + f"; {smi}", flush=True)
        if not np.isfinite(losses).all() or len(losses) != steps:
            raise AssertionError(f"{name}: losses {losses}")
        runs[name] = {k: v for k, v in res.items() if k != "metrics"}
        runs[name]["losses"] = losses.tolist()
    peak = torch.cuda.max_memory_allocated(dev)
    resumed = runs["train_resume"]
    if (resumed["start_epoch"], resumed["first_step"], resumed["steps"]) != (
            2, 2 * per_epoch, 3 * per_epoch) or not resumed["checkpoint"].endswith("step_3"):
        raise AssertionError(f"resume: epoch {resumed['start_epoch']}, step "
                             f"{resumed['first_step']} -> {resumed['steps']}, "
                             f"{resumed['checkpoint']}")

    # the restore: a loop built as the CLI builds it, resumed from the copy
    args = cli.step1_parser().parse_args(flags + ["--checkpoint-dir",
                                                  os.path.join(d, "restore")])
    _, loop = cli.build_step1(args)
    saved = checkpoint.load_checkpoint(os.path.join(d, "restore", "step_2"))
    epoch = loop.resume()
    differ = [f"{m}.{k}" for m in ("text_encoder", "duration_predictor", "decoder")
              for k, v in loop.modules[m].state_dict().items()
              if not torch.equal(v.cpu(), saved[m][k])]
    opt = loop.optimizer.state_dict()["state"]
    moments = [(i, k) for i, st in saved["opt_state"]["state"].items()
               for k in ("exp_avg", "exp_avg_sq", "step")
               if not torch.equal(opt[i][k].cpu(), st[k])]
    print(f"  restored from step_2: epoch {epoch}, step {loop.step}; "
          f"{len(saved['opt_state']['state'])} Adam entries; parameters differing "
          f"{len(differ)}, moments differing {len(moments)}", flush=True)
    if epoch != 2 or loop.step != 2 * per_epoch or differ or moments or len(opt) < 100:
        raise AssertionError(f"restore: epoch {epoch}, step {loop.step}, {differ[:5]}, "
                             f"{moments[:5]}")

    # the run's batch shapes (its epochs 0 and 1; the resumed run replays
    # epoch 0's order), then whole loop steps (the batch to the card and its
    # mel frontend, train_step, the metrics to the host) under
    # torch.profiler from the restored state on the first batch, each timed
    # on the host clock in the same profiled call
    rng = np.random.default_rng(cfg.train.seed)
    epochs = [[(TRAIN_BATCH, b["tokens"].shape[1], b["wav"].shape[1] // cfg.data.hop_length)
               for b in iterate_batches(loop.dataset, loop.collator, TRAIN_BATCH, key=rng)]
              for _ in range(2)]
    shapes = epochs[0] + epochs[1] + epochs[0]
    raw = next(iterate_batches(loop.dataset, loop.collator, TRAIN_BATCH,
                               key=np.random.default_rng(cfg.train.seed)))
    gen = torch.Generator(device=dev).manual_seed(0)
    prof = _profiled_steps(torch, lambda: loop.step_once(raw, gen), peak,
                           f"STEP1 step at full width (batch {TRAIN_BATCH})", smi)
    prof["ms_per_step"] = float(np.median(runs["train"]["step_seconds"][1:]
                                          + resumed["step_seconds"][1:])) * 1e3
    print(f"  {prof['ms_per_step']:.1f} ms a STEP1 step (median after each run's first, host "
          f"clock); {smi}", flush=True)
    del loop, raw

    # M1 at the run's batch shapes, against its plain version; one record a
    # shape, weighted in the kernels line by its share of the run's steps
    m1 = []
    for shape in sorted(set(shapes)):
        errs = []
        for kind in ("ties", "lengths"):
            lp, mask = _m1_case(torch, kind, *shape, dev, seed=sum(shape))
            got = mas.maximum_path(lp, mask)
            want = mas.maximum_path_plain(lp, mask)
            cpu = mas.maximum_path_plain(lp.cpu(), mask.cpu())
            if not (torch.equal(got, want) and torch.equal(got.cpu(), cpu)):
                raise AssertionError(f"M1 at {shape} ({kind}) differs from its plain version")
            errs.append((got - want).abs().max().item())
        b_ms, by_ms, op_ms = bound_ms(mas.work(*shape))
        rec = dict(name="maximum_path", route="cuda", source="unitspeech_tpu_torch/csrc/mas.cu",
                   replaces=M1_REPLACES, site=f"(B, Tx, Ty) = {shape}",
                   counts=dict(counts(0), train=shapes.count(shape) / len(shapes)),
                   max_abs_err=max(errs), tol=0.0,
                   ms=_time_ms(torch, lambda: mas.maximum_path(lp, mask)),
                   plain_ms=_time_ms(torch, lambda: mas.maximum_path_plain(lp, mask),
                                     reps=5, warmup=1),
                   bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms, lib_ms=None)
        m1.append(rec)
        print(f"  M1 at (B, Tx, Ty) = {shape} ({shapes.count(shape)} of the run's steps): "
              f"bit-equal to maximum_path_plain (ties; ragged lengths); "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.2f} ms, least "
              f"{b_ms:.5f} ms ({'bytes' if by_ms >= op_ms else 'operations'}); {smi}", flush=True)
    train_launches = {k: len(shapes) if k in TRAIN_KERNELS else 0 for k in KERNELS}

    # a small f32 step on the card against the CPU, the same draws
    check = step_check.card_vs_cpu(dev)
    print(f"  small f32 STEP1 step, card vs CPU (strict f32, cuDNN deterministic, the same "
          f"draws): largest relative difference of the losses and gradient norms "
          f"{check['max_rel']:.3e} (bound {check['bound']:.0e})", flush=True)

    # the trained checkpoint served: the serving defaults and the plain path
    spk = os.path.join(d, "spk.npy")
    with np.load(corp["spk_embs"]) as z:
        np.save(spk, z["0"])
    step3 = resumed["checkpoint"]
    served = _served_request(torch, cli, "trained checkpoint served",
                             ["--checkpoint", step3, "--vocoder", ckpt_path, "--spk-emb", spk],
                             per_call, os.path.join(d, "trained"), cfg.data.hop_length)
    trained = artifacts.read(step3)
    paths = compare_paths(torch, dev, dict(artifacts.read(ckpt_path), **{
        k: trained[k] for k in ("text_encoder", "duration_predictor", "decoder", "mel_min",
                                "mel_max")}, spk_emb=torch.from_numpy(np.load(spk))[None]),
        per_call, runs=ADAPT_RUNS, vocoder=False, what="trained ")
    torch.cuda.empty_cache()
    res = {"runs": runs, "profile": prof, "step_check": check, "paths": paths,
           "phase_s": time.perf_counter() - t_phase}
    print(f"train phase: {res['phase_s']:.1f} s", flush=True)
    return res, m1, served, train_launches


# The STEP2 phase (after train): a corpus tree made from a seed at 22.05 kHz
# (TRAIN_UTTS utterances, TRAIN_SPEAKERS speakers, texts beside the wavs),
# its filelist by `cli make-filelist --corpus generic`, the speaker
# embeddings and units by the SSL models the frontends phase wrote, then
# `cli train-step2` against the train phase's STEP1 decoder, 2 epochs and 1
# resumed, and the trained unit encoder served through `cli finetune`
TRAIN2_SEED, TRAIN2_FT_ITERS = 60, 20


def _served_request(torch, cli, what, args, per_call, out, hop):
    """One forced 344-frame request through `cli inference` on the serving
    defaults and one with --no-fast-kernels, each with exactly the launches
    of its path (one estimator call a step and one vocoder call, or none).
    Returns the defaults' launches."""
    served = {}
    for name, extra, want in (
            ("kernels", [], {k: STEPS * per_call["int8"][k] if k in ESTIMATOR_KERNELS
                             else per_call["int8"][k] if k in VOCODER_KERNELS else 0
                             for k in KERNELS}),
            ("plain", ["--no-fast-kernels"], {k: 0 for k in KERNELS})):
        path = f"{out}_{name}.wav"
        res = _counted(f"{what}, {name}", lambda: cli.main_inference(
            ["--ipa", "--text", FORCED_TEXT, *args, "--output", path, "--device", "cuda",
             "--seed", "0", "--diffusion-steps", str(STEPS), "--text-gradient-scale", "1.0",
             "--spk-gradient-scale", "1.0", "--frames", str(FRAMES), *extra]), want)
        with wave.open(path, "rb") as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        if n != FRAMES * hop or not np.any(pcm):
            raise AssertionError(f"{what} ({name}): {n} samples")
        print(f"  {what} ({name}): wall {res['wall_s']:.3f} s", flush=True)
        served[name] = want
    return served["kernels"]


def _profiled_steps(torch, step, peak, what, smi):
    """Whole loop steps `step()` (each ending on the host) under
    torch.profiler: the host-clock wall of the same profiled calls, the
    device's busy time and launches a step, the idle share, with the
    peak memory of the run before."""
    from unitspeech_tpu_torch.utils.precision import strict_f32

    walls = []

    def one_step():
        t = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t)

    with strict_f32():
        act = kernel_breakdown.device_activity(one_step, PROFILED_STEPS)
    wall_ms = float(np.mean(walls[-PROFILED_STEPS:])) * 1e3
    prof = {"profiled_wall_ms": wall_ms, "device_ms": act["busy_ms"],
            "launches": act["launches"], "idle_share": 1.0 - act["busy_ms"] / wall_ms,
            "peak_bytes": peak}
    print(f"  {what}: under torch.profiler, a whole loop step (mean of {PROFILED_STEPS}) "
          f"{wall_ms:.1f} ms on the host clock, device busy {act['busy_ms']:.2f} ms in "
          f"{act['launches']:.0f} launches, idle share {prof['idle_share']:.3f}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated over the training runs); {smi}",
          flush=True)
    return prof


def train2(torch, dev, tmp, ckpt_path, step1_ckpt, per_call, smi):
    """STEP2 and the unit-side preprocessors on the card through the CLIs at
    full width: `cli make-filelist`, `preprocess-mel-stats`,
    `preprocess-spk-embs` and `preprocess-units --device cuda` (WavLM-Large
    + ECAPA, mHuBERT-base and the 1000 centroids the frontends phase
    converted), `cli train-step2` for 2 epochs and `--resume` for a third
    against the STEP1 checkpoint's decoder (batch TRAIN_BATCH, no kernel
    launched: the plain decoder, frozen), every loss finite; whole loop
    steps under torch.profiler from the resumed state, after which every
    decoder parameter equals the STEP1 checkpoint's bit for bit and the
    optimizer holds none of them; then the trained unit encoder served:
    `cli finetune --unit-encoder <STEP2 checkpoint>` on a corpus wav with its
    sidecar units, the adapted decoder through `cli inference` on the
    serving defaults and on the plain path (exact launches), and its mels
    held to the plain paths' as the adapt phase holds them. Returns the
    measurements, the corpus filelist and the served request's launches."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.data.dataset import iterate_batches, parse_filelist
    from unitspeech_tpu_torch.tools import step_check, synthetic_corpus
    from unitspeech_tpu_torch.utils import artifacts, checkpoint

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "train2")
    base = MainConfig()
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, save_every=1))
    os.makedirs(d)
    cfg_path = os.path.join(d, "train2.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    texts = _ipa_sentences(np.random.default_rng(TRAIN2_SEED), TRAIN_UTTS, 4, 10)
    root = os.path.join(d, "corpus")
    synthetic_corpus(root, cfg, texts, TRAIN_SPEAKERS, TRAIN_SECONDS, seed=TRAIN2_SEED)
    dev_flags = ["--config", cfg_path, "--device", "cuda"]
    none = {k: 0 for k in KERNELS}
    t0 = time.perf_counter()
    _counted("cli make-filelist", lambda: cli.main(
        ["make-filelist", "--corpus", "generic", "--root", root, "--out-dir",
         os.path.join(d, "lists"), "--valid", "0", "--test", "0"]), none)
    fl = os.path.join(d, "lists", "train.txt")
    rows = parse_filelist(fl)
    ms, spk = os.path.join(d, "mel_stats.npz"), os.path.join(d, "spk_embs.npz")
    cli.main(["preprocess-mel-stats", "--filelist", fl, "--out", ms, *dev_flags])
    fe = os.path.join(tmp, "frontends")
    embs = _counted("cli preprocess-spk-embs", lambda: cli.main_preprocess_spk_embs(
        ["--filelist", fl, "--speaker-embedder", os.path.join(fe, "port_speaker-embedder.pt"),
         "--out", spk, *dev_flags]), none)
    n_units = _counted("cli preprocess-units", lambda: cli.main_preprocess_units(
        ["--filelist", fl, "--hubert", os.path.join(fe, "port_hubert.pt"), "--kmeans",
         os.path.join(fe, "port_kmeans.npz"), *dev_flags]), none)
    prep_s = time.perf_counter() - t0
    units = [np.load(r[0].rsplit(".", 1)[0] + ".units.npz")["units"] for r in rows]
    if (len(rows) != TRAIN_UTTS or sorted(embs) != list(range(TRAIN_SPEAKERS))
            or n_units != TRAIN_UTTS or not all(np.isfinite(v).all() for v in embs.values())
            or min(len(u) for u in units) < 10):
        raise AssertionError(f"train2 preprocessing: {len(rows)} rows, speakers {sorted(embs)},"
                             f" {n_units} unit sidecars")
    print(f"train2: make-filelist, mel stats, {len(embs)} speaker embeddings (WavLM-Large + "
          f"ECAPA, exact lengths) and {n_units} unit sidecars (mHuBERT-base + k-means, "
          f"{min(len(u) for u in units)}-{max(len(u) for u in units)} units) in {prep_s:.1f} s",
          flush=True)

    ck = os.path.join(d, "ckpt")
    flags = ["--filelist", fl, "--spk-embs", spk, "--mel-stats", ms, "--decoder", step1_ckpt,
             "--checkpoint-dir", ck, "--log-dir", os.path.join(d, "log"), "--batch-size",
             str(TRAIN_BATCH), *dev_flags]
    per_epoch = TRAIN_UTTS // TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for name, extra, epochs in (("train2", [], 2), ("train2_resume", ["--resume"], 3)):
        res = _counted(f"cli train-step2{' --resume' if extra else ''}",
                       lambda: cli.main_train_step2(flags + ["--n-epochs", str(epochs), *extra]),
                       none)
        losses = np.array([[m[k] for k in ("prior_loss", "diff_loss")] for m in res["metrics"]])
        steps = per_epoch * (1 if extra else epochs)
        print(f"  {name}: epochs {res['start_epoch']}..{epochs - 1} from step "
              f"{res['first_step']}, {res['steps']} steps, {res['ms_per_step']:.1f} ms a step "
              "after the first (host clock, each step's metrics on the host); prior / diff "
              "losses " + " ".join("/".join(f"{x:.4f}" for x in r) for r in losses)
              + f"; {smi}", flush=True)
        if not np.isfinite(losses).all() or len(losses) != steps:
            raise AssertionError(f"{name}: losses {losses}")
        runs[name] = {k: v for k, v in res.items() if k != "metrics"}
        runs[name]["losses"] = losses.tolist()
    peak = torch.cuda.max_memory_allocated(dev)
    resumed = runs["train2_resume"]
    tree = checkpoint.load_checkpoint(resumed["checkpoint"])
    if (resumed["start_epoch"], resumed["first_step"], resumed["steps"]) != (
            2, 2 * per_epoch, 3 * per_epoch) or not resumed["checkpoint"].endswith("step_3") \
            or "decoder" in tree or "unit_encoder" not in tree:
        raise AssertionError(f"train2 resume: {resumed}, checkpoint keys {sorted(tree)}")

    # whole loop steps from the resumed state; the frozen decoder after them
    args = cli.step2_parser().parse_args(flags)
    _, loop, decoder = cli.build_step2(args)
    loop.resume()
    raw = next(iterate_batches(loop.dataset, loop.collator, TRAIN_BATCH,
                               key=np.random.default_rng(cfg.train.seed)))
    gen = torch.Generator(device=dev).manual_seed(0)
    prof = _profiled_steps(torch, lambda: loop.step_once(raw, gen), peak,
                           f"STEP2 step at full width (batch {TRAIN_BATCH})", smi)
    prof["ms_per_step"] = float(np.median(runs["train2"]["step_seconds"][1:]
                                          + resumed["step_seconds"][1:])) * 1e3
    step1 = artifacts.load_decoder_bundle(step1_ckpt, cfg.decoder).state_dict
    moved = [k for k, v in decoder.state_dict().items() if not torch.equal(v.cpu(), step1[k])]
    held = {id(p) for g in loop.optimizer.param_groups for p in g["params"]}
    in_opt = sum(id(p) in held for p in decoder.parameters())
    grads = sum(p.grad is not None or p.requires_grad for p in decoder.parameters())
    print(f"  {prof['ms_per_step']:.1f} ms a STEP2 step (median after each run's first, host "
          f"clock); frozen decoder after {loop.step} steps: {len(moved)} of "
          f"{len(step1)} parameters moved, {in_opt} in the optimizer, {grads} with a gradient "
          f"or requiring one; {smi}", flush=True)
    if moved or in_opt or grads:
        raise AssertionError(f"frozen decoder: moved {moved[:5]}, {in_opt} in the optimizer, "
                             f"{grads} gradients")
    del loop, decoder, raw
    check = step_check.card_vs_cpu_step2(dev)
    print(f"  small f32 STEP2 step, card vs CPU (strict f32, cuDNN deterministic, the same "
          f"draws): largest relative difference of the losses and the gradient norm "
          f"{check['max_rel']:.3e} (bound {check['bound']:.0e})", flush=True)

    # the STEP2 unit encoder through `cli finetune`, the adapted decoder served
    wav, _, spk_id = rows[0]
    spk_npy = os.path.join(d, "spk.npy")
    np.save(spk_npy, embs[int(spk_id)])
    ft = _counted("cli finetune --unit-encoder <STEP2 checkpoint>", lambda: cli.main_finetune(
        ["--reference", wav, "--decoder", step1_ckpt, "--unit-encoder", resumed["checkpoint"],
         "--units", wav.rsplit(".", 1)[0] + ".units.npz", "--spk-emb", spk_npy, "--output-dir",
         os.path.join(d, "adapted"), "--n-iters", str(TRAIN2_FT_ITERS), "--seed", "0",
         "--device", "cuda"]), none)
    losses = np.asarray(ft["losses"])
    print(f"  cli finetune with the STEP2 unit encoder: {ft['units']} units, losses "
          + " ".join(f"{x:.4f}" for x in losses), flush=True)
    if losses.shape != (TRAIN2_FT_ITERS,) or not np.isfinite(losses).all():
        raise AssertionError(f"STEP2 fine-tune losses: {losses}")
    served = _served_request(torch, cli, "STEP2-adapted decoder served",
                             ["--checkpoint", ckpt_path, "--decoder", ft["output"]], per_call,
                             os.path.join(d, "adapted"), cfg.data.hop_length)
    bundle = artifacts.load_decoder_bundle(ft["output"], cfg.decoder)
    paths = compare_paths(torch, dev, dict(artifacts.read(ckpt_path), decoder=bundle.state_dict,
                                           spk_emb=bundle.spk_emb),
                          per_call, runs=ADAPT_RUNS, vocoder=False, what="STEP2-adapted ")
    torch.cuda.empty_cache()
    res = {"runs": runs, "profile": prof, "step_check": check, "paths": paths,
           "preprocess_s": prep_s,
           "finetune": {k: v for k, v in ft.items() if k != "losses"}, "card": smi,
           "phase_s": time.perf_counter() - t_phase}
    print(f"train2 phase: {res['phase_s']:.1f} s", flush=True)
    return res, fl, served


# The GAN phase (after train2): `cli train-vocoder` at the published BigVGAN
# 22 kHz widths with the full MPD and MRD on the train2 corpus, GAN_STEPS
# steps and GAN_RESUMED more after --resume, at JAX's segment and batch
GAN_STEPS, GAN_RESUMED, GAN_SEGMENT, GAN_BATCH = 6, 2, 8192, 16


def vocoder_gan(torch, dev, tmp, ckpt_path, filelist, per_call, smi):
    """BigVGAN's GAN training on the card through `cli train-vocoder`
    (GAN_STEPS steps saving at the last, then --resume to GAN_STEPS +
    GAN_RESUMED; no kernel launched: the generator trains on its plain
    path), every metric finite; whole steps under torch.profiler from the
    saved state; then the trained generator served by `cli inference
    --vocoder` on the serving defaults (K5 / K6, exact launches) and on the
    plain path, and held to the plain vocoder as compare_paths holds the
    kernel vocoder (VOC_RATIO). Returns the measurements and the served
    request's launches."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.data.dataset import parse_filelist
    from unitspeech_tpu_torch.tools import step_check
    from unitspeech_tpu_torch.train.vocoder_loop import (
        GanTrainer,
        SegmentSampler,
        VocoderTrainConfig,
    )
    from unitspeech_tpu_torch.utils import artifacts, checkpoint
    from unitspeech_tpu_torch.utils.audio import load_wav

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "vocoder_gan")
    os.makedirs(d)
    cfg = MainConfig()
    ck = os.path.join(d, "ckpt")
    flags = ["--filelist", filelist, "--batch-size", str(GAN_BATCH), "--segment-size",
             str(GAN_SEGMENT), "--checkpoint-dir", ck, "--save-every", str(GAN_STEPS),
             "--device", "cuda"]
    none = {k: 0 for k in KERNELS}
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for name, extra, steps in (("gan", [], GAN_STEPS),
                               ("gan_resume", ["--resume"], GAN_STEPS + GAN_RESUMED)):
        res = _counted(f"cli train-vocoder{' --resume' if extra else ''}",
                       lambda: cli.main_train_vocoder(flags + ["--steps", str(steps), *extra]),
                       none)
        m = res["final_metrics"]
        print(f"  {name}: to step {res['steps']} in {res['seconds']:.1f} s (modules built and "
              "initialized, or restored, included); last step: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in m.items()) + f"; {smi}", flush=True)
        if res["steps"] != steps or set(m) == {"already_complete", "restored_step"} or not all(
                np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name}: {res}")
        runs[name] = res
    peak = torch.cuda.max_memory_allocated(dev)
    saved = checkpoint.latest_checkpoint(ck)
    if not saved.endswith(f"step_{GAN_STEPS + GAN_RESUMED}") or sorted(os.listdir(ck)) != sorted(
            [f"step_{GAN_STEPS}", f"step_{GAN_STEPS + GAN_RESUMED}"]):
        raise AssertionError(f"GAN checkpoints: {os.listdir(ck)}")

    tcfg = VocoderTrainConfig(segment_size=GAN_SEGMENT, batch_size=GAN_BATCH)
    wavs = [load_wav(r[0])[0] for r in parse_filelist(filelist)]
    trainer = GanTrainer(cfg, tcfg, len(wavs), dev, checkpoint.load_checkpoint(saved))
    sampler = SegmentSampler(wavs, GAN_SEGMENT, GAN_BATCH, tcfg.seed)

    def step():
        metrics = trainer.train_step(torch.from_numpy(sampler.next()).to(dev))
        torch.stack(list(metrics.values())).tolist()

    prof = _profiled_steps(torch, step, peak, f"GAN step at the published widths (batch "
                           f"{GAN_BATCH} x {GAN_SEGMENT} samples, full MPD and MRD)", smi)
    # the host clock between the CLI runs' step ends, unprofiled (the
    # profiled wall above is for the idle share alone)
    prof["ms_per_step"] = float(np.median(runs["gan"]["step_seconds"]
                                          + runs["gan_resume"]["step_seconds"])) * 1e3
    print(f"  {prof['ms_per_step']:.1f} ms a GAN step (median of the intervals between step "
          f"ends in the two CLI runs, each run's first step excluded, host clock); {smi}",
          flush=True)
    del trainer
    check = step_check.card_vs_cpu_gan(dev)
    print(f"  small f32 GAN step, card vs CPU (strict f32, cuDNN deterministic): largest "
          f"relative difference of the losses and the discriminator's gradient norm "
          f"{check['max_rel']:.3e} (bound {check['bound']:.0e}), the generator's gradient "
          f"norm {check['rel']['gen_grad_norm']:.3e} (bound "
          f"{check['bounds']['gen_grad_norm']:.0e})", flush=True)

    served = _served_request(torch, cli, "trained generator served",
                             ["--checkpoint", ckpt_path, "--vocoder", saved], per_call,
                             os.path.join(d, "trained"), cfg.data.hop_length)
    plain = [r for r in RUNS if r[0] in ("plain", "plain_f32")]
    paths = compare_paths(torch, dev, dict(artifacts.read(ckpt_path),
                                           vocoder=artifacts.load_vocoder_params(saved,
                                                                                 cfg.vocoder)),
                          per_call, runs=plain, what="trained generator: ")
    torch.cuda.empty_cache()
    res = {"runs": runs, "profile": prof, "step_check": check, "paths": paths, "card": smi,
           "phase_s": time.perf_counter() - t_phase}
    print(f"vocoder_gan phase: {res['phase_s']:.1f} s", flush=True)
    return res, served


# The evaluation phase (after vocoder_gan), on the train2 corpus (texts
# beside the wavs): eval.generate_samples per speaker on EVAL_SPEAKERS
# speakers, EVAL_SENTENCES sentences each after an EVAL_FT_ITERS-step `cli
# finetune` from the wav (the frontends phase's SSL files), the flat mode on
# the base checkpoint with EVAL_FLAT sentences, `cli evaluate` on the card,
# finetune_decoder_batched at S = BATCHED_S for BATCHED_ITERS steps, and the
# two examples
EVAL_SPEAKERS, EVAL_SENTENCES, EVAL_FT_ITERS, EVAL_FLAT, EVAL_SEED = 2, 2, 10, 2, 70
BATCHED_S, BATCHED_ITERS = 2, 10
# the `module:function` hooks `cli evaluate` loads (stand-ins for Whisper and
# the MOS predictor, which need downloads; the speaker hook is the port's
# WavLM + ECAPA embedder)
EVAL_HOOKS = """import numpy as np
import torch

from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import MainConfig

SPEAKER_EMBEDDER = {path!r}
_embedder = []


def transcribe(wav, sr):
    return "hello world" if len(wav) % 2 == 0 else "hello word"


def predict_mos(wav, sr):
    return 3.0 + min(len(wav) / (10.0 * sr), 1.0)


def embed(wav, sr):
    if not _embedder:
        _embedder.append(cli.load_speaker_embedder(SPEAKER_EMBEDDER, MainConfig(),
                                                   torch.device({device!r})))
    return cli.embed_speaker(_embedder[0], wav, sr, MainConfig())[0]
"""


def _sample_want(per_call, cfg, bucket):
    """Launches of one served request on the serving default at a frame
    bucket: STEPS estimator calls (K4 at the bucket's attention sites) and
    one vocoder call."""
    want = _served_want(per_call, STEPS)
    want["fused_rezero_attention"] = STEPS * _k4_per_call(cfg, bucket)
    return want


def _units_card_vs_cpu(torch, cli, ssl, cfg, wavs, dev):
    """The unit streams of `wavs` [(wav, sr)] through the evaluate hook's
    extractor on the card and on the CPU in f32; per wav, whether the
    deduplicated streams are equal, the frames whose unit differs and the
    largest relative k-means margin among them (UNIT_MARGIN: a near-tie)."""
    from unitspeech_tpu_torch.models.ssl.kmeans import kmeans_distances
    from unitspeech_tpu_torch.utils.precision import strict_f32

    encs = {k: cli.build_unit_extractor(ssl["hubert"], ssl["kmeans"], cfg, device)
            for k, device in (("card", dev), ("cpu", torch.device("cpu")))}
    out = []
    with strict_f32(), torch.no_grad():
        for wav, sr in wavs:
            wav16 = encs["cpu"].maybe_resample(wav, sr)
            feats = {k: e.dense_model.features(wav16) for k, e in encs.items()}
            units = {k: e.quantizer(feats[k]) for k, e in encs.items()}
            cpu = feats["cpu"]
            dist = kmeans_distances(cpu, torch.from_numpy(encs["cpu"].quantizer.centroids))
            full = np.sort(dist.numpy() + (cpu.numpy() ** 2).sum(1, keepdims=True), axis=1)
            margin = (full[:, 1] - full[:, 0]) / full[:, 0]
            differ = units["card"] != units["cpu"]
            streams = [e(wav16)["units"] for e in encs.values()]
            out.append({"frames": int(differ.size), "units_differ": int(differ.sum()),
                        "stream_equal": bool(np.array_equal(*streams)),
                        "stream_len": int(len(streams[1])),
                        "max_margin_where_differ": float(margin[differ].max()) if differ.any()
                        else None})
    del encs
    return out


def evaluation(torch, dev, tmp, ckpt_path, filelist, per_call, smi):
    """Evaluation on the card through the port's entry points: eval/
    generate_samples per speaker (each speaker's first corpus wav adapts
    the base decoder through `cli finetune` from the wav alone, then its
    next EVAL_SENTENCES texts are synthesized on the serving defaults) and
    flat (the base checkpoint, EVAL_FLAT sentences); every request, warm-up
    included, with exactly its bucket's launches and its wav y_length x hop
    long, the .npy timings and the summaries agreeing with the samples; one
    sample of each mode again on the plain path from the same seed, within
    the TTS bounds; `cli evaluate --device cuda` on the first speaker's
    samples (ASR / MOS stubs, the port's WavLM + ECAPA as the speaker hook,
    mHuBERT + k-means) with a full row, then each sample against itself
    (UER 0), and two samples' unit streams against the CPU's;
    finetune_decoder_batched at full width (BATCHED_S speakers,
    BATCHED_ITERS steps) equal to single finetune_decoder runs on the same
    draws under deterministic algorithms; the demo and the speaker probe on
    the card; one flat request's device time, launches and idle share
    under torch.profiler. Returns the measurements and the phase's
    launches (every served eval request)."""
    import types

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.data.dataset import parse_filelist
    from unitspeech_tpu_torch.eval import generate_samples, harness
    from unitspeech_tpu_torch.examples import demo, speaker_probing
    from unitspeech_tpu_torch.infer.tts import Synthesizer
    from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.train.finetune import finetune_decoder, finetune_decoder_batched
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.audio import load_wav

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "eval")
    os.makedirs(d)
    cfg = MainConfig()
    hop, num_down = cfg.data.hop_length, cfg.decoder.num_downsamplings
    fe = os.path.join(tmp, "frontends")
    ssl = {"speaker-embedder": os.path.join(fe, "port_speaker-embedder.pt"),
           "hubert": os.path.join(fe, "port_hubert.pt"),
           "kmeans": os.path.join(fe, "port_kmeans.npz")}
    by_spk = {}
    for row in parse_filelist(filelist):
        by_spk.setdefault(row[2], []).append(row)
    speakers = sorted(by_spk)[:EVAL_SPEAKERS]
    lists = {"refs": [by_spk[s][0] for s in speakers],
             "evals": [r for s in speakers for r in by_spk[s][1:1 + EVAL_SENTENCES]]}
    for name, rows in lists.items():
        with open(os.path.join(d, f"{name}.txt"), "w", encoding="utf-8") as f:
            f.write("".join("|".join(r) + "\n" for r in rows))
    flat_texts = _ipa_sentences(np.random.default_rng(EVAL_SEED), EVAL_FLAT, 4, 10)
    with open(os.path.join(d, "sentences.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(flat_texts) + "\n")

    # every request the phase serves, with its launches (Synthesizer.__call__
    # wrapped: the counters set to 0 just before it and read just after)
    served, finetunes = [], []
    call, finetune = Synthesizer.__call__, cli.main_finetune
    wrappers = _kernel_wrappers()

    def counted_call(self, token_ids, generator=None, forced_total_frames=None, **kw):
        for w in wrappers.values():
            w.launches = 0
        wav, sr, mel = call(self, token_ids, generator, forced_total_frames, **kw)
        # the waveform is on the host: nothing the call launched may be left
        queued = dev.type == "cuda" and not torch.cuda.current_stream(dev).query()
        frames = int(mel.shape[0])
        served.append({"tokens": len(token_ids), "frames": frames, "samples": len(wav),
                       "bucket": choose_bucket(fix_len_compatibility(frames, num_down),
                                               self.frame_buckets),
                       "kernels": bool(self.models.decoder.estimator.use_kernels),
                       "launches": {k: w.launches for k, w in wrappers.items()},
                       "queued_after": queued, "mel": mel.float().cpu().numpy()})
        return wav, sr, mel

    def counted_finetune(argv):
        stats = _counted("eval cli finetune", lambda: finetune(argv), {k: 0 for k in KERNELS})
        finetunes.append({k: v for k, v in stats.items() if k != "losses"})
        return stats

    common = ["--text-encoder", ckpt_path, "--duration-predictor", ckpt_path, "--vocoder",
              ckpt_path, "--ipa", "--seed", str(EVAL_SEED), "--device", dev.type]
    Synthesizer.__call__, cli.main_finetune = counted_call, counted_finetune
    try:
        t0 = time.perf_counter()
        per_dir = os.path.join(d, "per_speaker")
        per = generate_samples.main(
            ["--reference-filelist", os.path.join(d, "refs.txt"), "--eval-filelist",
             os.path.join(d, "evals.txt"), "--decoder", ckpt_path, "--unit-encoder", ckpt_path,
             "--speaker-embedder", ssl["speaker-embedder"], "--hubert", ssl["hubert"],
             "--kmeans", ssl["kmeans"], "--finetune-iters", str(EVAL_FT_ITERS), "--out-dir",
             per_dir, *common])
        per_s = time.perf_counter() - t0
        n_per = len(served)
        t0 = time.perf_counter()
        flat_dir = os.path.join(d, "flat")
        flat = generate_samples.main(["--sentences", os.path.join(d, "sentences.txt"),
                                      "--decoder", ckpt_path, "--out-dir", flat_dir, *common])
        flat_s = time.perf_counter() - t0
    finally:
        Synthesizer.__call__, cli.main_finetune = call, finetune

    # the served requests: a warm-up and the samples of each set
    sets = [(os.path.join(per_dir, f"speaker_{s}"), [r[1] for r in lists["evals"] if r[2] == s])
            for s in speakers] + [(flat_dir, flat_texts)]
    records, i = [], 0
    for out_dir, texts in sets:
        warm, samples = served[i], served[i + 1:i + 1 + len(texts)]
        i += 1 + len(texts)
        for k, (rec, text) in enumerate(zip([warm] + samples, texts[:1] + texts)):
            want = _sample_want(per_call, cfg, rec["bucket"])
            if (rec["launches"] != want or not rec["kernels"]
                    or rec["tokens"] != len(phonemes_to_sequence(text))
                    or rec["samples"] != rec["frames"] * hop):
                raise AssertionError(f"eval request {out_dir} #{k}: {rec} (launches expected "
                                     f"{want})")
        for k, rec in enumerate(samples):
            wav, sr = load_wav(os.path.join(out_dir, f"sample_{k:04d}.wav"))
            if len(wav) != rec["frames"] * hop or sr != cfg.data.sampling_rate or not np.any(wav):
                raise AssertionError(f"{out_dir} sample {k}: {len(wav)} samples at {sr} Hz")
        timings = harness.EvalTimings.load(os.path.join(out_dir, "timings.npz"))
        if not np.array_equal(timings.speech_duration,
                              [r["samples"] / cfg.data.sampling_rate for r in samples]):
            raise AssertionError(f"{out_dir}: timings {timings.speech_duration}")
        records.append({"dir": out_dir, "samples": samples, "warmup": warm, "timings": timings})
    if i != len(served) or n_per != sum(1 + len(t) for _, t in sets[:-1]):
        raise AssertionError(f"eval: {len(served)} requests served, {i} expected")
    proc = np.concatenate([r["timings"].processing_time for r in records[:-1]])
    speech = np.concatenate([r["timings"].speech_duration for r in records[:-1]])
    if not (np.array_equal(np.load(os.path.join(per_dir, "processing_time.npy")), proc)
            and np.array_equal(np.load(os.path.join(per_dir, "speech_duration.npy")), speech)
            and per["n"] == len(proc) == EVAL_SPEAKERS * EVAL_SENTENCES
            and list(per["per_speaker"]) == speakers and flat["n"] == EVAL_FLAT
            and len(finetunes) == EVAL_SPEAKERS and np.all(proc > 0)):
        raise AssertionError(f"eval summaries: {per}, {flat}, {len(finetunes)} fine-tunes")
    launches = {k: sum(r["launches"][k] for r in served) for k in KERNELS}
    queued = sum(r["queued_after"] for r in served)
    print(f"eval: {len(served)} requests served on the serving defaults (warm-ups included), "
          f"each with its bucket's launches (buckets "
          f"{sorted({r['bucket'] for r in served})}); {queued} left work queued on the card "
          f"when its waveform reached the host; per-speaker RTF {per['rtf']:.4f} "
          f"({per_s:.1f} s with {EVAL_SPEAKERS} fine-tunes of {EVAL_FT_ITERS} steps: "
          + ", ".join(f"{f['seconds']:.2f} s loop, {f['ms_per_step']:.1f} ms a step"
                      for f in finetunes)
          + f"), flat RTF {flat['rtf']:.4f} ({flat_s:.1f} s); {smi}", flush=True)

    # one sample of each mode again on the plain path, from the same seed
    plain_routes = dict(use_kernels=False, use_int8_deep=False, use_deep=False,
                        use_resample=False, use_i8pre_deep=False)
    plain = {}
    for mode, rec, decoder, text in (
            ("per_speaker", records[0], finetunes[0]["output"], sets[0][1][0]),
            ("flat", records[-1], ckpt_path, flat_texts[0])):
        ns = types.SimpleNamespace(checkpoint=None, config=None, decoder=decoder,
                                   text_encoder=ckpt_path, duration_predictor=ckpt_path,
                                   vocoder=ckpt_path, spk_emb=None)
        synth = Synthesizer(cli._load_tts_models(ns, dev, torch.bfloat16, plain_routes))
        gen = torch.Generator(device=dev).manual_seed(cli.chunk_seed(EVAL_SEED, 0))
        mel = _counted(f"eval {mode} sample 0, plain", lambda: synth(
            phonemes_to_sequence(text), gen, diffusion_steps=STEPS, text_gradient_scale=1.0,
            spk_gradient_scale=1.0)[2],
            {k: 0 for k in KERNELS}).float().cpu().numpy()
        ref = rec["samples"][0]["mel"]
        if mel.shape != ref.shape:
            raise AssertionError(f"eval {mode}: plain mel {mel.shape}, kernels {ref.shape}")
        plain[mode] = _mel_bounds(f"eval {mode} sample 0 ({mel.shape[0]} frames)", ref, mel)
        del synth

    # cli evaluate on the card: the first speaker's samples
    hooks = os.path.join(d, "eval_stub_hooks.py")
    with open(hooks, "w") as f:
        f.write(EVAL_HOOKS.format(path=ssl["speaker-embedder"], device=str(dev)))
    sys.path.insert(0, d)
    spk0 = speakers[0]
    with open(os.path.join(d, "evals0.txt"), "w", encoding="utf-8") as f:
        f.write("".join("|".join(r) + "\n" for r in lists["evals"] if r[2] == spk0))
    unit_flags = ["--hubert", ssl["hubert"], "--kmeans", ssl["kmeans"], "--device", dev.type]
    t0 = time.perf_counter()
    row = _counted("cli evaluate", lambda: cli.main_evaluate(
        ["--samples-dir", records[0]["dir"], "--filelist", os.path.join(d, "evals0.txt"),
         "--reference-wav", lists["refs"][0][0], "--asr-hook", "eval_stub_hooks:transcribe",
         "--mos-hook", "eval_stub_hooks:predict_mos", "--spk-hook", "eval_stub_hooks:embed",
         *unit_flags]), {k: 0 for k in KERNELS})
    evaluate_s = time.perf_counter() - t0
    own = cli.main_evaluate(["--samples-dir", records[0]["dir"], "--uer-ref-dir",
                             records[0]["dir"], "--out", os.path.join(d, "self.csv"),
                             *unit_flags])
    sys.path.remove(d)
    keys = {"rtf", "rtf_mean_of_ratios", "wer", "cer", "mos_mean", "mos_min", "mos_max",
            "uer_mean", "uer_median", "uer_max", "spk_cosine_mean", "spk_cosine_min",
            "n_samples"}
    if set(row) != keys | {"mean_processing_s", "mean_speech_s", "n"} or not all(
            np.isfinite(v) for v in row.values()) or row["n_samples"] != EVAL_SENTENCES:
        raise AssertionError(f"cli evaluate row: {row}")
    if own["uer_max"] != 0.0:
        raise AssertionError(f"cli evaluate, each sample against itself: {own}")
    units = _units_card_vs_cpu(torch, cli, ssl, cfg, [
        load_wav(os.path.join(r["dir"], "sample_0000.wav")) for r in records[:2]], dev)
    if not all(u["stream_equal"] or u["max_margin_where_differ"] <= UNIT_MARGIN for u in units):
        raise AssertionError(f"eval unit streams, card vs CPU: {units}")
    print(f"  cli evaluate --device cuda ({evaluate_s:.1f} s): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items())
          + f"; each sample against itself: UER {own['uer_max']}; unit streams, card vs CPU "
          f"(f32): {units}", flush=True)

    # finetune_decoder_batched at full width against single runs, the same
    # draws, under deterministic algorithms
    ckpt = artifacts.read(ckpt_path)
    inputs, spks = [], []
    for s, ft in zip(speakers, finetunes):
        path = min((r[0] for r in by_spk[s]), key=lambda p: os.path.getsize(p))
        wav, sr = load_wav(path)
        with np.load(path.rsplit(".", 1)[0] + ".units.npz") as z:
            u, dur = z["units"], z["durations"]
        inputs.append(cli.finetune_inputs(cfg, wav, u, dur, ckpt["unit_encoder"],
                                          ckpt["mel_min"], ckpt["mel_max"],
                                          cli.DEFAULT_ADAPT_BUCKETS, dev))
        spks.append(torch.load(ft["output"], map_location=dev, weights_only=True)["spk_emb"])
    if len({tuple(x[1].shape) for x in inputs}) != 1:
        raise AssertionError(f"batched inputs at buckets {[x[1].shape for x in inputs]}")
    base = ckpt["decoder"]
    kw = dict(dtype=torch.bfloat16, segment_size=cfg.out_size, n_iters=BATCHED_ITERS,
              learning_rate=cfg.finetune.learning_rate, grad_clip=cfg.finetune.grad_clip)
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        stack, losses = _counted("finetune_decoder_batched", lambda: finetune_decoder_batched(
            cfg.decoder, {k: torch.stack([v] * BATCHED_S).to(dev) for k, v in base.items()},
            *(torch.stack(xs) for xs in zip(*inputs)), torch.stack(spks),
            generators=[torch.Generator(device=dev).manual_seed(EVAL_SEED + k)
                        for k in range(BATCHED_S)], **kw), {k: 0 for k in KERNELS})
        batched_s = time.perf_counter() - t0
        equal = []
        for k in range(BATCHED_S):
            state, single = finetune_decoder(
                cfg.decoder, base, *inputs[k], spks[k],
                generator=torch.Generator(device=dev).manual_seed(EVAL_SEED + k), **kw)
            equal.append(bool(np.array_equal(single, losses[k])) and all(
                torch.equal(stack[n][k], v) for n, v in state.items()))
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[2:]
    moved = float(max((stack[n][0] - base[n].to(dev)).abs().max() for n in base))
    batched = {"speakers": BATCHED_S, "iters": BATCHED_ITERS, "seconds": batched_s,
               "ms_per_step": 1e3 * batched_s / (BATCHED_S * BATCHED_ITERS),
               "losses": losses.tolist(), "equal_to_single": equal, "max_moved": moved,
               "bucket": int(inputs[0][1].shape[1])}
    print(f"  finetune_decoder_batched (S = {BATCHED_S}, {BATCHED_ITERS} steps, bf16, bucket "
          f"{batched['bucket']}, deterministic algorithms): {batched_s:.2f} s, "
          f"{batched['ms_per_step']:.1f} ms a step; each row equal to a single run: {equal}; "
          f"largest move {moved:.3e}; {smi}", flush=True)
    if not all(equal) or not np.isfinite(losses).all() or moved == 0.0:
        raise AssertionError(f"finetune_decoder_batched: {batched}")
    del stack, inputs

    # the examples on the card
    t0 = time.perf_counter()
    ex_demo = demo.main(["--output", os.path.join(d, "demo.wav")])
    baseline, disc, cont = speaker_probing.main([])
    examples = {"demo_seconds": ex_demo["seconds"], "demo_units": ex_demo["units"],
                "probe": {"baseline": baseline, "discrete": disc, "continuous": cont},
                "seconds": time.perf_counter() - t0}
    print(f"  examples on the card: demo {ex_demo['seconds']:.2f} s of audio, "
          f"{ex_demo['units']} units; speaker probe accuracies: discrete units {disc:.3f}, "
          f"continuous features {cont:.3f} (constant baseline {baseline:.3f}); "
          f"{examples['seconds']:.1f} s", flush=True)
    if not (os.path.getsize(os.path.join(d, "demo.wav")) > 44 and 0 <= disc <= 1
            and 0 <= cont <= 1):
        raise AssertionError(f"examples: {examples}")

    # one flat request under torch.profiler: device time, launches, idle share
    ns = types.SimpleNamespace(checkpoint=None, config=None, decoder=ckpt_path,
                               text_encoder=ckpt_path, duration_predictor=ckpt_path,
                               vocoder=ckpt_path, spk_emb=None)
    synth = Synthesizer(cli._load_tts_models(ns, dev, torch.bfloat16, cli.route_switches(
        types.SimpleNamespace(bf16=True, fast_kernels=True, int8=True, deep=False,
                              i8pre=False, resample=False))))
    ids = phonemes_to_sequence(flat_texts[0])
    walls = []

    def request():
        t = time.perf_counter()
        synth(ids, torch.Generator(device=dev).manual_seed(0), diffusion_steps=STEPS)
        walls.append(time.perf_counter() - t)

    request()
    act = kernel_breakdown.device_activity(request, PROFILED_STEPS)
    wall_ms = float(np.mean(walls[-PROFILED_STEPS:])) * 1e3
    profile = {"frames": records[-1]["samples"][0]["frames"],
               "bucket": records[-1]["samples"][0]["bucket"], "profiled_wall_ms": wall_ms,
               "device_ms": act["busy_ms"], "launches": act["launches"],
               "idle_share": 1.0 - act["busy_ms"] / wall_ms}
    print(f"  one flat request ({profile['frames']} frames, bucket {profile['bucket']}) under "
          f"torch.profiler (mean of {PROFILED_STEPS}): wall {wall_ms:.1f} ms, device busy "
          f"{act['busy_ms']:.2f} ms in {act['launches']:.0f} launches, idle share "
          f"{profile['idle_share']:.3f}; {smi}", flush=True)
    del synth
    torch.cuda.empty_cache()
    res = {"per_speaker": per, "flat": flat, "per_speaker_s": per_s, "flat_s": flat_s,
           "finetunes": finetunes, "buckets": [r["bucket"] for r in served],
           "queued_after": queued, "plain": plain, "evaluate": row, "evaluate_s": evaluate_s,
           "self_uer": own["uer_max"], "units_card_vs_cpu": units, "batched": batched,
           "examples": examples, "profile": profile, "card": smi,
           "phase_s": time.perf_counter() - t_phase}
    print(f"eval phase: {res['phase_s']:.1f} s", flush=True)
    return res, launches

# The extras phase (after eval): the textlesslib extras at full width from
# random checkpoints in the reference's formats (tools/extras_reference:
# Tacotron2Config(), WaveGlowConfig() with weight norm, cpc_base_config(),
# 100 codes), the frontends phase's full-width mHuBERT-base; 100 centroids
# for each stack from a 4 s synthetic 16 kHz wav's features
EXTRAS_SEED, EXTRAS_SECONDS, EXTRAS_CODES = 80, 4.0, 100
EXTRAS_DECODER_STEPS = 1000  # the decoder at length (the gate never fires)
EXTRAS_PROFILED_STEPS = 100  # decoder steps under torch.profiler
EXTRAS_CMP_STEPS = 100  # card vs CPU: Tacotron2 steps, WaveGlow on their mel
EXTRAS_F0_UTTS = 4
# card vs CPU in strict f32: relative L2 bounds (the F0 track: voicing equal,
# f0 within EXTRAS_BOUNDS["f0"] relative)
EXTRAS_BOUNDS = {"tacotron2": 1e-4, "waveglow": 1e-4, "denoiser": 1e-4, "denoiser_bias": 1e-4,
                 "cpc": 1e-5, "f0": 1e-4}


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _voiced_glide(seconds, seed):
    """The F0 oracle's harmonic glide (tests/test_f0_oracle.py synth_voiced:
    12 harmonics at 1/k, 120 -> 180 Hz, 20 dB SNR)."""
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 120 + 60 * t / t[-1]
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    sig = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 13))
    sig /= np.abs(sig).max()
    noise = np.random.default_rng(seed).standard_normal(t.size)
    noise *= np.sqrt((sig ** 2).mean() / 100.0 / (noise ** 2).mean())
    return (sig + noise).astype(np.float32)


def extras(torch, dev, tmp, smi):
    """The textlesslib extras on the card at full width: examples.resynthesis
    with the checkpoint stack (the frontends phase's mHuBERT-base as
    hubert-base-ls960 and 100 centroids, evenly spaced frames of its layer-6
    features of the wav; Tacotron2 + WaveGlow from_torch) on a 4 s wav, which must
    write n_steps x 256 samples; the CPC stack (build_unit_extractor,
    cpc-big-ll6k at depth 2) on the same wav and a vocoder; the default
    config's depth 6 must stop with the CPC depth ValueError; the decoder
    for EXTRAS_DECODER_STEPS steps (ms and launches a step); Tacotron2 with
    injected prenet masks, WaveGlow with injected noise, the denoiser, CPC
    features and the F0 track on the card against the CPU in strict f32;
    QuantizedFilelist with need_f0 over 4 utterances (the mHuBERT encoder:
    one F0 value a unit, the collater's 1-tuple; the CPC encoder raises the
    JAX package's tolerance error at these lengths); the GSLM example.
    No kernel of the port may launch. Returns the measurements and the
    phase's launches."""
    import dataclasses

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.data.quantize import QuantizedFilelist
    from unitspeech_tpu_torch.examples import gslm, resynthesis
    from unitspeech_tpu_torch.infer.unit_vocoder import TacotronVocoder, token_bucket
    from unitspeech_tpu_torch.models.ssl.cpc import CpcFeatureReader
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.models.tacotron2 import tacotron2_infer
    from unitspeech_tpu_torch.models.waveglow import noise_shapes, upsample_mel, waveglow_infer
    from unitspeech_tpu_torch.ops.f0 import extract_f0
    from unitspeech_tpu_torch.tools import extras_reference
    from unitspeech_tpu_torch.utils.audio import load_wav, write_wav
    from unitspeech_tpu_torch.utils.precision import strict_f32

    t_phase = time.perf_counter()
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    d = os.path.join(tmp, "extras")
    t0 = time.perf_counter()
    files = extras_reference.write_extras(d, seed=EXTRAS_SEED, n_codes=EXTRAS_CODES)
    fe = os.path.join(tmp, "frontends")
    files["hubert"] = os.path.join(fe, "port_hubert.pt")
    wav = resynthesis.default_wav(EXTRAS_SECONDS)
    files["wav"] = os.path.join(d, "in.wav")
    write_wav(files["wav"], wav, 16000)
    wav = load_wav(files["wav"])[0]
    cpc_reader = CpcFeatureReader.from_torch(files["cpc"], layer=2, device=dev)
    hub_reader = cli.build_unit_extractor(files["hubert"], os.path.join(fe, "port_kmeans.npz"),
                                          MainConfig(), dev).dense_model
    with strict_f32():
        feats, hub_feats = cpc_reader(wav), hub_reader(wav)
    # each stack's 100 centroids: evenly spaced frames of the wav's own
    # features (layer 6 of mHuBERT; the CPC LSTM's output), so the units vary
    for name, f in (("kmeans", hub_feats), ("kmeans_cpc", feats)):
        files[name] = os.path.join(d, f"{name}_100.npz")
        idx = np.linspace(0, len(f) - 1, EXTRAS_CODES).astype(int)
        KMeansQuantizer(np.ascontiguousarray(f[idx])).save(files[name])
    setup_s = time.perf_counter() - t0
    print(f"extras: random full-width checkpoints in the reference's formats (Tacotron2, "
          f"WaveGlow 12 flows x 8 layers x 256, CPC 512 / 256 x 2) written in {setup_s:.1f} s",
          flush=True)
    ckpt = ["--tacotron", files["tacotron"], "--waveglow", files["waveglow"], "--code-dict",
            files["code_dict"]]

    # resynthesis: the HuBERT stack through the example
    out_wav = os.path.join(d, "resynth.wav")
    t0 = time.perf_counter()
    hub = resynthesis.main(["--input", files["wav"], "--output", out_wav, "--hubert",
                            files["hubert"], "--kmeans", files["kmeans"], *ckpt])
    hub_wall = time.perf_counter() - t0
    out, sr = load_wav(out_wav)
    if not (sr == 22050 and len(out) == hub["samples"] and hub["samples"] % 256 == 0
            and 0 < hub["samples"] // 256 <= 2000 and np.isfinite(out).all()
            and hub["units"].size > 0):
        raise AssertionError(f"resynthesis (HuBERT): {len(out)} samples at {sr} Hz, {hub}")
    res = {"hubert": {"units": int(hub["units"].size), "uniform_bps": hub["uniform_bps"],
                      "unigram_bps": hub["unigram_bps"], "n_steps": hub["samples"] // 256,
                      "wall_s": hub_wall, "synth_s": hub["wall_s"],
                      "rtf": hub["wall_s"] / (hub["samples"] / 22050)}}
    print(f"  resynthesis, HuBERT stack (python -m unitspeech_tpu_torch.examples.resynthesis): "
          f"{hub['units'].size} units, {hub['uniform_bps']:.1f} / {hub['unigram_bps']:.1f} bps "
          f"(uniform / unigram), {res['hubert']['n_steps']} decoder steps -> {len(out)} samples; "
          f"{hub_wall:.2f} s with loading, {hub['wall_s']:.2f} s to encode and vocode (RTF "
          f"{res['hubert']['rtf']:.4f} of the output's duration)", flush=True)

    # the CPC stack on the same wav, and the default config's depth
    ucfg = MainConfig().unit_extractor
    cfg = dataclasses.replace(MainConfig(), unit_extractor=dataclasses.replace(
        ucfg, dense_model_name="cpc-big-ll6k", hubert_layer=2))
    with strict_f32():
        voc = TacotronVocoder.from_torch(files["tacotron"], files["code_dict"], files["waveglow"],
                                         device=dev)
        enc_cpc = cli.build_unit_extractor(files["cpc"], files["kmeans_cpc"], cfg, dev)
        t0 = time.perf_counter()
        units_cpc = enc_cpc(wav)["units"]
        out_cpc = voc(units_cpc)
        torch.cuda.synchronize()
        cpc_wall = time.perf_counter() - t0
    uni, unig = resynthesis.bitrates("cpc-big-ll6k", units_cpc.size, EXTRAS_CODES,
                                     EXTRAS_SECONDS)
    res["cpc"] = {"units": int(units_cpc.size), "uniform_bps": uni, "unigram_bps": unig,
                  "n_steps": len(out_cpc) // 256, "synth_s": cpc_wall,
                  "rtf": cpc_wall / (len(out_cpc) / 22050)}
    if not (units_cpc.size > 0 and len(out_cpc) % 256 == 0 and np.isfinite(out_cpc).all()):
        raise AssertionError(f"resynthesis (CPC): {res['cpc']}")
    print(f"  resynthesis, CPC stack (cpc-big-ll6k, depth 2): {units_cpc.size} units, "
          f"{uni:.1f} / {unig:.1f} bps, {len(out_cpc)} samples, {cpc_wall:.2f} s (RTF "
          f"{res['cpc']['rtf']:.4f})", flush=True)
    try:
        resynthesis.main(["--input", files["wav"], "--output", out_wav, "--dense-model",
                          "cpc-big-ll6k", "--hubert", files["cpc"], "--kmeans",
                          files["kmeans_cpc"], *ckpt])
    except ValueError as e:
        res["cpc_default_depth"] = str(e)
    else:
        raise AssertionError("resynthesis --dense-model cpc-big-ll6k at the default depth 6 ran")
    print(f"  --dense-model cpc-big-ll6k at the default config's depth: "
          f"{res['cpc_default_depth']}", flush=True)

    # the decoder at length, and WaveGlow over a whole decoder buffer
    ids = voc.tts_input.get_ids(" ".join(map(str, hub["units"])))
    tokens = torch.zeros((1, token_bucket(len(ids))), dtype=torch.long)
    tokens[0, :len(ids)] = torch.from_numpy(ids.astype(np.int64))
    tokens, lengths = tokens.to(dev), torch.tensor([len(ids)], device=dev)
    long_cfg = dataclasses.replace(voc.tacotron.cfg, gate_threshold=1.1,
                                   max_decoder_steps=EXTRAS_DECODER_STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    with strict_f32():
        tacotron2_infer(voc.tacotron, tokens, lengths, generator=gen,
                        cfg=dataclasses.replace(long_cfg, max_decoder_steps=8))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long = tacotron2_infer(voc.tacotron, tokens, lengths, generator=gen, cfg=long_cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / EXTRAS_DECODER_STEPS
        act = kernel_breakdown.device_activity(lambda: tacotron2_infer(
            voc.tacotron, tokens, lengths, generator=gen,
            cfg=dataclasses.replace(long_cfg, max_decoder_steps=EXTRAS_PROFILED_STEPS)), 1)
        mel = long[1]
        waveglow_infer(voc.waveglow, mel[:, :8], sigma=0.666, generator=gen)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = waveglow_infer(voc.waveglow, mel, sigma=0.666, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    audio_s = audio.shape[1] / 22050
    res["decoder"] = {"steps": int(long[4][0]), "ms_per_step": decode_ms,
                      "launches_per_step": act["launches"] / EXTRAS_PROFILED_STEPS,
                      "device_ms_per_step": act["busy_ms"] / EXTRAS_PROFILED_STEPS}
    res["waveglow"] = {"frames": int(mel.shape[1]), "audio_s": audio_s,
                       "ms_per_audio_s": float(np.median(times)) * 1e3 / audio_s}
    if not (int(long[4][0]) == EXTRAS_DECODER_STEPS and torch.isfinite(mel).all()
            and torch.isfinite(audio).all()):
        raise AssertionError(f"the decoder at length: {res['decoder']}")
    print(f"  Tacotron2 decoder, {EXTRAS_DECODER_STEPS} steps at full width (f32, the gate "
          f"never fires): {decode_ms:.3f} ms a step (host clock), "
          f"{res['decoder']['launches_per_step']:.1f} launches and "
          f"{res['decoder']['device_ms_per_step']:.3f} ms of device time a step "
          f"(torch.profiler, {EXTRAS_PROFILED_STEPS} steps); WaveGlow over the "
          f"{mel.shape[1]}-frame buffer ({audio_s:.2f} s of audio): "
          f"{res['waveglow']['ms_per_audio_s']:.2f} ms a second of audio (median of 3); {smi}",
          flush=True)

    # card vs CPU in strict f32
    cpu = torch.device("cpu")
    cmp_cfg = dataclasses.replace(voc.tacotron.cfg, max_decoder_steps=EXTRAS_CMP_STEPS)
    masks = torch.rand((EXTRAS_CMP_STEPS, 2, 1, cmp_cfg.prenet_dim),
                       generator=torch.Generator().manual_seed(1)) < 0.5
    errs = {}
    with strict_f32():
        voc_cpu = TacotronVocoder.from_torch(files["tacotron"], files["code_dict"],
                                             files["waveglow"], device=cpu)
        card = tacotron2_infer(voc.tacotron, tokens, lengths, prenet_masks=masks.to(dev),
                               cfg=cmp_cfg)
        ref = tacotron2_infer(voc_cpu.tacotron, tokens.cpu(), lengths.cpu(), prenet_masks=masks,
                              cfg=cmp_cfg)
        errs["tacotron2"] = _rel_l2(card[1].cpu(), ref[1])
        mel_cpu = ref[1]
        t_g = upsample_mel(voc_cpu.waveglow, mel_cpu).shape[2]
        rng = np.random.default_rng(2)
        noise = [rng.standard_normal(s).astype(np.float32)
                 for s in noise_shapes(voc.waveglow.cfg, 1, t_g)]
        wg_card = waveglow_infer(voc.waveglow, mel_cpu.to(dev), sigma=0.666, noise=noise)
        wg_cpu = waveglow_infer(voc_cpu.waveglow, mel_cpu, sigma=0.666, noise=noise)
        errs["waveglow"] = _rel_l2(wg_card.cpu(), wg_cpu)
        den_card = voc.denoiser(wg_cpu.to(dev), 0.1)
        den_cpu = voc_cpu.denoiser(wg_cpu, 0.1)
        errs["denoiser_bias"] = _rel_l2(voc.denoiser.bias_spec.cpu(), voc_cpu.denoiser.bias_spec)
        errs["denoiser"] = _rel_l2(den_card.cpu(), den_cpu)
        cpc_cpu = CpcFeatureReader.from_torch(files["cpc"], layer=2, device=cpu)
        errs["cpc"] = _rel_l2(feats, cpc_cpu(wav))
        glide = _voiced_glide(1.0, 0)
        f0_card = extract_f0(torch.from_numpy(glide).to(dev))
        f0_cpu = extract_f0(torch.from_numpy(glide))
    voiced = f0_cpu > 0
    f0_rel = float((np.abs(f0_card - f0_cpu)[voiced] / f0_cpu[voiced]).max())
    errs["f0"] = f0_rel
    f0_voicing_equal = bool(np.array_equal(f0_card > 0, voiced))
    res["card_vs_cpu"] = {"errors": errs, "bounds": EXTRAS_BOUNDS,
                          "f0_voicing_equal": f0_voicing_equal, "f0_voiced": int(voiced.sum())}
    print("  card vs CPU (strict f32), relative L2 (F0: largest relative error) beside its "
          "bound: " + ", ".join(f"{k} {v:.3e} (<= {EXTRAS_BOUNDS[k]:.0e})" for k, v in
                                errs.items()) + f"; F0 voicing equal: {f0_voicing_equal} "
          f"({int(voiced.sum())} of {voiced.size} frames voiced)", flush=True)
    if not (f0_voicing_equal and all(errs[k] <= EXTRAS_BOUNDS[k] for k in EXTRAS_BOUNDS)):
        raise AssertionError(f"extras card vs CPU: {res['card_vs_cpu']}")
    del voc_cpu, cpc_cpu

    # the F0 stream over a quantized filelist
    rows = []
    for i in range(EXTRAS_F0_UTTS):
        p = os.path.join(d, f"f0_{i}.wav")
        write_wav(p, _voiced_glide(1.5 + 0.25 * i, 10 + i), 16000)
        rows.append(f"{p}|utterance {i}|spk{i % 2}")
    with open(os.path.join(d, "f0_list.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    enc_hub = cli.build_unit_extractor(files["hubert"], files["kmeans"], MainConfig(), dev)
    with strict_f32():
        ds = QuantizedFilelist(SpeechEncoder(enc_hub.dense_model, enc_hub.quantizer,
                                             need_f0=True), os.path.join(d, "f0_list.txt"))
        items = [ds[i] for i in range(len(ds))]
        batch = ds.collater(items)
        try:
            QuantizedFilelist(SpeechEncoder(enc_cpc.dense_model, enc_cpc.quantizer,
                                            need_f0=True), os.path.join(d, "f0_list.txt"))[0]
        except ValueError as e:
            cpc_f0 = str(e)
        else:
            raise AssertionError("the CPC encoder's F0 stream ran within JAX's tolerance")
    per_unit = all(it["f0"].shape == it["units"].shape for it in items)
    if not (per_unit and isinstance(batch["f0"], tuple) and len(batch["f0"]) == 1
            and batch["f0"][0].shape == batch["units"].shape
            and all((it["f0"] > 0).any() for it in items)):
        raise AssertionError("the F0 stream: one value a unit and the collater's 1-tuple")
    res["f0_stream"] = {"units": [int(it["units"].size) for it in items],
                        "voiced_units": [int((it["f0"] > 0).sum()) for it in items],
                        "batch": list(batch["units"].shape), "cpc_need_f0": cpc_f0}
    print(f"  F0 stream: QuantizedFilelist over {len(items)} utterances, mHuBERT + 100 centroids "
          f"with need_f0: units {res['f0_stream']['units']}, voiced units "
          f"{res['f0_stream']['voiced_units']}, collated f0 a 1-tuple of "
          f"{tuple(batch['f0'][0].shape)}; the CPC encoder with need_f0: {cpc_f0}", flush=True)

    # the GSLM example
    t0 = time.perf_counter()
    loss, prompt, cont = gslm.main(["--output", os.path.join(d, "gslm.wav")])
    res["gslm"] = {"final_ce": loss, "prompt_units": int(prompt.size), "sampled": int(cont.size),
                   "seconds": time.perf_counter() - t0}
    print(f"  GSLM (python -m unitspeech_tpu_torch.examples.gslm): final next-unit CE "
          f"{loss:.3f}, {prompt.size} prompt units + {cont.size} sampled, "
          f"{res['gslm']['seconds']:.1f} s", flush=True)
    if not (np.isfinite(loss) and cont.size > 0):
        raise AssertionError(f"gslm: {res['gslm']}")

    launches = {name: w.launches for name, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"extras: kernel launches {launches}, expected none")
    del voc, enc_cpc, enc_hub, cpc_reader, hub_reader
    torch.cuda.empty_cache()
    res["card"] = smi
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"extras phase: {res['phase_s']:.1f} s", flush=True)
    return res, launches


# The operator tools' phase (unitspeech_tpu_torch/tools): closed-loop load,
# the exact / speculative paths, a live refresh, the window A/B, STEP1 at
# the config's batch, the SSL frontends and adapting a voice, then the two
# host tools on the load's /stats snapshot
OPS_CLIENTS, OPS_REQUESTS, OPS_MAX_BATCH = 8, 16, 8  # two waves: a steady closed loop
OPS_REFRESH_REQUESTS = 16  # before and after the refresh each
OPS_FT_ITERS = 10
# the A/B's traffic, cut for the script's limit from the tool's 27 short + 3
# long requests (the same 90 / 10 mix)
OPS_AB_TRAFFIC = {"n_short": 9, "n_long": 1}
# the kernels a served request launches on the serving default (K1-K4, K7,
# K5 / K6), and the one a STEP1 step launches (M1)
SERVED = frozenset(ESTIMATOR_KERNELS[:5] + VOCODER_KERNELS)
OPS_PATHS = {"bench_server": SERVED, "bench_serving": SERVED, "refresh_under_load": SERVED,
             "bucket_policy_ab": SERVED, "bench_train": frozenset(TRAIN_KERNELS),
             "bench_ssl": SERVED, "capacity_plan": frozenset(), "analyze_buckets": frozenset()}


def operator_tools(torch, dev, tmp, ckpt_path, smi, argv=None):
    """The operator tools' paths on the card, each tool's main called in
    this process with every launch counter set to 0 just before it and read
    just after: each path's kernels (OPS_PATHS) must launch and no other.
    bench_server: OPS_CLIENTS closed-loop clients (a child process),
    OPS_REQUESTS requests of ~344 frames, ddpm@50, --max-batch
    OPS_MAX_BATCH, the TTFA probe of 2 sentences; every request answered
    (the tool holds the replies' samples to the served lengths x hop) and a
    dispatch of 2 or more. bench_serving; refresh_under_load (16 + 16
    requests): the window swapped away from the stale one, no request
    failed. bucket_policy_ab: both windows served every request, a long one
    at >= LONG_FRAMES (K4's C = 1024 stage). bench_train: STEP1 at batch 32
    (k1 1, k2 2), its loss finite. bench_ssl (the frontends phase's SSL
    files, OPS_FT_ITERS iterations): the adapted request's mel finite. Then
    capacity_plan (utilization 1, at bench_server's most common dispatch
    size) and analyze_buckets on bench_server's /stats snapshot: the plan's
    ms a request beside the measured dispatch ms a request, and the measured
    throughput over the plan's bound, the port's default utilization.
    argv: {tool: argv} in place of the full-size ones of the six device
    tools (a CPU rehearsal).
    Returns the results and each path's launches."""
    import importlib
    import math

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "operator_tools")
    os.makedirs(d)
    fe = os.path.join(tmp, "frontends")
    stats_path = os.path.join(d, "stats.json")
    common = ["--device", dev.type, "--checkpoint", ckpt_path]

    def out(name):
        return ["--out", os.path.join(d, f"{name}.json")]

    def host_argv(batch):
        return {"capacity_plan": ["--stats", stats_path, "--preset", "ddpm50", "--batch",
                                  str(batch), "--utilization", "1.0", "--json"],
                "analyze_buckets": ["--stats", stats_path, "--preset", "ddpm50", "--json"]}

    full = {
        "bench_server": [*common, "--clients", str(OPS_CLIENTS), "--requests", str(OPS_REQUESTS),
                         "--max-batch", str(OPS_MAX_BATCH), "--ttfa-sentences", "2",
                         "--stats-out", stats_path, *out("bench_server")],
        "bench_serving": [*common, "--reps", "1", *out("bench_serving")],
        "refresh_under_load": [*common, "--warmup-requests", str(OPS_REFRESH_REQUESTS),
                               "--tail-requests", str(OPS_REFRESH_REQUESTS),
                               *out("refresh_under_load")],
        "bucket_policy_ab": [*common, *out("bucket_policy_ab")],
        "bench_train": ["--device", dev.type, "--batch", "32", "--k1", "1", "--k2", "2",
                        *out("bench_train")],
        "bench_ssl": [*common, "--n-iters", str(OPS_FT_ITERS), "--speaker-embedder",
                      os.path.join(fe, "port_speaker-embedder.pt"), "--hubert",
                      os.path.join(fe, "port_hubert.pt"), "--kmeans",
                      os.path.join(fe, "port_kmeans.npz"), *out("bench_ssl")],
    }
    argv = argv or full
    wrappers = _kernel_wrappers()
    res, launches, walls = {}, {}, {}
    for name, own in OPS_PATHS.items():
        if name == "capacity_plan":
            with open(stats_path) as f:
                stats = json.load(f)
            sizes = {int(k): v for k, v in stats["batch_sizes"].items()}
            batch = max(sizes, key=lambda k: (sizes[k], k))
            argv = {**argv, **host_argv(batch)}
        print(f"operator_tools: python -m unitspeech_tpu_torch.tools.{name} "
              f"{' '.join(argv[name])}", flush=True)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        tool = importlib.import_module(f"unitspeech_tpu_torch.tools.{name}")
        if name == "bucket_policy_ab":
            full_traffic, tool.FULL = tool.FULL, {**tool.FULL, **OPS_AB_TRAFFIC}
        try:
            res[name] = tool.main(argv[name])
        finally:
            if name == "bucket_policy_ab":
                tool.FULL = full_traffic
        walls[name] = time.perf_counter() - t0
        got = {k: w.launches for k, w in wrappers.items()}
        missing = sorted(k for k in own if got[k] == 0)
        stray = sorted(k for k, v in got.items() if v and k not in own)
        print(f"  {walls[name]:.1f} s; kernel launches {({k: v for k, v in got.items() if v})}",
              flush=True)
        if missing or stray:
            raise AssertionError(f"{name}: kernels not launched {missing}, stray {stray}")
        launches[name] = got

    srv = res["bench_server"]
    if srv["requests"] != stats["requests"] or stats["errors"]:
        raise AssertionError(f"bench_server: {srv['requests']} answered, /stats "
                             f"{stats['requests']} ({stats['errors']} errors)")
    if max(sizes) < 2:
        raise AssertionError(f"bench_server: no dispatch of 2 or more: {sizes}")
    ref = res["refresh_under_load"]
    if not ref["decision"]["refreshed"] or ref["decision"]["window"] == ref["stale_window"]:
        raise AssertionError(f"refresh_under_load: no swap: {ref['decision']}")
    ab = res["bucket_policy_ab"]
    if not all(ab[k]["measured_mean_ms"] > 0 for k in ("cost", "quantile")) or (
            not ab["smoke"] and ab["frames_max"] < LONG_FRAMES):
        raise AssertionError(f"bucket_policy_ab: {ab}")
    tr = res["bench_train"]
    if not math.isfinite(tr["loss"]) or (tr["device"] == "cuda" and tr["batch"] != 32):
        raise AssertionError(f"bench_train: {tr}")
    ad = res["bench_ssl"]["adapted_request"]
    if not ad["finite"] or ad["frames"] < 1:
        raise AssertionError(f"bench_ssl: the adapted request {ad}")

    cap = res["capacity_plan"]
    measured_ms = stats["mean_dispatch_s"] * stats["batches"] * 1e3 / stats["requests"]
    ratio = srv["value"] / cap["streams_per_chip"]
    best = res["analyze_buckets"]["best"]["window"]
    summary = {
        "card": smi, "walls_s": walls,
        "server": {k: srv[k] for k in ("value", "p50_latency_s", "p95_latency_s", "wall_s",
                                       "speech_s", "batch_sizes", "switch_buckets",
                                       "stream_ttfa_s", "stream_total_s")},
        "plan_ms_per_request": cap["mean_proc_ms_batched"], "plan_batch": batch,
        "measured_dispatch_ms_per_request": measured_ms,
        "plan_bound_streams": cap["streams_per_chip"], "utilization_measured": ratio,
        "analyze_best_window": best,
        "serving": {m: res["bench_serving"][m] for m in ("exact", "speculative")},
        "refresh": {k: ref[k] for k in ("stale_window", "refresh_s", "n_before", "n_during",
                                        "n_after", "p50_before_s", "p95_before_s",
                                        "p50_during_s", "p95_during_s", "p50_after_s",
                                        "p95_after_s")},
        "refresh_window": ref["decision"]["window"],
        "ab": {k: ab[k] for k in ("cost", "quantile", "frames_p50", "frames_max",
                                  "measured_speedup", "predicted_speedup")},
        "train": {k: tr.get(k) for k in ("value", "batch", "t_x", "t_y", "out_size", "peak_gib",
                                         "loss", "m1_ms", "m1_share", "compile_s")},
        "ssl": {k: res["bench_ssl"][k] for k in ("spk_embedder", "unit_extractor",
                                                 "adapt_voice", "adapted_request")},
    }
    print(f"  bench_server: {srv['value']}x realtime, p50 {srv['p50_latency_s']} s, p95 "
          f"{srv['p95_latency_s']} s, dispatches {srv['batch_sizes']}; capacity_plan at batch "
          f"{batch}: {cap['mean_proc_ms_batched']} ms a request predicted, {measured_ms:.1f} ms "
          f"measured (dispatch time a request); throughput over the plan's bound at utilization "
          f"1 ({cap['streams_per_chip']} streams): {ratio:.4f}; analyze_buckets' best window "
          f"{best} (served {srv['switch_buckets']}); {smi}", flush=True)
    res["phase_s"] = summary["phase_s"] = time.perf_counter() - t_phase
    print(f"operator_tools phase: {res['phase_s']:.1f} s", flush=True)
    return summary, res, launches


# The parallel phase (after the operator tools): the port's multi-device
# paths in spawned ranks that import only the port and load the kernels the
# parent built. World 1 over NCCL on card 0 gives the single-rank results;
# then two ranks: over NCCL one a card where the machine has two cards or
# more, else both on card 0 over gloo (NCCL refuses two ranks on one card;
# gloo's all_reduce and broadcast, the port's only collectives, take CUDA
# tensors). Each rank runs one data-parallel STEP1 step at full width on
# its rows of a global batch of PAR_BATCH (strict f32, then one timed step
# and one under torch.profiler), the data-sharded batch of PAR_REQUESTS
# forced-FRAMES requests (serving default, STEPS steps, injected noise),
# speaker-per-rank adaptation at S = PAR_FT_S for PAR_FT_ITERS steps
# (deterministic algorithms) and the transcription of PAR_WAVS wavs.
PAR_BATCH, PAR_TX, PAR_TY = 32, 72, 344
PAR_REQUESTS, PAR_FT_S, PAR_FT_ITERS, PAR_WAVS, PAR_SEED = 4, 2, 3, 4, 90
PAR_TIMEOUT = 300.0  # seconds a group may take, start to join
# The sequence-sharded sampler in the parallel phase: one forced FRAMES-frame
# request (176 + 168 frames at world 2) on each mode and sampler spec,
# SEQ_STEPS steps, noise injected (ddpm) from PAR_SEED
SEQ_STEPS, SEQ_SAMPLERS = 4, ("ddpm", "dpm2:cs2")
SEQ_MODES = {"int8": {"use_int8_deep": True}, "bf16": {},
             "deep_i8": {"use_int8_deep": True, "use_deep": True, "use_resample": True,
                         "use_i8pre_deep": True}}
# (mode, sampler) of the seq part's requests: both samplers on the int8 and
# bf16 modes, ddpm on the fused deep configuration (--deep --i8pre
# --resample: K8, K9, K11 on their sharded forms)
SEQ_RUNS = tuple((m, s) for m in ("int8", "bf16") for s in SEQ_SAMPLERS) + (("deep_i8", "ddpm"),)
# the seq-sharded kernels' launches a request, held to the unsharded path's;
# each mode's mel at world 2 is held to world 1's within the TTS bounds
# (MEL_L1_BOUND, MEL_MAX_BOUND; PERF.md §6)
SEQ_KERNELS = ("fused_resnet_block", "fused_final_block", "row_stats", "fused_rezero_attention",
               "row_absmax", "fused_resnet_block_deep", "fused_resnet_block_deep_i8",
               "fused_downsample_conv", "fused_upsample_conv")
# the DP step at world 2 against world 1 (strict f32: the shards' sums run
# in another order): the losses and the pre-clip norms within PAR_REL; each
# parameter moves lr * sign(g) in Adam's first step, so the two worlds
# differ only where a gradient's sign is a rounding coin toss: at most
# PAR_MOVED of the entries by more than 2e-3 * lr
PAR_REL, PAR_MOVED = 1e-4, 1e-3


# Tensor parallelism in the parallel phase (parallel/tp.py): the
# decoder sharded over 'model' by shard_params_tp. At world 2, (data 1, seq
# 1, model 2): each kernel's model form at n = 2 held to its plain version
# (_tp_kernel_checks), then the seq part's forced request as TP2_RUNS says
# (each mode and each sampler once); at world 4, (1, 2, 2), JAX's full-size
# layout (sampler_tp_x_seq), TP4_RUNS, then one strict-f32 DP x TP
# STEP1 step on (2, 1, 2) at a global batch of TP_BATCH against world 1's
# (the DP step's bounds, PAR_REL and PAR_MOVED). Each mel within the TTS
# bounds of world 1's seq-part mel; the launches a request world 1's; the
# collectives a request exact.
TP_BATCH = 4
TP2_RUNS = (("int8", "ddpm"), ("bf16", "dpm2:cs2"), ("deep_i8", "ddpm"))  # (mode, sampler)
TP4_RUNS = (("int8", "ddpm"),)


def seq_collectives_per_call(est, t) -> int:
    """The seq axis's collectives in one estimator call over T global frames
    (models/unet.py's sharded forms, each site's route taken at the global
    frames): 4 a K1 or K8 block (halos of x and h, two tile-sum gathers), 4
    a plain-Blocks block (two halos, two statistics sums), 4 a flat block
    (two halos, two statistics sums) and 2 more with int8 (K7's maxima of
    its two convs), 6 a K9 block (its input's maxima, the halos of x8 and
    h8, two tile-sum gathers, h's maxima; 5 where conv1 runs in bf16, Cin >
    Cout: no input maxima), 1 a K4 attention (its partials), 2 a plain
    attention (the key maxima, then the sums with the context), 1 a
    Downsample or Upsample (its halo; K11's or the library conv's), 2 the
    final block (a halo and the tile sums)."""
    from unitspeech_tpu_torch.models.unet import PALLAS_MIN_TOKENS
    from unitspeech_tpu_torch.ops import fused_attention

    n = len(est.dims)
    stages = [(f"down_{i}_{r}", i) for i in range(n) for r in ("res1", "res2")]
    stages += [("mid_res1", n - 1), ("mid_res2", n - 1)]
    stages += [(f"up_{i}_{r}", i + 1) for i in range(n - 1) for r in ("res1", "res2")]
    per_route = {"k1": 4, "k8": 4, "blocks": 4, "flat": 6 if est.use_int8_deep else 4}
    total = 0
    for name, level in stages:
        f = -(-est.n_feats // 2 ** level)
        blk = getattr(est, name)
        route = blk.route(t >> level, f, est.use_kernels, est.use_int8_deep, est.use_deep,
                          est.use_i8pre_deep)
        cin, cout = blk.widths()
        total += (5 if cin > cout else 6) if route == "k9" else per_route[route]
    attn = [i for i in range(n)] + [n - 1] + [i + 1 for i in range(n - 1)]
    for level, c in zip(attn, est.dims + [est.dims[-1]] + est.dims[:-1]):
        tokens = (t >> level) * -(-est.n_feats // 2 ** level)
        total += 1 if (est.use_kernels and tokens >= PALLAS_MIN_TOKENS
                       and fused_attention.takes(c)) else 2
    return total + 2 * (n - 1) + 2


def model_collectives_per_call(est, t) -> int:
    """The model axis's collectives in one call of a model-sharded estimator
    (parallel/tp.py) over T global frames, each site's route taken at the
    global widths (models/unet.py): 2 the time MLP, 2 a K1, K8 or flat block
    (h and the output gathered; its FiLM bias stays the rank's columns), 3
    a K9 block (h's maxima, h8 and the output gathered), 3 a plain-Blocks
    block (the FiLM bias and the two convs gathered) and 1 more with its
    1x1 residual, 0 a K4 attention (whole on every rank), 2 a plain
    attention (its two projections), 1 a Downsample or Upsample (K11's
    columns or the library conv's gathered), 1 the final block (K2's
    partial dots summed, or the plain final conv's input gathered). Every
    rank holds whole GroupNorm groups (a straddling group adds one sum
    gather a flat statistics)."""
    from unitspeech_tpu_torch.models.unet import PALLAS_MIN_TOKENS
    from unitspeech_tpu_torch.ops import fused_attention

    n = len(est.dims)
    stages = [(f"down_{i}_{r}", i) for i in range(n) for r in ("res1", "res2")]
    stages += [("mid_res1", n - 1), ("mid_res2", n - 1)]
    stages += [(f"up_{i}_{r}", i + 1) for i in range(n - 1) for r in ("res1", "res2")]
    total = 2
    for name, level in stages:
        blk = getattr(est, name)
        route = blk.route(t >> level, -(-est.n_feats // 2 ** level), est.use_kernels,
                          est.use_int8_deep, est.use_deep, est.use_i8pre_deep)
        total += {"k1": 2, "k8": 2, "flat": 2, "k9": 3}.get(route, 3 + (blk.res_conv is not None))
    attn = [i for i in range(n)] + [n - 1] + [i + 1 for i in range(n - 1)]
    for level, c in zip(attn, est.dims + [est.dims[-1]] + est.dims[:-1]):
        tokens = (t >> level) * -(-est.n_feats // 2 ** level)
        total += 0 if (est.use_kernels and tokens >= PALLAS_MIN_TOKENS
                       and fused_attention.takes(c)) else 2
    return total + 2 * (n - 1) + 1


def _seq_wrappers():
    """The estimator kernels' wrappers a sharded request is counted by
    (SEQ_KERNELS)."""
    from unitspeech_tpu_torch.ops import (
        fused_attention,
        fused_resnet,
        fused_resnet_deep,
        resample,
        row_stats,
    )

    mods = (fused_resnet, row_stats, fused_attention, fused_resnet_deep, resample)
    return {k: next(getattr(m, k) for m in mods if hasattr(m, k)) for k in SEQ_KERNELS}


def _deep_block(rand, cin, cout):
    """A deep ResnetBlock's random parameters at full width, as check_kernels
    draws them (the FiLM bias in bf16, as the estimator's MLP gives it)."""
    p = dict(t_bias=rand(3, cout), w1=rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
             b1=rand(cout, scale=0.1), gn1_scale=1 + rand(cout, scale=0.1),
             gn1_bias=rand(cout, scale=0.1), w2=rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
             b2=rand(cout, scale=0.1), gn2_scale=1 + rand(cout, scale=0.1),
             gn2_bias=rand(cout, scale=0.1))
    if cin != cout:
        p.update(wres=rand(1, 1, cin, cout, scale=cin ** -0.5), bres=rand(cout, scale=0.1))
    return p


# the fused deep configuration's sites held in their sharded forms: K8 at
# F = 20 and at F = 10 with Cin = 2 048 (level, F, Cin, Cout), K9 with an
# int8 conv1 at F = 20 and with conv1 in bf16 (Cin = 2 048) at F = 10
DEEP_SHARD_K8 = ((2, 20, 512, 512), (3, 10, 2048, 512))
DEEP_SHARD_K9 = ((2, 20, 256, 512), (3, 10, 2048, 512))


def _deep_sharded_checks(torch, dev, rand, held, seq=None, ms=None):
    """The fused deep configuration's sharded forms at the 344-frame sites
    (each rank draws the same global tensors): on a frame slice (seq, this
    rank's frames kept) or a column slice (ms, the weights' columns) K8's
    chain (DEEP_SHARD_K8) and K9's (DEEP_SHARD_K9) against their plain
    versions on the whole input, K9's split quantize (us_i8_absmax, the
    maxima reduced, us_i8_quantize_scaled) and its int8 conv (halo'd on a
    frame slice) bit for bit against their plain twins on the same slice,
    and K11a / K11b (halo'd, or the rank's Cout columns gathered) against
    the plain versions on the whole input. held(what, got, want, rel)."""
    from unitspeech_tpu_torch.ops import fused_resnet, fused_resnet_deep as frd, resample

    bf16 = torch.bfloat16
    top = None if seq is None else seq
    cols = (lambda v: v) if ms is None else (lambda v: ms.take(v))

    def level_of(level):
        sl = top
        for _ in range(level):
            sl = sl.down()
        return sl

    def local(v, sl):
        return v if sl is None else sl.take(v)

    for kind, sites in (("K8", DEEP_SHARD_K8), ("K9", DEEP_SHARD_K9)):
        for level, f, cin, cout in sites:
            sl = None if top is None else level_of(level)
            t = FRAMES >> level if sl is None else sl.t
            mask = _lens_mask(torch, t, dev)
            x = rand(3, t, f, cin).to(bf16)
            p = _deep_block(rand, cin, cout)
            if kind == "K9":
                p["t_bias"] = p["t_bias"].to(bf16)
            site = f"F={f} T={t} {cin}->{cout}"
            a = fused_resnet.block_rows_args(
                x, mask, p["t_bias"], p["w1"], p["b1"], p["gn1_scale"], p["gn1_bias"], p["w2"],
                p["b2"], p["gn2_scale"], p["gn2_bias"], p.get("wres"), p.get("bres"))
            pc = {k: cols(v) if k in ("t_bias", "w1", "b1", "w2", "b2", "wres", "bres") else v
                  for k, v in p.items()}
            if kind == "K8":
                want = fused_resnet.resnet_block_plain(*a, f=f, groups=8)
                packed = fused_resnet.pack_block_weights(pc["w1"], pc["w2"], pc.get("wres"))
                got = frd.fused_resnet_block_deep(local(x, sl), local(mask, sl), groups=8,
                                                  packed=packed, seq=sl, model=ms, **pc)
                held(f"K8 chain {site}", got, local(want.reshape(3, t, f, cout), sl), BF16_REL)
                continue
            wq = (frd.quant_w(p["w1"]), frd.quant_w(p["w2"]))
            want = frd.resnet_block_deep_i8_plain(*a[:4], wq[0], *a[4:7], wq[1], *a[8:], f=f,
                                                  groups=8)
            wqc = (frd.quant_w(pc["w1"]), frd.quant_w(pc["w2"]))
            packed = frd.pack_block_weights_i8(pc["w1"], wqc, pc.get("wres"), cin > cout)
            got = frd.fused_resnet_block_deep_i8(local(x, sl), local(mask, sl), groups=8, wq=wqc,
                                                 packed=packed, seq=sl, model=ms, **pc)
            held(f"K9 chain {site}", got, local(want.reshape(3, t, f, cout), sl), I8_REL)
            if cin > cout:
                continue
            # the split quantize and the int8 conv (halo'd on a frame slice)
            # against their plain twins on the same slice, bit for bit
            n = x.shape[1] if sl is None else sl.length
            xl = local(x, sl).reshape(3, n * f, cin)
            ll = fused_resnet.lens_rows_from_mask(local(mask, sl), f)
            x8, sx = frd._quantize_sharded(xl, ll, f, sl, True)
            x8p, sxp = frd._quantize_sharded(xl, ll, f, sl, False)
            held(f"K9 split quantize x8 {site}", x8.float(), x8p.float(), 0.0)
            held(f"K9 split quantize scale {site}", sx, sxp, 0.0)
            b1 = pc["b1"]
            c, part = frd._conv_i8_rows(x8, sx, wqc[0], b1, ll, f, packed[0], sl, bf16, True)
            c_ref, part_ref = frd._conv_i8_rows(x8, sx, wqc[0], b1, ll, f, None, sl, bf16, False)
            form = "halo " if sl is not None else ""
            held(f"K9 int8 conv ({form}slice) {site}", c, c_ref, 0.0)
            held(f"K9 int8 conv ({form}slice) sums {site}", part.sum(dim=1), part_ref.sum(dim=1),
                 F32_REL)
    for (t, f, c), up in [(s, False) for s in K11_DOWN_SITES] + [(s, True) for s in K11_UP_SITES]:
        sl = None if top is None else level_of(0 if t == FRAMES else 1)
        x = rand(3, t, f, c).to(bf16)
        mask = _lens_mask(torch, t, dev)
        taps = 4 if up else 3
        w, bias = rand(taps, taps, c, c, scale=(taps * taps * c) ** -0.5), rand(c, scale=0.1)
        pack = resample.pack_upsample_weight if up else resample.pack_downsample_weight
        plain = resample.upsample_conv_plain if up else resample.downsample_conv_plain
        fn = resample.fused_upsample_conv if up else resample.fused_downsample_conv
        want = plain(x, mask, w, bias)
        if sl is not None:
            want = want.narrow(1, 2 * sl.start, 2 * sl.length) if up else sl.down().take(want)
        got = fn(local(x, sl), local(mask, sl), cols(w), cols(bias), packed=pack(cols(w)),
                 seq=sl, model=ms)
        held(f"K11{'b' if up else 'a'} ({'halo' if sl is not None else 'columns'}) T={t} F={f} "
             f"C={c}", got, want, BF16_REL)


def _seq_kernel_checks(torch, dev, shard):
    """At world 2, on this rank's slice of the 344-frame sites: the halo'd
    kernel A (us_resnet_conv3x3_halo) against its plain twin on the same
    halo'd input, K1's and K2's sharded chains and the split K4 against the
    unsharded plain versions on the whole input (every rank draws the same
    global tensors), this rank's frames kept; then the fused deep
    configuration's sharded forms (_deep_sharded_checks: K8's and K9's
    chains, K9's split quantize and halo'd int8 conv, K11a / K11b halo'd).
    The bf16 outputs within BF16_REL of max(|ref|, 1), K9's chains within
    I8_REL, the tile sums within F32_REL, the split quantize and the int8
    conv bit for bit. Returns the errors by site."""
    from unitspeech_tpu_torch.ops import conv_matmul, fused_attention, fused_resnet
    from unitspeech_tpu_torch.utils.precision import strict_f32

    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 3)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def held(what, got, want, rel):
        err = (got.float() - want.float()).abs().max().item()
        tol = rel * max(want.float().abs().max().item(), 1.0)
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"seq {what}: {err} exceeds {tol}")
        out[what] = err

    out = {}
    top = shard.at(FRAMES)
    bf16 = torch.bfloat16
    with strict_f32():  # the plain versions' f32 convs and products without TF32
        for level, f, cin, cout in ((0, 80, 2, 128), (0, 80, 128, 128), (1, 40, 128, 256)):
            sl = top.down() if level else top
            t = sl.t
            mask = _lens_mask(torch, t, dev)
            lens = fused_resnet.lens_rows_from_mask(mask, f)
            x = rand(3, t, f, cin).to(bf16)
            p = dict(t_bias=rand(3, cout), w1=rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                     b1=rand(cout, scale=0.1), gn1_scale=1 + rand(cout, scale=0.1),
                     gn1_bias=rand(cout, scale=0.1),
                     w2=rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                     b2=rand(cout, scale=0.1), gn2_scale=1 + rand(cout, scale=0.1),
                     gn2_bias=rand(cout, scale=0.1))
            if cin != cout:
                p.update(wres=rand(1, 1, cin, cout, scale=cin ** -0.5),
                         bres=rand(cout, scale=0.1))
            packed = fused_resnet.pack_block_weights(p["w1"], p["w2"], p.get("wres"))
            site = f"F={f} T={t} {cin}->{cout}"  # the global site; each rank its slice
            args = fused_resnet.block_rows_args(
                x, mask, p["t_bias"], p["w1"], p["b1"], p["gn1_scale"], p["gn1_bias"], p["w2"],
                p["b2"], p["gn2_scale"], p["gn2_bias"], p.get("wres"), p.get("bres"))
            want = fused_resnet.resnet_block_plain(*args, f=f, groups=8).reshape(3, t, f, cout)
            got = fused_resnet.fused_resnet_block(sl.take(x), sl.take(mask), groups=8,
                                                  packed=packed, seq=sl, **p)
            held(f"K1 chain {site}", got, sl.take(want), BF16_REL)
            xl = sl.take(x).reshape(3, sl.length * f, cin)
            ll = fused_resnet.lens_rows_from_mask(sl.take(mask), f)
            xh = conv_matmul.halo_rows(xl, f, sl, ll)
            w1r = p["w1"].reshape(9 * cin, cout)
            c, part = fused_resnet.resnet_conv3x3_halo(xh, ll, w1r, p["b1"], f, packed[0])
            c_ref, part_ref = fused_resnet.resnet_conv3x3_halo_plain(xh, ll, w1r, p["b1"], f)
            held(f"kernel A (halo) {site}", c, c_ref, BF16_REL)
            held(f"kernel A (halo) sums {site}", part.sum(dim=1), part_ref.sum(dim=1), F32_REL)
        t, f, c = FRAMES, 80, 128
        x = rand(3, t, f, c).to(bf16)
        mask = _lens_mask(torch, t, dev)
        w1, b1 = rand(3, 3, c, c, scale=(9 * c) ** -0.5), rand(c, scale=0.1)
        s1, be1 = 1 + rand(c, scale=0.1), rand(c, scale=0.1)
        wo, bo = rand(1, 1, c, 1, scale=c ** -0.5), rand(1, scale=0.1)
        want = fused_resnet.final_block_plain(
            x.reshape(3, t * f, c), fused_resnet.lens_rows_from_mask(mask, f),
            w1.reshape(9 * c, c), b1, s1, be1, wo.reshape(c), bo, f=f, groups=8)
        got = fused_resnet.fused_final_block(top.take(x), top.take(mask), w1, b1, s1, be1, wo,
                                             bo, groups=8, seq=top,
                                             packed=fused_resnet.pack_conv_weight(w1))
        held(f"K2 chain F={f} T={t} {c}->1", got,
             top.take(want.reshape(3, t, f)), BF16_REL)
        for level, f, c in ((0, 80, 128), (2, 20, 512)):
            sl = top.down().down() if level else top
            t = sl.t
            x = rand(3, t, f, c).to(bf16)
            w_qkv, w_out = rand(c, 384, scale=c ** -0.5), rand(128, c, scale=128 ** -0.5)
            b_out, gate = rand(c, scale=0.1), torch.tensor([0.7], device=dev)
            lens = fused_resnet.lens_rows_from_mask(_lens_mask(torch, t, dev), f)
            want = fused_attention.rezero_attention_plain(x.reshape(3, t * f, c), w_qkv, w_out,
                                                          b_out, gate, lens, 4, 32)
            ll = torch.clamp(lens - sl.start * f, 0, sl.length * f).to(torch.int32)
            got = fused_attention.fused_rezero_attention(
                sl.take(x).reshape(3, sl.length * f, c), w_qkv, w_out, b_out, gate, ll,
                packed=fused_attention.pack_attention_weights(w_qkv, w_out), seq=sl)
            held(f"K4 split N={t * f} C={c}", got,
                 sl.take(want.reshape(3, t, f, c)).reshape(3, sl.length * f, c), BF16_REL)
        _deep_sharded_checks(torch, dev, rand, held, seq=top)
    return out


def _seq_rank(torch, dev, ckpt, world, rank, d, tag):
    """The seq-sharded requests of one rank: a forced FRAMES-frame request on
    each (mode, sampler) of SEQ_RUNS through a Synthesizer on a (data 1, seq
    = world) mesh with sample_spec (None, "seq", None), once to warm up,
    then counted (the estimator kernels' launches and the seq axis's
    collectives, every counter set to 0 just before) and timed; at world 1
    also the same request without a mesh (must be equal bit for bit). Rank
    0 writes each mel to <tag>_seq_<mode>_<sampler>.npy. At world 2 first
    the kernel checks (_seq_kernel_checks)."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.parallel import SeqShard, make_mesh
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    wrappers = _seq_wrappers()
    mesh = make_mesh(data=1, seq=world)
    rec = {"split": [list(b) for b in SeqShard.of(mesh).split(FRAMES)] if world > 1 else None}
    if world > 1:
        rec["kernels"] = _seq_kernel_checks(torch, dev, SeqShard.of(mesh))
    cfg = MainConfig()
    q = phonemes_to_sequence(FORCED_TEXT)
    rng = np.random.default_rng(PAR_SEED + 2)
    shape = (1, FRAMES, cfg.data.n_feats)
    noise = {"noise_z": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
             "noises": torch.from_numpy(rng.standard_normal(
                 (SEQ_STEPS,) + shape).astype(np.float32)).to(dev)}
    runs = {}
    for mode in dict.fromkeys(m for m, _ in SEQ_RUNS):
        models = TTSModels.from_checkpoint(ckpt, device=dev, **SEQ_MODES[mode])
        synth = Synthesizer(models, mesh=mesh, sample_spec=(None, "seq", None))
        want = seq_collectives_per_call(models.decoder.estimator, FRAMES)
        for sampler in (sp for m, sp in SEQ_RUNS if m == mode):
            kw = dict(diffusion_steps=SEQ_STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
                      durations=forced_durations(len(q), FRAMES), sampler=sampler, **noise)
            with torch.inference_mode():
                synth.synthesize_mel(q, **kw)
                for w in wrappers.values():
                    w.launches = 0
                SeqShard.collectives = 0
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                mel, y_len, _ = synth.synthesize_mel(q, **kw)
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
                run = {"wall_ms": wall, "y_length": y_len,
                       "launches": {k: w.launches for k, w in wrappers.items()},
                       "collectives": SeqShard.collectives,
                       "collectives_want": (SEQ_STEPS * want + 1) if world > 1 else 0,
                       "finite": bool(torch.isfinite(mel).all())}
                if world == 1:
                    alone = Synthesizer(models).synthesize_mel(q, **kw)[0]
                    run["equal_unsharded"] = bool(torch.equal(alone, mel))
                    if rank == 0 and mode == "bf16" and sampler == "ddpm":
                        # the request's sensitivity: its prior draw moved by
                        # at most one f32 ulp
                        nudged = dict(kw, noise_z=noise["noise_z"] * (1 + 2.0 ** -23))
                        np.save(os.path.join(d, f"{tag}_seq_nudged.npy"),
                                synth.synthesize_mel(q, **nudged)[0][0].float().cpu().numpy())
            if rank == 0:
                np.save(os.path.join(d, f"{tag}_seq_{mode}_{sampler.replace(':', '_')}.npy"),
                        mel[0].float().cpu().numpy())
            runs[f"{mode} {sampler}"] = run
        del models, synth
        torch.cuda.empty_cache()
    rec["runs"] = runs
    return rec


def _tp_kernel_checks(torch, dev, ms):
    """At world 2, each estimator kernel's model form on this rank's columns
    (model = 2) at its 344-frame sites against its plain version on the
    whole input (every rank draws the same global tensors): K1's chain
    (kernel A on the rank's Cout columns, gn_film on the slice's groups, h
    gathered, kernel B, gn_finalize, kernel C with the residual's columns,
    the output gathered), K2's (the ranks' partial final dots summed), K3's
    fold on the slice's groups and the flat bf16 and int8 convs on a Cout
    slice (K7's scale over the whole input) at the flat sites, K4 whole on
    every rank from its gathered weights (design b); then the fused deep
    configuration's model forms (_deep_sharded_checks: K8's and K9's chains
    on the rank's columns, K9's quantize and int8 conv, K11a / K11b on the
    rank's Cout columns, gathered). The bf16 outputs within BF16_REL of
    max(|ref|, 1), K9's chains within I8_REL, the statistics and the flat
    convs within F32_REL, the quantize and the int8 conv bit for bit.
    Returns the errors by site."""
    from unitspeech_tpu_torch.models.unet import RezeroAttention
    from unitspeech_tpu_torch.ops import conv_matmul, fused_attention, fused_resnet, row_stats
    from unitspeech_tpu_torch.parallel.tp import shard_params_tp
    from unitspeech_tpu_torch.utils.precision import strict_f32

    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 5)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def held(what, got, want, rel):
        err = (got.float() - want.float()).abs().max().item()
        tol = rel * max(want.float().abs().max().item(), 1.0)
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"model {what}: {err} exceeds {tol}")
        out[what] = err

    out = {}
    bf16 = torch.bfloat16
    with strict_f32():
        for f, cin, cout in ((80, 2, 128), (80, 128, 128), (40, 128, 256)):
            t = FRAMES if f == 80 else FRAMES // 2
            mask = _lens_mask(torch, t, dev)
            x = rand(3, t, f, cin).to(bf16)
            p = dict(t_bias=rand(3, cout), w1=rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                     b1=rand(cout, scale=0.1), gn1_scale=1 + rand(cout, scale=0.1),
                     gn1_bias=rand(cout, scale=0.1),
                     w2=rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                     b2=rand(cout, scale=0.1), gn2_scale=1 + rand(cout, scale=0.1),
                     gn2_bias=rand(cout, scale=0.1))
            if cin != cout:
                p.update(wres=rand(1, 1, cin, cout, scale=cin ** -0.5),
                         bres=rand(cout, scale=0.1))
            args = fused_resnet.block_rows_args(
                x, mask, p["t_bias"], p["w1"], p["b1"], p["gn1_scale"], p["gn1_bias"], p["w2"],
                p["b2"], p["gn2_scale"], p["gn2_bias"], p.get("wres"), p.get("bres"))
            want = fused_resnet.resnet_block_plain(*args, f=f, groups=8).reshape(3, t, f, cout)
            cols = {k: ms.take(p[k]) for k in ("t_bias", "w1", "b1", "w2", "b2", "wres", "bres")
                    if k in p}
            packed = fused_resnet.pack_block_weights(cols["w1"], cols["w2"], cols.get("wres"))
            got = fused_resnet.fused_resnet_block(x, mask, groups=8, packed=packed, model=ms,
                                                  **{**p, **cols})
            held(f"K1 chain F={f} T={t} {cin}->{cout}", got, want, BF16_REL)
        t, f, c = FRAMES, 80, 128
        x = rand(3, t, f, c).to(bf16)
        mask = _lens_mask(torch, t, dev)
        w1, b1 = rand(3, 3, c, c, scale=(9 * c) ** -0.5), rand(c, scale=0.1)
        s1, be1 = 1 + rand(c, scale=0.1), rand(c, scale=0.1)
        wo, bo = rand(1, 1, c, 1, scale=c ** -0.5), rand(1, scale=0.1)
        want = fused_resnet.final_block_plain(
            x.reshape(3, t * f, c), fused_resnet.lens_rows_from_mask(mask, f),
            w1.reshape(9 * c, c), b1, s1, be1, wo.reshape(c), bo, f=f, groups=8)
        got = fused_resnet.fused_final_block(
            x, mask, ms.take(w1), ms.take(b1), s1, be1, wo, bo, groups=8, model=ms,
            packed=fused_resnet.pack_conv_weight(ms.take(w1)))
        held(f"K2 chain F={f} T={t} {c}->1", got, want.reshape(3, t, f), BF16_REL)
        for level, f, c in ((2, 20, 512), (3, 10, 1024)):
            t = FRAMES >> level
            acc = rand(3, t * f, c)  # a deep conv's f32 accumulator
            got = torch.stack(row_stats.group_mean_inv(ms.take(acc), 8, model=ms))
            want = torch.stack([ms.take(v) for v in row_stats.group_mean_inv_plain(acc, 8)])
            held(f"K3 fold (slice groups) F={f} C={c}", got, want, F32_REL)
            xf = rand(3, t * f, c).to(bf16)
            w = rand(3, 3, c, c, scale=(9 * c) ** -0.5)
            held(f"flat bf16 conv F={f} C={c}", conv_matmul.conv3x3_rows(xf, ms.take(w), f),
                 ms.take(conv_matmul.conv3x3_rows(xf.float(), w.to(bf16).float(), f)), F32_REL)
            want = conv_matmul.conv3x3_int8(xf, w, f, absmax=row_stats.row_absmax_plain)
            held(f"flat int8 conv (K7 scale) F={f} C={c}",
                 conv_matmul.conv3x3_int8(xf, ms.take(w), f), ms.take(want), F32_REL)
        for level, f, c in ((0, 80, 128), (2, 20, 512)):
            t = FRAMES >> level
            x = rand(3, t, f, c).to(bf16)
            att = RezeroAttention(c).to(dev)
            w_qkv, w_out = rand(c, 384, scale=c ** -0.5), rand(128, c, scale=128 ** -0.5)
            b_out, gate = rand(c, scale=0.1), torch.tensor([0.7], device=dev)
            with torch.no_grad():
                for prm, v in ((att.fn.to_qkv.kernel, w_qkv), (att.fn.to_out.kernel, w_out),
                               (att.fn.to_out.bias, b_out), (att.g, gate)):
                    prm.copy_(v)
            mask = _lens_mask(torch, t, dev)
            want = fused_attention.rezero_attention_plain(
                x.reshape(3, t * f, c), w_qkv, w_out, b_out, gate,
                fused_resnet.lens_rows_from_mask(mask, f), 4, 32)
            shard_params_tp(att, ms)
            att.pack()  # the whole weights gathered once, then K4's pack
            with torch.no_grad():
                got = att(x, mask, bf16, True)
            held(f"K4 whole N={t * f} C={c}", got, want.reshape(3, t, f, c), BF16_REL)
        _deep_sharded_checks(torch, dev, rand, held, ms=ms)
    return out


def _tp_requests(torch, dev, ckpt, mesh, spec, pairs, rank, d, tag):
    """The seq part's forced FRAMES-frame request (SEQ_STEPS steps, the same
    injected noise) on each (mode, sampler) of `pairs` through a
    Synthesizer whose decoder shard_params_tp sharded over the mesh's
    model axis, with sample_spec `spec`: once to warm up, then counted (the
    estimator kernels' launches and the model and seq axes' collectives,
    every counter set to 0 just before) and timed. Rank 0 writes each mel
    to <tag>_tp_<mode>_<sampler>.npy."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.parallel import ModelShard, SeqShard, shard_params_tp
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    wrappers = _seq_wrappers()
    cfg = MainConfig()
    q = phonemes_to_sequence(FORCED_TEXT)
    rng = np.random.default_rng(PAR_SEED + 2)  # the seq part's draws
    shape = (1, FRAMES, cfg.data.n_feats)
    noise = {"noise_z": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
             "noises": torch.from_numpy(rng.standard_normal(
                 (SEQ_STEPS,) + shape).astype(np.float32)).to(dev)}
    runs = {}
    for mode in dict.fromkeys(m for m, _ in pairs):
        models = TTSModels.from_checkpoint(ckpt, device=dev, **SEQ_MODES[mode])
        t0 = time.perf_counter()
        shard_params_tp(models.decoder, mesh)
        shard_s = time.perf_counter() - t0
        synth = Synthesizer(models, mesh=mesh if spec else None, sample_spec=spec)
        est = models.decoder.estimator
        want_model = SEQ_STEPS * model_collectives_per_call(est, FRAMES)
        want_seq = SEQ_STEPS * seq_collectives_per_call(est, FRAMES) + 1 if spec else 0
        for sampler in (sp for m, sp in pairs if m == mode):
            kw = dict(diffusion_steps=SEQ_STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
                      durations=forced_durations(len(q), FRAMES), sampler=sampler, **noise)
            with torch.inference_mode():
                synth.synthesize_mel(q, **kw)
                for w in wrappers.values():
                    w.launches = 0
                ModelShard.collectives = SeqShard.collectives = 0
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                mel, y_len, _ = synth.synthesize_mel(q, **kw)
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
                runs[f"{mode} {sampler}"] = {
                    "wall_ms": wall, "y_length": y_len, "shard_s": shard_s,
                    "launches": {k: w.launches for k, w in wrappers.items()},
                    "model_collectives": ModelShard.collectives,
                    "model_collectives_want": want_model,
                    "seq_collectives": SeqShard.collectives, "seq_collectives_want": want_seq,
                    "finite": bool(torch.isfinite(mel).all())}
            if rank == 0:
                np.save(os.path.join(d, f"{tag}_tp_{mode}_{sampler.replace(':', '_')}.npy"),
                        mel[0].float().cpu().numpy())
        del models, synth
        torch.cuda.empty_cache()
    return runs


def _tp_step(torch, dev, ckpt, mesh):
    """One strict-f32 STEP1 step at a global batch of TP_BATCH (PAR_TX
    tokens, PAR_TY frames, the rows' lengths differ) on the checkpoint's
    weights, the draws from PAR_SEED + 4: with `mesh` (data, 1, model)
    every module sharded by shard_params_tp and the rank's rows of the
    mesh's data axis; without it unsharded (world 1). Returns the metrics,
    the step's ms (host clock) and the parameters after it, gathered and
    flat."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.parallel import (
        DataShard,
        gather_params_tp,
        shard_batch,
        shard_params_tp,
    )
    from unitspeech_tpu_torch.tools import bench_train
    from unitspeech_tpu_torch.train.steps import make_step1_train_step
    from unitspeech_tpu_torch.utils.precision import strict_f32

    cfg = MainConfig()
    with dev:
        mods = [Encoder.from_config(cfg.text_encoder),
                DurationPredictor.from_config(cfg.duration_predictor),
                UnitSpeech.from_config(cfg.decoder)]
    for k, m in zip(("text_encoder", "duration_predictor", "decoder"), mods):
        m.load_state_dict(ckpt[k])
        m.train().requires_grad_(True)
    shard = None
    batch = bench_train._batch(cfg, TP_BATCH, PAR_TX, PAR_TY, dev, False)
    if mesh is not None:
        for m in mods:
            shard_params_tp(m, mesh)
        shard = DataShard.of(mesh)
        batch = shard_batch(batch, shard)
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()],
                           lr=cfg.train.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    step = make_step1_train_step(*mods, opt, out_size=cfg.out_size,
                                 spk_uncond=torch.zeros(cfg.decoder.spk_emb_dim, device=dev),
                                 spk_dropout=cfg.train.spk_dropout, shard=shard)
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 4)
    with strict_f32():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        metrics = {k: v.item() for k, v in step(batch, gen).items()}
        ms = (time.perf_counter() - t0) * 1e3
        flat = torch.cat([v.detach().reshape(-1) for m in mods
                          for v in gather_params_tp(m).values()])
    return metrics, ms, flat


def _parallel_rank(rank, world, d, backend, tag):
    """One rank of the parallel phase (spawned; imports only the port), on
    the checkpoint's weights. Writes <tag>_rank<r>.json (records); world 1
    also w1_params.pt, the parameters after its DP step, which rank 0 of
    world 2 compares with its own; every failure raises, so the process
    exits non-zero."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import hashlib

    import torch
    import torch.distributed as dist

    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.ops import _cuda
    from unitspeech_tpu_torch.ops.masking import generate_path, sequence_mask
    from unitspeech_tpu_torch.parallel import (
        DataShard,
        make_mesh,
        maybe_initialize_distributed,
        shard_batch,
    )
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.tools import bench_train, distributed_transcribe
    from unitspeech_tpu_torch.train.finetune import finetune_decoder_batched
    from unitspeech_tpu_torch.train.steps import make_step1_train_step
    from unitspeech_tpu_torch.utils.precision import strict_f32

    with open(os.path.join(d, "phase.json")) as f:
        job = json.load(f)
    if not _cuda.library_path().exists():
        raise RuntimeError("the kernel library is not built: the parent builds it first")
    _cuda.lib()
    t_start = time.perf_counter()
    maybe_initialize_distributed(f"file://{d}/{tag}.init", world, rank, backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    shard = DataShard.of(mesh)
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
           "init_s": time.perf_counter() - t_start}
    cfg = MainConfig()
    ckpt = torch.load(job["ckpt"], map_location="cpu", weights_only=True)

    # one data-parallel STEP1 step on this rank's rows of the global batch
    with dev:
        mods = {"text_encoder": Encoder.from_config(cfg.text_encoder),
                "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
                "decoder": UnitSpeech.from_config(cfg.decoder)}
    for k, m in mods.items():
        m.load_state_dict(ckpt[k])
        m.train().requires_grad_(True)
    opt = torch.optim.Adam([p for m in mods.values() for p in m.parameters()],
                           lr=cfg.train.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    step = make_step1_train_step(*mods.values(), opt, out_size=cfg.out_size,
                                 spk_uncond=torch.zeros(cfg.decoder.spk_emb_dim, device=dev),
                                 spk_dropout=cfg.train.spk_dropout, shard=shard)
    batch = shard_batch(bench_train._batch(cfg, PAR_BATCH, PAR_TX, PAR_TY, dev, False), shard)
    rec["rows"] = {"token_lengths": batch["token_lengths"].tolist(),
                   "mel_lengths": batch["mel_lengths"].tolist()}
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    with strict_f32():
        rec["dp_metrics"] = {k: v.item() for k, v in step(batch, gen).items()}
        flat = torch.cat([p.detach().reshape(-1) for m in mods.values() for p in m.parameters()])
        rec["params_sha256"] = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
        ref = os.path.join(d, "w1_params.pt")
        if world == 1:
            torch.save(flat.cpu(), ref)
        elif rank == 0:  # against world 1's step: entries beyond 2e-3 * lr, the largest
            diff = (flat - torch.load(ref, weights_only=True).to(dev)).abs()
            rec["dp_params"] = {"n": flat.numel(), "max": float(diff.max()), "far": int(
                (diff > 2e-3 * cfg.train.learning_rate).sum())}
        del flat
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(batch, gen)["total_loss"].item()
        rec["dp_step_ms"] = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch, gen)["total_loss"].item()
            wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    # the host's time in the all-reduces (the op and its backend's span nest:
    # the larger of them) and the NCCL kernels' device time
    reduce_cpu = max((e.cpu_time_total for e in ev if e.key in (
        "c10d::allreduce_", "gloo:all_reduce", "nccl:all_reduce")), default=0.0) / 1e3
    reduce_dev = sum(getattr(e, "device_time_total", 0.0) for e in ev
                     if e.key.startswith(("ncclDevKernel", "ncclKernel"))) / 1e3
    rec["dp_profile"] = {"wall_ms": wall, "allreduce_host_ms": reduce_cpu,
                         "allreduce_device_ms": reduce_dev,
                         "share": max(reduce_cpu, reduce_dev) / wall}
    del mods, opt, step, batch
    torch.cuda.empty_cache()

    # the data-sharded batch on the serving default (kernels, int8 deep convs)
    from unitspeech_tpu_torch.ops import (
        aa_snake,
        fused_attention,
        fused_resnet,
        row_stats,
    )

    wrappers = {"fused_resnet_block": fused_resnet.fused_resnet_block,
                "fused_final_block": fused_resnet.fused_final_block,
                "row_stats": row_stats.row_stats,
                "fused_rezero_attention": fused_attention.fused_rezero_attention,
                "row_absmax": row_stats.row_absmax,
                "fused_aa_snake_conv": aa_snake.fused_aa_snake_conv,
                "fused_aa_snake": aa_snake.fused_aa_snake}
    models = TTSModels.from_checkpoint(ckpt, device=dev, use_int8_deep=True)
    synth = Synthesizer(models, mesh=mesh, sample_spec=("data", None, None))
    words = FORCED_TEXT.split()
    seqs = [phonemes_to_sequence(" ".join(words[i:i + 6])) for i in range(PAR_REQUESTS)]
    rng = np.random.default_rng(PAR_SEED)
    n_feats = cfg.data.n_feats
    kw = dict(diffusion_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
              durations=[forced_durations(len(q), FRAMES)[0] for q in seqs],
              noise_z=torch.from_numpy(rng.standard_normal(
                  (PAR_REQUESTS, FRAMES, n_feats)).astype(np.float32)).to(dev),
              noises=torch.from_numpy(rng.standard_normal(
                  (STEPS, PAR_REQUESTS, FRAMES, n_feats)).astype(np.float32)).to(dev))
    with torch.inference_mode():
        mel, y_lengths = synth.synthesize_mel_batch(seqs, **kw)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        wavs = synth.synthesize_batch(seqs, **kw)
        rec["batch_wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["batch_launches"] = {k: w.launches for k, w in wrappers.items()}
    if rank == 0:
        np.save(os.path.join(d, f"{tag}_mel.npy"), mel.float().cpu().numpy())
    rec["y_lengths"] = [int(y) for y in y_lengths]
    rec["wav_samples"] = [int(len(w)) for w, _ in wavs]
    rec["wav_finite"] = bool(all(np.isfinite(w).all() and np.any(w) for w, _ in wavs))
    del models, synth, mel, wavs
    torch.cuda.empty_cache()

    # the sequence-sharded sampler (every rank on the seq axis)
    t0 = time.perf_counter()
    rec["seq"] = _seq_rank(torch, dev, ckpt, world, rank, d, tag)
    rec["seq"]["seconds"] = time.perf_counter() - t0

    # tensor parallelism: world 1 the DP x TP step's reference; world 2 every
    # rank on the model axis, the kernels' model forms, then the requests
    t0 = time.perf_counter()
    if world == 1:
        metrics, ms, flat = _tp_step(torch, dev, ckpt, None)
        torch.save(flat.cpu(), os.path.join(d, "w1_tp_params.pt"))
        rec["tp"] = {"step_metrics": metrics, "step_ms": ms}
        del flat
    else:
        from unitspeech_tpu_torch.parallel import ModelShard

        tp_mesh = make_mesh(data=1, seq=1, model=world)
        rec["tp"] = {"kernels": _tp_kernel_checks(torch, dev, ModelShard.of(tp_mesh)),
                     "runs": _tp_requests(torch, dev, ckpt, tp_mesh, None, TP2_RUNS, rank, d,
                                          tag)}
    rec["tp"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # speaker-per-rank adaptation (world 1: the speakers one after another)
    t_y, t_x = FRAMES, FRAMES // 4
    frng = np.random.default_rng(PAR_SEED + 1)
    cond_x = torch.from_numpy((0.1 * frng.standard_normal(
        (PAR_FT_S, 1, t_x, n_feats))).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.tanh(frng.standard_normal(
        (PAR_FT_S, 1, t_y, n_feats))).astype(np.float32)).to(dev)
    y_len = torch.full((PAR_FT_S, 1), t_y - 20, device=dev)
    spk = frng.standard_normal((PAR_FT_S, 1, cfg.decoder.spk_emb_dim)).astype(np.float32)
    spk = torch.from_numpy(spk / np.linalg.norm(spk, axis=-1, keepdims=True)).to(dev)
    dur = torch.full((1, t_x), 4.0, device=dev)
    attn = torch.stack([generate_path(dur, sequence_mask(
        torch.tensor([t_x], device=dev), t_x)[:, :, None] * sequence_mask(
            y_len[s], t_y)[:, None, :]) for s in range(PAR_FT_S)])
    base = ckpt["decoder"]
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    stack, losses = finetune_decoder_batched(
        cfg.decoder, {k: torch.stack([v] * PAR_FT_S).to(dev) for k, v in base.items()},
        cond_x, y, y_len, attn, spk, segment_size=cfg.out_size, n_iters=PAR_FT_ITERS,
        learning_rate=cfg.finetune.learning_rate, grad_clip=cfg.finetune.grad_clip,
        generators=[torch.Generator(device=dev).manual_seed(PAR_SEED + s)
                    for s in range(PAR_FT_S)], mesh=mesh if world > 1 else None)
    rec["finetune_s"] = time.perf_counter() - t0
    torch.use_deterministic_algorithms(flags[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]
    rec["finetune_losses"] = losses.tolist()
    rec["finetune_sha256"] = [hashlib.sha256(torch.cat(
        [v[s].reshape(-1).float() for v in stack.values()]).cpu().numpy().tobytes()).hexdigest()
        for s in range(PAR_FT_S)]
    rec["finetune_moved"] = float(max((stack[k][0] - base[k].to(dev)).abs().max()
                                      for k in base))
    del stack
    torch.cuda.empty_cache()

    # distributed transcription (each rank its strided share, rank 0 merges)
    t0 = time.perf_counter()
    rc = distributed_transcribe.main(["--manifest", job["manifest"], "--output",
                                      os.path.join(d, f"{tag}_units.txt"), "--hubert",
                                      job["hubert"], "--kmeans", job["kmeans"]])
    rec["transcribe"] = {"rc": rc, "seconds": time.perf_counter() - t0}
    rec["seconds"] = time.perf_counter() - t_start
    rec["jax_free"] = not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu")
                              for m in sys.modules)
    with open(os.path.join(d, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _tp4_rank(rank, world, d, backend, tag):
    """One rank of the parallel phase's four-rank group (spawned; imports
    only the port), on the checkpoint's weights: the requests of TP4_RUNS
    on a (1, 2, 2) mesh with sample_spec (None, "seq", None) (_tp_requests),
    then the DP x TP STEP1 step on a (2, 1, 2) mesh (_tp_step; rank 0
    holds its parameters to world 1's w1_tp_params.pt). Writes
    <tag>_rank<r>.json; every failure raises."""
    import hashlib

    import torch
    import torch.distributed as dist

    from unitspeech_tpu_torch.ops import _cuda
    from unitspeech_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    with open(os.path.join(d, "phase.json")) as f:
        job = json.load(f)
    if not _cuda.library_path().exists():
        raise RuntimeError("the kernel library is not built: the parent builds it first")
    _cuda.lib()
    t_start = time.perf_counter()
    maybe_initialize_distributed(f"file://{d}/{tag}.init", world, rank, backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
           "init_s": time.perf_counter() - t_start}
    ckpt = torch.load(job["ckpt"], map_location="cpu", weights_only=True)
    t0 = time.perf_counter()
    rec["runs"] = _tp_requests(torch, dev, ckpt, make_mesh(data=1, seq=2, model=2),
                               (None, "seq", None), TP4_RUNS, rank, d, tag)
    rec["requests_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics, ms, flat = _tp_step(torch, dev, ckpt, make_mesh(data=2, seq=1, model=2))
    rec["step"] = {"metrics": metrics, "ms": ms, "seconds": time.perf_counter() - t0,
                   "sha256": hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()}
    if rank == 0:  # against world 1's step: entries beyond 2e-3 * lr, the largest
        from unitspeech_tpu_torch.config import MainConfig

        lr = MainConfig().train.learning_rate
        diff = (flat - torch.load(os.path.join(d, "w1_tp_params.pt"),
                                  weights_only=True).to(dev)).abs()
        rec["step"]["params"] = {"n": flat.numel(), "max": float(diff.max()),
                                 "far": int((diff > 2e-3 * lr).sum())}
    rec["seconds"] = time.perf_counter() - t_start
    rec["jax_free"] = not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu")
                              for m in sys.modules)
    with open(os.path.join(d, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _tp_held(what, runs, want, d, tag):
    """Check the tensor-parallel runs of one group: every run's launches a
    request `want` (by mode), its collectives those it computed, its
    length FRAMES, its mel finite and within the TTS bounds of world 1's
    seq-part mel (the unsharded program on the same request). Returns the
    bounds by run."""
    bounds = {}
    for key in runs[0]:
        mode = key.split()[0]
        for r in runs:
            got = {k: r[key]["launches"][k] for k in SEQ_KERNELS}
            if got != want[mode] or r[key]["model_collectives"] != \
                    r[key]["model_collectives_want"] or r[key]["seq_collectives"] != \
                    r[key]["seq_collectives_want"] or r[key]["y_length"] != FRAMES or \
                    not r[key]["finite"]:
                raise AssertionError(f"{what} {key}: launches {got} (expected {want[mode]}), "
                                     f"collectives {r[key]}")
        tag_k = key.replace(" ", "_").replace(":", "_")
        bounds[key] = _mel_bounds(f"{what} {key} vs world 1",
                                  np.load(os.path.join(d, f"{tag}_tp_{tag_k}.npy")),
                                  np.load(os.path.join(d, f"w1_seq_{tag_k}.npy")))
    return bounds


def parallel(torch, dev, tmp, ckpt_path, per_call, smi):
    """The multi-device paths on the card (_parallel_rank), world 1 over
    NCCL, then two ranks; each group must end within PAR_TIMEOUT with every
    rank's exit code 0. Checks: the DP step at world 2 equal to world 1's
    (PAR_REL, PAR_MOVED; the ranks' parameters bit-equal); each request's
    mel of the sharded batch within the TTS bounds of the single-rank
    batch's, and each rank's launches those of one request of its rows (a
    call's launches do not depend on its rows: STEPS estimator calls and
    one vocoder call); the speaker-per-rank adaptation bit-equal to the
    sequential one (deterministic algorithms); the two-rank transcription
    equal to the one-rank one. Returns the phase's summary."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.parallel import run_group
    from unitspeech_tpu_torch.utils.audio import write_wav

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "parallel")
    os.makedirs(d, exist_ok=True)
    fe = os.path.join(tmp, "frontends")
    rng = np.random.default_rng(PAR_SEED)
    wavs = []
    for i in range(PAR_WAVS):
        p = os.path.join(d, f"w{i}.wav")
        t = np.arange(int(16000 * (1.0 + 0.25 * i))) / 16000
        write_wav(p, 0.4 * np.sin(2 * np.pi * (140 + 30 * i) * t * (1 + 0.1 * np.sin(3 * t)))
                  + 0.02 * rng.standard_normal(t.size), 16000)
        wavs.append(p)
    with open(os.path.join(d, "manifest.txt"), "w") as f:
        f.write("\n".join(wavs) + "\n")
    with open(os.path.join(d, "phase.json"), "w") as f:
        json.dump({"ckpt": ckpt_path, "manifest": os.path.join(d, "manifest.txt"),
                   "hubert": os.path.join(fe, "port_hubert.pt"),
                   "kmeans": os.path.join(fe, "port_kmeans.npz")}, f)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    groups = [("w1", 1, "nccl", _parallel_rank), ("w2", 2, "nccl" if cards >= 2 else "gloo",
                                                  _parallel_rank),
              ("w4", 4, "nccl" if cards >= 4 else "gloo", _tp4_rank)]
    recs, walls = {}, {}
    for tag, world, backend, fn in groups:
        print(f"parallel: {world} rank(s) over {backend} "
              f"({'one a card' if backend == 'nccl' else 'all on card 0'})", flush=True)
        t0 = time.perf_counter()
        run_group(fn, world, (d, backend, tag), timeout=PAR_TIMEOUT)
        walls[tag] = time.perf_counter() - t0
        recs[tag] = []
        for r in range(world):
            with open(os.path.join(d, f"{tag}_rank{r}.json")) as f:
                recs[tag].append(json.load(f))
    one, two, four = recs["w1"][0], recs["w2"], recs["w4"]
    if not all(r["jax_free"] for rs in recs.values() for r in rs):
        raise AssertionError("a parallel rank imported jax or unitspeech_tpu")

    # the DP step
    lr = MainConfig().train.learning_rate
    rel = {k: max(abs(r["dp_metrics"][k] - v) / max(abs(v), 1e-12) for r in two)
           for k, v in one["dp_metrics"].items()}
    n_all, far, most = (two[0]["dp_params"][k] for k in ("n", "far", "max"))
    lens = [(sum(r["rows"]["token_lengths"]), sum(r["rows"]["mel_lengths"])) for r in two]
    print(f"  DP STEP1 step, global batch {PAR_BATCH} ({PAR_BATCH // 2} a rank; the ranks' "
          f"token / frame length sums {lens}), strict f32: world 2 vs world 1, largest "
          f"relative difference of each metric { {k: f'{v:.2e}' for k, v in rel.items()} } "
          f"(bound {PAR_REL:.0e}); parameters: {far} of {n_all} entries beyond 2e-3 * lr, "
          f"largest {most:.3e} (lr {lr:.0e}); ranks' parameters equal: "
          f"{two[0]['params_sha256'] == two[1]['params_sha256']}", flush=True)
    if (max(rel.values()) > PAR_REL or far > PAR_MOVED * n_all or most > 2 * lr
            or two[0]["params_sha256"] != two[1]["params_sha256"] or lens[0] == lens[1]):
        raise AssertionError(f"parallel DP step: {rel}, {far} / {n_all}, {most}, {lens}")

    # the data-sharded batch
    mel1, mel2 = (np.load(os.path.join(d, f"{t}_mel.npy")) for t in ("w1", "w2"))
    bounds = [_mel_bounds(f"sharded batch request {i}, world 2 vs world 1", mel2[i], mel1[i])
              for i in range(PAR_REQUESTS)]
    cfg = MainConfig()
    want = _sample_want(per_call, cfg, FRAMES)
    for r in [one] + two:
        got = r["batch_launches"]
        exp = {k: want[k] for k in got}
        if got != exp or r["y_lengths"] != [FRAMES] * PAR_REQUESTS or not r["wav_finite"] or \
                r["wav_samples"] != [FRAMES * cfg.data.hop_length] * PAR_REQUESTS:
            raise AssertionError(f"parallel batch, world {r['world']} rank {r['rank']}: "
                                 f"launches {got} (expected {exp}), lengths {r['y_lengths']}")
    print(f"  data-sharded batch ({PAR_REQUESTS} forced {FRAMES}-frame requests, int8 default, "
          f"{STEPS} steps): each rank's launches {two[0]['batch_launches']} (those of one "
          f"request of its rows); wall {one['batch_wall_ms']:.1f} ms at world 1, "
          f"{[round(r['batch_wall_ms'], 1) for r in two]} ms a rank at world 2", flush=True)

    # speaker-per-rank adaptation and transcription
    ft_equal = all(r["finetune_losses"] == one["finetune_losses"]
                   and r["finetune_sha256"] == one["finetune_sha256"] for r in two)
    with open(os.path.join(d, "w1_units.txt")) as f1, open(os.path.join(d, "w2_units.txt")) as f2:
        u1, u2 = f1.read(), f2.read()
    print(f"  speaker-per-rank adaptation (S = {PAR_FT_S}, {PAR_FT_ITERS} steps, bf16, "
          f"deterministic): equal to the sequential run {ft_equal}, largest move "
          f"{one['finetune_moved']:.3e}; transcription of {PAR_WAVS} wavs, 2 ranks vs 1: equal "
          f"{u1 == u2} ({len(u1.splitlines())} lines)", flush=True)
    if not ft_equal or one["finetune_moved"] == 0.0 or u1 != u2 or \
            len(u1.splitlines()) != PAR_WAVS or any(r["transcribe"]["rc"] for r in [one] + two):
        raise AssertionError(f"parallel finetune / transcription: {ft_equal}, {u1!r}, {u2!r}")

    # the sequence-sharded sampler
    seq1, seq2 = one["seq"], [r["seq"] for r in two]
    for name in seq2[0]["kernels"]:
        print(f"  seq-sharded {name} vs its plain version: max_abs_err "
              f"{max(s['kernels'][name] for s in seq2):.3e} (the larger of the ranks'); "
              f"{smi}", flush=True)
    seq_bounds = {}
    for key, r1 in seq1["runs"].items():
        mode = key.split()[0]
        want = {k: SEQ_STEPS * per_call[mode][k] for k in SEQ_KERNELS}
        want["fused_rezero_attention"] = SEQ_STEPS * _k4_per_call(cfg, FRAMES)
        for r in [r1] + [s["runs"][key] for s in seq2]:
            got = {k: r["launches"][k] for k in SEQ_KERNELS}
            if got != want or r["collectives"] != r["collectives_want"] or \
                    r["y_length"] != FRAMES or not r["finite"]:
                raise AssertionError(f"seq {key}: launches {got} (expected {want}), collectives "
                                     f"{r['collectives']} (expected {r['collectives_want']})")
        if not r1["equal_unsharded"]:
            raise AssertionError(f"seq {key}: the seq = 1 mesh's mel differs from the "
                                 f"unsharded request's")
        tag_k = key.replace(" ", "_").replace(":", "_")
        m1, m2 = (np.load(os.path.join(d, f"{t}_seq_{tag_k}.npy")) for t in ("w1", "w2"))
        if key == "bf16 ddpm":
            nudged = np.load(os.path.join(d, "w1_seq_nudged.npy"))
            span = float(m1.max() - m1.min())
            diff = np.abs(nudged - m1)
            seq_bounds["bf16 ddpm, world 1, prior nudged one f32 ulp"] = {
                "mel_l1": float(diff.mean()) / span, "mel_max": float(diff.max()) / span}
            print(f"  seq {key}: world 1 with its prior draw moved by one f32 ulp: mel L1 "
                  f"{float(diff.mean()) / span:.3e}, max |diff| {float(diff.max()) / span:.3e} "
                  f"of the range (the request's own sensitivity)", flush=True)
        seq_bounds[key] = _mel_bounds(f"seq {key}, world 2 ({seq2[0]['split']}) vs world 1",
                                      m2, m1)
        print(f"  seq {key}: {SEQ_STEPS} steps, launches a request {want} on every rank; "
              f"collectives a request {seq2[0]['runs'][key]['collectives']} (= {SEQ_STEPS} x "
              f"the per-call formula + 1 gather); wall {r1['wall_ms']:.1f} ms at world 1, "
              f"{[round(s['runs'][key]['wall_ms'], 1) for s in seq2]} ms a rank at world 2; "
              f"{smi}", flush=True)

    # tensor parallelism
    for name in two[0]["tp"]["kernels"]:
        print(f"  model-sharded {name} vs its plain version: max_abs_err "
              f"{max(r['tp']['kernels'][name] for r in two):.3e} (the larger of the ranks'); "
              f"{smi}", flush=True)
    want = {}
    for mode in SEQ_MODES:
        want[mode] = {k: SEQ_STEPS * per_call[mode][k] for k in SEQ_KERNELS}
        want[mode]["fused_rezero_attention"] = SEQ_STEPS * _k4_per_call(cfg, FRAMES)
    tp_bounds = {"model 2": _tp_held("TP (1, 1, 2)", [r["tp"]["runs"] for r in two], want,
                                     d, "w2"),
                 "seq 2 x model 2": _tp_held("TP (1, 2, 2)", [r["runs"] for r in four], want,
                                             d, "w4")}
    for layout, runs in (("model 2", [r["tp"]["runs"] for r in two]),
                         ("seq 2 x model 2", [r["runs"] for r in four])):
        for key, r in runs[0].items():
            print(f"  TP {layout} {key}: {SEQ_STEPS} steps, launches a request "
                  f"{want[key.split()[0]]} (world 1's); model collectives a request "
                  f"{r['model_collectives']}, seq "
                  f"{r['seq_collectives']} (= {SEQ_STEPS} x the per-call formulas"
                  f"{' + 1 gather' if r['seq_collectives'] else ''}); wall "
                  f"{[round(x[key]['wall_ms'], 1) for x in runs]} ms a rank; {smi}", flush=True)
    step1, step4 = one["tp"], [r["step"] for r in four]
    tp_rel = {k: max(abs(r["metrics"][k] - v) / max(abs(v), 1e-12) for r in step4)
              for k, v in step1["step_metrics"].items()}
    tp_far, tp_n, tp_most = (step4[0]["params"][k] for k in ("far", "n", "max"))
    print(f"  DP x TP STEP1 step on (2, 1, 2), global batch {TP_BATCH}, strict f32, vs world 1: "
          f"largest relative difference of each metric "
          f"{ {k: f'{v:.2e}' for k, v in tp_rel.items()} } (bound {PAR_REL:.0e}); parameters "
          f"gathered: {tp_far} of {tp_n} entries beyond 2e-3 * lr, largest {tp_most:.3e}; "
          f"ranks' parameters equal: {len({r['sha256'] for r in step4}) == 1}; step ms "
          f"{[round(r['ms'], 1) for r in step4]} a rank, world 1 {step1['step_ms']:.1f}",
          flush=True)
    if (max(tp_rel.values()) > PAR_REL or tp_far > PAR_MOVED * tp_n or tp_most > 2 * lr
            or len({r["sha256"] for r in step4}) != 1):
        raise AssertionError(f"parallel DP x TP step: {tp_rel}, {tp_far} / {tp_n}, {tp_most}")
    tp_res = {"kernels": {k: max(r["tp"]["kernels"][k] for r in two)
                          for k in two[0]["tp"]["kernels"]},
              "mel": tp_bounds,
              "wall_ms": {layout: {k: [x[k]["wall_ms"] for x in runs] for k in runs[0]}
                          for layout, runs in (("model 2", [r["tp"]["runs"] for r in two]),
                                               ("seq 2 x model 2", [r["runs"] for r in four]))},
              "collectives": {layout: {k: [r["model_collectives"], r["seq_collectives"]]
                                       for k, r in runs.items()}
                              for layout, runs in (("model 2", two[0]["tp"]["runs"]),
                                                   ("seq 2 x model 2", four[0]["runs"]))},
              "shard_s": two[0]["tp"]["runs"][next(iter(two[0]["tp"]["runs"]))]["shard_s"],
              "step": {"rel": tp_rel, "far": tp_far, "n": tp_n, "max": tp_most,
                       "ms": [r["ms"] for r in step4], "world1_ms": step1["step_ms"]},
              "seconds": {"w2": [r["tp"]["seconds"] for r in two],
                          "w4": [r["seconds"] for r in four]}}
    print(f"  TP seconds: world 2 {tp_res['seconds']['w2']}, world 4 {tp_res['seconds']['w4']}",
          flush=True)

    dp_recs = {t: recs[t] for t in ("w1", "w2")}  # the groups of _parallel_rank
    res = {"groups": {t: {"world": len(rs), "backend": rs[0]["backend"],
                          "wall_s": walls[t], "rank_s": [r["seconds"] for r in rs]}
                      for t, rs in recs.items()},
           "dp_step_ms": {t: [r["dp_step_ms"] for r in rs] for t, rs in dp_recs.items()},
           "dp_profile": {t: [r["dp_profile"] for r in rs] for t, rs in dp_recs.items()},
           "batch_wall_ms": {t: [r["batch_wall_ms"] for r in rs] for t, rs in dp_recs.items()},
           "finetune_s": {t: [r["finetune_s"] for r in rs] for t, rs in dp_recs.items()},
           "dp_rel": rel, "dp_params_far": far, "dp_params_max": most, "mel": bounds,
           "seq": {"split": seq2[0]["split"], "mel": seq_bounds,
                   "kernels": {k: max(s["kernels"][k] for s in seq2)
                               for k in seq2[0]["kernels"]},
                   "wall_ms": {t: {k: [s["runs"][k]["wall_ms"] for s in ss]
                                   for k in seq1["runs"]}
                               for t, ss in (("w1", [seq1]), ("w2", seq2))},
                   "collectives": {k: seq2[0]["runs"][k]["collectives"] for k in seq1["runs"]},
                   "seconds": {t: [s["seconds"] for s in ss]
                               for t, ss in (("w1", [seq1]), ("w2", seq2))}},
           "tp": tp_res, "launches_rank0": two[0]["batch_launches"], "card": smi,
           "phase_s": time.perf_counter() - t_phase}
    print(f"  DP step ms a rank: {res['dp_step_ms']}; all-reduce share of a profiled step: "
          f"{ {t: [round(p['share'], 4) for p in ps] for t, ps in res['dp_profile'].items()} }; "
          f"batch wall ms: {res['batch_wall_ms']}; {smi}", flush=True)
    print(f"parallel phase: {res['phase_s']:.1f} s (groups {walls}); {smi}", flush=True)
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
    """One entry per kernel: its launches on its home path's run (served
    requests, a tool, or the STEP1 steps), and per call on that path (HOME;
    at the 344-frame bucket, or a STEP1 step at the run's shapes) the
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
    print("per-launch device time inside K4, K9, K10a, K7, K5, K6, K3 and K2 at their sites "
          "(torch.profiler; python -m unitspeech_tpu_torch.tools.kernel_breakdown):",
          flush=True)
    breakdown = kernel_breakdown.breakdown(dev)
    check_launch_counts(breakdown)

    stamps = {}

    def stamp(name):
        """The script's elapsed seconds after each phase (its time limit)."""
        stamps[name] = time.perf_counter() - t0
        print(f"[{name} done at {stamps[name]:.1f} s]", flush=True)

    stamp("kernel checks")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = serve(torch, tmp, per_call)
        paths = compare_paths(torch, dev, ckpt, per_call)
        paths["long_bucket"] = long_bucket(torch, dev, ckpt, per_call)
        stamp("serve and paths")
        graphed = graphs(torch, dev, tmp, ckpt, per_call, smi)
        stamp("graphs")
        adapted, adapted_launches = adapt(torch, dev, tmp, ckpt, per_call, smi)
        front, launches["grapheme"] = frontends(torch, dev, tmp, ckpt, per_call, smi)
        stamp("adapt and frontends")
        voice = voice_and_samplers(torch, dev, tmp, ckpt, adapted["finetune"]["output"],
                                   per_call, smi)
        stamp("voice and samplers")
        served = serving(torch, dev, tmp, ckpt, per_call, smi)
        trained, m1, launches["trained"], launches["train"] = train(torch, dev, tmp, ckpt,
                                                                   per_call, smi)
        step1_ckpt = trained["runs"]["train_resume"]["checkpoint"]
        trained2, corpus, launches["step2_adapted"] = train2(torch, dev, tmp, ckpt, step1_ckpt,
                                                             per_call, smi)
        gan, launches["gan_served"] = vocoder_gan(torch, dev, tmp, ckpt, corpus, per_call, smi)
        evaluated, launches["eval"] = evaluation(torch, dev, tmp, ckpt, corpus, per_call, smi)
        extra, launches["extras"] = extras(torch, dev, tmp, smi)
        stamp("serving to extras")
        ops, ops_res, ops_launches = operator_tools(torch, dev, tmp, ckpt, smi)
        stamp("operator tools")
        par = parallel(torch, dev, tmp, ckpt, per_call, smi)
        stamp("parallel")
    launches.update(ops_launches)
    launches["parallel_rank0"] = {k: par["launches_rank0"].get(k, 0) for k in KERNELS}
    records += m1
    launches["adapted"] = adapted_launches
    tool_launches, tools = run_tools()
    launches.update(tool_launches)
    stamp("tools")

    kernels = kernels_line(records, launches)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "paths": paths, "adapt": adapted,
                       "frontends": front, "voice": voice, "serving": served,
                       "graphs": graphed,
                       "train": trained, "train2": trained2, "vocoder_gan": gan,
                       "eval": evaluated, "extras": extra, "elapsed_s": stamps,
                       "operator_tools": {"summary": ops, "results": ops_res},
                       "parallel": par,
                       "kernels": kernels,
                       "launches": launches, "tools": tools, "breakdown": breakdown}, f,
                      indent=1)
    print(json.dumps({"paths": paths}))
    print(json.dumps({"adapt": {k: v for k, v in adapted.items() if k != "losses"}}))
    print(json.dumps({"frontends": {k: v for k, v in front.items() if k != "losses"}}))
    print(json.dumps({"voice": voice}))
    print(json.dumps({"graphs": graphed}))
    print(json.dumps({"serving": served}))
    print(json.dumps({"train": {k: v for k, v in trained.items() if k != "runs"}}))
    print(json.dumps({"train2": {k: v for k, v in trained2.items() if k != "runs"}}))
    print(json.dumps({"vocoder_gan": {k: v for k, v in gan.items() if k != "runs"}}))
    print(json.dumps({"eval": {
        "rtf": {"per_speaker": evaluated["per_speaker"]["rtf"],
                "flat": evaluated["flat"]["rtf"]},
        "finetune_s": [f["seconds"] for f in evaluated["finetunes"]],
        "uer": {k: evaluated["evaluate"][k] for k in ("uer_mean", "uer_median", "uer_max")},
        "sample": evaluated["profile"], "phase_s": evaluated["phase_s"], "card": smi}}))
    print(json.dumps({"extras": {
        "resynthesis": {k: {m: extra[k][m] for m in ("units", "uniform_bps", "unigram_bps",
                                                     "synth_s", "rtf")}
                        for k in ("hubert", "cpc")},
        "hubert_wall_s": extra["hubert"]["wall_s"], "decoder": extra["decoder"],
        "waveglow_ms_per_audio_s": extra["waveglow"]["ms_per_audio_s"],
        "errors": extra["card_vs_cpu"]["errors"], "bounds": EXTRAS_BOUNDS,
        "gslm_final_ce": extra["gslm"]["final_ce"], "phase_s": extra["phase_s"],
        "card": smi}}))
    print(json.dumps({"operator_tools": ops}))
    print(json.dumps({"parallel": {k: v for k, v in par.items() if k != "launches_rank0"}}))
    print(json.dumps({"elapsed_s": stamps}))
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
