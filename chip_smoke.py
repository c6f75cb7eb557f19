"""Quickest proof that the PyTorch port runs on the GPU: build the CUDA
kernels, hold each against its plain PyTorch version at the main-path
shapes, then serve adaptive-TTS requests through the port's CLI at full
model width (random weights from a seed) with its serving defaults (every
kernel, int8 deep-stage convs) and check what comes out: the kernel path
against the plain path, the int8 gate, and the kernel vocoder, each run
with the exact kernel launches its path makes.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero (and prints no result) without one.
The last line of standard output is the JSON result.
"""

from __future__ import annotations

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
# Every kernel site of one estimator call at the 344-frame bucket, each
# launched once per call unless a count is given
K1_SITES = [  # (F, Cin, Cout)
    (80, 2, 128), (80, 128, 128),
    (40, 128, 256), (40, 256, 256), (40, 512, 128), (40, 128, 128),
]
K3_SITES = [  # (rows, C, input dtype, launches per call with int8, without): GroupNorm
    # statistics of the deep blocks, on the conv outputs of the flat blocks
    # (rounded to bf16 in int8 mode, the serving default; f32 accumulators
    # with --no-int8) and on the bf16 output of the one deep block that runs
    # as plain Blocks (up_1_res2)
    (1720, 512, "bfloat16", 4, 0), (430, 1024, "bfloat16", 8, 0), (430, 512, "bfloat16", 4, 0),
    (1720, 256, "bfloat16", 4, 2),
    (1720, 512, "float32", 0, 4), (430, 1024, "float32", 0, 8), (430, 512, "float32", 0, 4),
    (1720, 256, "float32", 0, 2),
]
K7_SITES = [  # (rows, C, launches per call): the int8 activation scale of every
    # deep-stage conv input (nine flat blocks, two convs each)
    (1720, 256, 2), (1720, 512, 3), (1720, 1024, 1), (430, 512, 4), (430, 1024, 7),
    (430, 2048, 1),
]
# BigVGAN at the 344-frame bucket: (T, C) after each upsample stage; every
# AMP block (k = 3, 7, 11) runs K5 for act1 + conv1 at d = 1, 3, 5 and for
# act2 + conv2 (d = 1, + residual) three times: 72 launches per vocoder call
VOC_STAGES = [(2752, 256), (22016, 128), (44032, 64), (88064, 32)]
K5_SITES = [(t, c, k, d, res, 3 if res else 1) for t, c in VOC_STAGES for k in (3, 7, 11)
            for d, res in ((1, False), (3, False), (5, False), (1, True))]
K6_SITE = (88064, 32)
AA_REL = 2.0 ** -7  # K5/K6 vs f32: one bf16 rounding of the output plus f32 order
K4_SITES = [(27520, 128), (6880, 256), (6880, 128), (1720, 512), (1720, 256)]
# bound on max|kernel - plain| relative to max|plain|: both round to bf16 at
# the same points, so they differ where f32 sums taken in another order
# round to neighbouring bf16 values (one bf16 step is 2^-8..2^-7 relative)
BF16_REL = 2.0 ** -6
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
# gate_ratio; the JAX package measured 1.25-1.28)
INT8_GATE_RATIO = 2.0
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


def check_kernels(torch, dev):
    """Each kernel against its plain version on the same inputs, bf16 on the
    card (K5/K6 against theirs in f32). Returns one record per (kernel,
    site); raises on a mismatch."""
    from unitspeech_tpu_torch.ops import aa_snake, fused_attention, fused_resnet, row_stats

    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    records = []

    def compare(name, src, replaces, site, kern, plain, rel, count=1, ref32=None,
                count_no_int8=None):
        """count, count_no_int8: launches per call on the int8 path (the
        serving default) and on the bf16 kernel path (--no-int8). ref32: an
        f32 reference on the same (bf16-rounded) inputs; the error is taken
        against it, and the bf16 plain version's distance to the kernel is
        printed beside it."""
        got = kern()
        want = plain() if ref32 is None else ref32()
        torch.cuda.synchronize()
        err = (got.float().reshape(want.shape) - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        bound = rel * max(ref, 1.0)
        ok = bool(np.isfinite(err) and err <= bound)
        extra = ""
        if ref32 is not None:
            d_plain = (got.float() - plain().float()).abs().max().item()
            extra = f", vs the bf16 plain version {d_plain:.3e}"
            del want
        rec = dict(name=name, route="cuda", source=src, replaces=replaces, site=site,
                   per_call=count,
                   per_call_no_int8=count if count_no_int8 is None else count_no_int8,
                   max_abs_err=err, bound=bound,
                   ms=_time_ms(torch, kern), plain_ms=_time_ms(torch, plain))
        print(f"  {name} {site}: max_abs_err {err:.3e} (bound {bound:.3e}, max|ref| "
              f"{ref:.3e}{extra}) kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} {site}: {err} exceeds {bound}")
        records.append(rec)

    src_res = "unitspeech_tpu_torch/csrc/resnet_block.cu"
    for f, cin, cout in K1_SITES:
        t = FRAMES * f // 80
        x = rand(3, t, f, cin).to(torch.bfloat16)
        mask = _lens_mask(torch, t, dev)
        lens = fused_resnet.lens_rows_from_mask(mask, f)
        p = dict(t_bias=rand(3, cout), w1=rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                 b1=rand(cout, scale=0.1), gn1_scale=1 + rand(cout, scale=0.1),
                 gn1_bias=rand(cout, scale=0.1),
                 w2=rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5), b2=rand(cout, scale=0.1),
                 gn2_scale=1 + rand(cout, scale=0.1), gn2_bias=rand(cout, scale=0.1))
        if cin != cout:
            p.update(wres=rand(1, 1, cin, cout, scale=cin ** -0.5), bres=rand(cout, scale=0.1))
        args = (x.reshape(3, t * f, cin), lens, p["t_bias"], p["w1"].reshape(9 * cin, cout),
                p["b1"], p["gn1_scale"], p["gn1_bias"], p["w2"].reshape(9 * cout, cout),
                p["b2"], p["gn2_scale"], p["gn2_bias"],
                p["wres"].reshape(cin, cout) if cin != cout else None, p.get("bres"))
        compare("fused_resnet_block", src_res,
                "unitspeech_tpu/ops/pallas_resnet.py:1243",
                f"F={f} T={t} {cin}->{cout}",
                lambda: fused_resnet.fused_resnet_block(x, mask, groups=8, **p),
                lambda: fused_resnet.resnet_block_plain(*args, f=f, groups=8), BF16_REL)

    t, f, c = FRAMES, 80, 128
    x = rand(3, t, f, c).to(torch.bfloat16)
    mask = _lens_mask(torch, t, dev)
    lens = fused_resnet.lens_rows_from_mask(mask, f)
    w1, b1 = rand(3, 3, c, c, scale=(9 * c) ** -0.5), rand(c, scale=0.1)
    s1, be1 = 1 + rand(c, scale=0.1), rand(c, scale=0.1)
    wo, bo = rand(1, 1, c, 1, scale=c ** -0.5), rand(1, scale=0.1)
    compare("fused_final_block", src_res, "unitspeech_tpu/ops/pallas_resnet.py:778",
            f"F={f} T={t} {c}->1",
            lambda: fused_resnet.fused_final_block(x, mask, w1, b1, s1, be1, wo, bo, groups=8),
            lambda: fused_resnet.final_block_plain(x.reshape(3, t * f, c), lens,
                                                   w1.reshape(9 * c, c), b1, s1, be1,
                                                   wo.reshape(c), bo, f=f, groups=8),
            BF16_REL)

    for n, c, dt, count, count_no_int8 in K3_SITES:
        x = (rand(3, n, c) + 0.5).to(getattr(torch, dt))
        compare("row_stats", "unitspeech_tpu_torch/csrc/row_stats.cu",
                "unitspeech_tpu/ops/pallas_stats.py:96", f"n={n} C={c} {dt}",
                lambda: row_stats.row_stats(x), lambda: row_stats.row_stats_plain(x),
                F32_REL, count, count_no_int8=count_no_int8)

    for n, c, count in K7_SITES:
        x = rand(3, n, c).to(torch.bfloat16)
        compare("row_absmax", "unitspeech_tpu_torch/csrc/row_stats.cu",
                "unitspeech_tpu/ops/pallas_stats.py:119", f"n={n} C={c} bf16",
                lambda: row_stats.row_absmax(x), lambda: row_stats.row_absmax_plain(x),
                0.0, count, count_no_int8=0)

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
                BF16_REL)

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
                AA_REL, count,
                ref32=lambda: aa_snake.aa_snake_conv_plain(
                    x.float(), alpha, beta, w.float(), bias, d, None if r is None else r.float()))
    t, c = K6_SITE
    x = rand(1, c, t, scale=0.5).to(torch.bfloat16)
    alpha, beta = rand(c, scale=0.3), rand(c, scale=0.3)
    compare("fused_aa_snake", src_aa, "unitspeech_tpu/ops/pallas_kernels.py:388",
            f"T={t} C={c}", lambda: aa_snake.fused_aa_snake(x, alpha, beta),
            lambda: aa_snake.aa_snake_plain(x, alpha, beta), AA_REL,
            ref32=lambda: aa_snake.aa_snake_plain(x.float(), alpha, beta))
    return records


ESTIMATOR_KERNELS = ("fused_resnet_block", "fused_final_block", "row_stats",
                     "fused_rezero_attention", "row_absmax")
VOCODER_KERNELS = ("fused_aa_snake_conv", "fused_aa_snake")
KERNELS = ESTIMATOR_KERNELS + VOCODER_KERNELS
STEPS = 50  # DDPM steps of every request: one 3-row estimator call each
# IPA requests of different lengths, then one forced to the 344-frame bucket
REQUESTS = [
    "ðə kwɪk bɹaʊn fɑks.",
    "hɪɹ ɪz ə lɔŋɡɚ sɛntəns ðæt ʃʊd teɪk ə fjʊ sɛkəndz tə seɪ.",
    "wʌns əpɑn ə taɪm, ɪn ə smɔl vɪlɪdʒ baɪ ðə si, ðɛɹ lɪvd ən oʊld fɪʃɚmən hu "
    "spɛnt hɪz deɪz mɛndɪŋ nɛts ənd tɛlɪŋ stɔɹiz tə ðə tʃɪldɹən.",
]
FORCED_TEXT = "ðɪs ɹɪkwɛst ɪz fɔɹst tə ðə θɹi hʌndɹəd ənd fɔɹti fɔɹ fɹeɪm bʌkɪt."


def _kernel_wrappers():
    from unitspeech_tpu_torch.ops import aa_snake, fused_attention, fused_resnet, row_stats

    return {"fused_resnet_block": fused_resnet.fused_resnet_block,
            "fused_final_block": fused_resnet.fused_final_block,
            "row_stats": row_stats.row_stats,
            "fused_rezero_attention": fused_attention.fused_rezero_attention,
            "row_absmax": row_stats.row_absmax,
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


def serve_requests(torch, tmp):
    """The main path: a full-width random checkpoint, then `cli inference`
    on the card for each request with its defaults (every kernel, int8
    deep-stage convs; 50 DDPM steps, dual CFG 1.0/1.0, bf16 decoder and
    vocoder, f32 encoder). Returns each kernel's launches."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    ckpt = os.path.join(tmp, "ckpt.pt")
    t0 = time.perf_counter()
    cli.main_make_random_checkpoint(["--seed", "0", "--output", ckpt])
    print(f"random full-width checkpoint in {time.perf_counter() - t0:.1f} s", flush=True)
    # expected lengths from the port's own encoder + duration predictor
    enc = Synthesizer(TTSModels.from_checkpoint(
        torch.load(ckpt, map_location="cpu", weights_only=True), device="cuda",
        with_vocoder=False))
    hop = enc.models.cfg.data.hop_length
    expected = [max(int(enc.encode(phonemes_to_sequence(t))[2].sum().item()), 1)
                for t in REQUESTS] + [FRAMES]
    del enc

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    runs = [(t, []) for t in REQUESTS] + [(FORCED_TEXT, ["--frames", str(FRAMES)])]
    print("requests through cli inference (50 steps, dual CFG 1.0/1.0, bf16, int8 deep "
          "convs):", flush=True)
    for i, ((text, extra), frames) in enumerate(zip(runs, expected)):
        out = os.path.join(tmp, f"req{i}.wav")
        stats = cli.main_inference(
            ["--ipa", "--text", text, "--checkpoint", ckpt, "--output", out,
             "--device", "cuda", "--seed", str(i), "--diffusion-steps", str(STEPS),
             "--text-gradient-scale", "1.0", "--spk-gradient-scale", "1.0", *extra])
        with wave.open(out, "rb") as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        print(f"  request {i}: {stats['frames']} frames, {stats['seconds']:.3f} s audio, "
              f"wall {stats['wall_s']:.3f} s, RTF {stats['rtf']:.4f}", flush=True)
        if n != frames * hop or pcm.size == 0 or not np.any(pcm):
            raise AssertionError(f"request {i}: {n} samples, expected {frames * hop}")
        if not (stats["kernels"] and stats["int8"]):
            raise AssertionError(f"request {i}: the CLI defaults are not kernels + int8")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"kernel launches during the requests: {launches}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


def compare_paths(torch, dev, ckpt_path, records):
    """The forced 344-frame request on the card, four ways, with the same
    injected noise: the bf16 kernel path without int8 against the plain bf16
    path (their mels must agree within MEL_L1_BOUND / MEL_MAX_BOUND of the
    plain mel's dynamic range); the int8 kernel path (the serving default)
    against the plain f32 path, held to INT8_GATE_RATIO x the bf16 kernel
    path's distance to it; then the vocoder on the plain f32 mel, kernels
    (bf16) vs plain bf16 vs plain f32, the kernels held to VOC_RATIO x the
    plain bf16 vocoder's waveform L1. Each run's kernel launches must be
    exactly what its path makes at this bucket (the per-call counts of the
    site checks in `records`), and none on a plain path. Returns the
    measured distances."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict

    per_call = {key: {name: sum(r[key] for r in records if r["name"] == name)
                      for name in KERNELS} for key in ("per_call", "per_call_no_int8")}
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    ids = phonemes_to_sequence(FORCED_TEXT)
    g = torch.Generator(device=dev).manual_seed(1234)
    n_feats = ckpt["mel_min"].numel()
    noise_z = torch.randn((1, FRAMES, n_feats), generator=g, device=dev)
    noises = torch.randn((50, 1, FRAMES, n_feats), generator=g, device=dev)
    mels = {}
    for name, dtype, kernels, int8 in (("kernels", torch.bfloat16, True, False),
                                       ("int8", torch.bfloat16, True, True),
                                       ("plain", torch.bfloat16, False, False),
                                       ("plain_f32", torch.float32, False, False)):
        synth = Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, dtype=dtype,
                                                      use_kernels=kernels, use_int8_deep=int8,
                                                      with_vocoder=False))
        counts = per_call["per_call" if int8 else "per_call_no_int8"]
        want = {k: STEPS * counts[k] if kernels and k in ESTIMATOR_KERNELS else 0
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

    l1, mx = dist("kernels", "plain")
    print(f"kernel path vs plain path (bf16), forced {FRAMES} frames: mel L1 {l1:.3e}, "
          f"max |diff| {mx:.3e} of the mel's dynamic range {span:.1f} "
          f"(bounds {MEL_L1_BOUND:.0e}, {MEL_MAX_BOUND:.0e})", flush=True)
    for a in ("kernels", "int8", "plain"):
        print(f"  {a} vs plain f32: mel L1 %.3e, max |diff| %.3e" % dist(a, "plain_f32"),
              flush=True)
    if not (l1 <= MEL_L1_BOUND and mx <= MEL_MAX_BOUND):
        raise AssertionError(f"kernel path mel differs from the plain path: L1 {l1}, max {mx}")
    ratio = dist("int8", "plain_f32")[0] / dist("kernels", "plain_f32")[0]
    print(f"int8 gate: int8 path / bf16 kernel path mel L1 vs plain f32 = {ratio:.4f} "
          f"(bound {INT8_GATE_RATIO})", flush=True)
    if not ratio <= INT8_GATE_RATIO:
        raise AssertionError(f"int8 gate failed: ratio {ratio} > {INT8_GATE_RATIO}")

    cfg = config_from_dict(ckpt["config"])
    mel = mels["plain_f32"]
    wavs, times = {}, {}
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("plain", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        voc = build_modules(cfg, device=dev, dtype=dtype, use_kernels=kernels)["vocoder"]
        voc.load_state_dict(ckpt["vocoder"])
        voc.eval().requires_grad_(False)
        want = {k: per_call["per_call"][k] if kernels and k in VOCODER_KERNELS else 0
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
    return {"mel_l1": l1, "mel_max": mx, "int8_gate_ratio": ratio,
            "voc_wave_l1": wl1, "voc_ms": times}


def main() -> int:
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

    print("kernel vs plain (bf16, B=3, lengths 344/301):", flush=True)
    records = check_kernels(torch, dev)

    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_requests(torch, tmp)
        paths = compare_paths(torch, dev, os.path.join(tmp, "ckpt.pt"), records)

    kernels = []
    for name in KERNELS:
        sites = [r for r in records if r["name"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": sites[0]["source"],
            "replaces": sites[0]["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in sites),
            # per estimator call at the 344-frame bucket (per vocoder call for
            # the AA-snake kernels): every site's median times its launches
            # per call on the int8 path, and on the bf16 kernel path
            "ms": sum(r["ms"] * r["per_call"] for r in sites),
            "plain_ms": sum(r["plain_ms"] * r["per_call"] for r in sites),
            "ms_no_int8": sum(r["ms"] * r["per_call_no_int8"] for r in sites),
            "plain_ms_no_int8": sum(r["plain_ms"] * r["per_call_no_int8"] for r in sites),
            "sites": [{k: r[k] for k in ("site", "per_call", "per_call_no_int8", "max_abs_err",
                                         "bound", "ms", "plain_ms")} for r in sites],
        })
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
