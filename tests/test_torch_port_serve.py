"""The serving slice: the port's Synthesizer serving modes against the JAX
Synthesizer's (the padded batched encode, the bucket switch's choice and
fits, batched synthesis with per-row voices at the same bucket, the guessed
modes' fits), the modes against each other (a switch hit against the exact
path, each row of a batch against the single request), then the dynamic
batcher and its HTTP front end (mirroring tests/test_serve.py) and `cli
serve --dry-run` on the CPU.

Parameters come from tests/test_torch_port_tts.py's slice_pair (JAX init
redrawn from numpy seeds); noise is drawn with numpy and injected on both
sides. Tolerances: the mel within test_torch_port_tts._mel_tol (1e-3 of the
mel range), the waveform within its vocoder tolerance (5e-3 absolute).
Every wait below has its own time limit, and every batcher and server is
shut down in a finally or a fixture's teardown."""

import base64
import dataclasses
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tts import (  # noqa: F401 (slice_pair is a fixture)
    GUIDANCE,
    STEPS,
    TINY,
    TOKENS,
    _mel_tol,
    _port,
    slice_pair,
)
from unitspeech_tpu.infer import tts as jtts
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.infer.calibration import DurationCalibrator
from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu_torch.serve import (
    DynamicBatcher,
    Future,
    Overloaded,
    _normalize_sampler_spec,
    _Request,
    build_batcher,
    encode_wav_bytes,
    make_http_server,
)
from unitspeech_tpu_torch.utils.params import random_params

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

WAIT = 60  # seconds: the limit of every single wait
SEQS = [TOKENS, TOKENS[:7], TOKENS[3:7]]  # 91 / 42 / 47 frames with _voices(3)
WAV_TOL = 5e-3


def _voices(n, seed=3):
    v = np.random.default_rng(seed).standard_normal((n, 8)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _jax_encode(jsynth, seqs, spk):
    """JAX's batched encode (synthesize_batch's packing, per-row spk)."""
    m = jsynth.models
    tb = choose_bucket(max(len(s) for s in seqs), jsynth.token_buckets)
    packed = np.zeros((len(seqs), tb + 1), np.int32)
    for i, s in enumerate(seqs):
        packed[i, :len(s)], packed[i, -1] = s, len(s)
    return jtts._encode_and_duration(m.text_encoder, m.text_encoder_params, m.duration_predictor,
                                     m.duration_predictor_params, jnp.asarray(packed),
                                     jnp.asarray(spk))


def _noise(b, y_pad, seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, y_pad, 16)).astype(np.float32),
            rng.standard_normal((steps, b, y_pad, 16)).astype(np.float32))


def test_padded_encode_matches_unpadded(slice_pair):
    """The serving modes pad the token axis (JAX does in every mode); the
    exact path encodes the true tokens alone: mu_x within f32 round-off and
    the same durations on the true tokens, per-row speakers included."""
    _, ckpt = slice_pair
    synth = _port(ckpt)
    tokens, lengths = synth._pack(SEQS)
    assert tokens.shape == (3, 16) and list(lengths) == [12, 7, 4]
    spk = torch.from_numpy(_voices(3))
    mu, xm, w = synth._encode_and_duration(tokens, lengths, spk)
    for i, s in enumerate(SEQS):
        mu1, xm1, w1 = synth._encode_and_duration([s], [len(s)], spk[i:i + 1])
        np.testing.assert_allclose(mu[i, :len(s)].numpy(), mu1[0].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(w[i, :len(s)].numpy(), w1[0].numpy())
        assert not w[i, len(s):].any() and not mu[i, len(s):].any()
    # the default speaker broadcast is the model's own
    np.testing.assert_array_equal(synth.encode(TOKENS)[2].numpy(),
                                  synth._encode_and_duration([TOKENS], [12],
                                                             synth._spk_rows(1))[2].numpy())


def test_batch_matches_jax(slice_pair):
    """A batch of 3 with mixed lengths and per-row voices on the kernel path
    against JAX's batched encode + _align_and_sample at the same bucket
    (synthesize_batch's composition, with the voices and the noise JAX's
    synthesize_batch cannot take): the same lengths and bucket, the mel
    within _mel_tol, then each wav within the vocoder tolerance."""
    jsynth, ckpt = slice_pair
    spk = _voices(3)
    mu_x, x_mask, w_ceil = _jax_encode(jsynth, SEQS, spk)
    y_lengths = np.maximum(np.asarray(jnp.sum(w_ceil, axis=1)).astype(np.int64), 1)
    y_pad = choose_bucket(fix_len_compatibility(int(y_lengths.max()), 1), jsynth.frame_buckets)
    assert len(set(y_lengths)) == 3  # mixed lengths
    noise_z, noises = _noise(3, y_pad, 7)
    m = jsynth.models
    want, _ = jtts._align_and_sample(
        m.decoder.apply, m.decoder_params, mu_x, x_mask, w_ceil, None, jnp.asarray(spk),
        jax.random.PRNGKey(0), m.mel_min, m.mel_max, n_timesteps=STEPS,
        text_gradient_scale=1.0, spk_gradient_scale=1.0, beta_min=m.cfg.decoder.beta_min,
        beta_max=m.cfg.decoder.beta_max, y_pad=y_pad, noise_z=jnp.asarray(noise_z),
        noises=jnp.asarray(noises))
    want = np.asarray(want)
    synth = _port(ckpt)
    got, got_len = synth.synthesize_mel_batch(SEQS, diffusion_steps=STEPS, spk=spk,
                                              noise_z=torch.from_numpy(noise_z),
                                              noises=torch.from_numpy(noises), **GUIDANCE)
    np.testing.assert_array_equal(got_len, y_lengths)
    assert got.shape == want.shape == (3, y_pad, 16)
    assert np.isfinite(want).all() and np.ptp(want) > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_mel_tol(ckpt))
    wav_want = np.asarray(jsynth.vocode(jnp.asarray(want)))
    np.testing.assert_allclose(synth.vocode(got).numpy(), wav_want, rtol=0, atol=WAV_TOL)
    outs = synth.synthesize_batch(SEQS, diffusion_steps=1, spk=spk, **GUIDANCE)
    assert [len(w) for w, _ in outs] == [4 * int(y) for y in y_lengths]


def test_switch_choice_matches_jax(slice_pair):
    """The bucket switch's choice and fits against JAX's
    _synthesize_bucket_switch on the same batch (one step, no guidance:
    the choice depends on the durations alone): its y_lengths and fits, and
    its bucket, where its mel (padded to the window's top with zeros) ends;
    then the port's _switch_dispatch on the same batch: a hit samples at
    that bucket, an overflow samples nothing."""
    jsynth, ckpt = slice_pair
    m = jsynth.models
    synth = _port(ckpt)
    spk = _voices(3)
    y_max = int(np.maximum(np.asarray(_jax_encode(jsynth, SEQS, spk)[2]).sum(1), 1).max())
    above = [b for b in jsynth.frame_buckets if b >= y_max]
    below = [b for b in jsynth.frame_buckets if b < y_max]
    window = (below[-3], above[1])  # non-contiguous; SEQS hit its second branch
    fits_seen = []
    # the same shapes (token bucket 16) compile once: SEQS, then a longer
    # first row that overflows the window
    for seqs in (SEQS, [TOKENS + TOKENS[:4]] + SEQS[1:]):
        tokens, lengths = synth._pack(seqs)
        packed = np.concatenate([tokens, lengths[:, None]], axis=1).astype(np.int32)
        jw, jmel, jy, jfits, *_ = jtts._synthesize_bucket_switch(
            m.text_encoder, m.text_encoder_params, m.duration_predictor,
            m.duration_predictor_params, m.decoder.apply, m.decoder_params, m.vocoder,
            m.vocoder_params, jnp.asarray(packed), jnp.asarray(spk), jax.random.PRNGKey(0),
            m.mel_min, m.mel_max, buckets=window, upsample=4, n_timesteps=1, length_scale=1.0,
            text_gradient_scale=0.0, spk_gradient_scale=0.0, beta_min=m.cfg.decoder.beta_min,
            beta_max=m.cfg.decoder.beta_max)
        jmel = np.asarray(jmel)
        j_bucket = int(np.nonzero(np.abs(jmel).sum(axis=(0, 2)))[0].max()) + 1
        bucket, fits = ttts.switch_choice(int(np.asarray(jy).max()), window)
        assert (bucket, fits) == (j_bucket, bool(jfits)), seqs
        d = dataclasses.replace(synth, switch_buckets=window)._switch_dispatch(
            tokens, lengths, None, 1, 1.0, 0.0, 0.0, spk=spk)
        np.testing.assert_array_equal(d.y_lengths, np.asarray(jy))
        assert (d.bucket, d.fits) == (bucket, fits)
        assert (d.mel is None) == (not fits) and (d.mel is None or d.mel.shape[1] == bucket)
        fits_seen.append(fits)
    assert fits_seen == [True, False] and ttts.switch_choice(y_max, window) == (above[1], True)


def test_single_dispatch_fits_matches_jax(slice_pair):
    """The guessed modes' pass at a bucket chosen up front: y_lengths and
    fits equal JAX's _synthesize_single_dispatch at a bucket the batch
    overflows; at a bucket that holds it the port's pass fits; a miss's
    fallback samples at the exact bucket of the longest row, reusing the
    encoder outputs."""
    jsynth, ckpt = slice_pair
    m = jsynth.models
    synth = _port(ckpt)
    tokens, lengths = synth._pack(SEQS[:2])
    packed = np.concatenate([tokens, np.zeros_like(tokens), lengths[:, None]],
                            axis=1).astype(np.float32)
    out = jtts._synthesize_single_dispatch(
        m.text_encoder, m.text_encoder_params, m.duration_predictor,
        m.duration_predictor_params, m.decoder.apply, m.decoder_params, m.vocoder,
        m.vocoder_params, jnp.asarray(packed), jnp.broadcast_to(m.spk_emb, (2, 8)),
        jax.random.PRNGKey(0), m.mel_min, m.mel_max, frame_bucket=64, n_timesteps=1,
        length_scale=1.0, text_gradient_scale=0.0, spk_gradient_scale=0.0,
        beta_min=m.cfg.decoder.beta_min, beta_max=m.cfg.decoder.beta_max)
    d = synth._single_dispatch(tokens, lengths, None, 64, None, 1, 1.0, 0.0, 0.0)
    np.testing.assert_array_equal(d.y_lengths, np.asarray(out[2]))
    assert d.fits is bool(out[4]) is False and d.mel.shape[1] == 64
    f = synth._fallback(d, None, 1, 0.0, 0.0)
    assert f.bucket == choose_bucket(fix_len_compatibility(int(d.y_lengths.max()), 1),
                                     synth.frame_buckets) == f.mel.shape[1] and f.fits
    hit = synth._single_dispatch(tokens, lengths, None, 104, None, 1, 1.0, 0.0, 0.0)
    assert hit.fits and hit.mel.shape[1] == 104
    np.testing.assert_array_equal(hit.y_lengths, d.y_lengths)


def test_switch_hit_equals_exact_path(slice_pair):
    """__call__ on a switch window holding the exact path's bucket gives
    the exact path's waveform and mel (the same injected noise): the padded
    encode against the unpadded one, then the same sampler at the same
    bucket. With a calibrator attached the switch observes the total."""
    _, ckpt = slice_pair
    synth = _port(ckpt)
    y_len = int(synth.encode(TOKENS)[2].sum())
    y_pad = choose_bucket(fix_len_compatibility(y_len, 1), synth.frame_buckets)
    noise_z, noises = _noise(1, y_pad, 9)
    kw = dict(diffusion_steps=STEPS, noise_z=torch.from_numpy(noise_z),
              noises=torch.from_numpy(noises), **GUIDANCE)
    want_wav, sr, want_mel = synth(TOKENS, **kw)
    cal = DurationCalibrator(n_vocab=40)
    switch = dataclasses.replace(synth, switch_buckets=(y_pad - 64, y_pad, y_pad + 64),
                                 calibrator=cal)
    got_wav, got_sr, got_mel = switch(TOKENS, **kw)
    assert got_sr == sr and got_wav.shape == want_wav.shape == (y_len * 4,)
    np.testing.assert_allclose(got_mel.numpy(), want_mel.numpy(), rtol=0, atol=_mel_tol(ckpt))
    np.testing.assert_allclose(got_wav, want_wav, rtol=0, atol=WAV_TOL)
    assert cal.observed_totals() == [float(y_len)]


def test_row_independence_plain_f32(slice_pair):
    """On the plain f32 path at a fixed bucket, row i of a batch (its own
    length, voice and noise) equals the single request with row i's noise:
    GroupNorm and the attention pool over one row's frames only."""
    _, ckpt = slice_pair
    synth = _port(ckpt, use_kernels=False)
    tokens, lengths = synth._pack(SEQS)
    spk = torch.from_numpy(_voices(3))
    mu, xm, w = synth._encode_and_duration(tokens, lengths, spk)
    y_pad = 104
    noise_z, noises = (torch.from_numpy(a) for a in _noise(3, y_pad, 11, steps=2))
    batch, _ = synth._align_and_sample(mu, xm, w, y_pad, 2, 1.0, 1.0, None, noise_z, noises,
                                       "ddpm", spk)
    for i in range(3):
        one, _ = synth._align_and_sample(mu[i:i + 1], xm[i:i + 1], w[i:i + 1], y_pad, 2, 1.0, 1.0,
                                         None, noise_z[i:i + 1], noises[:, i:i + 1], "ddpm",
                                         spk[i:i + 1])
        np.testing.assert_allclose(batch[i].numpy(), one[0].numpy(), rtol=0,
                                   atol=_mel_tol(ckpt))


def test_guessed_modes_and_fallbacks(slice_pair):
    """__call__'s calibrated mode (after calibrate: the guessed bucket; a
    guess too small falls back to the exact bucket) and the constant-ratio
    mode (a ratio too small re-runs the exact path): every waveform has the
    exact path's length; calibrate observes pre-scale durations."""
    _, ckpt = slice_pair
    synth = _port(ckpt)
    y_len = int(synth.encode(TOKENS)[2].sum())
    cal = DurationCalibrator(n_vocab=40, min_samples=2)
    cal_synth = dataclasses.replace(synth, calibrator=cal)
    cal_synth.calibrate([TOKENS, TOKENS[:5], TOKENS[4:]])
    assert cal.ready and cal.observed_totals()[0] == float(y_len)
    kw = dict(diffusion_steps=1, text_gradient_scale=0.0, spk_gradient_scale=0.0)
    wav, _, mel = cal_synth(TOKENS, **kw)
    assert wav.shape == (4 * y_len,) and mel.shape[0] == y_len
    cal.max_margin, cal._residuals = 0.3, [0.3] * 8  # guesses far too short: a miss
    assert cal.guess_frames(TOKENS) < y_len
    wav, _, _ = cal_synth(TOKENS, **kw)
    assert wav.shape == (4 * y_len,)
    for ratio in (1.0, 200.0):  # a miss (exact re-run) and a hit at a larger bucket
        wav, _, _ = dataclasses.replace(synth, speculative_frames_per_token=ratio)(TOKENS, **kw)
        assert wav.shape == (4 * y_len,)
    # the exact path feeds an attached calibrator, pre-scale
    fresh = DurationCalibrator(n_vocab=40)
    dataclasses.replace(synth, calibrator=fresh)(TOKENS, length_scale=2.0, **kw)
    assert fresh.observed_totals() == [float(y_len)]


def test_k4_takes_every_estimator_width():
    """K4 at C = 1024, the F = 10 stage of buckets of 880 frames and up,
    where the T * F >= 1024 gate passes (JAX runs its Pallas kernel there):
    csrc/rezero_attention.cu stages the weights where they fit and streams
    them through the x ring above C = 512. Its shared-memory arithmetic
    replayed (kv_smem_of / out_smem_of, the layout out_slots picks): every
    multiple of 128 up to 2048 fits both phases, so `takes` holds for each,
    and every attention site of a 1256-frame bucket takes the kernel."""
    from unitspeech_tpu_torch.models.unet import RezeroAttention
    from unitspeech_tpu_torch.ops import fused_attention

    smem_max, tile, kvc, ctx, bars = 232448, 128 * 64 * 2, 64, 2 * 4 * 32 * 40 * 2, 128

    def kv_smem(c, ws):
        return 1024 + (4 * 2 * tile if ws else (c // 64) * tile + 4 * tile) + 11 * kvc * 4 + bars

    def out_smem(c, n_xs, n_os, wq_ring):
        return (1024 + (0 if wq_ring else (c // 64) * tile) + n_os * 2 * tile
                + n_xs * (2 * tile if wq_ring else tile) + ctx + bars)

    for c in range(128, 2049, 128):
        ws = kv_smem(c, False) > smem_max
        assert ws == (c > 512) and kv_smem(c, ws) <= smem_max, c
        slots = next(s for s in [(4, c // 128, 0), (2, 1, 0), (4, min(2, c // 128), 1)]
                     if out_smem(c, *s) <= smem_max)
        assert slots[2] == (c > 512), c
        assert fused_attention.takes(c), c
    for t, f, c in [(157, 10, 1024), (157, 20, 512), (314, 40, 256), (628, 80, 128),
                    (110, 10, 1024)]:  # 1256 frames, then the F = 10 stage of 880
        assert RezeroAttention(c, 4, 32).uses_kernel(torch.zeros(1, t, f, c), True), (t, c)
    # the bucket below, 784 frames: 980 tokens, under the gate
    assert not RezeroAttention(1024, 4, 32).uses_kernel(torch.zeros(1, 98, 10, 1024), True)


def test_device_activity_counts_records_by_name(monkeypatch):
    """kernel_breakdown.device_activity(names=True), which chip_smoke.py's
    serving phase holds to the launch counters: each record counted once
    under its short name (template arguments kept), per call."""
    from types import SimpleNamespace

    from unitspeech_tpu_torch.tools import kernel_breakdown

    def ev(name, start):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start),
                               device_time=1.0)

    trace = [ev("(anonymous namespace)::attn_kv(CUtensorMap, int)", 0.0),
             ev("void (anonymous namespace)::row_stats_kernel<__nv_bfloat16, true>(float*)", 2.0),
             ev("(anonymous namespace)::attn_kv(CUtensorMap, int)", 4.0),
             ev("(anonymous namespace)::attn_out(CUtensorMap, OutArgs)", 6.0)]
    monkeypatch.setattr(kernel_breakdown, "_device_events", lambda fn, reps: trace)
    got = kernel_breakdown.device_activity(None, 2, names=True)
    assert got["by_name"] == {"attn_kv": 1.0, "row_stats_kernel<__nv_bfloat16, true>": 0.5,
                              "attn_out": 0.5}
    assert got["launches"] == 2.0 and "by_name" not in kernel_breakdown.device_activity(None, 2)


# -- the batcher and its HTTP front end (tests/test_serve.py's behaviour) ----


def _tiny_synth(seed=0):
    cfg = dict(TINY, text_encoder=dict(TINY["text_encoder"], n_vocab=40))
    from unitspeech_tpu_torch.config import config_from_dict

    return ttts.Synthesizer(ttts.TTSModels.from_checkpoint(
        random_params(config_from_dict(cfg), seed), device="cpu", dtype=torch.float32))


def _texts(seed, n=8, lo=6, hi=9):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 39, int(rng.integers(lo, hi)))) for _ in range(n)]


FAST = dict(default_steps=2, text_gradient_scale=0.0, spk_gradient_scale=0.0)


@pytest.fixture(scope="module")
def batcher():
    voices = {name: np.random.default_rng(i).standard_normal(8)
              for i, name in enumerate(("alice", "bob"))}
    b = build_batcher(_tiny_synth(), calibration_texts=_texts(0), max_batch=4, max_wait_ms=300.0,
                      warmup_token_lengths=(8,), bucket_policy="quantile", voices=voices,
                      **FAST)
    yield b
    b.shutdown()


def test_single_request_roundtrip(batcher):
    wav, sr = batcher.submit([3, 1, 4, 1, 5]).result(timeout=WAIT)
    assert sr == 22050 and wav.ndim == 1 and wav.shape[0] % 4 == 0 and wav.shape[0] > 0
    assert np.isfinite(wav).all()


def test_concurrent_requests_batch_together(batcher):
    """Requests queued inside the wait window ride one dispatch."""
    before = batcher.stats.batches
    futs = [batcher.submit([1 + i, 5, 9, 2]) for i in range(4)]
    outs = [f.result(timeout=WAIT) for f in futs]
    assert all(np.isfinite(w).all() and w.shape[0] > 0 for w, _ in outs)
    assert batcher.stats.batches - before <= 2 and max(batcher.stats.batch_sizes) >= 2


def test_partial_batch_pads_with_repeat_rows(batcher):
    """3 requests on the {1, 2, 4} ladder pad to 4 with a repeat of a real
    row (tokens, lengths and voice), so the frame bucket is that of the 3
    real rows; every real request gets its own waveform."""
    seen = []
    real = batcher.synth._switch_dispatch

    def spy(tokens, lengths, *a, **kw):
        seen.append((tokens.copy(), lengths.copy(), kw.get("spk")))
        return real(tokens, lengths, *a, **kw)

    batcher.synth._switch_dispatch = spy
    try:
        futs = [batcher.submit(t, speaker=s) for t, s in
                (([2, 4, 6, 8], "alice"), ([2, 4], None), ([9, 4, 6], "bob"))]
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        del batcher.synth._switch_dispatch
    tokens, lengths, spk = seen[-1]
    assert tokens.shape[0] == 4 and list(lengths) == [4, 2, 3, 4]
    np.testing.assert_array_equal(tokens[3], tokens[0])
    np.testing.assert_array_equal(spk[3], spk[0])
    assert all(sr == 22050 and w.shape[0] > 0 and np.isfinite(w).all() for w, sr in outs)


def test_dispatcher_thread_owns_inference_mode(batcher):
    """The dispatcher thread enters inference mode itself (grad mode is per
    thread in PyTorch) and is the thread that runs the batch."""
    seen = []
    real = batcher._run

    def spy(synth, batch):
        seen.append((threading.current_thread().name, torch.is_inference_mode_enabled()))
        return real(synth, batch)

    batcher._run = spy
    try:
        batcher.submit([5, 6, 7]).result(timeout=WAIT)
    finally:
        del batcher._run
    assert seen == [("tts-dispatcher", True)]


def test_stats_recent_frames_ring(batcher):
    wav, _ = batcher.submit([7, 3, 2, 8]).result(timeout=WAIT)
    snap = batcher.stats.snapshot()
    frames, toks = snap["recent_frames"], snap["recent_tokens"]
    assert frames and all(isinstance(x, int) and x > 0 for x in frames)
    assert frames[-1] * 4 == wav.shape[0]
    assert len(toks) == len(frames) and toks[-1] == 4


def test_sampler_groups_never_mix(batcher):
    before = batcher.stats.batches
    futs = [batcher.submit([1, 2, 3]) for _ in range(2)]
    futs += [batcher.submit([1, 2, 3], sampler="dpm2", steps=2) for _ in range(2)]
    outs = [f.result(timeout=WAIT) for f in futs]
    assert all(np.isfinite(w).all() for w, _ in outs)
    assert batcher.stats.batches - before >= 2


def test_solo_request_never_batched(batcher):
    before_ones = batcher.stats.batch_sizes.get(1, 0)
    f0 = batcher.submit([9, 8, 7], solo=True)
    rest = [batcher.submit([9, 8, 7]) for _ in range(3)]
    outs = [f.result(timeout=WAIT) for f in [f0] + rest]
    assert all(np.isfinite(w).all() and w.shape[0] > 0 for w, _ in outs)
    assert batcher.stats.batch_sizes.get(1, 0) >= before_ones + 1


def test_multi_voice_batch(batcher):
    """Named voices are per-row conditioning: mixed speakers pack into one
    batch and give speaker-dependent audio."""
    toks = [5, 4, 3, 2]
    futs = [batcher.submit(toks), batcher.submit(toks, speaker="alice"),
            batcher.submit(toks, speaker="bob")]
    w_def, w_alice, w_bob = (f.result(timeout=WAIT)[0] for f in futs)
    assert w_alice.shape != w_bob.shape or not np.allclose(w_alice, w_bob)
    assert w_def.shape != w_alice.shape or not np.allclose(w_def, w_alice)


def test_unknown_speaker_rejected(batcher):
    with pytest.raises(ValueError, match="unknown speaker"):
        batcher.submit([1, 2, 3], speaker="nobody")


def test_stats_padding_and_dispatch(batcher):
    before_real = batcher.stats.real_rows
    futs = [batcher.submit([6, 6, 6]) for _ in range(3)]
    for f in futs:
        f.result(timeout=WAIT)
    snap = batcher.stats.snapshot()
    assert batcher.stats.real_rows - before_real == 3
    assert snap["mean_dispatch_s"] > 0.0 and 0.0 <= snap["padding_waste"] < 1.0


def test_concurrent_submitters_lose_nothing():
    """24 threads (more than this machine's cores) submit at once with a
    short switch interval: every request resolves to its own length, and
    the stats count each one once (a lost update would show)."""
    import sys

    synth = _tiny_synth()
    b = DynamicBatcher(dataclasses.replace(synth, switch_buckets=(256, 512)), max_batch=4,
                       max_wait_ms=5.0, default_steps=1, text_gradient_scale=0.0,
                       spk_gradient_scale=0.0)
    seqs = _texts(9, n=24, lo=2, hi=6)
    want = [int(synth.encode(s)[2].sum()) * 4 for s in seqs]
    outs, interval = [None] * len(seqs), sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(i):
            outs[i] = b.submit(seqs[i]).result(timeout=WAIT)[0].shape[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(seqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.shutdown()
    assert outs == want
    assert b.stats.requests == b.stats.real_rows == len(seqs) == sum(
        n * k for n, k in b.stats.batch_sizes.items())
    assert len(b.stats.recent_frames) == len(seqs) and b.stats.errors == 0


def test_warmup_runs_the_grid_and_resets_stats():
    """warmup samples each (batch ladder x token bucket x window bucket)
    once, marks the group and token ceiling warmed, and leaves /stats and
    the calibrator untouched; a new window's warm-up (_warm_synth) samples
    each of its buckets at every ladder size."""
    synth = _tiny_synth()
    b = DynamicBatcher(dataclasses.replace(synth, switch_buckets=(64, 128)), max_batch=2, **FAST)
    sampled = []

    def spy(s):
        real = s._align_and_sample

        def run(mu_x, x_mask, w_ceil, y_pad, *args, **kwargs):
            sampled.append((mu_x.shape[0], mu_x.shape[1], int(y_pad)))
            return real(mu_x, x_mask, w_ceil, y_pad, *args, **kwargs)
        s._align_and_sample = run
        return s

    spy(b.synth)
    try:
        b.warmup((8, 20))
        # ladder {1, 2} x token buckets {16, 32} x the window's 2 buckets
        assert sorted(sampled) == sorted((n, t, f) for n in (1, 2) for t in (16, 32)
                                         for f in (64, 128))
        assert b.stats.batches == 0 and b._warmed_max_tokens == 32
        assert b._warmed_groups == {(2, "ddpm")}
        sampled.clear()
        b._warm_synth(spy(dataclasses.replace(synth, switch_buckets=(40, 96))))
        assert sorted(sampled) == sorted((n, t, f) for n in (1, 2) for t in (16, 32)
                                         for f in (40, 96))
    finally:
        b.shutdown()


def test_overflow_falls_back_to_correct_length():
    """A request overflowing the switch window synthesizes at its true
    length through the batched fallback (the encoder outputs reused)."""
    synth = _tiny_synth()
    y_len = int(synth.encode([1] * 12)[2].sum() * 8.0)
    below = [b for b in synth.frame_buckets if b < y_len]
    b = DynamicBatcher(dataclasses.replace(synth, switch_buckets=(below[-1],)), max_batch=2,
                       max_wait_ms=5.0, length_scale=8.0, **FAST)
    try:
        wav, _ = b.submit([1] * 12).result(timeout=WAIT)
        assert wav.shape[0] == y_len * 4 and b.stats.overflows == 1
    finally:
        b.shutdown()


def test_submit_rejects_empty_and_after_shutdown():
    synth = _tiny_synth()
    b = DynamicBatcher(dataclasses.replace(synth, switch_buckets=(synth.frame_buckets[2],)),
                       max_batch=1, max_wait_ms=1.0, **FAST)
    with pytest.raises(ValueError):
        b.submit([])
    b.shutdown()
    with pytest.raises(RuntimeError):
        b.submit([1, 2])


def test_strict_grid_refuses_what_was_not_warmed():
    b = build_batcher(_tiny_synth(), calibration_texts=_texts(0), max_batch=2, max_wait_ms=5.0,
                      warmup_token_lengths=(8,), bucket_policy="quantile", strict_grid=True,
                      **FAST)
    try:
        assert b.submit([1, 2, 3]).result(timeout=WAIT)[0].shape[0] > 0
        with pytest.raises(ValueError, match="warmed"):
            b.submit([1, 2, 3], steps=7)
        with pytest.raises(ValueError):
            b.submit([1, 2, 3], sampler="dpm2")
        with pytest.raises(ValueError, match="tokens exceeds"):
            b.submit([1] * (b._warmed_max_tokens + 1))
    finally:
        b.shutdown()


def test_strict_grid_overflow_refused():
    synth = _tiny_synth()
    y_len = int(synth.encode([1] * 12)[2].sum() * 8.0)
    below = [b for b in synth.frame_buckets if b < y_len]
    b = DynamicBatcher(dataclasses.replace(synth, switch_buckets=(below[-1],)), max_batch=2,
                       max_wait_ms=5.0, length_scale=8.0, strict_grid=True, **FAST)
    b._warmed_groups.add((b.default_steps, b.default_sampler))
    b._warmed_max_tokens = 64
    try:
        with pytest.raises(RuntimeError, match="overflowed the switch"):
            b.submit([1] * 12).result(timeout=WAIT)
        assert b.stats.overflows == 1
    finally:
        b.shutdown()


def test_refresh_window_from_served_traffic():
    """refresh_window re-derives the window from the served lengths under
    the card's measured cost model and hot-swaps it; its guards hold and
    serving goes on on the live window."""
    from unitspeech_tpu_torch.infer import bucket_cost

    rng = np.random.default_rng(5)
    b = build_batcher(_tiny_synth(), calibration_texts=_texts(5), max_batch=2,
                      warmup_token_lengths=(8,), **FAST)
    try:
        d = b.refresh_window(min_samples=4)
        assert d["refreshed"] is False and "served lengths" in d["reason"]
        futs = [b.submit(list(rng.integers(1, 39, 4))) for _ in range(5)]
        futs.append(b.submit(list(rng.integers(1, 39, 30))))
        for f in futs:
            f.result(timeout=WAIT)
        assert len(b.stats.recent_frames) == 6
        old = tuple(b.synth.switch_buckets)
        d = b.refresh_window(policy="cost", min_samples=4, max_branches=3)
        assert d["n_lengths"] == 6
        want_tok = np.mean([bucket_cost.token_cost_ms(choose_bucket(t, b.synth.token_buckets))
                            for t in b.stats.recent_tokens])
        assert d["token_cost_ms"] == round(float(want_tok), 2)
        if d["refreshed"]:
            assert tuple(b.synth.switch_buckets) == tuple(d["window"])
            assert b.stats.window_refreshes == 1
        else:
            assert d["reason"] == "window unchanged" and tuple(b.synth.switch_buckets) == old
        assert b.submit([3, 1, 4]).result(timeout=WAIT)[0].shape[0] > 0
        assert b.refresh_window(policy="cost", min_samples=4, min_gain=10.0)["refreshed"] is False
        with pytest.raises(ValueError):
            b.refresh_window(policy="nonsense", min_samples=1)
    finally:
        b.shutdown()


def test_queue_backpressure_503():
    """At max_queue pending requests submit() sheds load with Overloaded;
    the HTTP layer maps it to 503 + Retry-After."""
    synth = _tiny_synth()
    synth = dataclasses.replace(synth, switch_buckets=(synth.frame_buckets[2],))
    b = DynamicBatcher(synth, max_batch=1, max_wait_ms=1.0, max_queue=2, **FAST)
    gate, entered = threading.Event(), threading.Event()
    inner = b._dispatch
    b._dispatch = lambda batch: (entered.set(), gate.wait(WAIT), inner(batch))[2]
    try:
        futs = [b.submit([1, 2, 3])]
        assert entered.wait(WAIT)
        futs += [b.submit([1, 2, 3]) for _ in range(2)]
        with pytest.raises(Overloaded, match="queue full"):
            b.submit([1, 2, 3])
        assert b.stats.rejected == 1
        gate.set()
        for f in futs:
            assert f.result(timeout=WAIT)[0].shape[0] > 0
    finally:
        gate.set()
        b.shutdown()
    b2 = DynamicBatcher(synth, max_batch=1, max_wait_ms=1.0, max_queue=0, **FAST)
    srv = make_http_server(b2, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, _, body = _post(f"http://127.0.0.1:{srv.server_address[1]}", {"token_ids": [1, 2]})
        assert code == 503 and b"queue full" in body
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(WAIT)
        b2.shutdown()
    assert not t.is_alive() and not b2._thread.is_alive()


def test_encode_wav_bytes_and_sampler_normalization():
    wav = np.sin(np.linspace(0, 40, 400)).astype(np.float32) * 0.5
    with wave.open(io.BytesIO(encode_wav_bytes(wav, 22050))) as w:
        assert w.getframerate() == 22050 and w.getnchannels() == 1
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    np.testing.assert_allclose(pcm / 32767.0, wav, atol=1e-4)
    assert _normalize_sampler_spec("ddpm:cs1") == "ddpm"
    assert _normalize_sampler_spec("dpm2:cs2") == "dpm2:cs2"
    with pytest.raises(ValueError):
        _normalize_sampler_spec("euler")
    a = _Request([1], 2, _normalize_sampler_spec("ddpm"), Future(), 0.0)
    assert a.group_key == _Request([1], 2, _normalize_sampler_spec("ddpm:cs1"), Future(),
                                   0.0).group_key
    with pytest.raises(TimeoutError):
        Future().result(timeout=0.01)


@pytest.fixture(scope="module")
def http_server(batcher):
    srv = make_http_server(batcher, port=0,
                           text_to_ids=lambda s: [1 + (ord(c) % 38) for c in s.strip() or "a"])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(WAIT)
    assert not t.is_alive()


def _post(url, payload, path="/synthesize"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_http_synthesize_wav_json_text(http_server):
    code, ctype, body = _post(http_server, {"token_ids": [3, 1, 4, 1]})
    assert code == 200 and ctype == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 22050 and w.getnframes() > 0
    code, ctype, body = _post(http_server, {"text": "hello", "format": "json"})
    assert code == 200 and ctype == "application/json"
    payload = json.loads(body)
    with wave.open(io.BytesIO(base64.b64decode(payload["wav_base64"]))) as w:
        assert w.getnframes() == payload["n_samples"] > 0


def test_http_rejects_bad_requests(http_server):
    code, _, body = _post(http_server, {})
    assert code == 400 and b"token_ids or text" in body
    assert _post(http_server, {"token_ids": [1], "sampler": "euler"})[0] == 400
    code, _, body = _post(http_server, [1, 2, 3])
    assert code == 400 and b"JSON object" in body
    assert _post(http_server, {"token_ids": 5})[0] == 400
    assert _post(http_server, {"token_ids": [1], "steps": "soon"})[0] == 400
    code, _, body = _post(http_server, {"text": "hi", "speaker": "nobody"})
    assert code == 400 and b"unknown speaker" in body
    assert _post(http_server, {"text": "hi", "speaker": 3})[0] == 400
    assert _post(http_server, {}, path="/nowhere")[0] == 404


def test_http_health_stats_and_refresh_window(http_server, batcher):
    with urllib.request.urlopen(http_server + "/healthz", timeout=WAIT) as r:
        assert json.loads(r.read())["status"] == "ok"
    batcher.submit([5, 2, 7]).result(timeout=WAIT)
    code, _, body = _post(http_server, {"policy": "quantile", "min_samples": 1},
                          path="/refresh_window")
    assert code == 200 and {"refreshed", "window"} <= set(json.loads(body))
    with urllib.request.urlopen(http_server + "/stats", timeout=WAIT) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["batches"] >= 1 and stats["mean_latency_s"] >= 0
    assert stats["switch_buckets"] == [int(x) for x in batcher.synth.switch_buckets]
    assert _post(http_server, {"policy": "bogus", "min_samples": 1},
                 path="/refresh_window")[0] == 400


def test_http_speaker_split_and_stream(http_server):
    """speaker, split (sentence chunks batched, concatenated) and stream
    (chunked audio/wav, the first chunk solo; its PCM as long as the split
    response's)."""
    code, _, body = _post(http_server, {"text": "hi there", "speaker": "alice",
                                        "format": "json"})
    assert code == 200 and json.loads(body)["n_samples"] > 0
    text = "hello there. how are you. fine thanks!"
    code, _, one = _post(http_server, {"text": "hello there.", "format": "json"})
    code, _, body = _post(http_server, {"text": text, "split": True, "format": "json"})
    assert code == 200, body
    n_ref = json.loads(body)["n_samples"]
    assert n_ref > json.loads(one)["n_samples"]
    req = urllib.request.Request(http_server + "/synthesize",
                                 data=json.dumps({"text": text, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        assert r.status == 200 and r.headers.get("Transfer-Encoding") == "chunked"
        header, pcm = r.read(44), r.read()
    assert header[:4] == b"RIFF" and struct.unpack("<I", header[4:8])[0] == 0xFFFFFFFF
    assert struct.unpack("<I", header[24:28])[0] == 22050 and len(pcm) == 2 * n_ref
    req = urllib.request.Request(http_server + "/synthesize",
                                 data=json.dumps({"token_ids": [2, 7, 1, 8],
                                                  "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        body = r.read()
    assert body[:4] == b"RIFF" and len(body) > 44 and (len(body) - 44) % 2 == 0


BLOCKED_SERVE = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from unitspeech_tpu_torch import cli, serve  # noqa: F401
from unitspeech_tpu_torch.infer import bucket_cost, calibration, tts  # noqa: F401
from unitspeech_tpu_torch.tools import cost_anchors  # noqa: F401
from unitspeech_tpu_torch.utils import artifacts  # noqa: F401

cfg, ckpt = sys.argv[1:3]
cli.main_make_random_checkpoint(["--seed", "3", "--config", cfg, "--output", ckpt])
assert cli.main(["serve"] + sys.argv[3:]) == 0
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_cli_serve_dry_run_on_cpu(tmp_path):
    """`cli serve --dry-run --device cpu` with every import of jax, flax or
    unitspeech_tpu refused (the serving modules, the calibrator, the cost
    model and its tool import neither): load, calibrate from an IPA file,
    warm the grid, print the serving configuration, with a voice bank. The
    card is the default: with no CUDA device it exits, no fallback."""
    import os
    import subprocess
    import sys

    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "cal.txt").write_text("həloʊ wɜːld\nðə kwɪk bɹaʊn fɑks\nhaʊ ɑɹ ju\nfaɪn\n")
    np.savez(tmp_path / "voices.npz", alice=np.ones(8, np.float32), bob=np.arange(8.0))
    ckpt = str(tmp_path / "ckpt.pt")
    args = ["--checkpoint", ckpt, "--calibration-file", str(tmp_path / "cal.txt"),
            "--ipa-calibration", "--max-batch", "2", "--diffusion-steps", "1",
            "--warmup-token-lengths", "16", "--bucket-policy", "quantile", "--voices",
            str(tmp_path / "voices.npz"), "--dry-run"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SERVE, str(tmp_path / "tiny.json"), ckpt,
                           *args, "--device", "cpu"], cwd=root, env=env, capture_output=True,
                          text=True, timeout=WAIT * 3)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout
    got = next(json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{"))["serving_config"]
    assert got["batch_ladder"] == [1, 2] and got["voices"] == ["alice", "bob"]
    assert got["default_steps"] == 1 and got["switch_buckets"] == sorted(got["switch_buckets"])
    assert got["device"] == "cpu" and got["kernels"] and got["int8"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main_serve(args)
