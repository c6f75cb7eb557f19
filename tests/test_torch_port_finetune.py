"""Speaker adaptation in the port against the JAX package on the CPU: the
mel frontend, reflect_extend, process_unit, the forward-diffusion
coefficients, the segment crop, fine_tune_loss and its gradients,
clip_by_global_norm, prepare_finetune_inputs, three iterations of
finetune_decoder (and 20 steps at lr 1e-3, where both packages are
compared for divergence), finetune_decoder_batched at two speakers, then
`cli finetune` -> `cli inference --decoder`, `cli finetune` from a wav
alone through the SSL frontends, and the CLI's refusals; last, marked slow, twelve steps at lr 1e-3 at full
width, the port's loss held to JAX's at the same parameters.

The JAX PRNG streams cannot be reproduced in torch, so the port is fed
JAX's draws (the crop's u, then t, then z: unitspeech_tpu/models/
diffusion.py fine_tune_loss, with the key of each step folded in as
train/finetune.py does). The decoder is a 2-stage estimator at dim 8, the
JAX side jit-compiled once in this file (the 3-step fine-tune)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize, scale_gates
from unitspeech_tpu.config import DecoderConfig, EncoderConfig
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models import encoder as jenc
from unitspeech_tpu.ops import mel as jmel
from unitspeech_tpu.ops import schedule as jsched
from unitspeech_tpu.ops import units as junits
from unitspeech_tpu.train import finetune as jft
from unitspeech_tpu.train.steps import clip_by_global_norm as jclip
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models import encoder as tenc
from unitspeech_tpu_torch.ops import mel as tmel
from unitspeech_tpu_torch.ops import schedule as tsched
from unitspeech_tpu_torch.ops import units as tunits
from unitspeech_tpu_torch.train import finetune as tft
from unitspeech_tpu_torch.train.steps import clip_by_global_norm
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

DEC = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)
UNIT_ENC = dict(n_vocab=50, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                n_heads=2)
SEG, TY, TX, LR, ITERS = 16, 40, 12, 1e-3, 3


# --- the mel frontend ------------------------------------------------------


def _mel_f64(y):
    """The same log-mel in float64 numpy: what both f32 versions round."""
    pad = (1024 - 256) // 2
    yy = np.pad(y.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    n = 1 + (yy.shape[1] - 1024) // 256
    frames = yy[:, np.arange(1024)[None] + 256 * np.arange(n)[:, None]]
    spec = np.fft.rfft(frames * jmel.hann_window(1024).astype(np.float64), axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return np.log(np.clip(mag @ jmel.mel_filterbank().astype(np.float64).T, 1e-5, None))


def test_mel_matches_jax_on_a_random_wav():
    """Within 1e-4 absolute of JAX's log-mel, equal frame counts."""
    rng = np.random.default_rng(0)
    y = (0.5 * rng.standard_normal((2, 22050 + 77))).clip(-1, 1).astype(np.float32)
    want = np.asarray(jmel.mel_spectrogram(y))
    got = tmel.mel_spectrogram(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2, tmel.mel_true_frames(22127), 80)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mel_matches_jax_on_a_sine():
    """A 440 Hz sine: equal frame counts, the peak near band 11, and
    within 1e-4 absolute of JAX's log-mel on the tonal bands (float64
    log-mel above -6, 1127 of the 6880 entries). The bands the Hann
    window's sidelobes leave at the f32 FFT's rounding noise (magnitudes
    ~1e-4 against a peak of ~128) sit just above the 1e-5 floor, where
    JAX's own f32 mel is 2.1e-3 from the float64 one and the port's
    2.4e-3: there both are held to that float64 mel within 5e-3, and to
    each other with the JAX package's own mel bound (tests/test_mel.py:
    linear mel, rtol 3e-3, atol 1e-5)."""
    y = (0.5 * np.sin(2 * np.pi * 440 * np.arange(22050) / 22050))[None].astype(np.float32)
    want = np.asarray(jmel.mel_spectrogram(y))
    got = tmel.mel_spectrogram(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (1, 86, 80)
    assert abs(int(got[0, 40].argmax()) - 11) <= 1
    exact = _mel_f64(y)
    tonal = exact > -6.0
    assert tonal.sum() > 1000
    np.testing.assert_allclose(got[tonal], want[tonal], rtol=0, atol=1e-4)
    for m in (got, want):
        np.testing.assert_allclose(m, exact, rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=3e-3, atol=1e-5)


def test_reflect_extend_keeps_the_exact_mel_prefix():
    """The first mel_true_frames frames of a reflect_extend-ed wav's mel
    equal the exact-length mel bit for bit, and the extension equals
    JAX's."""
    rng = np.random.default_rng(1)
    kw = dict(n_fft=512, num_mels=16, sampling_rate=8000, hop_size=128, win_size=512,
              fmin=0.0, fmax=4000.0)
    for n in (5000, 7777, 16384):
        wav = (rng.standard_normal(n) * 0.2).astype(np.float32)
        t_true = tmel.mel_true_frames(n, 512, 128)
        exact = tmel.mel_spectrogram(torch.from_numpy(wav)[None], **kw)[0]
        assert exact.shape[0] == t_true
        bucket = ((t_true + 63) // 64 + 1) * 64
        ext = tmel.reflect_extend(wav, bucket * 128)
        np.testing.assert_array_equal(ext, jmel.reflect_extend(wav, bucket * 128))
        assert ext.shape[0] == bucket * 128
        np.testing.assert_array_equal(ext[:n], wav)
        bucketed = tmel.mel_spectrogram(torch.from_numpy(ext)[None], **kw)[0]
        assert bucketed.shape[0] == bucket
        assert torch.equal(bucketed[:t_true], exact)
    with pytest.raises(ValueError):
        tmel.reflect_extend(np.zeros(1, np.float32), 10)


def test_normalize_mel_round_trip_and_filterbank():
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.standard_normal((3, 10, 80)).astype(np.float32))
    lo, hi = mel.amin(dim=(0, 1)) - 0.1, mel.amax(dim=(0, 1)) + 0.1
    normed = tmel.normalize_mel(mel, lo, hi)
    assert normed.abs().max() <= 1.0
    torch.testing.assert_close(tmel.denormalize_mel(normed, lo, hi), mel, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))
    np.testing.assert_allclose(tmel.hann_window(1024), torch.hann_window(1024).numpy(),
                               atol=1e-6)


# --- units, schedule, crop, clipping -----------------------------------------


@pytest.mark.parametrize("sr,hop", [(16000, 256), (200, 4), (16000, 320)])
def test_process_unit_equals_jax(sr, hop):
    """Exactly JAX's, ties to the smallest unit (torch.mode), over runs of
    units at 50 Hz; and dedup_consecutive is torch.unique_consecutive."""
    rng = np.random.default_rng(sr + hop)
    units = rng.integers(0, 6, 200)  # a small vocabulary: many ties and repeats
    durations = rng.integers(1, 4, 200)
    got = tunits.process_unit(units, durations, sr, hop)
    want = junits.process_unit(units, durations, sr, hop)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    u, c = torch.unique_consecutive(torch.from_numpy(units), return_counts=True)
    du, dc = tunits.dedup_consecutive(units)
    np.testing.assert_array_equal(du, u.numpy())
    np.testing.assert_array_equal(dc, c.numpy())
    e = tunits.process_unit(units[:1], durations[:1] * 0, sr, hop)
    assert e[0].shape == e[1].shape == (0,)


def test_forward_diffusion_coefficients_match_jax():
    t = np.linspace(1e-5, 1 - 1e-5, 33).astype(np.float32)
    for g, w in zip(tsched.forward_diffusion_coefficients(torch.from_numpy(t), 0.05, 20.0),
                    jsched.forward_diffusion_coefficients(jnp.asarray(t), 0.05, 20.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tsched.get_noise(t, 0.05, 20.0),
                               np.asarray(jsched.get_noise(t, 0.05, 20.0)), rtol=1e-6)


@pytest.mark.parametrize("t_y,lengths", [(40, [40, 23]), (12, [12, 9])], ids=["crop", "pad"])
def test_random_segment_crop_matches_jax(t_y, lengths):
    """The same u gives JAX's crop: offset floor(u * (max_offset + 1))
    capped at max_offset; utterances shorter than the segment zero-padded."""
    rng = np.random.default_rng(t_y)
    y = rng.standard_normal((2, t_y, 16)).astype(np.float32)
    attn = rng.standard_normal((2, 7, t_y)).astype(np.float32)
    y_len = np.array(lengths, np.int32)
    for u in (np.array([0.0, 0.999999], np.float32), rng.uniform(size=2).astype(np.float32)):
        key = jax.random.PRNGKey(0)
        # feed JAX this u: its crop draws uniform(key); replace the draw
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda k, shape, *a, **kw: jnp.asarray(u))
            want = jdiff.random_segment_crop(jnp.asarray(y), jnp.asarray(attn),
                                             jnp.asarray(y_len), SEG, key)
        got = tdiff.random_segment_crop(torch.from_numpy(y), torch.from_numpy(attn),
                                        torch.from_numpy(y_len), SEG, torch.from_numpy(u))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        want, wnorm = jclip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        grads = [torch.from_numpy(tree["a"].copy()), None, torch.from_numpy(tree["b"].copy())]
        norm = clip_by_global_norm(grads, max_norm)
        np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(want["a"]), rtol=1e-6)
        np.testing.assert_allclose(grads[2].numpy(), np.asarray(want["b"]), rtol=1e-6)
    assert np.allclose(grads[0].numpy(), tree["a"])  # under max_norm: unchanged


# --- the fine-tune ---------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """JAX and port twins: the unit encoder, the decoder (2 stages, dim 8,
    gates scaled down) and one utterance's fine-tune inputs from JAX's
    prepare_finetune_inputs."""
    rng = np.random.default_rng(7)
    jue = jenc.Encoder.from_config(EncoderConfig(**UNIT_ENC))
    units = rng.integers(0, 50, TX).astype(np.int32)
    dur = np.full(TX, TY // TX)
    dur[: TY - dur.sum()] += 1
    ue_params = randomize(jax.jit(jue.init)(jax.random.PRNGKey(1), units[None],
                                            np.array([TX])), 8)
    mel = np.tanh(rng.standard_normal((TY, 16))).astype(np.float32)
    jdec = jdiff.UnitSpeech(**DEC)
    z = np.zeros((1, 16, 16), np.float32)
    init = jax.jit(jdec.init)(jax.random.PRNGKey(2), z, np.ones((1, 16), np.float32), z,
                              np.zeros((1,), np.float32), np.zeros((1, 8), np.float32))
    dparams = scale_gates(randomize(init, 9), 0.1)
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    spk /= np.linalg.norm(spk)
    jin = jft.prepare_finetune_inputs(jue, ue_params, units, dur, mel, num_downsamplings=1)
    tue = load(tenc.Encoder.from_config(EncoderConfig(**UNIT_ENC)), ue_params)
    return dict(jue=jue, ue_params=ue_params, tue=tue, units=units, dur=dur, mel=mel,
                jdec=jdec, dparams=jax.device_get(dparams), spk=spk, jin=jin)


def _port_inputs(s):
    return tuple(torch.from_numpy(np.array(x)) for x in s["jin"])


@pytest.mark.parametrize("pad_to", [None, 48])
def test_prepare_finetune_inputs_matches_jax(setup, pad_to):
    s = setup
    want = jft.prepare_finetune_inputs(s["jue"], s["ue_params"], s["units"], s["dur"], s["mel"],
                                       num_downsamplings=1, pad_to=pad_to)
    got = tft.prepare_finetune_inputs(s["tue"], s["units"], s["dur"], s["mel"],
                                      num_downsamplings=1, pad_to=pad_to)
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(w)) for w in want]
    assert not any(g.requires_grad for g in got)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="pad_to"):
        tft.prepare_finetune_inputs(s["tue"], s["units"], s["dur"], s["mel"],
                                    num_downsamplings=1, pad_to=41)


def _jax_draws(key, i, y_shape, seg=SEG):
    """The draws of JAX's fine-tune step i (its key folded with i): the crop's
    u, then the loss's t and z (seg frames), each from its split key."""
    k = jax.random.fold_in(key, i)
    key_seg, key_loss = jax.random.split(k)
    key_t, key_z = jax.random.split(key_loss)
    b = y_shape[0]
    return {"u": torch.from_numpy(np.asarray(jax.random.uniform(key_seg, (b,)))),
            "t": torch.from_numpy(np.asarray(jax.random.uniform(key_t, (b,)))),
            "z": torch.from_numpy(np.asarray(jax.random.normal(key_z, (b, seg, y_shape[2]))))}


def _port_decoder(s):
    dec = tdiff.UnitSpeech(**DEC)
    dec.load_state_dict(params_from_jax(s["dparams"]))
    return dec


def test_fine_tune_loss_and_gradients_match_jax(setup):
    """fine_tune_loss in f32 within 1e-5 relative of JAX's with JAX's draws,
    and every decoder parameter's gradient within rtol 1e-4 of jax.grad's,
    atol 1e-5 of that parameter's largest gradient (f32 sums in another
    order through ~20 normalized layers). The unconditional embeddings are
    unused by the loss: zero in JAX, None in torch."""
    s = setup
    key = jax.random.PRNGKey(5)
    cond_x, y, y_len, attn = s["jin"]

    def loss_fn(p):
        return jdiff.fine_tune_loss(s["jdec"].apply, p, cond_x, y, y_len, attn,
                                    jnp.asarray(s["spk"]), SEG, jax.random.fold_in(key, 0))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(s["dparams"])
    dec = _port_decoder(s)
    c, yy, yl, a = _port_inputs(s)
    loss = tdiff.fine_tune_loss(dec, c, yy, yl, a, torch.from_numpy(s["spk"]), SEG,
                                draws=_jax_draws(key, 0, yy.shape))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.device_get(want_grads))
    for name, p in dec.named_parameters():
        w = want[name].numpy()
        if name in ("text_uncon", "spk_uncon"):
            assert p.grad is None and not np.any(w)
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.fixture(scope="module")
def jax_finetune(setup):
    """JAX's 3-iteration fine-tune (one jit compile)."""
    s = setup
    cond_x, y, y_len, attn = s["jin"]
    params, losses = jft.finetune_decoder(
        s["jdec"].apply, jax.tree_util.tree_map(jnp.array, s["dparams"]), cond_x, y, y_len,
        attn, jnp.asarray(s["spk"]), jax.random.PRNGKey(11), segment_size=SEG, n_iters=ITERS,
        learning_rate=LR, grad_clip=1.0)
    return params_from_jax(jax.device_get(params)), np.asarray(losses)


def test_finetune_decoder_three_iterations_match_jax(setup, jax_finetune):
    """Three iterations of finetune_decoder (f32) with JAX's draws: the
    losses within 1e-5 relative of JAX's; each parameter within 2e-3 * lr *
    steps (one part in 500 of the most Adam can move it) plus one f32
    rounding of its value. Adam moves an entry by about lr a step whatever
    its gradient's size, so entries whose first-step gradient is below 1e-3
    of their tensor's RMS gradient (rounding level) may go either way: they
    are held to 2 * lr * steps. Clipping is on (grad_clip 1.0 against a
    global norm well above it)."""
    s = setup
    want_params, want_losses = jax_finetune
    key = jax.random.PRNGKey(11)
    c, yy, yl, a = _port_inputs(s)
    draws = [_jax_draws(key, i, yy.shape) for i in range(ITERS)]
    base = params_from_jax(s["dparams"])
    got, losses = tft.finetune_decoder(
        DecoderConfig(**DEC), base, c, yy, yl, a, torch.from_numpy(s["spk"]),
        dtype=torch.float32, segment_size=SEG, n_iters=ITERS, learning_rate=LR,
        grad_clip=1.0, draws=draws)
    assert losses.shape == (ITERS,) and losses.dtype == np.float32
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_adapted_like_jax(s, got, want_params, base, (c, yy, yl, a),
                             torch.from_numpy(s["spk"]), draws[0])


def _assert_adapted_like_jax(s, got, want_params, base, inputs, spk, draws0):
    """Each adapted parameter within 2e-3 * lr * steps of JAX's plus one f32
    rounding of its value; the entries whose first-step gradient (from
    draws0) is at rounding level within 2 * lr * steps; the parameters the
    loss does not use unmoved; and the adaptation moved the weights."""
    dec = _port_decoder(s)
    tdiff.fine_tune_loss(dec, *inputs, spk, SEG, draws=draws0).backward()
    bound = 2e-3 * LR * ITERS
    moved = 0
    for name, p in dec.named_parameters():
        g, w, b0 = got[name].numpy(), want_params[name].numpy(), base[name].numpy()
        assert g.dtype == np.float32
        tol = np.full(g.shape, bound) + np.spacing(np.abs(w))
        if p.grad is not None:
            gg = p.grad.numpy()
            tiny = np.abs(gg) < 1e-3 * np.sqrt(np.mean(gg ** 2))
            tol[tiny] = 2 * LR * ITERS
            moved += int(np.sum(np.abs(w - b0) > 0.5 * LR))
        else:  # unused by the loss: Adam leaves it where it was
            np.testing.assert_array_equal(g, b0)
        assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max())
    assert moved > 1000  # the adaptation moved the weights


def test_finetune_decoder_batched_matches_jax(setup):
    """finetune_decoder_batched at S = 2 (the second speaker another mel and
    voice), 3 iterations, f32, each speaker with its own JAX draws, against
    JAX's finetune_decoder_batched(mesh=None): the losses within 1e-5
    relative, each speaker's parameters at the single fine-tune test's
    tolerance; and each row bit-equal to a single finetune_decoder run."""
    s = setup
    rng = np.random.default_rng(17)
    mel2 = np.tanh(rng.standard_normal((TY, 16))).astype(np.float32)
    spk2 = rng.standard_normal((1, 8)).astype(np.float32)
    spk2 /= np.linalg.norm(spk2)
    jin2 = jft.prepare_finetune_inputs(s["jue"], s["ue_params"], s["units"], s["dur"], mel2,
                                       num_downsamplings=1)
    per = [tuple(np.asarray(x) for x in s["jin"]), tuple(np.asarray(x) for x in jin2)]
    spks = [s["spk"], spk2]
    stacked = [np.stack(xs) for xs in zip(*per)]
    keys = jax.random.split(jax.random.PRNGKey(21), 2)
    jparams = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), s["dparams"])
    want_params, want_losses = jft.finetune_decoder_batched(
        s["jdec"].apply, jparams, *stacked, jnp.asarray(np.stack(spks)), keys, mesh=None,
        segment_size=SEG, n_iters=ITERS, learning_rate=LR, grad_clip=1.0)
    want_params = params_from_jax(jax.device_get(want_params))

    base = params_from_jax(s["dparams"])
    inputs = [tuple(torch.from_numpy(x) for x in p) for p in per]
    draws = [[_jax_draws(keys[k], i, inputs[k][1].shape) for i in range(ITERS)]
             for k in range(2)]
    got, losses = tft.finetune_decoder_batched(
        DecoderConfig(**DEC), {k: torch.stack([v, v]) for k, v in base.items()},
        *(torch.stack(xs) for xs in zip(*inputs)), torch.from_numpy(np.stack(spks)),
        dtype=torch.float32, segment_size=SEG, n_iters=ITERS, learning_rate=LR, grad_clip=1.0,
        draws=draws)
    assert losses.shape == (2, ITERS) and set(got) == set(base)
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-5)
    assert not np.allclose(losses[0], losses[1])
    for k in range(2):
        row = {n: v[k] for n, v in got.items()}
        _assert_adapted_like_jax(s, row, {n: v[k] for n, v in want_params.items()}, base,
                                 inputs[k], torch.from_numpy(spks[k]), draws[k][0])
        single, single_losses = tft.finetune_decoder(
            DecoderConfig(**DEC), base, *inputs[k], torch.from_numpy(spks[k]),
            dtype=torch.float32, segment_size=SEG, n_iters=ITERS, learning_rate=LR,
            grad_clip=1.0, draws=draws[k])
        assert np.array_equal(single_losses, losses[k])
        assert all(torch.equal(single[n], row[n]) for n in single)


def test_finetune_bf16_loss_near_f32(setup):
    """The default activations (bf16, f32 parameters) on the CPU: one step's
    loss within 5% of f32's with the same draws, and the step moves the
    parameters."""
    s = setup
    c, yy, yl, a = _port_inputs(s)
    draws = [_jax_draws(jax.random.PRNGKey(12), 0, yy.shape)]
    base = params_from_jax(s["dparams"])
    out = {dt: tft.finetune_decoder(DecoderConfig(**DEC), base, c, yy, yl, a,
                                    torch.from_numpy(s["spk"]), dtype=dt, segment_size=SEG,
                                    n_iters=1, learning_rate=LR, draws=draws)
           for dt in (torch.bfloat16, torch.float32)}
    (sd16, l16), (_, l32) = out[torch.bfloat16], out[torch.float32]
    assert np.isfinite(l16).all() and abs(l16[0] - l32[0]) <= 0.05 * abs(l32[0])
    assert all(v.dtype == torch.float32 for v in sd16.values())
    assert not torch.equal(sd16["estimator.final_conv.kernel"],
                           base["estimator.final_conv.kernel"])


# lr 1e-3 (fifty times the reference's 2e-5) for 20 steps in bf16
# activations, as the fine-tune that went non-finite on the card ran; and
# lr 5e-2, where JAX's own run goes non-finite at this width. LONG_REL:
# where both runs are finite their losses agree within 1e-2 relative (the
# two bf16 runs round at different points, XLA fusing its casts, PyTorch
# rounding each op's output, and Adam moves every parameter by about lr a
# step whatever its gradient, so the trajectories drift apart; 3.3e-3 at
# most was seen at lr 1e-3)
LONG_REL = 1e-2


@pytest.mark.parametrize("dtype,lr,iters", [("bfloat16", 1e-3, 20), ("bfloat16", 5e-2, 20),
                                            ("float32", 5e-2, 8)])
def test_finetune_high_lr_finite_when_jax_is(setup, dtype, lr, iters):
    """`iters` steps of finetune_decoder at learning rate `lr` in both
    packages from one params_from_jax tree with JAX's draws (activations
    in `dtype`, parameters f32): where both losses are finite they agree
    within LONG_REL; once a run's loss is non-finite it stays so (the NaN
    reaches every parameter); the port's last loss is finite exactly when
    JAX's is, and at lr 1e-3 every step is finite exactly when JAX's is
    (all of them, at this width). At lr 5e-2 JAX's run goes non-finite
    too: a divergence at a high learning rate is the algorithm's (Adam on
    random weights), not the port's."""
    s = setup
    key = jax.random.PRNGKey(13)
    cond_x, y, y_len, attn = s["jin"]
    jdec = jdiff.UnitSpeech(**DEC, dtype=getattr(jnp, dtype))
    _, want = jft.finetune_decoder(
        jdec.apply, jax.tree_util.tree_map(jnp.array, s["dparams"]), cond_x, y, y_len, attn,
        jnp.asarray(s["spk"]), key, segment_size=SEG, n_iters=iters, learning_rate=lr,
        grad_clip=1.0)
    want = np.asarray(want)
    c, yy, yl, a = _port_inputs(s)
    _, got = tft.finetune_decoder(
        DecoderConfig(**DEC), params_from_jax(s["dparams"]), c, yy, yl, a,
        torch.from_numpy(s["spk"]), dtype=getattr(torch, dtype), segment_size=SEG,
        n_iters=iters, learning_rate=lr, grad_clip=1.0,
        draws=[_jax_draws(key, i, yy.shape) for i in range(iters)])
    fin_got, fin_want = np.isfinite(got), np.isfinite(want)
    for fin in (fin_got, fin_want):  # finite steps form a prefix
        assert not np.any(fin[1:] & ~fin[:-1]), fin
    both = fin_got & fin_want
    assert both[0]
    np.testing.assert_allclose(got[both], want[both], rtol=LONG_REL)
    assert fin_got[-1] == fin_want[-1]
    if lr == 1e-3:
        np.testing.assert_array_equal(fin_got, fin_want)
    else:
        assert not fin_want[-1]  # JAX diverges at this learning rate


# --- the CLI ---------------------------------------------------------------

# a tiny configuration whose mel frontend and segment are small: 1.6 kHz
# audio, hop 16, 100-frame segments; spk_embedder.sr 1600 counts a 50 Hz
# unit as 32 samples, two frames
TINY_FT = dict(
    data=dict(n_feats=16, n_fft=64, hop_length=16, win_length=64, sampling_rate=1600,
              mel_fmax=800.0),
    text_encoder=dict(n_vocab=180, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                      n_heads=2),
    unit_encoder=dict(UNIT_ENC),
    duration_predictor=dict(in_channels=16, filter_channels=16, spk_emb_dim=8),
    decoder=dict(DEC, dim_mults=[1, 2]),
    vocoder=dict(num_mels=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                 upsample_initial_channel=16, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]], sampling_rate=1600),
    train=dict(out_size_second=1),
    spk_embedder=dict(sr=1600),
)


def _sidecars(tmp_path, seconds=2.5):
    from unitspeech_tpu_torch.utils.audio import write_wav

    (tmp_path / "tiny.json").write_text(json.dumps(TINY_FT))
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "4", "--config",
                     str(tmp_path / "tiny.json"), "--output", ckpt]) == 0
    rng = np.random.default_rng(5)
    n = int(seconds * 1600)
    write_wav(str(tmp_path / "ref.wav"), 0.3 * np.sin(np.arange(n) * 0.3)
              + 0.05 * rng.standard_normal(n), 1600)
    n_units = int(seconds * 50)
    units = rng.integers(0, 50, n_units // 2)
    durations = np.full(n_units // 2, 2)
    np.savez(tmp_path / "units.npz", units=units, durations=durations)
    np.save(tmp_path / "spk.npy", rng.standard_normal(8).astype(np.float32))
    return ckpt, ["--reference", str(tmp_path / "ref.wav"), "--decoder", ckpt,
                  "--unit-encoder", ckpt, "--spk-emb", str(tmp_path / "spk.npy"),
                  "--units", str(tmp_path / "units.npz"), "--output-dir",
                  str(tmp_path / "adapted")]


def test_cli_finetune_then_inference_on_cpu(tmp_path, capsys):
    """`cli finetune --device cpu` writes a decoder bundle (adapted weights,
    the speaker embedding given, the base mel min/max, the config) that
    `cli inference --decoder` serves with the base checkpoint's other
    modules; its JSON line carries the loss means and the output."""
    ckpt, args = _sidecars(tmp_path)
    stats = cli.main_finetune(args + ["--device", "cpu", "--n-iters", "4",
                                      "--learning-rate", "1e-3", "--frame-buckets", "160,320"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iterations"] == 4 and line["output"] == stats["output"]
    assert line["frames"] == tmel.mel_true_frames(4000, 64, 16) == 250
    assert line["bucket"] == 320 and line["segment"] == 100
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 4
    assert line["loss_first10"] == pytest.approx(float(np.mean(stats["losses"])))
    out = torch.load(stats["output"], weights_only=True)
    base = torch.load(ckpt, weights_only=True)
    assert out["step"] == 4 and out["config"] == base["config"]
    assert torch.equal(out["mel_min"], base["mel_min"])
    spk = np.load(tmp_path / "spk.npy")
    np.testing.assert_allclose(out["spk_emb"].numpy()[0], spk / np.linalg.norm(spk), rtol=1e-6)
    changed = [k for k in out["decoder"] if not torch.equal(out["decoder"][k], base["decoder"][k])]
    assert "estimator.final_conv.kernel" in changed and "text_uncon" not in changed

    served = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt, "--decoder",
                                 stats["output"], "--output", str(tmp_path / "a.wav"),
                                 "--device", "cpu", "--diffusion-steps", "2"])
    assert served["frames"] > 0 and served["kernels"]


def test_cli_finetune_refuses_cuda_without_a_card_and_ssl_flags(tmp_path):
    """No quiet fall back to the CPU; without --units the unit extractor
    needs both --hubert and --kmeans."""
    _, args = _sidecars(tmp_path, seconds=1.0)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main_finetune(args + ["--device", "cuda", "--n-iters", "1"])
    i = args.index("--units")
    no_units = args[:i] + args[i + 2:]
    for flag in ([], ["--hubert", "h.pt"], ["--kmeans", "k.npz"]):
        with pytest.raises(SystemExit, match=r"need --units or \(--hubert and --kmeans\)"):
            cli.main_finetune(no_units + ["--device", "cpu", *flag])


# TINY_FT with the SSL frontends at their test configurations: the test
# WavLM + a 16-channel ECAPA, the test HuBERT read at its layer 2, 50
# centroids; both read the 1.6 kHz reference as it is
SSL_FT = dict(TINY_FT, spk_embedder=dict(sr=1600, feat_type="wavlm_test", channels=16,
                                         spk_emb_dim=8),
              unit_extractor=dict(dense_model_name="hubert-test", sr=1600, vocab_size=50,
                                  hubert_layer=2))


def test_cli_finetune_from_a_wav_alone_matches_jax_sidecars(tmp_path):
    """`cli finetune --speaker-embedder S --hubert H --kmeans K` (no sidecar
    files; S and H port files of the same weights as JAX's orbax files)
    gives the losses of `cli finetune --spk-emb --units` with sidecars
    written from JAX's extract_speaker_embedding (on the sample-bucket
    ladder) and extract_units on the same reference: units equal, the
    stored speaker embedding within 1e-5 of JAX's, the f32 losses within
    1e-5 relative."""
    from unitspeech_tpu import cli as jcli
    from unitspeech_tpu.config import load_json as jload_json
    from unitspeech_tpu.data.dataset import load_wav as jload_wav
    from unitspeech_tpu.models import speaker as jsp
    from unitspeech_tpu.models.ssl import hubert as jh
    from unitspeech_tpu.utils.checkpoint import save_checkpoint
    from unitspeech_tpu_torch.config import config_from_dict
    from unitspeech_tpu_torch.utils import artifacts

    ckpt, args = _sidecars(tmp_path)
    ref = args[args.index("--reference") + 1]
    (tmp_path / "ssl.json").write_text(json.dumps(SSL_FT))
    jcfg, tcfg = jload_json(str(tmp_path / "ssl.json")), config_from_dict(SSL_FT)

    def variables(model, seed):
        v = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2000))), seed)
        return jax.device_get(jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.abs(x) + 0.5 if str(getattr(p[-1], "key", "")) == "var" else x, v))

    spk_v = variables(jsp.SpeakerEmbedder.from_config(jcfg.spk_embedder), 40)
    hub_v = variables(jh.HubertModel(jh.hubert_test_config()), 41)
    files = {"--speaker-embedder": artifacts.save_module(
                 str(tmp_path / "spk.pt"), "speaker_embedder", params_from_jax(spk_v), tcfg),
             "--hubert": artifacts.save_module(str(tmp_path / "hubert.pt"), "hubert",
                                               params_from_jax(hub_v), tcfg),
             "--kmeans": str(tmp_path / "km.npz")}
    np.savez(files["--kmeans"], centroids=np.random.default_rng(42).standard_normal(
        (50, 16)).astype(np.float32))
    wav, sr = jload_wav(ref)
    jspk = jcli.extract_speaker_embedding(save_checkpoint(str(tmp_path / "jspk"), 0, spk_v),
                                          wav, sr, jcfg)
    units, durations = jcli.extract_units(save_checkpoint(str(tmp_path / "jhub"), 0, hub_v),
                                          files["--kmeans"], wav, sr, jcfg)
    np.save(tmp_path / "jspk.npy", jspk)
    np.savez(tmp_path / "junits.npz", units=units, durations=durations)

    common = ["--reference", ref, "--decoder", ckpt, "--unit-encoder", ckpt, "--config",
              str(tmp_path / "ssl.json"), "--device", "cpu", "--n-iters", "3", "--fp32",
              "--frame-buckets", "160,320"]
    side = cli.main_finetune(common + ["--spk-emb", str(tmp_path / "jspk.npy"), "--units",
                                       str(tmp_path / "junits.npz"), "--output-dir",
                                       str(tmp_path / "side")])
    alone = cli.main_finetune(common + [x for kv in files.items() for x in kv]
                              + ["--output-dir", str(tmp_path / "alone")])
    assert alone["units"] == side["units"] == len(units) > 10
    assert "unit_extractor_s" in alone and "speaker_embedder_s" in alone
    got = torch.load(alone["output"], weights_only=True)["spk_emb"].numpy()
    np.testing.assert_allclose(got, jspk / np.linalg.norm(jspk), atol=1e-5)
    np.testing.assert_allclose(alone["losses"], side["losses"], rtol=1e-5)
    assert np.isfinite(alone["losses"]).all()


def test_out_size_matches_jax():
    from unitspeech_tpu.config import MainConfig as JMain
    from unitspeech_tpu_torch.config import MainConfig, config_from_dict

    assert MainConfig().out_size == JMain().out_size == 176
    tiny = config_from_dict(TINY_FT)
    assert tiny.out_size == 100
    assert dataclasses.asdict(tiny.finetune) == {"learning_rate": 2e-5, "n_iters": 500,
                                                 "grad_clip": 1.0}


# The full-width lr 1e-3 comparison. Free runs at this learning rate part:
# the trajectory amplifies f32 rounding (its float64 run goes non-finite
# first, PERF.md section 6), so the two free runs are recorded, not
# bounded. The bound is on the loss at the same parameters: FULL_REL, ten
# times the narrow three-step test's 1e-5 (the full-width decoder sums
# about a hundred times more terms a product); the narrow high-lr test's
# 3.3e-3 was the drift of two bf16 free runs, a different quantity.
# GRAD_REL: the port's f32 gradient against its float64 gradient at one
# point, per tensor, relative to the tensor's largest float64 gradient (f32
# rounding through ~100 normalized layers).
FULL_REL = 1e-4
GRAD_REL = 1e-2
FULL_STEPS = 12


def _port_points(cfg, state, inputs, spk, draws, dtype, steps):
    """finetune_decoder's loop, step by step: (losses, the parameters each
    step's loss was taken at)."""
    model = tdiff.UnitSpeech.from_config(cfg.decoder, dtype=dtype).to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    model.train().requires_grad_(True)
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    cast = lambda x: x.to(dtype) if x.is_floating_point() else x  # noqa: E731
    losses, points = [], []
    for i in range(steps):
        points.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        opt.zero_grad(set_to_none=True)
        d = {k: (v if k == "u" else cast(v)) for k, v in draws[i].items()}
        loss = tdiff.fine_tune_loss(model, *[cast(x) for x in inputs], cast(spk), cfg.out_size,
                                    draws=d)
        loss.backward()
        clip_by_global_norm([p.grad for p in params], 1.0)
        opt.step()
        losses.append(loss.item())
    return np.array(losses), points


@pytest.mark.slow
def test_finetune_lr1e3_full_width_matches_jax(tmp_path):
    """Twelve fine-tune steps at lr 1e-3 (fifty times the reference's) at
    MainConfig()'s decoder widths (dim 128, mults 1,2,4,8), f32, segment
    176, on chip_smoke.py's adapt inputs (the seed-0 random checkpoint, the
    seed-10 synthetic 6 s reference and its sidecars, the 688-frame bucket),
    from one params_from_jax tree, with JAX's draws injected into the port.

    Prints, for PERF.md: JAX's finetune_decoder losses and the port's; the
    port's loop again, step by step, with JAX's loss at each of its
    parameter points; the same loop in float64; and at the port's step-5
    point each tensor's f32 gradient error against the float64 gradient,
    JAX's and the port's. Asserts: the step-by-step loop is
    finetune_decoder's (equal losses); at every point the two packages'
    losses are finite together and, finite, within FULL_REL; the port's
    gradient at the step-5 point within GRAD_REL of float64's. Minutes on a
    CPU: marked slow."""
    import time

    from unitspeech_tpu.config import MainConfig as JMain
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.tools import synthetic_reference
    from unitspeech_tpu_torch.utils.audio import load_wav
    from unitspeech_tpu_torch.utils.params import params_to_jax, random_params

    cfg = MainConfig()
    ckpt = random_params(cfg, 0)
    flags = synthetic_reference(str(tmp_path), cfg, 6.0, seed=10)
    with np.load(flags[3]) as z:
        units, durations = z["units"], z["durations"]
    inputs = cli.finetune_inputs(cfg, load_wav(flags[1])[0], units, durations,
                                 ckpt["unit_encoder"], ckpt["mel_min"], ckpt["mel_max"],
                                 cli.DEFAULT_ADAPT_BUCKETS, torch.device("cpu"))
    spk = np.load(flags[5]).reshape(1, -1).astype(np.float32)
    spk /= np.linalg.norm(spk)
    tree = params_to_jax(ckpt["decoder"])
    seg, key = cfg.out_size, jax.random.PRNGKey(14)
    jin = [jnp.asarray(x.numpy()) for x in inputs]
    jdec = jdiff.UnitSpeech.from_config(JMain().decoder)

    t0 = time.perf_counter()
    _, want = jft.finetune_decoder(
        jdec.apply, jax.tree_util.tree_map(jnp.array, tree), *jin, jnp.asarray(spk), key,
        segment_size=seg, n_iters=FULL_STEPS, learning_rate=1e-3, grad_clip=1.0)
    want = np.asarray(want)
    t_jax = time.perf_counter() - t0
    draws = [_jax_draws(key, i, (1, seg, 80), seg) for i in range(FULL_STEPS)]
    t0 = time.perf_counter()
    _, got = tft.finetune_decoder(
        cfg.decoder, params_from_jax(tree), *inputs, torch.from_numpy(spk),
        dtype=torch.float32, segment_size=seg, n_iters=FULL_STEPS, learning_rate=1e-3,
        grad_clip=1.0, draws=draws)
    t_port = time.perf_counter() - t0
    print(f"lr 1e-3 full width f32, free runs: JAX finetune_decoder {want.tolist()} "
          f"({t_jax:.1f} s); port finetune_decoder {got.tolist()} ({t_port:.1f} s)")

    steps, points = _port_points(cfg, params_from_jax(tree), inputs, torch.from_numpy(spk),
                                 draws, torch.float32, FULL_STEPS)
    np.testing.assert_array_equal(steps, got)

    def jax_loss_fn(p, i):
        return jdiff.fine_tune_loss(jdec.apply, p, *jin, jnp.asarray(spk), seg,
                                    jax.random.fold_in(key, i))

    jax_loss = jax.jit(jax_loss_fn)
    at = np.array([float(jax_loss(params_to_jax(pt), i)) for i, pt in enumerate(points)])
    f64, _ = _port_points(cfg, params_from_jax(tree), inputs, torch.from_numpy(spk), draws,
                          torch.float64, FULL_STEPS)
    print(f"the port's points: port {steps.tolist()}; JAX at the same parameters "
          f"{at.tolist()}; the port's loop in float64 {f64.tolist()}")
    np.testing.assert_array_equal(np.isfinite(at), np.isfinite(steps))
    both = np.isfinite(at)
    assert both[0]
    np.testing.assert_allclose(steps[both], at[both], rtol=FULL_REL)

    # gradients at the port's step-5 point: JAX's and the port's f32 against
    # the port's float64
    k = 5
    _, jg = jax.jit(jax.value_and_grad(jax_loss_fn))(params_to_jax(points[k]), k)
    jg = params_from_jax(jax.device_get(jg))
    grads = {}
    for dt in (torch.float32, torch.float64):
        model = tdiff.UnitSpeech.from_config(cfg.decoder, dtype=dt).to(dt)
        model.load_state_dict({n: v.to(dt) for n, v in points[k].items()})
        model.train()
        cast = lambda x: x.to(dt) if x.is_floating_point() else x  # noqa: E731
        d = {n: (v if n == "u" else cast(v)) for n, v in draws[k].items()}
        tdiff.fine_tune_loss(model, *[cast(x) for x in inputs], cast(torch.from_numpy(spk)),
                             seg, draws=d).backward()
        grads[dt] = {n: p.grad.double().numpy() for n, p in model.named_parameters()
                     if p.grad is not None}
    err = {"port": {}, "jax": {}}
    for n, g64 in grads[torch.float64].items():
        s = np.abs(g64).max()
        err["port"][n] = float(np.abs(grads[torch.float32][n] - g64).max() / s)
        err["jax"][n] = float(np.abs(jg[n].numpy() - g64).max() / s)
    for who, e in err.items():
        worst = sorted(e.items(), key=lambda kv: -kv[1])[:3]
        print(f"step {k} gradients, {who} f32 vs float64, largest per-tensor errors: {worst}")
    assert max(err["port"].values()) <= GRAD_REL
