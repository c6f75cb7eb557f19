"""The adaptive-TTS slice end to end: the port's Synthesizer against the JAX
Synthesizer on the tiny_synth config of tests/test_tts_e2e.py (encoder ->
durations -> generate_path -> DDPM with dual CFG -> BigVGAN), with the same
parameters and the same injected noise; then the port's CLI on the CPU.

Parameters come from the JAX init, every leaf redrawn from a numpy seed and
carried across with params_from_jax. Two changes keep the run meaningful:
the rezero gates are scaled down (tests/_torch_port.scale_gates says why),
and the duration predictor's bias is raised so that tokens take several
frames and the first U-Net stage reaches the attention kernel's
T*F >= 1024 gate.

Tolerance: 1e-3 of the mel range (mel_max - mel_min) end to end, f32."""

import dataclasses
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import randomize, scale_gates
from unitspeech_tpu.config import (
    DataConfig,
    DecoderConfig,
    DurationPredictorConfig,
    EncoderConfig,
    MainConfig,
    VocoderConfig,
)
from unitspeech_tpu.infer import tts as jtts
from unitspeech_tpu.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.models.unet import PALLAS_MIN_TOKENS
from unitspeech_tpu_torch.utils.params import params_from_jax

TINY = dict(
    data=dict(n_feats=16, hop_length=4),
    text_encoder=dict(n_vocab=40, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                      n_heads=2),
    duration_predictor=dict(in_channels=16, filter_channels=16, spk_emb_dim=8),
    decoder=dict(n_feats=16, dim=8, dim_mults=[1, 2], groups=4, spk_emb_dim=8),
    vocoder=dict(num_mels=16, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
                 upsample_initial_channel=16, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]]),
)
TOKENS = [1, 5, 9, 3, 7, 2, 11, 4, 8, 6, 10, 12]
STEPS = 4
FORCED_FRAMES = 70
GUIDANCE = dict(text_gradient_scale=1.0, spk_gradient_scale=1.0)


def tiny_config() -> MainConfig:
    return MainConfig(
        data=DataConfig(**TINY["data"]),
        text_encoder=EncoderConfig(**TINY["text_encoder"]),
        duration_predictor=DurationPredictorConfig(**TINY["duration_predictor"]),
        decoder=DecoderConfig(**{**TINY["decoder"], "dim_mults": (1, 2)}),
        vocoder=VocoderConfig(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                              upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),)),
    )


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX Synthesizer, port checkpoint dict) with identical parameters."""
    cfg = tiny_config()
    jm = jtts.TTSModels.random_init(cfg, jax.random.PRNGKey(0))
    te = randomize(jm.text_encoder_params, 1)
    dp = jax.device_get(randomize(jm.duration_predictor_params, 2))
    dp["params"]["proj"]["bias"] = np.array([3.4], np.float32)
    dec = scale_gates(randomize(jm.decoder_params, 3), 0.003)
    voc = randomize(jm.vocoder_params, 4)
    jm = dataclasses.replace(jm, text_encoder_params=te, duration_predictor_params=dp,
                             decoder_params=dec, vocoder_params=voc)
    ckpt = {name: params_from_jax(jax.device_get(getattr(jm, f"{name}_params")))
            for name in ("text_encoder", "duration_predictor", "decoder", "vocoder")}
    ckpt.update(spk_emb=torch.tensor(np.asarray(jm.spk_emb)),
                mel_min=torch.tensor(np.asarray(jm.mel_min)),
                mel_max=torch.tensor(np.asarray(jm.mel_max)),
                config=dataclasses.asdict(cfg))
    return jtts.Synthesizer(jm), ckpt


def _port(ckpt, use_kernels=True):
    return ttts.Synthesizer(ttts.TTSModels.from_checkpoint(
        ckpt, device="cpu", dtype=torch.float32, use_kernels=use_kernels))


def _jax_durations(jsynth):
    m = jsynth.models
    packed = np.zeros((1, 17), np.int32)
    packed[0, :len(TOKENS)] = TOKENS
    packed[0, -1] = len(TOKENS)
    mu, hidden, x_mask = m.text_encoder.apply(m.text_encoder_params, packed[:, :-1],
                                              packed[:, -1])
    logw = m.duration_predictor.apply(m.duration_predictor_params, hidden, x_mask,
                                      g=m.spk_emb, reverse=True)
    return np.exp(np.asarray(logw)[0, :len(TOKENS)])


def _noise(y_pad, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, y_pad, 16)).astype(np.float32),
            rng.standard_normal((STEPS, 1, y_pad, 16)).astype(np.float32))


def _y_pad(frames, jsynth):
    return choose_bucket(fix_len_compatibility(frames, 1), jsynth.frame_buckets)


def _mel_tol(ckpt):
    return 1e-3 * float((ckpt["mel_max"] - ckpt["mel_min"]).max())


def test_durations_match_jax(slice_pair):
    """ceil(exp(logw)) flips under f32 noise only next to an integer: the
    comparison is exact once no exp(logw) lies within 1e-4 of one."""
    jsynth, ckpt = slice_pair
    w = _jax_durations(jsynth)
    assert np.min(np.abs(w - np.round(w))) > 1e-4, w
    _, _, w_ceil = _port(ckpt).encode(TOKENS)
    np.testing.assert_array_equal(w_ceil[0].numpy(), np.ceil(w))
    frames = int(np.ceil(w).sum())
    # the first U-Net stage reaches the attention kernel's gate
    assert _y_pad(frames, jsynth) * 16 >= PALLAS_MIN_TOKENS


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_synthesize_mel_matches_jax(slice_pair, use_kernels):
    jsynth, ckpt = slice_pair
    frames = int(np.ceil(_jax_durations(jsynth)).sum())
    noise_z, noises = _noise(_y_pad(frames, jsynth), 0)
    want, want_len, want_attn = jsynth.synthesize_mel(
        TOKENS, jax.random.PRNGKey(0), diffusion_steps=STEPS, noise_z=jnp.asarray(noise_z),
        noises=jnp.asarray(noises), **GUIDANCE)
    got, got_len, got_attn = _port(ckpt, use_kernels).synthesize_mel(
        TOKENS, diffusion_steps=STEPS, noise_z=torch.from_numpy(noise_z),
        noises=torch.from_numpy(noises), **GUIDANCE)
    assert got_len == want_len == frames
    np.testing.assert_array_equal(got_attn.numpy(), np.asarray(want_attn)[:, :len(TOKENS)])
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.ptp(want) > 1.0  # the sampler did real work
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_mel_tol(ckpt))


@pytest.mark.parametrize("forced", [None, FORCED_FRAMES], ids=["exact", "forced"])
def test_call_matches_jax(slice_pair, forced):
    """Synthesizer.__call__ on the kernel path (the CLI's), exact and
    forced-duration modes, against the JAX exact path with the same noise.
    Tolerance 5e-3 absolute on the tanh-bounded waveform: with random
    weights the mel reaching the vocoder is ~1e3 in magnitude, so an f32
    difference of 1e-6 relative there moves an unsaturated sample by up to
    ~1e-3."""
    jsynth, ckpt = slice_pair
    frames = forced or int(np.ceil(_jax_durations(jsynth)).sum())
    noise_z, noises = _noise(_y_pad(frames, jsynth), 1)
    jkw = {} if forced is None else dict(_forced_total_frames=forced, _exact=True)
    want, sr = jsynth(TOKENS, jax.random.PRNGKey(0), diffusion_steps=STEPS,
                      _noise_z=jnp.asarray(noise_z), _noises=jnp.asarray(noises), **jkw,
                      **GUIDANCE)
    got, got_sr, got_mel = _port(ckpt)(TOKENS, forced_total_frames=forced,
                                       diffusion_steps=STEPS,
                                       noise_z=torch.from_numpy(noise_z),
                                       noises=torch.from_numpy(noises), **GUIDANCE)
    hop = ckpt["config"]["data"]["hop_length"]
    assert got_sr == sr and got.shape == (frames * hop,) == np.asarray(want).shape
    assert got_mel.shape == (frames, ckpt["config"]["data"]["n_feats"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-3)


def _tiny_checkpoint(tmp_path):
    cfg_path = tmp_path / "tiny.json"
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the IPA symbol table
    cfg_path.write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "3", "--config", str(cfg_path),
                     "--output", ckpt]) == 0
    return ckpt


def test_cli_inference_writes_wav_on_cpu(tmp_path):
    """`cli inference` on the CPU: bf16 decoder and vocoder with the kernel
    wrappers on CPU tensors (their plain versions), 3 steps, dual CFG."""
    ckpt = _tiny_checkpoint(tmp_path)
    out = str(tmp_path / "out.wav")
    stats = cli.main_inference(["--ipa", "--text", "həloʊ wɜːld", "--checkpoint", ckpt,
                                "--output", out, "--device", "cpu", "--diffusion-steps", "3",
                                "--text-gradient-scale", "1.0", "--spk-gradient-scale", "1.0"])
    with wave.open(out, "rb") as w:
        assert w.getframerate() == 22050 and w.getsampwidth() == 2
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16)
    assert n == stats["frames"] * 4 > 0 and np.any(pcm)
    assert stats["device"] == "cpu"


def test_cli_refuses_cuda_without_a_device(tmp_path):
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt = _tiny_checkpoint(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                            "--output", str(tmp_path / "x.wav"), "--device", "cuda"])


def test_default_device_is_the_card(slice_pair, monkeypatch):
    """TTSModels.from_checkpoint and build_modules put the modules on the card
    unless the caller asks for the CPU; with no CUDA device they raise, and
    never fall back to the CPU."""
    from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict

    _, ckpt = slice_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttts.TTSModels.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_modules(config_from_dict(ckpt["config"]))
    assert _port(ckpt).models.device.type == "cpu"


def _jax_exact_mel(jsynth, key, sampler, noise_z):
    """JAX's exact path with a sampler spec (Synthesizer.__call__'s
    _encode_and_duration, then _align_and_sample at the resolved bucket),
    its prior injected; the DDPM draws its own noise from the key."""
    m = jsynth.models
    n_tok = len(TOKENS)
    packed = np.zeros((1, choose_bucket(n_tok, jsynth.token_buckets) + 1), np.int32)
    packed[0, :n_tok] = TOKENS
    packed[0, -1] = n_tok
    mu_x, x_mask, w_ceil = jtts._encode_and_duration(
        m.text_encoder, m.text_encoder_params, m.duration_predictor,
        m.duration_predictor_params, jnp.asarray(packed), m.spk_emb)
    y_pad = noise_z.shape[1]
    mel, _ = jtts._align_and_sample(
        m.decoder.apply, m.decoder_params, mu_x, x_mask, w_ceil, None, m.spk_emb, key,
        m.mel_min, m.mel_max, n_timesteps=STEPS, text_gradient_scale=1.0,
        spk_gradient_scale=1.0, beta_min=m.cfg.decoder.beta_min,
        beta_max=m.cfg.decoder.beta_max, y_pad=y_pad, sampler=sampler,
        noise_z=jnp.asarray(noise_z))
    return np.asarray(mel)


@pytest.mark.parametrize("sampler", ["ddpm:cs2", "dpm2:cs3"])
def test_synthesize_mel_sampler_spec_matches_jax(slice_pair, sampler):
    """Synthesizer.synthesize_mel(sampler=spec) on the kernel path against
    JAX's exact path with the same spec: the same prior, and for the DDPM
    JAX's draws, fold_in(fold_in(key, 1), i) at step i (JAX refuses injected
    noise at a stride above 1). The mel within _mel_tol; a malformed spec
    raises before any work."""
    jsynth, ckpt = slice_pair
    frames = int(np.ceil(_jax_durations(jsynth)).sum())
    y_pad = _y_pad(frames, jsynth)
    noise_z, _ = _noise(y_pad, 2)
    key = jax.random.PRNGKey(4)
    want = _jax_exact_mel(jsynth, key, sampler, noise_z)
    k1 = jax.random.fold_in(key, 1)
    noises = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k1, i), (1, y_pad, 16)))
                       for i in range(STEPS)])
    synth = _port(ckpt)
    got, got_len, _ = synth.synthesize_mel(TOKENS, diffusion_steps=STEPS,
                                           noise_z=torch.from_numpy(noise_z),
                                           noises=torch.from_numpy(noises), sampler=sampler,
                                           **GUIDANCE)
    assert got_len == frames and got.shape == want.shape
    assert np.isfinite(want).all() and np.ptp(want) > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_mel_tol(ckpt))
    with pytest.raises(ValueError, match="bad sampler option"):
        synth.synthesize_mel(TOKENS, sampler="ddpm:x2")
