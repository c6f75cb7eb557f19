"""Voice conversion in the port against the JAX package on the CPU: the
contentvec Encoder, interpolate_linear, the HF contentvec HuBERT
converter (bit for bit, the positional conv's three weight forms) and
ContentvecExtractor, voice_conversion with every sampler spec (JAX's
draws injected), the `convert contentvec-encoder` round trip, and `cli
voice-conversion --device cpu` end to end from contentvec features and from
a contentvec HuBERT checkpoint.

Small widths: a 24-wide contentvec input to a 16-channel encoder, the
2-stage decoder at dim 8 with small rezero gates, the test HuBERT
(models/ssl/hubert.hubert_test_config). f32. Tolerances: 1e-5 absolute /
1e-4 relative for the modules (2e-5 absolute for the HuBERT's features,
PR 11's HUBERT_ATOL); the denormalized mel 1e-5 plus 1e-4 of its largest
magnitude; converters bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize, scale_gates
from tests.test_torch_port_tts import TINY
from unitspeech_tpu.config import EncoderConfig
from unitspeech_tpu.infer import vc as jvc
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models import encoder as jenc
from unitspeech_tpu.models.ssl import contentvec as jcv
from unitspeech_tpu.models.ssl import hubert as jh
from unitspeech_tpu.utils import torch_convert as jconv
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import config_from_dict
from unitspeech_tpu_torch.infer import vc as tvc
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models import encoder as tenc
from unitspeech_tpu_torch.models.ssl import contentvec as tcv
from unitspeech_tpu_torch.models.ssl import hubert as th
from unitspeech_tpu_torch.tools import vc_reference
from unitspeech_tpu_torch.utils import artifacts
from unitspeech_tpu_torch.utils.audio import load_wav
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
HUBERT_ATOL = 2e-5
CV_ENC = dict(n_vocab=40, n_feats=16, n_channels=16, filter_channels=32, n_layers=2, n_heads=2,
              n_contentvec=24)
DEC = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)
MEL_MIN, MEL_MAX = -4.0, 2.0


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def encoders():
    """The contentvec Encoder, JAX and port, with the same random weights."""
    jm = jenc.Encoder.from_config(EncoderConfig(**CV_ENC))
    v = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 6, 24)),
                                   jnp.array([6])), 21)
    return jm, jax.device_get(v), load(tenc.Encoder.from_config(EncoderConfig(**CV_ENC)), v)


def test_contentvec_encoder_matches_jax(encoders):
    """Features (B, T, 24) with a padded row -> (mu, hidden, mask) within
    1e-5 / 1e-4 of JAX's Encoder(n_contentvec=24); `emb.kernel` is the flax
    (in, out) layout and there is no embedding table."""
    jm, v, tm = encoders
    assert tuple(tm.state_dict()["emb.kernel"].shape) == (24, 16)
    assert "emb.embedding" not in tm.state_dict() and "emb.bias" not in tm.state_dict()
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    lengths = np.array([11, 7], np.int32)
    want = jm.apply(v, x, lengths)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("new_len", [5, 13, 29, 64])
def test_interpolate_linear_matches_jax(new_len):
    """Down (5), equal (13) and up (29, 64) from 13 frames."""
    x = np.random.default_rng(23).standard_normal((2, 13, 6)).astype(np.float32)
    got = tvc.interpolate_linear(torch.from_numpy(x), new_len)
    want = np.asarray(jvc.interpolate_linear(jnp.asarray(x), new_len))
    assert got.shape == want.shape == (2, new_len, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("form", vc_reference.POS_CONV_FORMS)
def test_convert_hubert_hf_bit_equal_to_jax(form):
    """An HF-named HuBERT state dict (tools/vc_reference, with content-vec-
    best's final_proj and masked_spec_embed) converts to params_from_jax of
    JAX's tree bit for bit, which the port's HubertModel loads strictly."""
    c = th.hubert_test_config()
    sd = {k: v.numpy() for k, v in vc_reference.hf_hubert_sd(c, 24, form).items()}
    want = params_from_jax(jcv.convert_hubert_hf(sd, c.num_layers, len(c.conv_layers)))
    got = params_from_jax(tcv.convert_hubert_hf(sd, c.num_layers, len(c.conv_layers)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    th.HubertModel(c).load_state_dict(got)


def test_contentvec_configs_match_jax():
    assert tcv.contentvec_config() == th.HubertConfig()
    assert tcv.contentvec_config_for(768) == tcv.contentvec_config()
    assert tcv.contentvec_config_for(16) == th.hubert_test_config()
    assert [getattr(jcv.contentvec_config(), f) for f in ("embed_dim", "num_layers", "ffn_dim")] \
        == [768, 12, 3072] == [getattr(tcv.contentvec_config(), f)
                               for f in ("embed_dim", "num_layers", "ffn_dim")]
    with pytest.raises(KeyError, match="no contentvec HuBERT of width 24"):
        tcv.contentvec_config_for(24)


def test_contentvec_extractor_matches_jax(tmp_path):
    """ContentvecExtractor.from_torch on an HF-named checkpoint file (the
    test HuBERT) against JAX's extractor on the same weights: the last
    layer's features of a 16 kHz wav, at HUBERT_ATOL."""
    c = th.hubert_test_config()
    sd = vc_reference.hf_hubert_sd(c, 25)
    torch.save(sd, tmp_path / "cv.pt")
    jx = jcv.ContentvecExtractor(jh.HubertModel(c), jcv.convert_hubert_hf(
        {k: v.numpy() for k, v in sd.items()}, c.num_layers, len(c.conv_layers)))
    tx = tcv.ContentvecExtractor.from_torch(str(tmp_path / "cv.pt"), device="cpu", config=c)
    assert tx.reader.layer == c.num_layers
    wav = (0.3 * np.random.default_rng(26).standard_normal(3000)).astype(np.float32)
    want, got = jx(wav), tx(wav)
    assert got.shape == want.shape and got.shape[1] == c.embed_dim
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=HUBERT_ATOL)


@pytest.fixture(scope="module")
def vc_pair(encoders):
    """(JAX encoder + params, JAX decoder + params, port encoder, port
    decoder, content, spk)."""
    jenc_m, ev, tenc_m = encoders
    rng = np.random.default_rng(27)
    jdec = jdiff.UnitSpeech(**DEC)
    z = np.zeros((1, 16, 16), np.float32)
    init = jax.jit(jdec.init)(jax.random.PRNGKey(1), z, np.ones((1, 16), np.float32), z,
                              np.zeros((1,), np.float32), np.zeros((1, 8), np.float32))
    dv = jax.device_get(scale_gates(randomize(init, 28), 0.003))
    tdec = tdiff.UnitSpeech(**DEC)
    tdec.load_state_dict(params_from_jax(dv))
    content = rng.standard_normal((1, 11, 24)).astype(np.float32)
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    spk /= np.linalg.norm(spk)
    return jenc_m, ev, jdec, dv, tenc_m, tdec.eval(), content, spk


@pytest.mark.parametrize("sampler", ["ddpm", "dpm2", "ddpm:cs2", "dpm2:cs2"])
def test_voice_conversion_matches_jax(vc_pair, sampler):
    """The port's voice_conversion against JAX's (4 steps, dual CFG 1.0 /
    1.0, 20 mel frames from 11 content frames, padded to the 32-frame
    bucket) with JAX's draws injected: z from fold_in(key, 0), the DDPM's
    step i noise from fold_in(fold_in(key, 1), i), the same for the strided
    DDPM. The padded frames of the normalized mel are zero."""
    jenc_m, ev, jdec, dv, tenc_m, tdec, content, spk = vc_pair
    mel_len, steps, key = 20, 4, jax.random.PRNGKey(29)
    kw = dict(n_timesteps=steps, text_gradient_scale=1.0, spk_gradient_scale=1.0,
              num_downsamplings=1, sampler=sampler)
    mel_min, mel_max = jnp.full((16,), MEL_MIN), jnp.full((16,), MEL_MAX)
    want = np.asarray(jvc.voice_conversion(jenc_m, ev, jdec, dv, jnp.asarray(content), mel_len,
                                           jnp.asarray(spk), mel_min, mel_max, key, **kw))
    pad = tvc.vc_frames(mel_len, 1)
    assert want.shape == (1, pad, 16) and pad == 32
    z = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (1, pad, 16)))
    k1 = jax.random.fold_in(key, 1)
    noises = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k1, i), (1, pad, 16)))
                       for i in range(steps)])
    got = tvc.voice_conversion(tenc_m, tdec, torch.from_numpy(content), mel_len,
                               torch.from_numpy(spk), torch.full((16,), MEL_MIN),
                               torch.full((16,), MEL_MAX), noise_z=torch.from_numpy(z),
                               noises=torch.from_numpy(noises), **kw)
    assert np.isfinite(want).all() and np.ptp(want[0, :mel_len]) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL + RTOL * np.abs(want).max())
    np.testing.assert_allclose(got[0, mel_len:].numpy(), MEL_MIN + (MEL_MAX - MEL_MIN) / 2)


def test_voice_conversion_refuses_a_bad_spec(vc_pair):
    *_, tenc_m, tdec, content, spk = vc_pair
    with pytest.raises(ValueError, match="unknown sampler 'euler'"):
        tvc.voice_conversion(tenc_m, tdec, torch.from_numpy(content), 20, torch.from_numpy(spk),
                             torch.zeros(16), torch.ones(16), sampler="euler")


def test_convert_contentvec_encoder_round_trip(tmp_path):
    """A reference-format contentvec encoder (tools/vc_reference) through
    `cli convert contentvec-encoder` equals params_from_jax of JAX's
    convert_encoder(contentvec=True) bit for bit; load_encoder_params reads
    the reference file and the port file alike; the port's Encoder loads it
    strictly."""
    ecfg = EncoderConfig(**CV_ENC)
    sd = vc_reference.contentvec_encoder_sd(ecfg, 30)
    torch.save({"model": sd}, tmp_path / "ref.pt")
    (tmp_path / "cfg.json").write_text(json.dumps({"contentvec_encoder": CV_ENC}))
    assert cli.main(["convert", "contentvec-encoder", str(tmp_path / "ref.pt"),
                     str(tmp_path / "out.pt"), "--config", str(tmp_path / "cfg.json")]) == 0
    out = torch.load(tmp_path / "out.pt", weights_only=True)
    want = params_from_jax(jconv.convert_encoder({k: v.numpy() for k, v in sd.items()},
                                                 n_layers=2, contentvec=True))
    assert out["config"]["contentvec_encoder"]["n_contentvec"] == 24
    tcfg = config_from_dict(out["config"]).contentvec_encoder
    for src in (str(tmp_path / "ref.pt"), str(tmp_path / "out.pt")):
        got = artifacts.load_encoder_params(src, tcfg, "contentvec_encoder")
        assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    tenc.Encoder.from_config(tcfg).load_state_dict(out["contentvec_encoder"])


# TINY (tests/test_torch_port_tts.py) with a contentvec encoder on the test
# HuBERT's 16-wide features and the IPA symbol table
TINY_VC = dict(TINY, text_encoder=dict(TINY["text_encoder"], n_vocab=180),
               contentvec_encoder=dict(CV_ENC, n_contentvec=16))
SOURCE_SAMPLES = 402  # at hop 4: 100 frames, the 104-frame bucket


def _vc_files(tmp_path):
    (tmp_path / "tiny.json").write_text(json.dumps(TINY_VC))
    cfg = config_from_dict(TINY_VC)
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "3", "--config",
                     str(tmp_path / "tiny.json"), "--output", ckpt]) == 0
    files = vc_reference.random_vc_reference(str(tmp_path), cfg, seed=31)
    src = vc_reference.random_source(str(tmp_path / "src.wav"), cfg,
                                     SOURCE_SAMPLES / cfg.data.sampling_rate, seed=32)
    return ckpt, files, src


def test_cli_voice_conversion_on_cpu(tmp_path, capsys):
    """`cli voice-conversion --device cpu` from contentvec features (.npy)
    and from the contentvec HuBERT checkpoint (HF names, the test HuBERT):
    each writes a finite wav of the source's frames and prints one JSON
    statistics line; the features the HuBERT route extracts, given back as
    --content-features, give the same mel; a missing content source, a bad
    sampler spec and a card request without a card are refused."""
    ckpt, files, src = _vc_files(tmp_path)
    wav, sr = load_wav(src)
    assert len(wav) == SOURCE_SAMPLES
    common = ["--source", src, "--decoder", ckpt, "--content-encoder",
              files["contentvec-encoder"], "--vocoder", ckpt, "--device", "cpu",
              "--diffusion-steps", "3", "--fp32"]
    feats = cli.extract_contentvec(files["contentvec"], wav, sr, config_from_dict(TINY_VC),
                                   torch.device("cpu"))
    np.save(tmp_path / "feats.npy", feats)
    runs = {}
    for name, extra in (("features", ["--content-features", str(tmp_path / "feats.npy")]),
                        ("hubert", ["--contentvec", files["contentvec"], "--sampler",
                                    "ddpm:cs2"]),
                        ("hubert_cs1", ["--contentvec", files["contentvec"], "--sampler",
                                        "ddpm:cs1"]),
                        ("dpm2", ["--content-features", str(tmp_path / "feats.npy"),
                                  "--sampler", "dpm2:cs2", "--no-sv56"])):
        out = str(tmp_path / f"{name}.wav")
        runs[name] = cli.main_voice_conversion(common + extra + ["--output", out])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["frames"] == 100 and line["bucket"] == 104
        assert line["content_frames"] == len(feats) > 5
        out_wav, out_sr = load_wav(out)
        assert out_sr == sr and len(out_wav) == 100 * 4 and np.isfinite(out_wav).all()
        assert np.abs(out_wav).max() > 0
    assert "contentvec_s" in runs["hubert"] and "contentvec_s" not in runs["features"]
    assert runs["hubert"]["sampler"] == "ddpm:cs2" and not runs["features"]["kernels"]
    np.testing.assert_array_equal(runs["hubert_cs1"]["mel"], runs["features"]["mel"])
    assert np.abs(runs["hubert"]["mel"] - runs["features"]["mel"]).max() > 0
    with pytest.raises(SystemExit, match="need --content-features or --contentvec"):
        cli.main_voice_conversion(common)
    with pytest.raises(SystemExit, match="--sampler: unknown sampler 'euler'"):
        cli.main_voice_conversion(common + ["--contentvec", files["contentvec"], "--sampler",
                                            "euler"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main_voice_conversion([a.replace("cpu", "cuda") for a in common]
                                      + ["--content-features", str(tmp_path / "feats.npy")])
