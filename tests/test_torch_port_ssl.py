"""The SSL frontends in the port against their JAX twins on the CPU: the
conv feature extractor (both modes), the relative-position buckets, the
positional conv (odd and even kernels), the transformer (pre- and post-LN,
output_layer), WavLM and HuBERT at their test configurations,
HubertFeatureReader (bucket padding, chunking), k-means, SpeechEncoder,
ECAPA and SpeakerEmbedder (the CLI's sample buckets and --exact-ssl), the
parameter bridge on their trees, the f32 policy of the CLI's entry
points, and the device-activity sum that times the frontends on the card.

Inputs are drawn from a numpy seed; the JAX side runs with matmul
precision pinned to f32 (tests/conftest.py). Tolerance: 1e-5 absolute plus
1e-4 relative, f32 (ATOL, RTOL), except HuBERT's outputs, hidden states
and features, held to HUBERT_ATOL = 2e-5 absolute: at 1e-5 one HuBERT
feature of 24 000 (1.3e-5 off, on values up to 3, after the post-LN
model's final LayerNorm over 16 channels) fails. The buckets, units and
durations are equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import randomize
from unitspeech_tpu import cli as jcli
from unitspeech_tpu.config import SpeakerEmbedderConfig as JSpkCfg
from unitspeech_tpu.models import speaker as jsp
from unitspeech_tpu.models.ssl import feature_extractor as jfe
from unitspeech_tpu.models.ssl import hubert as jh
from unitspeech_tpu.models.ssl import kmeans as jkm
from unitspeech_tpu.models.ssl import speech_encoder as jse
from unitspeech_tpu.models.ssl import transformer as jt
from unitspeech_tpu.models.ssl import wavlm as jw
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import SpeakerEmbedderConfig, config_from_dict
from unitspeech_tpu_torch.models import speaker as tsp
from unitspeech_tpu_torch.models.ssl import feature_extractor as tfe
from unitspeech_tpu_torch.models.ssl import hubert as th
from unitspeech_tpu_torch.models.ssl import kmeans as tkm
from unitspeech_tpu_torch.models.ssl import speech_encoder as tse
from unitspeech_tpu_torch.models.ssl import transformer as tt
from unitspeech_tpu_torch.models.ssl import wavlm as tw
from unitspeech_tpu_torch.utils.params import params_from_jax, params_to_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
HUBERT_ATOL = 2e-5
CONVS = ((8, 10, 5), (8, 3, 2), (8, 2, 2))
# a speaker embedder of about 16 channels on the test WavLM
SPK = dict(feat_type="wavlm_test", channels=16, spk_emb_dim=8)


def _wav(seed, *shape):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def _variables(module, seed, *args, **kw):
    """JAX variables redrawn from a numpy seed; BatchNorm variances
    positive."""
    v = randomize(jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw))(*args), seed)
    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.abs(x) + 0.5 if str(getattr(p[-1], "key", "")) == "var" else x, v))


def _port(module, variables):
    module.load_state_dict(params_from_jax(variables))
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (16, 64)])
def test_relative_position_bucket_equal(num_buckets, max_distance):
    """Every relative position of a 1000-frame sequence (the integer
    buckets) equal to JAX's."""
    rel = np.arange(-999, 1000)
    want = np.asarray(jt.relative_position_bucket(jnp.asarray(rel), num_buckets, max_distance))
    got = tt.relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["group_norm", "layer_norm"])
def test_feature_extractor_matches_jax(mode):
    wav = _wav(1, 2, 1234)
    jm = jfe.ConvFeatureExtractor(CONVS, mode, conv_bias=False)
    v = _variables(jm, 2, jnp.asarray(wav))
    got = _port(tfe.ConvFeatureExtractor(CONVS, mode, conv_bias=False), v)(torch.from_numpy(wav))
    want = jm.apply(v, jnp.asarray(wav))
    assert got.shape[1] == tfe.conv_frames(1234, CONVS)
    _close(got, want)


@pytest.mark.parametrize("k", [8, 7])
def test_positional_conv_matches_jax(k):
    """The grouped positional conv: an even kernel drops the trailing frame."""
    x = _wav(3, 2, 37, 16)
    jm = jt.ConvPositionalEmbedding(16, k, 2)
    v = _variables(jm, 4, jnp.asarray(x))
    got = _port(tt.ConvPositionalEmbedding(16, k, 2), v)(torch.from_numpy(x))
    assert got.shape == (2, 37, 16)
    _close(got, jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("pre_ln,relpos,output_layer",
                         [(False, False, None), (False, False, 1), (True, True, None),
                          (True, True, 2)])
def test_transformer_matches_jax(pre_ln, relpos, output_layer):
    """Post-LN (HuBERT) and pre-LN with the gated relative position bias
    (WavLM): the output and every hidden state; output_layer stops early
    and skips the pre-LN model's final LayerNorm."""
    kw = dict(embed_dim=16, num_layers=3, num_heads=2, ffn_dim=32, layer_norm_first=pre_ln,
              relative_position_embedding=relpos, gru_rel_pos=relpos, num_buckets=16,
              max_distance=64, conv_pos=8, conv_pos_groups=2)
    x = _wav(5, 2, 41, 16)
    jm = jt.SSLTransformerEncoder(**kw)
    v = _variables(jm, 6, jnp.asarray(x))
    want, want_h = jm.apply(v, jnp.asarray(x), output_layer=output_layer)
    got, got_h = _port(tt.SSLTransformerEncoder(**kw), v)(torch.from_numpy(x), output_layer)
    assert len(got_h) == len(want_h) == (output_layer or 3) + 1
    _close(got, want)
    for g, w in zip(got_h, want_h):
        _close(g, w)


@pytest.fixture(scope="module")
def wavlm():
    wav = _wav(7, 2, 3000)
    jm = jw.WavLMModel(jw.wavlm_test_config())
    v = _variables(jm, 8, jnp.asarray(wav))
    return jm, v, _port(tw.WavLMModel(tw.wavlm_test_config()), v), wav


def test_wavlm_matches_jax(wavlm):
    """The test WavLM: final output and its 3 hidden states (the embedding
    and each layer's output; WavLM-Large has 25)."""
    jm, v, tm, wav = wavlm
    want, want_h = jm.apply(v, jnp.asarray(wav))
    got, got_h = tm(torch.from_numpy(wav))
    assert len(got_h) == len(want_h) == jw.wavlm_test_config().num_layers + 1
    _close(got, want)
    for g, w in zip(got_h, want_h):
        _close(g, w)
    assert tw.wavlm_large_config().num_layers + 1 == 25


@pytest.fixture(scope="module")
def hubert():
    jm = jh.HubertModel(jh.hubert_test_config())
    v = _variables(jm, 9, jnp.zeros((1, 2000), jnp.float32))
    return jm, v, _port(th.HubertModel(th.hubert_test_config()), v)


@pytest.mark.parametrize("output_layer", [None, 2])
def test_hubert_matches_jax(hubert, output_layer):
    """The test HuBERT: its output (layer 2's with output_layer) and every
    hidden state (the embedding and each layer's output that ran)."""
    jm, v, tm = hubert
    wav = _wav(10, 2, 2500)
    want, want_h = jm.apply(v, jnp.asarray(wav), output_layer=output_layer)
    got, got_h = tm(torch.from_numpy(wav), output_layer)
    assert got.dtype == torch.float32
    assert len(got_h) == len(want_h) == (output_layer or th.hubert_test_config().num_layers) + 1
    _close(got, want, HUBERT_ATOL)
    for g, w in zip(got_h, want_h):
        _close(g, w, HUBERT_ATOL)


@pytest.mark.parametrize("n,max_chunk", [(7000, 1_600_000), (30000, 12000), (8, 1_600_000)])
def test_hubert_feature_reader_matches_jax(hubert, n, max_chunk):
    """The reader zero-pads each chunk to its sample bucket (a multiple of
    320 * 64), with no padding mask, and keeps its true frames: the same
    buckets and features as JAX's, also chunked at a small max_chunk (the
    last chunk shorter) and for a wav shorter than one frame's window."""
    jm, v, tm = hubert
    wav = _wav(11, n)
    jr = jh.HubertFeatureReader(jm, v, layer=2, max_chunk=max_chunk)
    tr = th.HubertFeatureReader(tm, layer=2, max_chunk=max_chunk)
    assert tr.buckets == jr.buckets
    want, got = jr(wav), tr(wav)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=HUBERT_ATOL)


def test_kmeans_predict_and_quantizer(tmp_path):
    rng = np.random.default_rng(12)
    x, c = rng.standard_normal((300, 16)), rng.standard_normal((50, 16))
    x, c = x.astype(np.float32), c.astype(np.float32)
    want = np.asarray(jkm.kmeans_predict(jnp.asarray(x), jnp.asarray(c)))
    got = tkm.kmeans_predict(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ((x[:, None] - c[None]) ** 2).sum(-1).argmin(1))
    q = tkm.KMeansQuantizer(c)
    q.save(str(tmp_path / "k.npz"))
    jq = jkm.KMeansQuantizer.load(str(tmp_path / "k.npz"))
    np.testing.assert_array_equal(tkm.KMeansQuantizer.load(str(tmp_path / "k.npz"))(x), jq(x))
    units = np.array([3, 3, 1, 1, 1, 4, 3, 3])
    for a, b in zip(tkm.dedup_consecutive(units), jkm.dedup_consecutive(units)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dedup,bos_eos", [(True, False), (False, True)])
def test_speech_encoder_units_equal_jax(hubert, dedup, bos_eos):
    """Units, durations and dense features of SpeechEncoder (mHuBERT layer
    2 of the test model, 40 centroids), with and without deduplication and
    bos/eos."""
    jm, v, tm = hubert
    cent = np.random.default_rng(13).standard_normal((40, 16)).astype(np.float32)
    wav = _wav(14, 9000)
    want = jse.SpeechEncoder(jh.HubertFeatureReader(jm, v, layer=2), jkm.KMeansQuantizer(cent),
                             deduplicate=dedup, add_bos_eos=bos_eos)(wav)
    got = tse.SpeechEncoder(th.HubertFeatureReader(tm, layer=2), tkm.KMeansQuantizer(cent),
                            deduplicate=dedup, add_bos_eos=bos_eos)(wav)
    np.testing.assert_array_equal(got["units"], want["units"])
    np.testing.assert_array_equal(got["durations"], want["durations"])
    np.testing.assert_allclose(got["dense"], want["dense"], rtol=RTOL, atol=HUBERT_ATOL)
    # need_f0: the test model's 20-sample frames are not the 320 its reader
    # declares, so the F0 track misses the units' length by more than the
    # tolerance; both raise the same error (tests/test_torch_port_extras.py
    # holds the F0 stream itself over the CPC reader)
    errors = []
    for se, reader in ((jse, jh.HubertFeatureReader(jm, v, layer=2)),
                       (tse, th.HubertFeatureReader(tm, layer=2))):
        with pytest.raises(ValueError, match="Cannot subsample F0") as err:
            se.SpeechEncoder(reader, se.KMeansQuantizer(cent), deduplicate=dedup,
                             add_bos_eos=bos_eos, need_f0=True)(wav)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.fixture(scope="module")
def embedder():
    jm = jsp.SpeakerEmbedder.from_config(JSpkCfg(**SPK))
    v = _variables(jm, 15, jnp.zeros((1, 1000), jnp.float32))
    return jm, v, _port(tsp.SpeakerEmbedder.from_config(SpeakerEmbedderConfig(**SPK)), v)


def test_ecapa_matches_jax(embedder):
    """ECAPA alone on stacked hidden states (running-statistics BatchNorm)."""
    jm, v, tm = embedder
    h = _wav(16, 3, 2, 50, 16)
    je = jsp.EcapaTdnn(feat_dim=16, channels=16, emb_dim=8, n_hidden_states=3)
    ev = {"params": v["params"]["ecapa"], "batch_stats": v["batch_stats"]["ecapa"]}
    _close(tm.ecapa(torch.from_numpy(h)), je.apply(ev, jnp.asarray(h)))


@pytest.mark.parametrize("buckets", [cli.DEFAULT_SPK_SAMPLE_BUCKETS, None],
                         ids=["sample_buckets", "exact_ssl"])
def test_speaker_embedding_matches_jax_cli(embedder, buckets):
    """embed_speaker as the CLI calls it, on a 22.05 kHz wav resampled on
    the host to 16 kHz: reflect-extended to the 96 000-sample bucket, or
    at its exact length (--exact-ssl); against JAX's embed_speaker."""
    jm, v, tm = embedder
    cfg = config_from_dict({"spk_embedder": SPK})
    wav = _wav(17, 22050)
    assert jcli.DEFAULT_SPK_SAMPLE_BUCKETS == cli.DEFAULT_SPK_SAMPLE_BUCKETS
    want = jcli.embed_speaker(jm, v, wav, 22050, cfg, sample_buckets=buckets)
    got = cli.embed_speaker(tm, wav, 22050, cfg, sample_buckets=buckets)
    assert got.shape == want.shape == (1, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_params_round_trip_on_ssl_trees(embedder, hubert):
    """params_from_jax carries the speaker embedder's params and batch_stats
    (merged under their flax paths) and HuBERT's params; params_to_jax
    gives the same trees back bit for bit."""
    for variables in (embedder[1], hubert[1]):
        sd = params_from_jax(variables)
        assert "ecapa.bn.mean" in sd or "encoder.pos_conv.kernel" in sd
        back = params_to_jax(sd)
        assert set(back) == set(variables)
        for (kp, a), (kq, b) in zip(*(sorted(jax.tree_util.tree_leaves_with_path(t),
                                             key=lambda e: jax.tree_util.keystr(e[0]))
                                      for t in (variables, back))):
            assert jax.tree_util.keystr(kp) == jax.tree_util.keystr(kq)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_points_run_strict_f32_and_restore(tmp_path, monkeypatch):
    """f32 means f32: inside `cli inference` (and every entry point under
    strict_f32) TF32 is off for f32 matmuls and cuDNN convs; the caller's
    settings, TF32 on here, come back after it returns."""
    from tests.test_torch_port_tts import TINY
    from unitspeech_tpu_torch.infer import tts
    from unitspeech_tpu_torch.utils.precision import strict_f32

    seen = []
    real = tts.Synthesizer.synthesize_mel

    def spy(self, *a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(self, *a, **kw)

    monkeypatch.setattr(tts.Synthesizer, "synthesize_mel", spy)
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "ckpt.pt")
    cli.main_make_random_checkpoint(["--config", str(tmp_path / "c.json"), "--output", ckpt])
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt, "--device", "cpu",
                            "--diffusion-steps", "1", "--fp32", "--output",
                            str(tmp_path / "o.wav")])
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with pytest.raises(RuntimeError):
            with strict_f32():
                assert not torch.backends.cudnn.allow_tf32
                raise RuntimeError("restored on the way out too")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_device_activity_counts_overlap_once(monkeypatch):
    """kernel_breakdown.device_activity, which chip_smoke.py's frontends
    phase reads, on a stub trace of two calls: the busy time counts
    overlapping intervals once, the sum each duration, both per call."""
    from types import SimpleNamespace

    from unitspeech_tpu_torch.tools import kernel_breakdown

    def ev(start, us):
        return SimpleNamespace(time_range=SimpleNamespace(start=start), device_time=us)

    trace = [ev(20.0, 5.0), ev(0.0, 10.0), ev(5.0, 10.0), ev(7.0, 2.0), ev(40.0, 0.0)]
    monkeypatch.setattr(kernel_breakdown, "_device_events", lambda fn, reps: trace)
    got = kernel_breakdown.device_activity(None, 2)
    assert got == {"sum_ms": 27.0 / 2e3, "busy_ms": 20.0 / 2e3, "launches": 2.5}
