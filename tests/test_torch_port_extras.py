"""The textlesslib extras of the port against the JAX package, on the CPU
at small sizes, inputs from numpy seeds and JAX trees carried across by
params_from_jax: the F0 tracker and its helpers, CPC (model, reader,
converter, the depth check), SpeechEncoder's F0 stream, Tacotron2,
WaveGlow and its denoiser, the unit vocoder, the quantized datasets, the
resynthesis and GSLM examples and the CLI's CPC unit extractor."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_f0_oracle import FRAME, HOP, SR, synth_voiced
from unitspeech_tpu.data import quantize as jq
from unitspeech_tpu.infer import unit_vocoder as juv
from unitspeech_tpu.models import tacotron2 as jt
from unitspeech_tpu.models import waveglow as jw
from unitspeech_tpu.models.ssl import cpc as jc
from unitspeech_tpu.models.ssl import kmeans as jkm
from unitspeech_tpu.models.ssl import speech_encoder as jse
from unitspeech_tpu.ops import f0 as jf
from unitspeech_tpu_torch.data import quantize as tq
from unitspeech_tpu_torch.infer import unit_vocoder as tuv
from unitspeech_tpu_torch.models import tacotron2 as tt
from unitspeech_tpu_torch.models import waveglow as tw
from unitspeech_tpu_torch.models.ssl import cpc as tc
from unitspeech_tpu_torch.models.ssl import kmeans as tkm
from unitspeech_tpu_torch.models.ssl import speech_encoder as tse
from unitspeech_tpu_torch.ops import f0 as tf
from unitspeech_tpu_torch.tools import extras_reference as er
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


# the JAX functions under jit (one compile each instead of op-by-op dispatch)
_jtaco = jax.jit(jt.tacotron2_infer, static_argnums=(1,), static_argnames=("prenet_dropout",))
_jwg = jax.jit(jw.waveglow_infer, static_argnums=(1,), static_argnames=("sigma",))
_jstft = jax.jit(jw.stft_transform, static_argnums=(1, 2, 3))
_jistft = jax.jit(jw.stft_inverse, static_argnums=(2, 3, 4))


def _load(module, tree):
    module.load_state_dict(params_from_jax(jax.device_get(tree)))
    return module.eval()


# ---------------------------------------------------------------------------
# F0


def _tone(f0, seconds=1.0):
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _creak():
    t = np.arange(SR) / SR
    phase = 2 * np.pi * 140.0 * t
    sig = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 13))
    sig = sig * (1.0 - 0.35 * (np.sin(np.pi * 140.0 * t) > 0))
    return (sig / np.abs(sig).max()).astype(np.float32)


def _octave_segments():
    segs = []
    for f0, dur in ((110.0, 0.4), (0.0, 0.2), (220.0, 0.4)):
        t = np.arange(int(SR * dur)) / SR
        s = sum((1.0 / k) * np.sin(k * 2 * np.pi * f0 * t) for k in range(1, 13)) if f0 \
            else np.zeros(t.size)
        segs.append(s / max(np.abs(s).max(), 1e-12))
    return np.concatenate(segs).astype(np.float32)


def _jitter():
    walk = 150.0 * np.exp(np.cumsum(np.random.default_rng(3).normal(0, 0.02, 400))
                          * 0.25).clip(0.6, 1.6)
    grid = np.linspace(0, 1, 400)
    return synth_voiced(lambda t: np.interp(t / t[-1], grid, walk), dur=2.0, snr_db=15.0,
                        seed=4)


# the signals of tests/test_f0.py and tests/test_f0_oracle.py: (wav, truth
# or None, the oracle's (voiced fraction, GPE, FPE) envelope or None)
F0_CASES = {
    "pure_tone": lambda: (_tone(220.0), None, None),
    "silence": lambda: (np.zeros(SR, np.float32), None, None),
    "tone_then_silence": lambda: (np.concatenate([_tone(150.0, 0.5), np.zeros(SR // 2,
                                                                             np.float32)]),
                                  None, None),
    "glide": lambda: (*synth_voiced(lambda t: 120 + 60 * t / t[-1]), (0.9, 0.05, 0.02)),
    "vibrato": lambda: (*synth_voiced(lambda t: 200 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))),
                        (0.9, 0.05, 0.02)),
    "low_male": lambda: (*synth_voiced(lambda t: np.full_like(t, 85.0)), (0.9, 0.05, 0.02)),
    "high_female": lambda: (*synth_voiced(lambda t: np.full_like(t, 350.0),
                                          harmonics=range(1, 10)), (0.9, 0.05, 0.02)),
    "missing_fundamental": lambda: (*synth_voiced(lambda t: np.full_like(t, 160.0),
                                                  harmonics=range(2, 13)), (0.9, 0.05, 0.02)),
    "noisy_5db": lambda: (*synth_voiced(lambda t: 140 + 40 * t / t[-1], snr_db=5.0),
                          (0.9, 0.05, 0.02)),
    "zero_db": lambda: (*synth_voiced(lambda t: 120 + 60 * t / t[-1], snr_db=0.0, seed=5),
                        (0.9, 0.10, None)),
    "jitter": lambda: (*_jitter(), (0.9, 0.05, None)),
    "gating": lambda: (synth_voiced(lambda t: np.full_like(t, 200.0),
                                    amp_fn=lambda t: (np.sin(2 * np.pi * 2 * t) > 0)
                                    .astype(float))[0], None, None),
    "creak": lambda: (_creak(), None, None),
    "octave_segments": lambda: (_octave_segments(), None, None),
    "noise_only": lambda: ((np.random.default_rng(9).standard_normal(SR) * 0.3)
                           .astype(np.float32), None, None),
}


def _near_ties(wav):
    """Frames where a choice may flip between two FFTs' roundings: the two
    best DP costs within 1e-5, or two candidates' NCCF merits (recovered
    from the local costs: merit = (1 - cost) / (1 - 0.3 lag / lag_max))
    within 1e-5. An onset frame whose correlation window holds only
    silence has an NCCF plateau of exactly 1, where rounding picks the
    peaks."""
    local_v, freq = (a.numpy() for a in tf.f0_candidates(torch.from_numpy(wav)))
    _, costs = tf.viterbi(local_v, freq, return_costs=True)
    srt = np.sort(costs, axis=1)
    lag_max = min(int(SR / 60.0), FRAME // 2 - 2)
    fin = np.isfinite(local_v)
    merit = np.where(fin, (1.0 - np.where(fin, local_v, 0.0))
                     / (1.0 - tf._LAG_WT * (SR / freq) / lag_max), -np.inf)
    m = -np.sort(-merit, axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf where no state is finite
        tied = (np.isfinite(m[:, 1:]) & (m[:, :-1] - m[:, 1:] < 1e-5)).any(axis=1)
        return (srt[:, 1] - srt[:, 0] < 1e-5) | tied


@pytest.mark.parametrize("case", list(F0_CASES))
def test_extract_f0_matches_jax(case):
    """The voicing frame by frame and f0 within 1e-4 relative of JAX's
    extract_f0, except at demonstrated near-ties; the oracle's GPE / FPE
    envelope where it has one."""
    wav, truth, envelope = F0_CASES[case]()
    want = np.asarray(jf.extract_f0(wav))
    got = tf.extract_f0(torch.from_numpy(wav))
    assert got.dtype == np.float32 and got.shape == want.shape
    voiced = want > 0
    rel = np.abs(got - want) / np.where(voiced, want, 1.0)
    differ = ((got > 0) != voiced) | (voiced & (rel > 1e-4))
    if differ.any():
        assert _near_ties(wav)[differ].all(), np.flatnonzero(differ)
    if envelope is not None:
        min_voiced, max_gpe, max_fpe = envelope
        centers = (np.arange(len(got)) * HOP + FRAME // 2).clip(0, len(wav) - 1)
        v = got > 0
        r = np.abs(got[v] - truth[centers][v]) / truth[centers][v]
        assert v.mean() > min_voiced and (r > 0.2).mean() <= max_gpe
        if max_fpe is not None:
            assert np.median(r[r <= 0.2]) <= max_fpe


def test_extract_f0_on_the_wavs_device_path():
    """An array goes through the CPU; a tensor's device computes the
    candidates; the result is the same numpy track."""
    wav = _tone(180.0, 0.3)
    np.testing.assert_array_equal(tf.extract_f0(wav), tf.extract_f0(torch.from_numpy(wav)))


def test_f0_helpers_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    f0 = np.where(rng.random(90) < 0.3, 0.0, rng.uniform(80, 300, 90)).astype(np.float32)
    f0[-5:] = 0.0
    for name in ("mean_normalize_f0", "std_normalize_f0", "trailing_silence_mask"):
        np.testing.assert_array_equal(getattr(tf, name)(f0), getattr(jf, name)(f0))
    np.testing.assert_array_equal(tf.quantize_f0(tf.mean_normalize_f0(f0), n_bins=16),
                                  jf.quantize_f0(jf.mean_normalize_f0(f0), n_bins=16))
    stats = {"a": {"f0_mean": 150.0, "f0_std": 30.0, "logf0_mean": 5.0, "logf0_std": 0.3}}
    for kw in ({}, {"scale": True}, {"log": False, "scale": True}):
        np.testing.assert_array_equal(tf.SpeakerMeanNormalize(stats, **kw)(f0, "a"),
                                      jf.SpeakerMeanNormalize(stats, **kw)(f0, "a"))
        np.testing.assert_array_equal(tf.PromptNormalize(**kw)(f0), jf.PromptNormalize(**kw)(f0))
    bins = np.sort(rng.uniform(-1, 6, 12))
    np.testing.assert_array_equal(tf.F0BinQuantizer(bins)(f0), jf.F0BinQuantizer(bins)(f0))
    durs = rng.integers(1, 4, 20)
    assert 2 * durs.sum() + 1 <= len(f0)
    for n in (int(2 * durs.sum()) - 1, int(2 * durs.sum()), int(2 * durs.sum()) + 1):
        np.testing.assert_array_equal(tf.align_f0_to_durations(f0[:n], durs, 2.0),
                                      jf.align_f0_to_durations(f0[:n], durs, 2.0))
    # the tolerance error, message and all
    errors = []
    for mod in (tf, jf):
        with pytest.raises(ValueError) as err:
            mod.align_f0_to_durations(f0[:30], durs, 2.0, tol=3.0)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "Cannot subsample F0" in errors[0]


# ---------------------------------------------------------------------------
# CPC


CPC_CFG = tc.cpc_test_config()


@pytest.fixture(scope="module")
def cpc():
    """A torch-named CPC state dict at the test widths, both packages'
    models holding its conversion."""
    sd = {k: v.numpy() for k, v in er.random_cpc_state_dict(CPC_CFG, seed=3).items()}
    jcfg = jc.cpc_test_config()
    tree = jc.convert_cpc(sd, jcfg)
    return sd, jc.CpcModel(jcfg), tree, _load(tc.CpcModel(CPC_CFG), tree)


def test_convert_cpc_bit_equal(cpc):
    sd, _, tree, tm = cpc
    got = tc.convert_cpc(sd, CPC_CFG)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(params_from_jax(got)) == sorted(tm.state_dict())


@pytest.mark.parametrize("get_encoded,norm_output", [(False, False), (True, False), (False, True)])
def test_cpc_model_matches_jax(cpc, get_encoded, norm_output):
    _, jm, tree, tm = cpc
    wav = (0.1 * np.random.default_rng(1).standard_normal((1, 3200))).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(wav), get_encoded=get_encoded,
                               norm_output=norm_output))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), get_encoded=get_encoded, norm_output=norm_output).numpy()
    assert got.shape == want.shape == (1, 20, 8 if get_encoded else 6)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [4000, 1000, 100], ids=["windows_and_tail", "short", "empty"])
def test_cpc_reader_matches_jax(cpc, n):
    """max_chunk 1 600: 4 000 samples are two full windows and the tail
    pass over the whole wav; 1 000 only the tail; 100 gives no frame."""
    _, jm, tree, tm = cpc
    wav = (0.1 * np.random.default_rng(2).standard_normal(n)).astype(np.float32)
    for kw in ({}, {"norm_features": True}):
        want = jc.CpcFeatureReader(jm, tree, max_chunk=1600, **kw)(wav)
        reader = tc.CpcFeatureReader(tm, max_chunk=1600, **kw)
        got = reader(wav)
        assert got.shape == want.shape == (n // 160, 6)
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert (reader.hop, reader.code_hop_size, reader.expected_sample_rate) == (160, 160, 16000)


def _cpc_checkpoint(path, levels=2):
    cfg = tc.CpcConfig(8, 6, levels)
    torch.save({"weights": er.random_cpc_state_dict(cfg, seed=5),
                "config": {"hiddenEncoder": 8, "hiddenGar": 6, "nLevelsGRU": levels}}, path)
    return str(path)


def test_cpc_depth_above_the_checkpoint_raises(tmp_path):
    """The default config's hubert_layer (6) on a 2-level checkpoint: a
    ValueError naming both numbers (JAX stops with a bare KeyError), from
    from_torch and from the CLI's unit extractor; a shallower depth
    reads the first levels."""
    import dataclasses

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig

    path = _cpc_checkpoint(tmp_path / "cpc.pt")
    cfg = MainConfig()
    assert cfg.unit_extractor.hubert_layer == 6
    cfg = dataclasses.replace(cfg, unit_extractor=dataclasses.replace(
        cfg.unit_extractor, dense_model_name="cpc-big-ll6k"))
    np.savez(tmp_path / "k.npz", centroids=np.zeros((4, 6), np.float32))
    with pytest.raises(ValueError, match="layer 6 .*nLevelsGRU = 2"):
        cli.build_unit_extractor(path, str(tmp_path / "k.npz"), cfg, torch.device("cpu"))
    with pytest.raises(KeyError):  # JAX's
        jc.CpcFeatureReader.from_torch(path, layer=6)
    one = tc.CpcFeatureReader.from_torch(path, layer=1, device="cpu")
    assert one.model.config.n_levels_lstm == 1 and one.model.gAR.num_layers == 1


def test_hubert_base_ls960_is_in_the_registry():
    """The resynthesis example's default dense model: HuBERT Base's shapes
    in the port's registry; the JAX registry lacks the name (its
    example's checkpoint mode stops there with a KeyError)."""
    from unitspeech_tpu.models.ssl import hubert as jh
    from unitspeech_tpu_torch.models.ssl import hubert as th

    assert th.hubert_config_by_name("hubert-base-ls960") == th.mhubert_base_config()
    with pytest.raises(KeyError, match="unknown dense model"):
        jh.hubert_config_by_name("hubert-base-ls960")


def test_cli_cpc_unit_extractor_matches_jax(tmp_path):
    """build_unit_extractor with dense_model_name cpc-big-ll6k (depth 2)
    on a small CPC checkpoint and a centroid file: JAX's units."""
    import dataclasses

    from unitspeech_tpu import cli as jcli
    from unitspeech_tpu.config import MainConfig as JMainConfig
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig

    path = _cpc_checkpoint(tmp_path / "cpc.pt")
    rng = np.random.default_rng(6)
    wav = (0.2 * rng.standard_normal(5000)).astype(np.float32)
    # centroids at a few of the wav's own frames, so that the units vary
    feats = tc.CpcFeatureReader.from_torch(path, device="cpu")(wav)
    np.savez(tmp_path / "k.npz", centroids=feats[::5])

    def cfg_of(main):
        c = main()
        return dataclasses.replace(c, unit_extractor=dataclasses.replace(
            c.unit_extractor, dense_model_name="cpc-big-ll6k", hubert_layer=2))

    want = jcli.build_unit_extractor(path, str(tmp_path / "k.npz"), cfg_of(JMainConfig))(wav)
    enc = cli.build_unit_extractor(path, str(tmp_path / "k.npz"), cfg_of(MainConfig),
                                   torch.device("cpu"))
    got = enc(wav)
    assert isinstance(enc.dense_model, tc.CpcFeatureReader) and got["units"].size > 3
    np.testing.assert_array_equal(got["units"], want["units"])
    np.testing.assert_array_equal(got["durations"], want["durations"])


# ---------------------------------------------------------------------------
# SpeechEncoder's F0 stream


class _Dense320:
    """A 50 Hz stand-in dense model for both packages: the means of four
    80-sample quarters of each 320-sample frame (JAX calls it; the port
    reads .features)."""

    hop = 320

    def __call__(self, wav):
        n = len(wav) // 320
        return np.asarray(wav[:n * 320], np.float32).reshape(n, 4, 80).mean(axis=2)

    def features(self, wav):
        return torch.from_numpy(self(wav))


F0_BINS = np.linspace(-0.5, 0.5, 9)


@pytest.mark.parametrize("dedup,bos_eos,norm,quant", [
    (True, False, None, False), (False, True, "prompt", True), (True, True, "speaker", False),
])
def test_speech_encoder_f0_stream_matches_jax(dedup, bos_eos, norm, quant):
    """Units, durations and the F0 stream (one value a unit, bos / eos
    padded) of SpeechEncoder(need_f0=True) against JAX's, with each
    normalizer and F0BinQuantizer."""
    wav, _ = synth_voiced(lambda t: 110 + 50 * t / t[-1], dur=1.2, seed=7)
    centers = np.random.default_rng(8).standard_normal((6, 4)).astype(np.float32) * 0.2
    stats = {"s": {"f0_mean": 140.0, "f0_std": 20.0, "logf0_mean": 4.9, "logf0_std": 0.2}}
    encs = []
    for mod, km, f0m in ((jse, jkm, jf), (tse, tkm, tf)):
        normalizer = {None: None, "prompt": f0m.PromptNormalize(),
                      "speaker": f0m.SpeakerMeanNormalize(stats)}[norm]
        encs.append(mod.SpeechEncoder(_Dense320(), km.KMeansQuantizer(centers), deduplicate=dedup,
                                      add_bos_eos=bos_eos, need_f0=True, f0_normalizer=normalizer,
                                      f0_quantizer=f0m.F0BinQuantizer(F0_BINS) if quant else None))
    want, got = (e(wav, speaker="s") for e in encs)
    assert set(got) == set(want) == {"units", "durations", "dense", "f0"}
    np.testing.assert_array_equal(got["units"], want["units"])
    np.testing.assert_array_equal(got["durations"], want["durations"])
    assert got["f0"].shape == got["units"].shape and got["f0"].dtype == want["f0"].dtype
    if quant:
        np.testing.assert_array_equal(got["f0"], want["f0"])
    else:
        np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-4, atol=1e-6)
    assert encs[1].f0_code_ratio == encs[0].f0_code_ratio == 4.0


def test_speech_encoder_f0_over_the_cpc_reader(cpc):
    """Over the CPC reader (100 Hz): JAX's F0 track of 1024-sample frames
    is 12 frames short of two a unit at any length past 55 ms, beyond the
    tolerance of 5 units' frames (10): both packages raise the same error
    at 1 s; on 800 samples (within it) the streams are equal."""
    _, jm, tree, tm = cpc
    centers = np.random.default_rng(9).standard_normal((5, 6)).astype(np.float32)
    encs = [jse.SpeechEncoder(jc.CpcFeatureReader(jm, tree, max_chunk=1600),
                              jkm.KMeansQuantizer(centers), need_f0=True, add_bos_eos=True),
            tse.SpeechEncoder(tc.CpcFeatureReader(tm, max_chunk=1600),
                              tkm.KMeansQuantizer(centers), need_f0=True, add_bos_eos=True)]
    wav = _tone(150.0, 1.0)
    errors = []
    for e in encs:
        with pytest.raises(ValueError) as err:
            e(wav)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "Cannot subsample F0: |188 - 2.0*100| > 10.0"
    want, got = (e(wav[:800]) for e in encs)
    for k in ("units", "durations"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-4)
    assert got["f0"].shape == got["units"].shape and (got["f0"][1:-1] > 0).all()
    np.testing.assert_allclose(got["dense"], want["dense"], atol=ATOL)


# ---------------------------------------------------------------------------
# Tacotron2


def _taco(seed=1, gate_scale=None, **kw):
    """JAX's random test tree (the port's draw where obs / lat are set:
    JAX's does not fit its decoder there). gate_scale: the gate's weights
    times it (-30 turns the random gate into one that rises over the first
    steps, so that rows stop at different steps)."""
    cfg = jt.tacotron2_test_config(**kw)
    tcfg = tt.tacotron2_test_config(**kw)
    tree = (tt.random_tacotron2_params(tcfg, seed=seed) if cfg.obs_dim or cfg.lat_dim
            else jt.random_tacotron2_params(cfg, seed=seed))
    if gate_scale is not None:
        tree["decoder"]["gate"]["weight"] = tree["decoder"]["gate"]["weight"] * gate_scale
    return cfg, tree, _load(tt.Tacotron2(tcfg), tree)


def _tokens(lengths, seed=0, t=None):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), t or max(lengths)), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, 12, n)
    return toks, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() for a in arrays]


def _jax_masks(key, steps, b, d):
    """_prenet's key chain replayed: two splits a step, each a
    bernoulli(sub, 0.5, (B, prenet_dim)) keep mask -> (steps, 2, B, d)."""

    @jax.jit
    def replay(key):
        def step(key, _):
            masks = []
            for _ in range(2):
                key, sub = jax.random.split(key)
                masks.append(jax.random.bernoulli(sub, 0.5, (b, d)))
            return key, jnp.stack(masks)

        return jax.lax.scan(step, key, None, length=steps)[1]

    return torch.from_numpy(np.array(replay(key)))


def test_random_params_and_convert_tacotron2_bit_equal():
    """random_tacotron2_params draws JAX's arrays; convert_tacotron2 of the
    reference-named state dict (tools/extras_reference) gives JAX's
    conversion and the tree back; the module's keys and shapes are the
    tree's. With obs / lat set, JAX's draw gives the attention RNN and the
    memory layer inputs its decoder never feeds them; the port's draw has
    the shapes the module (and the reference) use."""
    for kw in ({}, {"obs_dim": 3, "obs_n_class": 2, "lat_dim": 2}):
        cfg, tcfg = jt.tacotron2_test_config(**kw), tt.tacotron2_test_config(**kw)
        tree, got = jt.random_tacotron2_params(cfg, seed=4), tt.random_tacotron2_params(tcfg, 4)
        if kw:
            assert tree["decoder"]["attention"]["memory"]["weight"].shape == (12, 21)
            assert got["decoder"]["attention"]["memory"]["weight"].shape == (12, 16)
            tree = got
        sd = {k: v.numpy() for k, v in er.tacotron2_state_dict(tree, tcfg).items()}
        for other in (got, tt.convert_tacotron2(sd, tcfg), jt.convert_tacotron2(sd, cfg)):
            assert jax.tree_util.tree_structure(other) == jax.tree_util.tree_structure(tree)
            for a, b in zip(jax.tree_util.tree_leaves(other), jax.tree_util.tree_leaves(tree)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        want = {k: tuple(v.shape) for k, v in params_from_jax(tree).items()}
        assert want == {k: tuple(v.shape) for k, v in tt.Tacotron2(tcfg).state_dict().items()}


def test_encoder_padded_batch_matches_jax():
    cfg, tree, tm = _taco(seed=3)
    toks, lens = _tokens([5, 9, 12], seed=1)
    want = np.asarray(jt.encoder_infer(tree, cfg, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        got = tt.encoder_infer(tm, *_t(toks, lens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[0, 5:] == 0).all() and (got[1, 9:] == 0).all()


def _check_infer(want, got, atol=ATOL):
    for name, a, b in zip(("mels", "mel_post", "gates", "alignments"), want[:4], got[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))


@pytest.mark.parametrize("gate_threshold", [0.0, 0.215, 1.1], ids=["step1", "mixed", "never"])
def test_tacotron2_infer_matches_jax(gate_threshold):
    """prenet_dropout=False on a padded batch: every output, n_steps and
    has_eos; thresholds that stop every row at once, rows at different
    steps, and none."""
    cfg, tree, tm = _taco(gate_threshold=gate_threshold, gate_scale=-30)
    toks, lens = _tokens([5, 9, 12])
    want = _jtaco(tree, cfg, jnp.asarray(toks), jnp.asarray(lens), prenet_dropout=False)
    got = tt.tacotron2_infer(tm, *_t(toks, lens), prenet_dropout=False)
    _check_infer(want, got)
    steps = np.asarray(want[4])
    assert {0.0: (steps == 1).all(), 0.215: len(set(steps.tolist())) == 3,
            1.1: (steps == 40).all()}[gate_threshold], steps


def test_tacotron2_infer_with_jax_prenet_masks():
    """Dropout on: JAX's keep masks (its key chain replayed) injected."""
    cfg, tree, tm = _taco(gate_threshold=0.215, gate_scale=-30)
    toks, lens = _tokens([4, 11])
    key = jax.random.PRNGKey(7)
    want = _jtaco(tree, cfg, jnp.asarray(toks), jnp.asarray(lens), rng=key)
    masks = _jax_masks(key, cfg.max_decoder_steps, 2, cfg.prenet_dim)
    got = tt.tacotron2_infer(tm, *_t(toks, lens), prenet_masks=masks)
    _check_infer(want, got)
    free = tt.tacotron2_infer(tm, *_t(toks, lens), generator=torch.Generator().manual_seed(0))
    assert not torch.equal(free[0], got[0])  # drawn masks are others


def test_tacotron2_obs_and_lat_match_jax():
    cfg, tree, tm = _taco(seed=2, gate_threshold=1.1, obs_dim=4, obs_n_class=3, lat_dim=2,
                          max_decoder_steps=12)
    toks, lens = _tokens([4, 6], seed=3)
    obs = np.array([1, 2], np.int32)
    lat = np.random.default_rng(4).standard_normal((2, 2)).astype(np.float32)
    want = _jtaco(tree, cfg, jnp.asarray(toks), jnp.asarray(lens), obs_labels=jnp.asarray(obs),
                  lat=jnp.asarray(lat), prenet_dropout=False)
    got = tt.tacotron2_infer(tm, *_t(toks, lens), obs_labels=torch.from_numpy(obs).long(),
                             lat=torch.from_numpy(lat), prenet_dropout=False)
    _check_infer(want, got)
    default = tt.tacotron2_infer(tm, *_t(toks, lens), prenet_dropout=False)
    assert not torch.allclose(default[1], got[1])


def test_tacotron2_padded_bucket_invariance():
    _, _, tm = _taco(seed=2, gate_threshold=1.1, max_decoder_steps=10)
    ids = np.array([1, 3, 5, 7, 2])
    outs = []
    for bucket in (5, 16):
        toks, lens = _tokens([5], t=bucket)
        toks[0, :5] = ids
        outs.append(tt.tacotron2_infer(tm, *_t(toks, lens), prenet_dropout=False))
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(), atol=ATOL)
    np.testing.assert_allclose(outs[0][3].numpy(), outs[1][3][..., :5].numpy(), atol=ATOL)
    assert (outs[1][3][..., 5:] == 0).all()


def test_tacotron2_stop_check_every_k_steps_is_exact():
    """Checking for the stop every 32 steps (or 7) gives outputs bit-equal
    to a check every step: rows that stopped write zeros and count no
    step."""
    _, _, tm = _taco(gate_threshold=0.205, gate_scale=-30)
    toks, lens = _tokens([5, 9, 12])
    masks = torch.rand((40, 2, 3, 10), generator=torch.Generator().manual_seed(1)) < 0.5
    runs = [tt.tacotron2_infer(tm, *_t(toks, lens), prenet_masks=masks, stop_every=k)
            for k in (1, 7, 32)]
    assert runs[0][4].max() < 40  # every row stopped before the end
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# WaveGlow


def _wg(seed=1, **kw):
    cfg = jw.waveglow_test_config(**kw)
    tree = jw.random_waveglow_params(cfg, seed=seed)
    return cfg, tree, _load(tw.WaveGlow(tw.waveglow_test_config(**kw)), tree)


def test_random_params_and_convert_waveglow_bit_equal():
    """random_waveglow_params draws JAX's arrays; convert_waveglow of a
    weight-normed reference state dict (the fold with max(norm, 1e-12),
    np.linalg.inv in float32, the flipped upsample kernel) is JAX's."""
    tcfg = tw.waveglow_test_config()
    cfg = jw.waveglow_test_config()
    tree = jw.random_waveglow_params(cfg, seed=2)
    got = tw.random_waveglow_params(tcfg, seed=2)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(a, b)
    sd = {k: v.numpy() for k, v in er.random_waveglow_state_dict(tcfg, seed=3).items()}
    assert any(k.endswith("weight_g") for k in sd)
    sd["WN.0.start.weight_v"][0] = 0.0  # a zero direction: the 1e-12 floor
    want = jw.convert_waveglow(sd, cfg)
    got = tw.convert_waveglow(sd, tcfg)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(params_from_jax(got)) == sorted(tw.WaveGlow(tcfg).state_dict())


@pytest.mark.parametrize("sigma", [0.0, 0.666, 1.0])
def test_waveglow_infer_matches_jax(sigma):
    """Injected noise (JAX's list and order): within 1e-5 of the output's
    range."""
    cfg, tree, tm = _wg()
    rng = np.random.default_rng(1)
    spect = rng.standard_normal((2, 11, cfg.n_mel_channels)).astype(np.float32)
    t_g = tw.upsample_mel(tm, torch.from_numpy(spect)).shape[2]
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in tw.noise_shapes(tm.cfg, 2, t_g)]
    want = np.asarray(_jwg(tree, cfg, jnp.asarray(spect), sigma=sigma,
                           noise=[jnp.asarray(z) for z in noise]))
    got = tw.waveglow_infer(tm, torch.from_numpy(spect), sigma=sigma, noise=noise).numpy()
    assert got.shape == want.shape == (2, t_g * cfg.n_group)
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())


def test_stft_matches_jax_and_round_trips():
    audio = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32)
    mag, phase = _jstft(jnp.asarray(audio), 64, 16, 64)
    tmag, tphase = tw.stft_transform(torch.from_numpy(audio), 64, 16, 64)
    np.testing.assert_allclose(tmag.numpy(), np.asarray(mag), atol=1e-5)
    # phases agree modulo 2 pi (atan2's cut at a -0 / +0 imaginary part)
    d = np.abs(tphase.numpy() - np.asarray(phase))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-4
    want = np.asarray(_jistft(mag, phase, 64, 16, 64))
    got = tw.stft_inverse(tmag, tphase, 64, 16, 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, audio[:, :got.shape[1]], atol=1e-5)


def _jax_denoiser(tree, cfg, n_fft=32, bias_frames=88):
    """JAX's WaveGlowDenoiser with its constructor's sigma = 0 pass run
    under jit (the same functions)."""
    den = object.__new__(jw.WaveGlowDenoiser)
    den.n_fft, den.hop, den.win_length = n_fft, n_fft // 4, n_fft
    audio = _jwg(tree, cfg, jnp.zeros((1, bias_frames, cfg.n_mel_channels)), sigma=0.0)
    den.bias_spec = _jstft(audio, n_fft, n_fft // 4, n_fft)[0][:, :, :1]
    return den


def test_denoiser_matches_jax():
    cfg, tree, tm = _wg(seed=4)
    jd = _jax_denoiser(tree, cfg)
    td = tw.WaveGlowDenoiser(tm, n_fft=32, win_length=32)
    np.testing.assert_allclose(td.bias_spec.numpy(), np.asarray(jd.bias_spec), atol=ATOL)
    audio = np.random.default_rng(5).standard_normal((1, 700)).astype(np.float32)
    np.testing.assert_allclose(td(torch.from_numpy(audio), 0.3).numpy(),
                               np.asarray(jax.jit(jd.__call__, static_argnums=1)(
                                   jnp.asarray(audio), 0.3)), atol=ATOL)


# ---------------------------------------------------------------------------
# the unit vocoder


def test_code_dict_and_sequences_match_jax(tmp_path):
    p = tmp_path / "code_dict.txt"
    p.write_text("10\n20\n30\n40\n")
    for sos, eos in ((False, False), (True, True)):
        assert tuv.load_code_dict(str(p), sos, eos) == juv.load_code_dict(str(p), sos, eos)
    cd = tuv.load_code_dict(str(p), True, True)
    codes = "10 10 20 99 30 30 30 40".split()
    for collapse in (False, True):
        assert tuv.code_to_sequence(codes, cd, collapse) == juv.code_to_sequence(codes, cd,
                                                                                collapse)
        for sos, eos in ((False, True), (True, False)):
            np.testing.assert_array_equal(
                tuv.TacotronInput(cd, sos, eos, collapse).get_ids("10 10 20 5"),
                juv.TacotronInput(cd, sos, eos, collapse).get_ids("10 10 20 5"))
    assert [tuv.token_bucket(n) for n in (1, 32, 33)] == [32, 32, 64]


def test_synthesize_matches_jax_synthesize_jit():
    """synthesize against JAX's _synthesize_jit on the same draws: its
    prenet masks (the key chain replayed) and its WaveGlow noise
    (fold_in(rng, 1), one split a draw) injected; tacotron2 with dropout ->
    WaveGlow at 0.666 -> the denoiser over the whole buffer, re-padded."""
    tcfg, ttree, tm = _taco(gate_threshold=0.215, gate_scale=-30, max_decoder_steps=24)
    wcfg, wtree, wm = _wg(n_flows=3, n_channels=8)
    toks, lens = _tokens([7], t=32)
    key = jax.random.PRNGKey(3)
    bias = _jax_denoiser(wtree, wcfg).bias_spec
    want, n_steps, has_eos = juv._synthesize_jit(ttree, wtree, bias, tcfg, wcfg,
                                                 jnp.asarray(toks), jnp.asarray(lens), key, True,
                                                 0.1, 32, 8)
    t_g = want.shape[1] // wcfg.n_group
    keys = jax.random.split(jax.random.fold_in(key, 1), 1 + len(wm.cfg.early_flows()))
    noise = [np.asarray(jax.random.normal(k, s))
             for k, s in zip(keys, tw.noise_shapes(wm.cfg, 1, t_g))]
    bias_t = tw.WaveGlowDenoiser(wm, n_fft=32, win_length=32).bias_spec
    got, steps, eos = tuv.synthesize(
        tm, wm, bias_t, *_t(toks, lens), tm.cfg, n_fft=32, hop=8,
        prenet_masks=_jax_masks(key, tcfg.max_decoder_steps, 1, tcfg.prenet_dim), noise=noise)
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 24 * 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max())
    assert int(steps[0]) == int(n_steps[0]) and bool(eos[0]) == bool(has_eos[0])


def test_vocoder_from_torch_files(tmp_path):
    """from_torch on {'model_dict', 'hparams'} files (tools/extras_reference,
    small widths): the configs and the converted parameters are JAX's, bit
    for bit; one call gives n_steps x 256 finite samples."""
    tcfg = tt.tacotron2_test_config(n_symbols=14, gate_threshold=1.1)
    wcfg = tw.waveglow_test_config(n_mel_channels=8, n_flows=3, n_channels=8,
                                   upsample_kernel=1024, upsample_stride=256)
    paths = er.write_extras(str(tmp_path), tcfg, wcfg, tc.cpc_test_config(), n_codes=10)
    want = juv.TacotronVocoder.from_torch(paths["tacotron"], paths["code_dict"],
                                          paths["waveglow"], max_decoder_steps=6)
    got = tuv.TacotronVocoder.from_torch(paths["tacotron"], paths["code_dict"],
                                         paths["waveglow"], max_decoder_steps=6, device="cpu")
    assert got.taco_cfg.__dict__ == want.taco_cfg.__dict__
    assert got.waveglow.cfg.__dict__ == want.wg_cfg.__dict__
    assert got.tts_input.__dict__ == want.tts_input.__dict__
    assert got.sample_rate == want.sample_rate == 22050
    for mod, tree in ((got.tacotron, want.taco_params), (got.waveglow, want.wg_params)):
        sd = mod.state_dict()
        for k, v in params_from_jax(jax.device_get(tree)).items():
            assert torch.equal(sd[k], v), k
    np.testing.assert_allclose(got.denoiser.bias_spec.numpy(),
                               np.asarray(want._denoiser.bias_spec), atol=1e-4)
    out = got("1 2 3 3 4")
    assert out.shape == (6 * 256,) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# quantized datasets


class _Toy:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.items = [(0.3 * np.sin(np.arange(3200 + 640 * i) * (0.05 + 0.01 * i))
                       + 0.01 * rng.standard_normal(3200 + 640 * i), f"text-{i}", f"spk{i % 2}")
                      for i in range(3)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _quantized(mod, se, km, need_f0):
    centers = np.array([[-0.2] * 4, [0.0] * 4, [0.2] * 4], np.float32)
    enc = se.SpeechEncoder(_Dense320(), km.KMeansQuantizer(centers), need_f0=need_f0)
    return mod.QuantizeDataset(_Toy(), enc, speaker_extractor=lambda rest: rest[1])


@pytest.mark.parametrize("need_f0", [False, True])
def test_quantize_dataset_and_collater_match_jax(need_f0):
    jd, td = _quantized(jq, jse, jkm, need_f0), _quantized(tq, tse, tkm, need_f0)
    assert len(td) == len(jd) == 3 and td.unit_pad == jd.unit_pad == 5
    items = [[d[i] for i in range(3)] for d in (jd, td)]
    for want, got in zip(*items):
        assert set(got) == set(want) and got["rest"] == want["rest"]
        np.testing.assert_array_equal(got["units"], want["units"])
    want, got = jd.collater(items[0]), td.collater(items[1])
    assert set(got) == set(want) and got["rest"] == want["rest"]
    for k in ("units", "durations", "dense"):
        np.testing.assert_array_equal(got[k], want[k])
    if need_f0:
        assert isinstance(got["f0"], tuple) and len(got["f0"]) == 1
        assert got["f0"][0].shape == got["units"].shape
        np.testing.assert_allclose(got["f0"][0], want["f0"][0], rtol=1e-4)
    np.testing.assert_array_equal(tq.collate_arrays([np.array([1, 2, 3]), np.array([1])], 0),
                                  [[1, 2, 3], [1, 0, 0]])


def test_quantized_filelist_matches_jax(tmp_path):
    from unitspeech_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(2)
    rows = []
    for i in range(2):
        p = str(tmp_path / f"a{i}.wav")
        write_wav(p, 0.1 * rng.standard_normal(3200 + 320 * i), 16000)
        rows.append(f"{p}|hello|spk{i}")
    (tmp_path / "list.txt").write_text("\n".join(rows))
    centers = np.array([[-0.01] * 4, [0.0] * 4, [0.01] * 4], np.float32)
    want = jq.QuantizedFilelist(jse.SpeechEncoder(_Dense320(), jkm.KMeansQuantizer(centers)),
                                str(tmp_path / "list.txt"))
    got = tq.QuantizedFilelist(tse.SpeechEncoder(_Dense320(), tkm.KMeansQuantizer(centers)),
                               str(tmp_path / "list.txt"))
    wav, text, spk = got.dataset[0]
    assert (text, spk, len(wav)) == ("hello", "spk0", 3200)
    for i in range(2):
        assert got[i]["rest"] == want[i]["rest"] == ["hello", f"spk{i}"]
        np.testing.assert_array_equal(got[i]["units"], want[i]["units"])
        assert int(got[i]["durations"].sum()) == 10 + i


@pytest.mark.parametrize("name", ["QuantizedLibriSpeech", "QuantizedLjSpeech",
                                  "QuantizedVCTK_092", "QuantizedYesNo"])
def test_torchaudio_wrappers_need_torchaudio(name):
    if importlib.util.find_spec("torchaudio") is not None:
        pytest.skip("torchaudio is installed here")
    with pytest.raises(ImportError, match="torchaudio is required"):
        getattr(tq, name)(speech_encoder=None, root="/nonexistent")


# ---------------------------------------------------------------------------
# the examples


def _root_example(name):
    spec = importlib.util.spec_from_file_location(f"{name}_example_jax",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # flax's dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jexamples():
    return _root_example("resynthesis"), _root_example("gslm")


def test_resynthesis_tiny_stack_units_match_jax(jexamples, tmp_path, capsys):
    """The port's tiny stack with the JAX tiny stack's HuBERT parameters
    carried across: the same units; the same Tacotron2 / WaveGlow draws;
    then `main` end to end on the CPU."""
    from unitspeech_tpu_torch.examples import resynthesis

    jres = jexamples[0]
    jenc, jvoc, _, vocab = jres.build_tiny_stack()
    enc, voc, name, tvocab = resynthesis.build_tiny_stack()
    assert name == "tiny-random" and tvocab == vocab == 8
    enc.dense_model.model.load_state_dict(params_from_jax(jax.device_get(jenc.dense_model.params)))
    wav = resynthesis.default_wav(0.5)
    np.testing.assert_array_equal(enc(wav)["units"], jenc(wav)["units"])
    for mod, tree in ((voc.tacotron, jvoc.taco_params), (voc.waveglow, jvoc.wg_params)):
        sd = mod.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in params_from_jax(tree).items())
    assert resynthesis.bitrates("hubert-base-ls960", 10, 100, 0.5) == jres.bitrates(
        "hubert-base-ls960", 10, 100, 0.5)
    out = resynthesis.main(["--device", "cpu", "--output", str(tmp_path / "r.wav")])
    assert out["samples"] == 32 * 8 and os.path.getsize(tmp_path / "r.wav") == 44 + 2 * 256
    assert "bitrate: uniform" in capsys.readouterr().out


def _ulm_pair(jgslm, vocab=6, d_model=16, seq_len=12, seed=0):
    from unitspeech_tpu_torch.examples import gslm

    jlm = jgslm.UnitLM(vocab_size=vocab, d_model=d_model)
    init = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, seq_len), jnp.int32)))
    tlm = gslm.UnitLM(vocab, d_model=d_model)
    sd = params_from_jax(init)
    assert sorted(sd) == sorted(tlm.state_dict())
    return jlm, init, sd


def test_train_ulm_three_steps_match_jax(jexamples):
    """Three Adam steps of train_ulm from JAX's initial parameters against
    the root example's step (its UnitLM, next-token CE, optax.adam) on the
    same batches (numpy.random.default_rng(seed).integers): each step's
    loss within 1e-5 relative, and every parameter within 1e-5 relative
    (of itself and of its tensor's largest entry) plus Adam's
    amplification of gradient rounding: an entry moves by about lr a step
    whatever its gradient g, so a rounding error d in g changes its step
    by about lr d / |g|. The first gradients agree within 2.7e-7 of the
    largest (measured); each entry is allowed lr * steps * min(2, 1e-6 *
    top / |g|), which holds entries at rounding level to 2 * lr * steps
    (the Adam-near-zero rule of ROADMAP Queue 3)."""
    from unitspeech_tpu_torch.examples import gslm

    jgslm = jexamples[1]
    streams = [np.tile([0, 1, 2], 30), np.tile([3, 4, 5, 4], 20)]
    lr, steps, seq_len, batch = 3e-3, 3, 12, 4
    jlm, params, sd = _ulm_pair(jgslm)
    tx = optax.adam(lr)

    @jax.jit
    def step(params, opt, toks):
        inp = jnp.concatenate([jnp.full((toks.shape[0], 1), 6, jnp.int32), toks[:, :-1]], axis=1)

        def loss_fn(p):
            logp = jax.nn.log_softmax(jlm.apply(p, inp))
            return -jnp.take_along_axis(logp, toks[..., None], axis=-1)[..., 0].mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, grads

    flat = np.concatenate(streams).astype(np.int32)
    rng = np.random.default_rng(0)
    opt, jlosses, grads = tx.init(params), [], None
    for _ in range(steps):
        starts = rng.integers(0, max(len(flat) - seq_len, 1), batch)
        params, opt, loss, g = step(params, opt, jnp.asarray(np.stack(
            [flat[s:s + seq_len] for s in starts])))
        jlosses.append(float(loss))
        grads = grads or params_from_jax(jax.device_get(g))
    losses = [gslm.train_ulm(streams, 6, steps=k, seq_len=seq_len, batch=batch, lr=lr,
                             d_model=16, params=sd)[1] for k in (1, 2)]
    tlm, loss = gslm.train_ulm(streams, 6, steps=steps, seq_len=seq_len, batch=batch, lr=lr,
                               d_model=16, params=sd)
    np.testing.assert_allclose(losses + [loss], jlosses, rtol=1e-5)
    top = max(float(g.abs().max()) for g in grads.values())
    want = params_from_jax(jax.device_get(params))
    for name, p in tlm.state_dict().items():
        got, w, g0 = p.numpy(), want[name].numpy(), np.abs(grads[name].numpy())
        amplified = lr * steps * np.minimum(2.0, 1e-6 * top / np.maximum(g0, 1e-30))
        tol = 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max() + amplified
        assert np.all(np.abs(got - w) <= tol), (name, np.abs(got - w).max())


def test_sample_continuation_at_the_temperature_floor_matches_jax(jexamples):
    """At temperature 1e-6 (floored to 1e-4) both sample the argmax chain:
    the same tokens from the same parameters."""
    from unitspeech_tpu_torch.examples import gslm

    jgslm = jexamples[1]
    jlm, init, sd = _ulm_pair(jgslm, seed=3)
    rng = np.random.default_rng(4)
    init = jax.tree_util.tree_map(lambda x: x + 0.5 * rng.standard_normal(x.shape)
                                  .astype(np.float32), init)
    tlm = gslm.UnitLM(6, d_model=16)
    tlm.load_state_dict(params_from_jax(init))
    want = jgslm.sample_continuation(jlm, init, [0, 1, 2, 0], 9, temperature=1e-6)
    got = gslm.sample_continuation(tlm.eval(), [0, 1, 2, 0], 9, temperature=1e-6)
    assert got.shape == (9,) and len(set(got.tolist())) > 1
    np.testing.assert_array_equal(got, want)


def test_gslm_main_on_the_cpu(tmp_path, capsys):
    from unitspeech_tpu_torch.examples import gslm

    loss, prompt, cont = gslm.main(["--device", "cpu", "--train-steps", "3", "--output",
                                    str(tmp_path / "g.wav")])
    assert np.isfinite(loss) and prompt.size > 0 and cont.size == 50
    assert cont.min() >= 0 and cont.max() < 8 and os.path.getsize(tmp_path / "g.wav") > 44
    assert "ULM trained: final next-unit CE" in capsys.readouterr().out
