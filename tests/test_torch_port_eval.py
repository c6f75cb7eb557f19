"""Evaluation in the port against the JAX package on the CPU: every
function of eval/harness.py on the same arrays (the integers and RTFs
equal, the float64 metrics within 1e-12), unit_error_rate on 200+ pairs,
SpeechEncoder.maybe_resample, `cli evaluate` against JAX's
`main_evaluate` on one samples directory (stub hooks from
tests/_eval_hooks.py, a tiny random mHuBERT + k-means from
tools/ssl_reference), eval/generate_samples in both modes against the
root evaluation/generate_samples.py on the same reference-format
checkpoints, and the UER study's curve against the root
tools/uer_synth_study.py on the same seed and HuBERT weights.

The JAX PRNG streams cannot be reproduced in torch, so generated samples
differ in their noise; their files, keys and lengths (the durations are
deterministic) must not."""

import csv
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests._eval_hooks import embed, predict_mos, transcribe
from tests.test_torch_port_convert import (
    _torch_sd,
    ref_bigvgan,
    ref_decoder,
    ref_duration_predictor,
    ref_encoder,
)
from tests.test_torch_port_finetune import TINY_FT
from unitspeech_tpu import config as jcfg
from unitspeech_tpu.eval import harness as jh
from unitspeech_tpu.models.ssl.kmeans import KMeansQuantizer as JKMeans
from unitspeech_tpu.models.ssl.speech_encoder import SpeechEncoder as JSpeechEncoder
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.eval import harness as th
from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer as TKMeans
from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder as TSpeechEncoder
from unitspeech_tpu_torch.utils.audio import load_wav, write_wav

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name, rel):
    """A root script of the JAX side (evaluation/, tools/) as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the harness's functions -----------------------------------------------


def test_timings_and_rtf_summary_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    proc, speech = rng.uniform(0.1, 2.0, 7), rng.uniform(0.5, 5.0, 7)
    got, want = th.EvalTimings(proc, speech), jh.EvalTimings(proc, speech)
    assert (got.rtf, got.rtf_mean_of_ratios) == (want.rtf, want.rtf_mean_of_ratios)
    assert th.rtf_summary(got) == jh.rtf_summary(want)
    got.save(str(tmp_path / "t.npz"))
    back = jh.EvalTimings.load(str(tmp_path / "t.npz"))
    assert np.array_equal(back.processing_time, proc) and np.array_equal(
        back.speech_duration, speech)
    assert th.rtf_summary(th.EvalTimings.load(str(tmp_path / "t.npz"))) == jh.rtf_summary(want)


def test_mel_metrics_and_cosine_match_jax():
    rng = np.random.default_rng(1)
    for ta, tb, f in ((40, 40, 80), (37, 52, 16), (5, 3, 20)):
        a, b = rng.standard_normal((ta, f)), rng.standard_normal((tb, f))
        assert abs(th.mel_l1(a, b) - jh.mel_l1(a, b)) <= 1e-12
        for k in (13, 8):
            got, want = th.mel_cepstral_distortion(a, b, k), jh.mel_cepstral_distortion(a, b, k)
            assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
        ea, eb = rng.standard_normal((1, f)), rng.standard_normal(f)
        assert abs(th.speaker_cosine_similarity(ea, eb)
                   - jh.speaker_cosine_similarity(ea, eb)) <= 1e-12


def test_wer_cer_match_jax():
    rng = np.random.default_rng(2)
    words = ["a", "b", "cat", "dog", "hello", "world"]
    cases = [("", ""), ("", "a b"), ("a b", ""), ("hello world", "hello world"),
             ("hello world", "hello word")]
    for _ in range(60):
        cases.append((" ".join(rng.choice(words, rng.integers(0, 9))),
                      " ".join(rng.choice(words, rng.integers(0, 9)))))
    for r, h in cases:
        assert th.wer(r, h) == jh.wer(r, h), (r, h)
        assert th.cer(r, h) == jh.cer(r, h), (r, h)


def _uer_cases():
    """(ref, hyp) pairs: random, empty on either side or both, equal, and
    pairs that differ only in run lengths (equal after dedup)."""
    rng = np.random.default_rng(3)
    cases = [([], []), ([], [1, 2]), ([3, 3], []), ([1, 2, 3], [1, 2, 3]),
             ([1, 1, 1, 2, 3], [1, 2, 2, 3, 3, 3]), ([5], [5, 5, 5, 5])]
    for _ in range(200):
        vocab = int(rng.integers(1, 8))
        cases.append((rng.integers(0, vocab, rng.integers(0, 40)),
                      rng.integers(0, vocab, rng.integers(0, 40))))
    for _ in range(20):
        base = rng.integers(0, 6, rng.integers(1, 12))
        cases.append((np.repeat(base, rng.integers(1, 4, base.size)),
                      np.repeat(base, rng.integers(1, 4, base.size))))
        cases.append((base, base.copy()))
    return cases


@pytest.mark.parametrize("dedup", [True, False])
def test_unit_error_rate_matches_jax(dedup):
    """The same float as JAX's row-by-row DP on every pair (226 pairs)."""
    cases = _uer_cases()
    assert len(cases) >= 200
    for ref, hyp in cases:
        got = th.unit_error_rate(ref, hyp, dedup=dedup)
        assert type(got) is float and got == jh.unit_error_rate(ref, hyp, dedup=dedup), (ref, hyp)
    assert th.unit_error_rate([1, 1, 1, 2, 3], [1, 2, 2, 3, 3, 3]) == 0.0
    assert th.edit_distance(np.array([1, 2, 3]), np.array([], np.int64)) == 3


def test_transcriptions_mos_summary_and_csv_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    wavs = [(rng.standard_normal(n).astype(np.float32) * 0.1, 8000) for n in (400, 801, 1200)]
    pairs = [(w, sr, "Hello World") for w, sr in wavs]
    assert th.evaluate_transcriptions(pairs, transcribe) == jh.evaluate_transcriptions(
        pairs, transcribe)
    assert th.evaluate_mos(wavs, predict_mos) == jh.evaluate_mos(wavs, predict_mos)
    assert th.load_hook("tests._eval_hooks:embed") is jh.load_hook("tests._eval_hooks:embed")
    with pytest.raises(ValueError, match="module:function"):
        th.load_hook("tests._eval_hooks")

    def units(w, sr):
        return (np.asarray(w[: len(w) // 80 * 80]).reshape(-1, 80).mean(1) > 0).astype(int)

    kw = dict(timings=th.EvalTimings(np.array([0.5, 0.25, 1.0]), np.array([0.5, 0.75, 2.0])),
              transcription_pairs=pairs, transcribe=transcribe, mos_wavs=wavs,
              predict_mos=predict_mos,
              embedding_pairs=[(embed(*wavs[0]), embed(w, sr)) for w, sr in wavs],
              unit_pairs=[(w, sr, *wavs[0]) for w, sr in wavs], extract_units=units)
    got, want = th.evaluation_summary(**kw), jh.evaluation_summary(**kw)
    assert list(got) == list(want) and got == want
    assert th.evaluation_summary(timings=kw["timings"]) == jh.rtf_summary(kw["timings"])
    got["n_samples"] = want["n_samples"] = 3
    th.write_summary_csv(str(tmp_path / "a.csv"), got)
    jh.write_summary_csv(str(tmp_path / "b.csv"), want)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


class _Dense:
    """A stand-in dense model for both packages' SpeechEncoder: frame means
    of 320 samples (JAX calls it; the port reads .features on the CPU)."""

    hop = 320

    def __call__(self, wav):
        n = len(wav) // 320
        return np.asarray(wav[: n * 320], np.float32).reshape(n, 4, 80).mean(axis=2)

    def features(self, wav):
        return torch.from_numpy(self(wav))


def test_speech_encoder_resample_and_unit_roundtrip_match_jax():
    """maybe_resample (unchanged at 16 kHz, float64 resample_poly else),
    code_hop_size, expected_sample_rate, and the unit round trip through
    speech_encoder_unit_hook at 8, 16 and 22.05 kHz."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((8, 4)).astype(np.float32) * 0.5
    jenc = JSpeechEncoder(_Dense(), JKMeans(centers), deduplicate=True)
    tenc = TSpeechEncoder(_Dense(), TKMeans(centers), deduplicate=True)
    assert (tenc.code_hop_size, tenc.expected_sample_rate) == (320, 16000) == (
        jenc.code_hop_size, jenc.expected_sample_rate)
    wav = rng.standard_normal(4410).astype(np.float32)
    assert tenc.maybe_resample(wav, 16000) is wav
    for sr in (22050, 8000):
        got, want = tenc.maybe_resample(wav, sr), jenc.maybe_resample(wav, sr)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)

    gt = (np.sin(np.arange(16000) * 0.01) * rng.standard_normal(16000)).astype(np.float32)
    pairs = [(gt, 16000, gt, 16000)]
    for noise, sr in ((0.05, 16000), (0.5, 8000), (5.0, 22050)):
        deg = (gt + noise * rng.standard_normal(16000)).astype(np.float32)
        pairs.append((deg[:: 2] if sr == 8000 else deg, sr, gt, 16000))
    got = th.evaluate_unit_roundtrip(pairs, th.speech_encoder_unit_hook(tenc))
    want = jh.evaluate_unit_roundtrip(pairs, jh.speech_encoder_unit_hook(jenc))
    assert got == want and got["uer_max"] > 0
    assert th.evaluate_unit_roundtrip(pairs[:1], th.speech_encoder_unit_hook(tenc))[
        "uer_mean"] == 0.0


class _StubSynth:
    """A synthesizer stand-in: the waveform's length follows the tokens; it
    records each call's generator seed (port) or key (JAX)."""

    def __init__(self, torch_side):
        self.seeds = []
        if torch_side:
            self.models = type("M", (), {"device": torch.device("cpu")})()
        self.torch_side = torch_side

    def __call__(self, ids, gen, diffusion_steps=None, **kw):
        self.seeds.append(gen.initial_seed() if self.torch_side else np.asarray(gen))
        wav = np.linspace(-0.5, 0.5, 100 * len(ids), dtype=np.float32)
        return (wav, 8000, None) if self.torch_side else (wav, 8000)


def test_generate_eval_samples_files_and_seeds(tmp_path):
    """The same files and speech durations as JAX's generate_eval_samples;
    the warm-up request draws from the seed, sample i from
    cli.chunk_seed(seed, i)."""
    seqs = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    port, jax_side = _StubSynth(True), _StubSynth(False)
    got = th.generate_eval_samples(port, seqs, str(tmp_path / "p"), 7, diffusion_steps=2)
    want = jh.generate_eval_samples(jax_side, seqs, str(tmp_path / "j"), jax.random.PRNGKey(7),
                                    diffusion_steps=2)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == [
        "sample_0000.wav", "sample_0001.wav", "sample_0002.wav", "timings.npz"]
    assert np.array_equal(got.speech_duration, want.speech_duration)
    assert got.processing_time.shape == (3,) and np.all(got.processing_time > 0)
    assert port.seeds == [7] + [cli.chunk_seed(7, i) for i in range(3)]
    for i in range(3):
        a, b = (load_wav(str(tmp_path / d / f"sample_{i:04d}.wav")) for d in ("p", "j"))
        assert a[1] == b[1] and np.array_equal(a[0], b[0])


# --- cli evaluate ----------------------------------------------------------

# the unit extractor at test widths: the test HuBERT read at layer 2, 40
# centroids; the speaker embedder small (tools/ssl_reference writes one)
EVAL_SSL = dict(unit_extractor=dict(dense_model_name="hubert-test", vocab_size=40,
                                    hubert_layer=2),
                spk_embedder=dict(feat_type="wavlm_test", channels=16, spk_emb_dim=8))


def test_cli_evaluate_matches_jax(tmp_path, capsys, monkeypatch):
    """`cli evaluate` with every section (timings, the ASR / MOS / speaker
    hooks, --hubert / --kmeans with --filelist's ground truth) against
    JAX's main_evaluate on one samples directory: the same keys in the
    same order and the same values, the unit streams of both extractors
    equal on every wav, and the same CSV. Sample 0 is its own ground truth
    (UER 0). The port reads tools/ssl_reference's fairseq-format HuBERT;
    JAX, whose .pt reader assumes mHuBERT-base's seven conv layers, an
    orbax copy of the same weights."""
    from unitspeech_tpu.cli import main as jmain
    from unitspeech_tpu.utils.checkpoint import save_checkpoint
    from unitspeech_tpu_torch.config import load_json
    from unitspeech_tpu_torch.models.ssl.hubert import hubert_test_config
    from unitspeech_tpu_torch.tools.ssl_reference import random_ssl_reference
    from unitspeech_tpu_torch.utils.artifacts import load_hubert_params
    from unitspeech_tpu_torch.utils.params import params_to_jax

    (tmp_path / "cfg.json").write_text(json.dumps(EVAL_SSL))
    ssl = random_ssl_reference(str(tmp_path), load_json(str(tmp_path / "cfg.json")), seed=6)
    jhubert = save_checkpoint(str(tmp_path / "jhubert"), 0, params_to_jax(
        load_hubert_params(ssl["hubert"], hubert_test_config())))
    rng = np.random.default_rng(7)
    d, refs = tmp_path / "samples", tmp_path / "refs"
    d.mkdir()
    refs.mkdir()
    lines = []
    t = np.arange(11025) / 22050
    for i in range(3):
        gt = (0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t)
              + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        syn = gt if i == 0 else (gt + 0.2 * i * rng.standard_normal(t.size)).astype(np.float32)
        write_wav(str(d / f"sample_{i:04d}.wav"), syn, 22050)
        write_wav(str(refs / f"gt_{i}.wav"), gt, 22050)
        lines.append(f"{refs / f'gt_{i}.wav'}|hello world|0")
    th.EvalTimings(np.array([0.5, 0.25, 0.7]), np.array([0.5, 0.5, 0.5])).save(
        str(d / "timings.npz"))
    (tmp_path / "eval.txt").write_text("\n".join(lines) + "\n")
    args = ["--samples-dir", str(d), "--filelist", str(tmp_path / "eval.txt"),
            "--reference-wav", str(refs / "gt_1.wav"), "--asr-hook",
            "tests._eval_hooks:transcribe", "--mos-hook", "tests._eval_hooks:predict_mos",
            "--spk-hook", "tests._eval_hooks:embed", "--kmeans", ssl["kmeans"]]

    got = cli.main_evaluate(args + ["--hubert", ssl["hubert"], "--out", str(tmp_path / "port.csv"),
                                    "--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == got
    jtiny = jcfg.MainConfig(unit_extractor=jcfg.UnitExtractorConfig(**EVAL_SSL["unit_extractor"]))
    monkeypatch.setattr(jcfg, "MainConfig", lambda: jtiny)
    assert jmain(["evaluate", *args, "--hubert", jhubert, "--out",
                  str(tmp_path / "jax.csv")]) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[0])
    assert list(got) == list(want) and got == want
    assert {"rtf", "wer", "cer", "mos_mean", "uer_mean", "uer_median", "uer_max",
            "spk_cosine_mean", "n_samples"} <= set(got)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()

    # the unit streams behind uer_*: equal, and sample 0 against itself is 0
    from unitspeech_tpu.cli import build_unit_extractor as jbuild

    jenc = jh.speech_encoder_unit_hook(jbuild(jhubert, ssl["kmeans"], jtiny))
    tenc = th.speech_encoder_unit_hook(cli.build_unit_extractor(
        ssl["hubert"], ssl["kmeans"], load_json(str(tmp_path / "cfg.json")), torch.device("cpu")))
    for p in sorted(d.glob("*.wav")) + sorted(refs.glob("*.wav")):
        w, sr = load_wav(str(p))
        a, b = tenc(w, sr), jenc(w, sr)
        assert a.size > 5 and np.array_equal(a, np.asarray(b)), p
    first = load_wav(str(d / "sample_0000.wav"))
    assert th.unit_error_rate(tenc(*first), tenc(*first)) == 0.0
    with open(tmp_path / "port.csv") as f:
        assert next(csv.reader(f)) == list(got)


def test_cli_evaluate_refuses_cuda_without_a_card_and_an_empty_dir(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main_evaluate(["--samples-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no sample_"):
        cli.main_evaluate(["--samples-dir", str(tmp_path), "--device", "cpu"])


# --- eval/generate_samples -------------------------------------------------


SENTENCES = ("həloʊ wɜːld", "ɡʊd deɪ tə juː")


@pytest.fixture(scope="module")
def sample_env(tmp_path_factory):
    """Reference-format checkpoints at TINY_FT's widths that both packages
    read (the four served modules and the unit encoder), two speakers'
    1.6 kHz reference wavs, their sidecar units and a speaker embedding."""
    tmp = tmp_path_factory.mktemp("gen_samples")
    (tmp / "tiny.json").write_text(json.dumps(TINY_FT))
    c = TINY_FT
    te, ue, dp, dec, voc = (c[k] for k in ("text_encoder", "unit_encoder", "duration_predictor",
                                           "decoder", "vocoder"))
    files = {
        "decoder": {"model": ref_decoder(21, dec["n_feats"], dec["dim"],
                                         tuple(dec["dim_mults"]), dec["groups"],
                                         dec["spk_emb_dim"]),
                    "mel_min": np.full((16, 1), -11.0, np.float32),
                    "mel_max": np.full((16, 1), 2.0, np.float32)},
        "text-encoder": {"model": ref_encoder(22, **{k: te[k] for k in (
            "n_vocab", "n_feats", "n_channels", "filter_channels", "n_layers", "n_heads")})},
        "unit-encoder": {"model": ref_encoder(23, **{k: ue[k] for k in (
            "n_vocab", "n_feats", "n_channels", "filter_channels", "n_layers", "n_heads")})},
        "duration-predictor": ref_duration_predictor(24, dp["in_channels"],
                                                     dp["filter_channels"], dp["spk_emb_dim"]),
        "vocoder": {"generator": ref_bigvgan(25, voc["num_mels"], voc["upsample_rates"],
                                             voc["upsample_kernel_sizes"],
                                             voc["upsample_initial_channel"],
                                             voc["resblock_kernel_sizes"],
                                             voc["resblock_dilation_sizes"])},
    }
    flags = {}
    for flag, obj in files.items():
        obj = {k: (_torch_sd(v) if isinstance(v, dict) else torch.from_numpy(v))
               for k, v in obj.items()}
        torch.save(obj, tmp / f"{flag}.pt")
        flags[flag] = str(tmp / f"{flag}.pt")
    rng = np.random.default_rng(26)
    n = int(1.5 * 1600)
    refs = []
    for spk in (0, 1):
        write_wav(str(tmp / f"ref{spk}.wav"), 0.3 * np.sin(np.arange(n) * (0.2 + 0.1 * spk))
                  + 0.05 * rng.standard_normal(n), 1600)
        refs.append(f"{tmp / f'ref{spk}.wav'}|reference {spk}|{spk}")
    (tmp / "refs.txt").write_text("\n".join(refs) + "\n")
    # the flat mode's sentences again, so that JAX compiles each length once
    (tmp / "sentences.txt").write_text("\n".join(SENTENCES) + "\n")
    (tmp / "eval.txt").write_text(f"{tmp}/e0.wav|{SENTENCES[0]}|0\n{tmp}/e1.wav|{SENTENCES[1]}|0\n"
                                  f"{tmp}/e2.wav|{SENTENCES[0]}|1\n")
    np.savez(tmp / "units.npz", units=rng.integers(0, 50, 37), durations=np.full(37, 2))
    np.save(tmp / "spk.npy", rng.standard_normal(8).astype(np.float32))
    return tmp, flags


def _durations_margin(flags, cfg_path, spk, sentence):
    """The smallest distance of the port's pre-ceil durations exp(logw) of
    `sentence` to an integer: how close a length came to a flip."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    args = type("A", (), dict(checkpoint=None, config=cfg_path, spk_emb=spk,
                              **{k.replace("-", "_"): v for k, v in flags.items()}))
    models = cli._load_tts_models(args, torch.device("cpu"), torch.float32,
                                  dict(use_kernels=False, use_int8_deep=False, use_deep=False,
                                       use_resample=False, use_i8pre_deep=False))
    synth = Synthesizer(models)
    ids = phonemes_to_sequence(sentence)
    tokens, lengths = synth._pack([ids])
    m = synth.models
    with torch.no_grad():
        mu_x, hidden, x_mask = m.text_encoder(torch.from_numpy(tokens), torch.from_numpy(lengths))
        w = torch.exp(m.duration_predictor(hidden, x_mask, synth._spk_rows(1)))[0, :len(ids)]
    return float((w - w.round()).abs().min())


@pytest.mark.parametrize("mode", ["flat", "per_speaker"])
def test_generate_samples_matches_jax(sample_env, tmp_path, mode):
    """eval/generate_samples against the root evaluation/generate_samples.py
    on the same reference-format files (--ipa, 2 DDPM steps, f32; the
    per-speaker mode fine-tunes 3 iterations from sidecar units and a
    speaker embedding): the same files outside the fine-tune directories,
    the same summary keys, every sample's length equal to JAX's (a length
    may differ only where a duration sits within 1e-4 of an integer)."""
    tmp, flags = sample_env
    common = ["--ipa", "--config", str(tmp / "tiny.json"), "--decoder", flags["decoder"],
              "--text-encoder", flags["text-encoder"], "--duration-predictor",
              flags["duration-predictor"], "--vocoder", flags["vocoder"], "--spk-emb",
              str(tmp / "spk.npy"), "--diffusion-steps", "2", "--fp32"]
    if mode == "flat":
        common += ["--sentences", str(tmp / "sentences.txt")]
        texts = {"": SENTENCES}
    else:
        common += ["--reference-filelist", str(tmp / "refs.txt"), "--eval-filelist",
                   str(tmp / "eval.txt"), "--unit-encoder", flags["unit-encoder"], "--units",
                   str(tmp / "units.npz"), "--finetune-iters", "3"]
        texts = {"speaker_0": SENTENCES, "speaker_1": SENTENCES[:1]}
    from unitspeech_tpu_torch.eval import generate_samples

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    got = generate_samples.main(common + ["--out-dir", str(port_dir), "--device", "cpu"])
    jgen = _script("generate_samples_jax", "evaluation/generate_samples.py")
    assert jgen.main(common + ["--out-dir", str(jax_dir), "--cpu"]) == 0
    want = json.loads((jax_dir / "summary.json").read_text())
    assert json.loads((port_dir / "summary.json").read_text()) == got
    assert list(got) == list(want)
    if mode == "per_speaker":
        assert list(got["per_speaker"]) == list(want["per_speaker"]) == ["0", "1"]
        assert all(list(got["per_speaker"][s]) == list(want["per_speaker"][s]) for s in "01")
        for name in ("processing_time.npy", "speech_duration.npy"):
            assert np.load(port_dir / name).shape == np.load(jax_dir / name).shape == (3,)
        assert np.array_equal(np.load(port_dir / "speech_duration.npy"),
                              np.load(jax_dir / "speech_duration.npy"))
        assert os.path.isfile(port_dir / "finetune_0" / "decoder.pt")
        assert os.path.isdir(jax_dir / "finetune_0")

    def listing(root):
        return sorted(os.path.relpath(os.path.join(p, f), root) for p, _, fs in os.walk(root)
                      for f in fs if not os.path.relpath(p, root).startswith("finetune_"))

    assert listing(port_dir) == listing(jax_dir)
    hop = TINY_FT["data"]["hop_length"]
    for sub, sentences in texts.items():
        for i, sentence in enumerate(sentences):
            a, sr = load_wav(str(port_dir / sub / f"sample_{i:04d}.wav"))
            b, jsr = load_wav(str(jax_dir / sub / f"sample_{i:04d}.wav"))
            assert sr == jsr == 1600 and a.size % hop == 0 and a.size > 0
            if a.size != b.size:  # only at a duration within 1e-4 of an integer
                margin = _durations_margin(flags, str(tmp / "tiny.json"),
                                           str(tmp / "spk.npy"), sentence)
                assert margin < 1e-4, (sentence, a.size, b.size, margin)
    assert got["n"] == want["n"] == sum(len(v) for v in texts.values())


# --- the UER study ---------------------------------------------------------


def test_uer_synth_study_matches_jax(tmp_path):
    """The port's study and the root tools/uer_synth_study.py on the same
    seed (corpus, k-means start, degradations) and the same HuBERT weights
    (JAX's flax init, carried across): the same curve, monotone."""
    from unitspeech_tpu.models.ssl.hubert import HubertModel, hubert_test_config
    from unitspeech_tpu_torch.tools import uer_synth_study
    from unitspeech_tpu_torch.utils.params import params_from_jax

    kw = dict(n_utts=2, seconds=0.75, k=24, seed=0)
    want = _script("uer_synth_study_jax", "tools/uer_synth_study.py").main(
        str(tmp_path / "jax.json"), **kw)
    params = jax.jit(HubertModel(hubert_test_config()).init)(jax.random.PRNGKey(1),
                                                             np.zeros((1, 3200), np.float32))
    got = uer_synth_study.study(str(tmp_path / "port.json"), device="cpu",
                                hubert={"hubert": params_from_jax(jax.device_get(params))}, **kw)
    assert got["uer_by_condition"] == want["uer_by_condition"], (got, want)
    assert got["monotone"] == want["monotone"]
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["uer_by_condition"]["identical"] == 0.0
    random_weights = uer_synth_study.main(["--n-utts", "2", "--seconds", "0.5", "--k", "8",
                                           "--device", "cpu"])
    assert random_weights["uer_by_condition"]["identical"] == 0.0
