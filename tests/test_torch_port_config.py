"""The port's configuration against the JAX package's, and the port's
independence from the JAX package: the port (and chip_smoke.py, which
drives it on the card) reads its own config module and imports nothing of
`jax` or `unitspeech_tpu`."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_tts import TINY
from unitspeech_tpu import config as jcfg
from unitspeech_tpu_torch import config as tcfg

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = [f.name for f in dataclasses.fields(tcfg.MainConfig)]


@pytest.mark.parametrize("section", SECTIONS)
def test_section_matches_jax(section):
    """Every section the port keeps has the JAX section's fields, defaults
    and types, in the same order."""
    want = getattr(jcfg.MainConfig(), section)
    got = getattr(tcfg.MainConfig(), section)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]


def test_checkpoint_dict_and_json_overlay_read_as_jax():
    """A JAX config's dict (as a checkpoint stores it) and a JSON overlay
    give the port the values the JAX package reads; sections the port does
    not keep are ignored."""
    cfg = jcfg.MainConfig(
        decoder=jcfg.DecoderConfig(dim=8, dim_mults=(1, 2), groups=4),
        vocoder=jcfg.VocoderConfig(resblock="2", resblock_dilation_sizes=((1, 3),)),
        train=jcfg.TrainConfig(batch_size=3))
    got = tcfg.config_from_dict(json.loads(json.dumps(dataclasses.asdict(cfg))))
    for section in SECTIONS:
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(cfg, section))
    assert got.decoder.num_downsamplings == cfg.decoder.num_downsamplings == 1
    assert isinstance(got.vocoder.resblock_dilation_sizes[0], tuple)


def test_json_overlay_matches_jax(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    want, got = jcfg.load_json(str(path)), tcfg.load_json(str(path))
    for section in SECTIONS:
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section))


BLOCKED_RUN = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import chip_smoke  # noqa: F401
from unitspeech_tpu_torch import cli, measure  # noqa: F401
from unitspeech_tpu_torch.ops import aa_snake, conv_matmul, fused_attention, fused_resnet
from unitspeech_tpu_torch.ops import fastmath, fused_resnet_deep, probes, resample  # noqa: F401
from unitspeech_tpu_torch.ops import mel, row_stats, schedule, units  # noqa: F401
from unitspeech_tpu_torch.train import finetune, steps  # noqa: F401
from unitspeech_tpu_torch.utils import artifacts, audio, convert_cli, torch_convert  # noqa: F401
from unitspeech_tpu_torch.tools import bench_resnet_kernel, bench_transcendental
from unitspeech_tpu_torch.tools import bisect_deep_compile, probe_stride, ssl_reference
from unitspeech_tpu_torch.text import g2p, g2p_ro  # noqa: F401
from unitspeech_tpu_torch.models import speaker  # noqa: F401
from unitspeech_tpu_torch.models.ssl import feature_extractor, hubert, kmeans  # noqa: F401
from unitspeech_tpu_torch.models.ssl import speech_encoder, transformer, wavlm  # noqa: F401
from unitspeech_tpu_torch.utils import precision, torch_convert_ssl  # noqa: F401
from unitspeech_tpu_torch.ops import mas  # noqa: F401
from unitspeech_tpu_torch.data import dataset  # noqa: F401
from unitspeech_tpu_torch.preprocess import stats  # noqa: F401
from unitspeech_tpu_torch.train import loop  # noqa: F401
from unitspeech_tpu_torch.utils import checkpoint, logging  # noqa: F401
from unitspeech_tpu_torch.tools import step_check, synthetic_corpus  # noqa: F401
# the operator tools: the serving load tools, STEP1 and SSL timers, the host tools
from unitspeech_tpu_torch.tools import analyze_buckets, bench_server, bench_serving  # noqa: F401
from unitspeech_tpu_torch.tools import bench_ssl, bench_train, bucket_policy_ab  # noqa: F401
from unitspeech_tpu_torch.tools import capacity_plan, refresh_under_load, sv56  # noqa: F401
from unitspeech_tpu_torch.tools import validate_dataloader  # noqa: F401
# the multi-device paths: the launcher, the mesh and its collectives, the transcriber
from unitspeech_tpu_torch.parallel import launch, mesh  # noqa: F401
from unitspeech_tpu_torch.tools import distributed_transcribe  # noqa: F401

cfg, ckpt, out = sys.argv[1:4]
cli.main_make_random_checkpoint(["--seed", "1", "--config", cfg, "--output", ckpt])
stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                            "--output", out, "--device", "cpu", "--diffusion-steps", "1"])
assert stats["kernels"] and stats["int8"], stats
# graphemes through the rule G2P (or espeak), in two sentence chunks
stats = cli.main_inference(["--text", "Hello there, 42 cats. Bye!", "--split-sentences",
                            "--checkpoint", ckpt, "--output", out, "--device", "cpu",
                            "--diffusion-steps", "1"])
assert stats["chunks"] == 2, stats
# the SSL checkpoints in the reference's formats, converted (test widths)
from unitspeech_tpu_torch.config import load_json
import os
ssl = ssl_reference.random_ssl_reference(os.path.dirname(ckpt), load_json(cfg), seed=3)
for kind in ("speaker-embedder", "hubert"):
    assert cli.main(["convert", kind, ssl[kind], ckpt + kind, "--config", cfg]) == 0
# voice conversion from a contentvec HuBERT in HF names (test widths), the
# encoder converted, with a strided sampler spec; the sampler gate, tiny
from unitspeech_tpu_torch.infer import vc  # noqa: F401
from unitspeech_tpu_torch.models.ssl import contentvec  # noqa: F401
from unitspeech_tpu_torch.tools import sampler_gate, vc_reference
import torch
vcf = vc_reference.random_vc_reference(os.path.dirname(ckpt), load_json(cfg), seed=4)
assert cli.main(["convert", "contentvec-encoder", vcf["contentvec-encoder"], ckpt + "ce",
                 "--config", cfg]) == 0
src = vc_reference.random_source(ckpt + ".src.wav", load_json(cfg), 0.02, seed=5)
stats = cli.main_voice_conversion(["--source", src, "--decoder", ckpt, "--content-encoder",
                                   ckpt + "ce", "--contentvec", vcf["contentvec"], "--vocoder",
                                   ckpt, "--output", out, "--device", "cpu", "--diffusion-steps",
                                   "2", "--sampler", "dpm2:cs2"])
assert stats["kernels"] and stats["sampler"] == "dpm2:cs2", stats
rep = sampler_gate.gate(load_json(cfg), [0], [0], torch.device("cpu"), frames=16, n_tok=4,
                        disc_steps=(2,), ref_steps=4, stride_configs=(("ddpm", 2),),
                        strides=(2,))
assert set(rep["max_frac"]) == {"bf16_band_frac", "disc_frac_@2", "bf16_ddpm@2_cs2",
                                "int8_ddpm@2_cs2"}, rep
stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                            "--output", out, "--device", "cpu", "--diffusion-steps", "1",
                            "--deep", "--i8pre", "--resample"])
assert stats["deep"] and stats["i8pre"] and stats["resample"], stats
# the four tools, on the CPU at small sizes (their plain versions)
bench_transcendental.main(["--device", "cpu", "--rows", "8", "--k", "4", "--k0", "2",
                           "--reps", "1"])
assert all(r["correct"] for r in probe_stride.main(["--device", "cpu", "--reps", "1"]).values())
assert len(bisect_deep_compile.main(["--device", "cpu", "--reps", "1", "t8_f10_c1024"])) == 1
res = bench_resnet_kernel.main(["--device", "cpu", "--frames", "8", "--reps", "1", "--int8",
                                "--deep", "--stages", "0,2"])
assert [r["kernel"] for r in res["stages"]] == ["K10a", "K10b"], res
# STEP1 from wavs: the two preprocessors, one epoch of train-step1, its
# checkpoint served with a voice and the random checkpoint's vocoder
d = os.path.dirname(ckpt)
corp = synthetic_corpus(os.path.join(d, "corpus"), load_json(cfg), ["həloʊ.", "ðə dɑɡ."] * 2,
                        n_speakers=2, seconds=(0.03, 0.05), seed=6)
ms, un = os.path.join(d, "ms.npz"), os.path.join(d, "un.npz")
assert cli.main(["preprocess-mel-stats", "--filelist", corp["filelist"], "--out", ms,
                 "--config", cfg, "--device", "cpu"]) == 0
assert cli.main(["preprocess-uncond", "--filelist", corp["filelist"], "--mel-stats", ms,
                 "--spk-embs", corp["spk_embs"], "--out", un, "--config", cfg,
                 "--device", "cpu"]) == 0
res = cli.main_train_step1(["--filelist", corp["filelist"], "--spk-embs", corp["spk_embs"],
                            "--mel-stats", ms, "--uncond-stats", un, "--config", cfg,
                            "--device", "cpu", "--n-epochs", "1", "--batch-size", "2",
                            "--checkpoint-dir", os.path.join(d, "ck"),
                            "--log-dir", os.path.join(d, "log")])
assert res["steps"] == 2 and res["checkpoint"].endswith("step_1"), res
import numpy as np
np.save(os.path.join(d, "spk.npy"), np.load(corp["spk_embs"])["0"])
# the two host tools on the card's cost model
np.savetxt(os.path.join(d, "frames.txt"), np.random.default_rng(0).uniform(100, 700, 50))
assert analyze_buckets.main(["--lengths", os.path.join(d, "frames.txt"), "--json"])["best"]
assert capacity_plan.main(["--lengths", os.path.join(d, "frames.txt"), "--chips", "2",
                           "--json"])["sustainable_qps"] > 0
stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", res["checkpoint"],
                            "--vocoder", ckpt, "--spk-emb", os.path.join(d, "spk.npy"),
                            "--output", out, "--device", "cpu", "--diffusion-steps", "1"])
assert stats["frames"] > 0, stats
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_port_and_chip_smoke_import_nothing_of_jax(tmp_path):
    """chip_smoke.py, the port's modules (the text frontend, the SSL
    frontends and voice conversion included), its CLI (make-random-
    checkpoint, then inference on the CPU with its defaults, with the fused
    deep-stage switches and from graphemes; convert of the SSL and
    contentvec-encoder checkpoints that tools/ssl_reference and
    tools/vc_reference write; voice-conversion from a contentvec HuBERT with
    a strided sampler spec; STEP1 training from wavs through the two
    preprocessors to a checkpoint that inference serves), its four kernel
    tools and the sampler gate (on the CPU at small sizes), the operator
    tools (imported; analyze_buckets and capacity_plan run), the parallel
    subpackage and the distributed transcriber (imported) run with every
    import of jax, flax or unitspeech_tpu refused."""
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the IPA symbol table
    cfg["spk_embedder"] = {"feat_type": "wavlm_test", "channels": 16, "spk_emb_dim": 8}
    cfg["unit_extractor"] = {"dense_model_name": "hubert-test", "vocab_size": 40}
    cfg["contentvec_encoder"] = {"n_contentvec": 16, "n_feats": 16, "n_channels": 16,
                                 "filter_channels": 32, "n_layers": 1, "n_heads": 2}
    cfg["train"] = {"save_every": 1}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "tiny.json"),
         str(tmp_path / "ckpt.pt"), str(tmp_path / "o.wav")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout


BLOCKED_TRAIN = r"""
import importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import load_json
from unitspeech_tpu_torch.models import discriminators  # noqa: F401
from unitspeech_tpu_torch.tools import ssl_reference, synthetic_corpus
from unitspeech_tpu_torch.train import vocoder_gan, vocoder_loop  # noqa: F401

cfg, d = sys.argv[1:3]
corp = synthetic_corpus(os.path.join(d, "corpus"), load_json(cfg),
                        ["həloʊ.", "ðə dɑɡ.", "ðə kwɪk.", "bɹaʊn fɑks."], n_speakers=2,
                        seconds=(0.6, 0.9), seed=6)
c = ["--config", cfg, "--device", "cpu"]
cli.main(["make-filelist", "--corpus", "generic", "--root", os.path.join(d, "corpus"),
          "--out-dir", os.path.join(d, "lists"), "--valid", "0", "--test", "0"])
fl = os.path.join(d, "lists", "train.txt")
assert len(open(fl).read().splitlines()) == 4
ms, spk = os.path.join(d, "ms.npz"), os.path.join(d, "spk.npz")
cli.main(["preprocess-mel-stats", "--filelist", fl, "--out", ms, *c])
ssl = ssl_reference.random_ssl_reference(d, load_json(cfg), seed=3)
assert len(cli.main_preprocess_spk_embs(["--filelist", fl, "--speaker-embedder",
                                         ssl["speaker-embedder"], "--out", spk, *c])) == 2
assert cli.main_preprocess_units(["--filelist", fl, "--hubert", ssl["hubert"], "--kmeans",
                                  ssl["kmeans"], *c]) == 4
rand = os.path.join(d, "rand.pt")
cli.main_make_random_checkpoint(["--config", cfg, "--output", rand])
res = cli.main_train_step2(["--filelist", fl, "--spk-embs", spk, "--mel-stats", ms,
                            "--decoder", rand, "--n-epochs", "1", "--batch-size", "2",
                            "--checkpoint-dir", os.path.join(d, "ck"), "--log-dir",
                            os.path.join(d, "log"), *c])
assert res["steps"] == 2, res
res = cli.main_train_vocoder(["--filelist", fl, "--steps", "1", "--batch-size", "1",
                              "--segment-size", "2048", *c])
assert res["steps"] == 1, res
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_training_commands_import_nothing_of_jax(tmp_path):
    """The port's five training-side commands (make-filelist,
    preprocess-spk-embs, preprocess-units, train-step2, train-vocoder) and
    their modules, on the CPU at the test widths (the SSL models in the
    reference's formats from tools/ssl_reference; train-vocoder one step of
    the full MPD and MRD), with every import of jax, flax or unitspeech_tpu
    refused; in a process of its own, on one thread."""
    cfg = json.loads(json.dumps(TINY))
    cfg["data"] = {"n_feats": 16, "n_fft": 64, "hop_length": 16, "win_length": 64,
                   "sampling_rate": 1600, "mel_fmax": 800.0}
    cfg["vocoder"].update(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                          sampling_rate=1600)
    cfg["unit_encoder"] = {"n_vocab": 40, "n_feats": 16, "n_channels": 16,
                           "filter_channels": 32, "n_layers": 1, "n_heads": 2}
    cfg["spk_embedder"] = {"sr": 3200, "feat_type": "wavlm_test", "channels": 16,
                           "spk_emb_dim": 8}
    cfg["unit_extractor"] = {"sr": 3200, "dense_model_name": "hubert-test", "vocab_size": 40,
                             "hubert_layer": 2}
    cfg["train"] = {"save_every": 1, "out_size_second": 1}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", BLOCKED_TRAIN, str(tmp_path / "tiny.json"),
                           str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout


BLOCKED_EVAL = r"""
import importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import load_json
from unitspeech_tpu_torch.eval import generate_samples
from unitspeech_tpu_torch.examples import demo, speaker_probing
from unitspeech_tpu_torch.tools import ssl_reference, uer_synth_study
from unitspeech_tpu_torch.utils.audio import write_wav

cfg, d = sys.argv[1:3]
ckpt = os.path.join(d, "ckpt.pt")
cli.main_make_random_checkpoint(["--seed", "2", "--config", cfg, "--output", ckpt])
rng = np.random.default_rng(0)
write_wav(os.path.join(d, "ref.wav"), 0.3 * np.sin(np.arange(1600) * 0.3), 1600)
np.savez(os.path.join(d, "units.npz"), units=rng.integers(0, 50, 25), durations=np.full(25, 2))
np.save(os.path.join(d, "spk.npy"), rng.standard_normal(8).astype(np.float32))
with open(os.path.join(d, "refs.txt"), "w") as f:
    f.write(os.path.join(d, "ref.wav") + "|ref|0\n")
with open(os.path.join(d, "eval.txt"), "w") as f:
    f.write(os.path.join(d, "ref.wav") + "|həloʊ|0\n")
with open(os.path.join(d, "s.txt"), "w") as f:
    f.write("həloʊ\n")
mods = ["--ipa", "--config", cfg, "--decoder", ckpt, "--text-encoder", ckpt,
        "--duration-predictor", ckpt, "--vocoder", ckpt, "--diffusion-steps", "1",
        "--device", "cpu"]
flat = generate_samples.main(mods + ["--sentences", os.path.join(d, "s.txt"), "--out-dir",
                                     os.path.join(d, "flat")])
per = generate_samples.main(mods + ["--reference-filelist", os.path.join(d, "refs.txt"),
                                    "--eval-filelist", os.path.join(d, "eval.txt"),
                                    "--unit-encoder", ckpt, "--units",
                                    os.path.join(d, "units.npz"), "--spk-emb",
                                    os.path.join(d, "spk.npy"), "--finetune-iters", "1",
                                    "--out-dir", os.path.join(d, "per")])
assert flat["n"] == 1 and list(per["per_speaker"]) == ["0"], (flat, per)
ssl = ssl_reference.random_ssl_reference(d, load_json(cfg), seed=3)
row = cli.main(["evaluate", "--samples-dir", os.path.join(d, "per", "speaker_0"), "--filelist",
                os.path.join(d, "eval.txt"), "--hubert", ssl["hubert"], "--kmeans",
                ssl["kmeans"], "--config", cfg, "--device", "cpu"])
assert row == 0 and os.path.exists(os.path.join(d, "per", "speaker_0", "summary.csv"))
uer_synth_study.main(["--n-utts", "2", "--seconds", "0.5", "--k", "8", "--device", "cpu"])
demo.main(["--device", "cpu", "--output", os.path.join(d, "demo.wav")])
speaker_probing.main(["--device", "cpu", "--steps", "2", "--n-per-speaker", "2"])
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_evaluation_commands_import_nothing_of_jax(tmp_path):
    """The evaluation slice's entry points with every import of jax, flax or
    unitspeech_tpu refused, on the CPU at test widths in a process of its
    own on one thread: eval.generate_samples flat and per-speaker (one
    fine-tune iteration, sidecar units), `cli evaluate --hubert --kmeans`
    (tools/ssl_reference's files), the UER study, the demo and the speaker
    probe."""
    from tests.test_torch_port_finetune import TINY_FT

    cfg = dict(TINY_FT, unit_extractor={"dense_model_name": "hubert-test", "vocab_size": 40,
                                        "hubert_layer": 2},
               spk_embedder={"sr": 1600, "feat_type": "wavlm_test", "channels": 16,
                             "spk_emb_dim": 8})
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", BLOCKED_EVAL, str(tmp_path / "tiny.json"),
                           str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout



def _unit_lm_tree():
    """The root GSLM example's UnitLM parameters from flax's init."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location("gslm_example_config",
                                                  os.path.join(ROOT, "examples", "gslm.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # flax's dataclasses look their module up
    spec.loader.exec_module(mod)
    lm = mod.UnitLM(vocab_size=6, d_model=16)
    return jax.device_get(jax.jit(lm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def _extras_tree(name):
    from unitspeech_tpu.models import tacotron2, waveglow
    from unitspeech_tpu.models.ssl import cpc
    from unitspeech_tpu_torch.tools import extras_reference

    if name == "tacotron2":
        return tacotron2.random_tacotron2_params(tacotron2.tacotron2_test_config(obs_dim=2), 1)
    if name == "waveglow":
        return waveglow.random_waveglow_params(waveglow.waveglow_test_config(), 2)
    if name == "cpc":
        sd = extras_reference.random_cpc_state_dict(cpc.cpc_test_config(), 3)
        return cpc.convert_cpc({k: v.numpy() for k, v in sd.items()}, cpc.cpc_test_config())
    return _unit_lm_tree()


@pytest.mark.parametrize("name", ["tacotron2", "waveglow", "cpc", "unit_lm"])
def test_extras_parameter_round_trip_is_exact(name):
    """params_to_jax(params_from_jax(tree)) gives the JAX tree back bit for
    bit (structure, dtypes, values) for the extras' trees: Tacotron2 and
    WaveGlow (plain dicts, which come back under "params"), CPC and the
    GSLM unit LM (flax variable trees)."""
    import jax

    from unitspeech_tpu_torch.utils.params import params_from_jax, params_to_jax

    tree = _extras_tree(name)
    back = params_to_jax(params_from_jax(tree))
    if "params" not in tree:
        assert set(back) == {"params"}
        back = back["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


BLOCKED_EXTRAS = r"""
import importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "unitspeech_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import MainConfig
from unitspeech_tpu_torch.data import quantize
from unitspeech_tpu_torch.examples import flax_layers, gslm, resynthesis  # noqa: F401
from unitspeech_tpu_torch.infer import unit_vocoder
from unitspeech_tpu_torch.models import tacotron2, waveglow
from unitspeech_tpu_torch.models.ssl import cpc
from unitspeech_tpu_torch.ops import f0
from unitspeech_tpu_torch.tools import extras_reference
from unitspeech_tpu_torch.utils.audio import write_wav

d = sys.argv[1]
resynthesis.main(["--device", "cpu", "--output", os.path.join(d, "r.wav")])
gslm.main(["--device", "cpu", "--train-steps", "2", "--output", os.path.join(d, "g.wav")])
paths = extras_reference.write_extras(
    d, tacotron2.tacotron2_test_config(n_symbols=14, gate_threshold=1.1),
    waveglow.waveglow_test_config(n_mel_channels=8, n_flows=3, n_channels=8,
                                  upsample_kernel=1024, upsample_stride=256),
    cpc.cpc_test_config(), n_codes=10)
np.savez(os.path.join(d, "k.npz"), centroids=np.random.default_rng(0).standard_normal(
    (10, 6)).astype(np.float32) * 0.1)
cfg = MainConfig()
cfg = dataclasses.replace(cfg, unit_extractor=dataclasses.replace(
    cfg.unit_extractor, dense_model_name="cpc-big-ll6k", hubert_layer=2))
enc = cli.build_unit_extractor(paths["cpc"], os.path.join(d, "k.npz"), cfg, torch.device("cpu"))
t = np.arange(8000) / 16000.0
for i in range(2):
    write_wav(os.path.join(d, f"u{i}.wav"), 0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t), 16000)
with open(os.path.join(d, "list.txt"), "w") as f:
    f.write("".join(f"{os.path.join(d, f'u{i}.wav')}|x|s{i}\n" for i in range(2)))
ds = quantize.QuantizedFilelist(enc, os.path.join(d, "list.txt"))
batch = ds.collater([ds[0], ds[1]])
assert batch["units"].shape[0] == 2 and "f0" not in batch
assert f0.extract_f0(np.sin(np.arange(4000) * 0.06).astype(np.float32)).shape == (38,)
voc = unit_vocoder.TacotronVocoder.from_torch(paths["tacotron"], paths["code_dict"],
                                              paths["waveglow"], max_decoder_steps=4,
                                              device="cpu")
assert voc(batch["units"][0][batch["units"][0] < 10]).shape == (4 * 256,)
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "flax", "optax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_extras_import_nothing_of_jax(tmp_path):
    """The textlesslib extras with every import of jax, flax, optax or
    unitspeech_tpu refused, on the CPU at test widths in a process of its
    own on one thread: the resynthesis and GSLM examples, the reference-
    format checkpoints of tools/extras_reference, the CLI's CPC unit
    extractor over a quantized filelist, the F0 tracker and the unit
    vocoder read from its files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", BLOCKED_EXTRAS, str(tmp_path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout
