"""The port's configuration against the JAX package's, and the port's
independence from the JAX package: the port (and chip_smoke.py, which
drives it on the card) reads its own config module and imports nothing of
`jax` or `unitspeech_tpu`."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from tests.test_torch_port_tts import TINY
from unitspeech_tpu import config as jcfg
from unitspeech_tpu_torch import config as tcfg

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
    a strided sampler spec), its four kernel tools and the sampler gate (on
    the CPU at small sizes) run with every import of jax, flax or
    unitspeech_tpu refused."""
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the IPA symbol table
    cfg["spk_embedder"] = {"feat_type": "wavlm_test", "channels": 16, "spk_emb_dim": 8}
    cfg["unit_extractor"] = {"dense_model_name": "hubert-test", "vocab_size": 40}
    cfg["contentvec_encoder"] = {"n_contentvec": 16, "n_feats": 16, "n_channels": 16,
                                 "filter_channels": 32, "n_layers": 1, "n_heads": 2}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "tiny.json"),
         str(tmp_path / "ckpt.pt"), str(tmp_path / "o.wav")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout
