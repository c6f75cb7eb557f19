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
from unitspeech_tpu_torch.ops import fused_resnet_deep, resample, row_stats  # noqa: F401

cfg, ckpt, out = sys.argv[1:4]
cli.main_make_random_checkpoint(["--seed", "1", "--config", cfg, "--output", ckpt])
stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                            "--output", out, "--device", "cpu", "--diffusion-steps", "1"])
assert stats["kernels"] and stats["int8"], stats
stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                            "--output", out, "--device", "cpu", "--diffusion-steps", "1",
                            "--deep", "--i8pre", "--resample"])
assert stats["deep"] and stats["i8pre"] and stats["resample"], stats
print("no JAX imported:", not any(m.split(".")[0] in ("jax", "unitspeech_tpu")
                                  for m in sys.modules))
"""


def test_port_and_chip_smoke_import_nothing_of_jax(tmp_path):
    """chip_smoke.py and the port's CLI (make-random-checkpoint, then
    inference on the CPU with its defaults and with the fused deep-stage
    switches) run with every import of jax, flax or unitspeech_tpu
    refused."""
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the IPA symbol table
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "tiny.json"),
         str(tmp_path / "ckpt.pt"), str(tmp_path / "o.wav")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no JAX imported: True" in proc.stdout
