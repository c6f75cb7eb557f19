"""The PyTorch port's host-side ops against the JAX package: masking,
schedule, IPA front end, sv56, mel denormalization and the parameter
bridge. Inputs come from numpy seeds; JAX runs in f32 on the CPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitspeech_tpu import text as jtext
from unitspeech_tpu.ops import masking as jmask
from unitspeech_tpu.ops import mel as jmel
from unitspeech_tpu.ops import schedule as jsched
from unitspeech_tpu.ops import sv56 as jsv56
from unitspeech_tpu_torch import text as ttext
from unitspeech_tpu_torch.ops import masking as tmask
from unitspeech_tpu_torch.ops import mel as tmel
from unitspeech_tpu_torch.ops import schedule as tsched
from unitspeech_tpu_torch.ops import sv56 as tsv56
from unitspeech_tpu_torch.utils.params import params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sequence_mask_and_generate_path():
    rng = np.random.default_rng(0)
    lengths = np.array([7, 3, 5], np.int32)
    want = np.asarray(jmask.sequence_mask(jnp.asarray(lengths), 9))
    got = tmask.sequence_mask(torch.from_numpy(lengths), 9).numpy()
    np.testing.assert_array_equal(got, want)

    dur = rng.integers(0, 4, size=(3, 6)).astype(np.float32)
    mask = (rng.random((3, 6, 14)) > 0.2).astype(np.float32)
    want = np.asarray(jmask.generate_path(jnp.asarray(dur), jnp.asarray(mask)))
    got = tmask.generate_path(torch.from_numpy(dur), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)  # 0/1 path: exact


@pytest.mark.parametrize("length", [1, 7, 8, 33, 344, 5000])
def test_bucketing_matches(length):
    assert tmask.fix_len_compatibility(length, 3) == jmask.fix_len_compatibility(length, 3)
    assert tmask.default_frame_buckets(4096) == jmask.default_frame_buckets(4096)
    buckets = tmask.default_frame_buckets(4096)
    assert tmask.choose_bucket(length, buckets) == jmask.choose_bucket(length, buckets)
    assert tmask.intersperse([1, 2, 3], 0) == jmask.intersperse([1, 2, 3], 0)


@pytest.mark.parametrize("steps", [3, 50])
def test_reverse_schedule_identical(steps):
    a = jsched.make_reverse_schedule(steps)
    b = tsched.make_reverse_schedule(steps)
    for name in ("t_cont", "c_x", "c_score", "c_noise"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))  # same f64 math


@pytest.mark.parametrize("ipa", ["həloʊ wɜːld", "ðə kwɪk bɹaʊn fɑks, ɪz hɪɹ!", "ˈæbc̃ ?"])
def test_ipa_front_end_matches(ipa):
    assert ttext.cleaned_text_to_sequence(ipa) == jtext.cleaned_text_to_sequence(ipa)
    assert ttext.phonemes_to_sequence(ipa) == jtext.phonemes_to_sequence(ipa)
    assert ttext.phonemes_to_sequence(ipa, False) == jtext.phonemes_to_sequence(ipa, False)


def test_sv56_and_denormalize_match():
    rng = np.random.default_rng(1)
    sr = 22050
    t = np.arange(sr) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (t > 0.3) + 0.01 * rng.standard_normal(sr))
    x = x.astype(np.float32)
    np.testing.assert_array_equal(tsv56.normalize(x, sr), jsv56.normalize(x, sr))

    mel = rng.uniform(-1, 1, (2, 5, 4)).astype(np.float32)
    lo, hi = np.full(4, -12.0, np.float32), np.full(4, 3.0, np.float32)
    want = np.asarray(jmel.denormalize_mel(jnp.asarray(mel), jnp.asarray(lo), jnp.asarray(hi)))
    got = tmel.denormalize_mel(torch.from_numpy(mel), torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_params_round_trip_bit_exact():
    rng = np.random.default_rng(2)
    tree = {"params": {
        "emb": {"embedding": rng.standard_normal((5, 3)).astype(np.float32)},
        "down_0_res1": {"block1": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4))
                                            .astype(np.float32),
                                            "bias": np.zeros(4, np.float32)}}},
        "g": np.array([0.5], np.float32),
    }}
    sd = params_from_jax(tree)
    assert set(sd) == {"emb.embedding", "down_0_res1.block1.conv.kernel",
                       "down_0_res1.block1.conv.bias", "g"}
    assert sd["down_0_res1.block1.conv.kernel"].shape == (3, 3, 2, 4)  # flax layout kept
    back = params_to_jax(sd)

    def leaves(t, p=""):
        for k, v in t.items():
            yield from (leaves(v, p + "/" + k) if isinstance(v, dict) else [(p + "/" + k, v)])

    a, b = dict(leaves(tree)), dict(leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_port_never_imports_jax():
    """Every module of the port imports without pulling jax in."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import unitspeech_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'optax'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
