"""Training on the card (CUDA only; every test skips without a CUDA
device): kernel M1 (csrc/mas.cu, monotonic alignment search) bit for bit
against maximum_path_plain, and one f32 STEP1 step, one STEP2 step and
one BigVGAN GAN step on the card against the same step on the CPU
(tools/step_check.py; the STEP2 and GAN steps launch no kernel). Run on a
CUDA machine beside the other card tests:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py \\
        tests/test_torch_port_cuda_serving.py tests/test_torch_port_cuda_train.py
"""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.ops import aa_snake, mas
from unitspeech_tpu_torch.tools import step_check


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(kind, b, tx, ty, seed):
    """(log_prior, mask) on the CPU: random, integer (ties everywhere), or
    random with ragged lengths (a row with fewer frames than tokens, a
    one-token row)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        lp = rng.integers(-2, 1, (b, tx, ty)).astype(np.float32)
    else:
        lp = (rng.standard_normal((b, tx, ty)) * 3).astype(np.float32)
    xl, yl = np.full(b, tx), np.full(b, ty)
    if kind == "lengths":
        xl = rng.integers(1, tx + 1, b)
        yl = np.maximum(xl + rng.integers(-3, ty, b), 1).clip(max=ty)
        xl[0], yl[-1] = 1, max(1, min(ty, xl[-1] - 1))
    mask = ((np.arange(tx)[None, :, None] < xl[:, None, None])
            & (np.arange(ty)[None, None, :] < yl[:, None, None])).astype(np.float32)
    return torch.from_numpy(lp), torch.from_numpy(mask)


# (B, Tx, Ty): a STEP1 batch's buckets, more tokens than a block's threads,
# and a value row past 48 KiB of shared memory
SHAPES = [(16, 96, 384), (16, 128, 448), (3, 700, 900), (2, 7000, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "lengths"])
@pytest.mark.parametrize("shape", SHAPES)
def test_maximum_path_kernel_bit_equal(dev, kind, shape):
    lp, mask = _case(kind, *shape, seed=sum(shape))
    before = mas.maximum_path.launches
    got = mas.maximum_path(lp.to(dev), mask.to(dev))
    assert mas.maximum_path.launches == before + 1 and got.dtype == torch.float32
    want = mas.maximum_path_plain(lp, mask)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(mas.maximum_path_plain(lp.to(dev), mask.to(dev)).cpu(), want)


@pytest.mark.cuda
def test_step1_step_matches_cpu(dev):
    """One f32 STEP1 step (tools/step_check.py: strict f32, cuDNN's
    deterministic algorithms, the same injected draws): the three losses
    and the three gradient norms within 1e-4 relative of the CPU's."""
    before = mas.maximum_path.launches
    out = step_check.card_vs_cpu(dev)
    assert out["max_rel"] <= step_check.REL and mas.maximum_path.launches == before + 1


def _no_kernel(fn):
    """fn() with no launch of M1, K5 or K6 in it; returns its result."""
    wrappers = (mas.maximum_path, aa_snake.fused_aa_snake_conv, aa_snake.fused_aa_snake)
    before = [w.launches for w in wrappers]
    out = fn()
    assert [w.launches for w in wrappers] == before
    return out


@pytest.mark.cuda
def test_step2_step_matches_cpu(dev):
    """One f32 STEP2 step (the unit encoder against the frozen decoder;
    strict f32, cuDNN's deterministic algorithms, the same injected
    draws): the two losses, the total and the gradient norm within 1e-5
    relative of the CPU's."""
    out = _no_kernel(lambda: step_check.card_vs_cpu_step2(dev))
    assert out["max_rel"] <= step_check.REL2 == 1e-5


@pytest.mark.cuda
def test_gan_step_matches_cpu(dev):
    """One fused f32 GAN step (a narrow generator on its plain path, the
    full MPD and MRD, 4096-sample segments, AdamW at 1e-4): the seven
    losses, the generator's read after the discriminators' update, and the
    discriminator's gradient norm within 1e-5 relative of the CPU's, the
    generator's gradient norm within 1e-4 (the CPU's own spread between 1
    and 8 threads is 1.1e-4: tools/step_check.py)."""
    out = _no_kernel(lambda: step_check.card_vs_cpu_gan(dev))
    assert out["max_rel"] <= step_check.REL2 == 1e-5
    assert out["rel"]["gen_grad_norm"] <= step_check.REL == 1e-4
