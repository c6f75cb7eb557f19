"""The port's examples on the CPU: the demo walkthrough end to end, and the
speaker probe against the root examples/speaker_probing.py: its
log-probabilities at the same parameters (flax's tree carried across by
params_from_jax) within 1e-5, discrete and continuous, and three Adam
steps of train_probe against optax.adam's within 1e-5 relative."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unitspeech_tpu_torch.examples import demo, speaker_probing
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_runs_on_the_cpu(tmp_path, capsys):
    out = demo.main(["--device", "cpu", "--output", str(tmp_path / "demo.wav")])
    assert os.path.getsize(tmp_path / "demo.wav") > 44
    assert out["seconds"] > 0 and len(out["batch_seconds"]) == 2 and out["units"] > 0
    assert out["losses"].shape == (30,) and np.isfinite(out["losses"]).all()
    assert "6) sv56 normalize + write" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "speaker_probing_jax", os.path.join(ROOT, "examples", "speaker_probing.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # flax's dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _batch(seed, b=5, t=9, d=6, vocab=11):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, vocab, (b, t)).astype(np.int32)
    dense = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.array([t, 1, 4, t - 2, 6][:b], np.int32)
    labels = rng.integers(0, 3, b).astype(np.int32)
    return units, dense, lengths, labels


def _pair(jprobe, discrete, seed):
    """The JAX probe's parameters (flax init, then every leaf redrawn so the
    LayerNorms and biases are not trivial) and the port's probe holding
    them."""
    units, dense, lengths, _ = _batch(seed)
    kw = dict(n_classes=3, vocab_size=11 if discrete else 0, d_model=8, n_heads=2,
              n_layers=2, ffn=16)
    jp = jprobe.Probe(**kw)
    params = jax.jit(jp.init)(jax.random.PRNGKey(seed), units, dense, lengths)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32), params)
    tp = speaker_probing.Probe(kw.pop("n_classes"), in_features=0 if discrete else 6, **kw)
    sd = params_from_jax(jax.device_get(params))
    assert sorted(sd) == sorted(tp.state_dict())
    tp.load_state_dict(sd)
    return jp, params, tp


def _torch(units, dense, lengths):
    return (torch.from_numpy(units).long(), torch.from_numpy(dense),
            torch.from_numpy(lengths).long())


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_probe_log_probs_match_jax(jprobe, discrete):
    jp, params, tp = _pair(jprobe, discrete, 1)
    units, dense, lengths, _ = _batch(1)
    want = np.asarray(jax.jit(jp.apply)(params, units, dense, lengths))
    got = tp.eval()(*_torch(units, dense, lengths)).detach().numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not np.allclose(want[0], want[1])  # the rows' lengths reach the readout


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_train_probe_three_adam_steps_match_optax(jprobe, discrete):
    """Three full-batch steps: train_probe (torch.optim.Adam) against the
    root example's optax.adam step from the same parameters: the loss, and
    every parameter within 1e-5 relative (of its tensor's largest entry).
    Adam moves an entry by about lr a step whatever its gradient's size, so
    entries whose first gradient is at rounding level (below 1e-4 of the
    largest; the key projection's bias, which the softmax cancels, is all
    such) may go either way: they are held to 2 * lr * steps."""
    jp, params, tp = _pair(jprobe, discrete, 2)
    units, dense, lengths, labels = _batch(2)
    lr, steps = 3e-3, 3
    tx = optax.adam(lr)

    def loss_fn(p):
        logp = jp.apply(p, units, dense, lengths)
        return -logp[jnp.arange(labels.shape[0]), labels].mean()

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    grads = params_from_jax(jax.device_get(jax.jit(jax.grad(loss_fn))(params)))
    opt = tx.init(params)
    for _ in range(steps):
        params, opt, jloss = step(params, opt)
    acc, loss = speaker_probing.train_probe(tp, _torch(units, dense, lengths),
                                            torch.from_numpy(labels).long(), steps=steps, lr=lr,
                                            init=False)
    assert 0.0 <= acc <= 1.0
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = params_from_jax(jax.device_get(params))
    top = max(float(g.abs().max()) for g in grads.values())
    for name, p in tp.state_dict().items():
        g, w = p.numpy(), want[name].numpy()
        tol = 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max()
        tol = np.where(np.abs(grads[name].numpy()) < 1e-4 * top, 2 * lr * steps, tol)
        assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max())


def test_speaker_probing_main_on_the_cpu(capsys):
    baseline, disc, cont = speaker_probing.main(["--device", "cpu", "--steps", "3",
                                                 "--n-per-speaker", "3"])
    assert baseline == 0.5 and 0.0 <= disc <= 1.0 and 0.0 <= cont <= 1.0
    assert "continuous-features probe" in capsys.readouterr().out
