"""The serving slice's host-side models against the JAX package's: the
duration calibrator (infer/calibration.py), the bucket-window functions
(infer/bucket_cost.py, both sides given the same explicit cost curve and
JAX's price of an overflow), the cost-anchor fit (tools/cost_anchors.py
against the root tools/refit_cost_model.py on COST_ANCHORS.json), and the
port's measured constants file (cost_anchors_h100.json)."""

import importlib.util
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
import torch

from unitspeech_tpu.infer import bucket_cost as jbc
from unitspeech_tpu.infer.calibration import DurationCalibrator as JaxCalibrator
from unitspeech_tpu_torch.infer import bucket_cost as tbc
from unitspeech_tpu_torch.infer.calibration import DurationCalibrator
from unitspeech_tpu_torch.ops.masking import default_frame_buckets
from unitspeech_tpu_torch.tools import cost_anchors

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = default_frame_buckets(4096)
CURVE = (104.74, 0.07749, 1.525e-4)  # an explicit curve handed to both sides


def _stream(seed, n=40, n_vocab=30):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = list(rng.integers(0, n_vocab, int(rng.integers(3, 20))))
        durs = rng.integers(1, 9, len(toks)).astype(np.float64)
        yield toks, durs, float(durs.sum() * rng.uniform(0.8, 1.3))


@pytest.mark.parametrize("seed", [0, 1])
def test_calibrator_matches_jax(seed, tmp_path):
    """The same stream of observations gives the same guesses, estimates,
    margin, readiness and observed totals at every point; the JSON file
    round-trips both ways (port -> JAX, JAX -> port)."""
    port, jax_cal = DurationCalibrator(n_vocab=30, min_samples=5), JaxCalibrator(n_vocab=30,
                                                                                 min_samples=5)
    probes = [list(range(5)), [3, 3, 3, 29], [7] * 12]
    for i, (toks, durs, total) in enumerate(_stream(seed)):
        if i % 3:
            for c in (port, jax_cal):
                c.observe_durations(toks, durs)
        for c in (port, jax_cal):
            c.observe_total(toks, total)
        assert port.ready == jax_cal.ready and port.margin == jax_cal.margin
        for p in probes:
            assert port.guess_frames(p) == jax_cal.guess_frames(p)
            assert port.estimate(p) == jax_cal.estimate(p)
    assert port.observed_totals() == jax_cal.observed_totals()
    assert port.ready and port.guess_frames(probes[0]) is not None

    port.save(str(tmp_path / "port.json"))
    jax_cal.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    for back in (JaxCalibrator.load(str(tmp_path / "port.json")),
                 DurationCalibrator.load(str(tmp_path / "jax.json"))):
        assert back.observed_totals() == port.observed_totals()
        assert [back.guess_frames(p) for p in probes] == [port.guess_frames(p) for p in probes]


lengths_st = st.lists(st.floats(min_value=20.0, max_value=1500.0, allow_nan=False),
                      min_size=1, max_size=40)


@settings(max_examples=25, deadline=None)
@given(lengths=lengths_st, lo_q=st.sampled_from([0.0, 0.05, 0.25]),
       branches=st.integers(1, 4), num_down=st.sampled_from([2, 3]))
def test_quantile_window_matches_jax(lengths, lo_q, branches, num_down):
    assert tbc.quantile_window(lengths, LADDER, lo_q=lo_q, max_branches=branches,
                               num_down=num_down) == jbc.quantile_window(
        lengths, LADDER, lo_q=lo_q, max_branches=branches, num_down=num_down)


@settings(max_examples=10, deadline=None)
@given(lengths=st.lists(st.floats(min_value=60.0, max_value=700.0, allow_nan=False), min_size=1,
                        max_size=30), branches=st.integers(1, 3), headroom=st.integers(0, 1),
       sync=st.sampled_from([0.0, jbc.SYNC_MS]))
def test_optimal_window_matches_jax(lengths, branches, headroom, sync):
    """The same explicit curve and JAX's price of an overflow (a wasted top
    pass and `sync` ms: top_pass_ms; JAX's SYNC_MS is its TPU value): the
    same window and cost row."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbc, "SYNC_MS", sync)
        got = tbc.optimal_window(lengths, LADDER, CURVE, branches, 3, headroom=headroom,
                                 top_pass_ms=sync)
        want = jbc.optimal_window(lengths, LADDER, CURVE, branches, 3, headroom=headroom)
        assert got == want
        assert tbc.window_cost(np.asarray(lengths), got[0], CURVE, LADDER, tok_ms=3.0,
                               top_pass_ms=sync) == \
            jbc.window_cost(np.asarray(lengths), got[0], CURVE, LADDER, tok_ms=3.0)


def test_port_prices_an_overflow_at_its_exact_bucket():
    """The port's switch knows an overflow before it samples: an overflow
    costs its exact bucket alone (no wasted top pass, no extra sync), so it
    is never dearer than landing in a window branch of that bucket; the
    port's optimal window holds every observed length all the same."""
    c = (10.0, 0.5, 0.0)
    ov = tbc.window_cost(np.array([330.0]), (136, 216), c, LADDER, tok_ms=2.0)
    hit = tbc.window_cost(np.array([330.0]), (136, 344), c, LADDER, tok_ms=2.0)
    assert ov["overflow_pct"] == 100.0 and hit["overflow_pct"] == 0.0
    assert ov["mean_proc_ms"] == hit["mean_proc_ms"] == 10.0 + 0.5 * 344 + 2.0
    assert ov["padding_waste_pct"] == hit["padding_waste_pct"]
    jax_priced = tbc.window_cost(np.array([330.0]), (136, 216), c, LADDER, top_pass_ms=0.0)
    assert jax_priced["mean_proc_ms"] == 10.0 + 0.5 * 216 + 10.0 + 0.5 * 344
    # an overflow is not dearer, but it runs a bucket the warm-up did not:
    # the port's optimal window still holds every observed length
    lengths = np.random.default_rng(3).uniform(40.0, 300.0, 24)
    w, row = tbc.optimal_window(lengths, LADDER, c, 3, 3)
    assert w[-1] >= tbc._needs(lengths, 3).max() and row["overflow_pct"] == 0.0


def test_anchor_fit_matches_jax_refit():
    """The port's fit on the JAX anchors (COST_ANCHORS.json) gives the JAX
    refit's curves (tools/refit_cost_model.py) and the constants JAX's
    bucket_cost hard-codes from it."""
    spec = importlib.util.spec_from_file_location(
        "refit_cost_model", os.path.join(ROOT, "tools", "refit_cost_model.py"))
    refit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refit)
    with open(os.path.join(ROOT, "COST_ANCHORS.json")) as f:
        data = json.load(f)
    got = cost_anchors.fit(data)
    want = refit.fit(data)
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-12)
        np.testing.assert_allclose(got[0][k], jbc.CURVES[k], rtol=5e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


def test_h100_anchors_file():
    """The committed constants: measured on the card (its name and power
    limit) at every anchor, per request of a forced batch of 8, the curves the fit of those rows gives, and the
    cost model built from them."""
    a = tbc.anchors()
    assert a["card"].startswith("NVIDIA H100") and a["card"].endswith(" W"), a["card"]
    assert a["script"] == "python -m unitspeech_tpu_torch.tools.cost_anchors"
    assert {(m["sampler"], m["stride"], m["steps"]) for m in a["modes"].values()} == {
        ("ddpm", 1, 50), ("dpm2", 2, 16)}
    assert a["repeats"] >= 3 and a["fixed_ms"] > 0 and a["batch"] == 8  # the served batch
    rows = {(r["sampler"], r["steps"], r["tok_bucket"], r["frames"]) for r in a["rows"]}
    for s, n in (("ddpm", 50), ("dpm2:cs2", 16)):
        assert {(s, n, 256, f) for f in (216, 344, 696, 1256)} <= rows
    assert {("dpm2:cs2", 16, 64, 344), ("dpm2:cs2", 16, 1024, 344)} <= rows
    curves, token_curve, _ = cost_anchors.fit(a, tok_ref=a["tok_ref"], tok_frames=a["tok_frames"])
    assert {k: list(v) for k, v in curves.items()} == {k: m["curve"] for k, m in
                                                       a["modes"].items()}
    assert list(token_curve) == a["token_curve"]
    c = tbc.frame_cost_curve("ddpm", 50)
    assert c == pytest.approx(a["modes"]["ddpm50"]["curve"])
    assert tbc.token_cost_ms(256) == 0.0
    assert tbc.preset_per_frame_ms("dpm2", 25) == pytest.approx(
        a["modes"]["ddpm50"]["per_frame_ms"] / 2)
    # a half-step ddpm curve keeps the floor and halves the rest
    h = tbc.frame_cost_curve("ddpm", 25)
    assert h[1:] == pytest.approx((c[1] / 2, c[2] / 2))
    assert h[0] == pytest.approx(a["fixed_ms"] + (c[0] - a["fixed_ms"]) / 2)
    w, row = tbc.optimal_window([300.0, 320.0, 340.0, 900.0], LADDER, c, 2, 3, headroom=1)
    assert len(w) <= 3 and row["mean_proc_ms"] > 0


def test_cost_policy_needs_the_file(monkeypatch, tmp_path):
    """Without the measured file the cost model's constants raise, naming
    the tool; the quantile window and an explicit curve need none."""
    monkeypatch.setattr(tbc, "ANCHORS_PATH", str(tmp_path / "absent.json"))
    monkeypatch.setattr(tbc, "_ANCHORS", None)
    for fn in (lambda: tbc.frame_cost_curve("ddpm", 50), lambda: tbc.token_cost_ms(64),
               lambda: tbc.preset_per_frame_ms("ddpm", 50),
               lambda: tbc.window_cost(np.array([100.0]), (128,), 0.5, LADDER)):
        with pytest.raises(FileNotFoundError, match="tools.cost_anchors"):
            fn()
    assert tbc.quantile_window([100.0, 200.0], LADDER)
    assert tbc.optimal_window([100.0, 200.0, 900.0], LADDER, CURVE, 2)[0]


def test_cost_anchors_tool_small_run(tmp_path):
    """The tool end to end on the CPU at test widths (a smoke run): every
    row, the fits and the file's keys."""
    out = tmp_path / "a.json"
    res = cost_anchors.main(["--device", "cpu", "--small", "--repeats", "1", "--out",
                             str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert len(res["rows"]) == 8 and res["card"].startswith("cpu")
    assert set(res["modes"]) == {"ddpm3", "dpm2_2_cs2"} and len(res["token_curve"]) == 2
