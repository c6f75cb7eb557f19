"""The operator tools in the port (unitspeech_tpu_torch/tools) against the
JAX package's root tools:

  * analyze_buckets and capacity_plan, the host tools, give the JAX tools'
    numbers at the JAX tools' constants: the port's cost model pointed at
    the JAX anchors (cost_anchors.fit of COST_ANCHORS.json, JAX's floor and
    token curve), JAX's price of an overflow through `top_pass_ms` (its
    SYNC_MS), and for capacity_plan JAX's per-dispatch floor (A = 1,
    F = FIXED_MS); their --json keys are JAX's plus `card`;
  * the stale window of refresh_under_load and the A/B windows of
    bucket_policy_ab equal JAX's functions on the same lengths;
  * the six device tools run end to end with --small --device cpu (their
    plain paths; 2 steps, 3 clients): every request answered, the keys of
    JAX's JSON present (from the JAX records, or from the JAX tool's source
    where it keeps none), nothing written at the repository's root;
  * sv56 against the root sv56.py --no-native on a seeded directory (1e-6),
    validate_dataloader printing the root script's lines.

Torch runs on one intra-op thread (the suite's workers share the cores)."""

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from unitspeech_tpu.infer import bucket_cost as jbc
from unitspeech_tpu.ops.masking import default_frame_buckets as jax_frame_buckets
from unitspeech_tpu_torch.infer import bucket_cost as tbc
from unitspeech_tpu_torch.ops.masking import default_frame_buckets
from unitspeech_tpu_torch.tools import (
    analyze_buckets,
    bench_server,
    bench_serving,
    bench_ssl,
    bench_train,
    bucket_policy_ab,
    capacity_plan,
    cost_anchors,
    refresh_under_load,
    sv56,
    validate_dataloader,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = default_frame_buckets(4096)
CURVE = jbc.CURVES["dpm2_16_cs2"]  # an explicit curve handed to both sides


def _root_module(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch) -> str:
    """A root tool's main() with sys.argv set; its standard output."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.fixture
def jax_constants(monkeypatch):
    """Both cost models on the JAX anchors: the curves cost_anchors.fit
    gives on COST_ANCHORS.json (on the JAX side too, in place of its rounded
    CURVES), the port's fixed_ms JAX's per-request floor at the token anchor
    (BASE_MS), JAX's token curve and PRESETS."""
    with open(os.path.join(ROOT, "COST_ANCHORS.json")) as f:
        curves, _, _ = cost_anchors.fit(json.load(f))
    monkeypatch.setattr(jbc, "CURVES", dict(curves))
    specs = {"ddpm50": ("ddpm", 1, 50), "dpm2_25": ("dpm2", 1, 25), "dpm2_16": ("dpm2", 1, 16),
             "dpm2_16_cs2": ("dpm2", 2, 16)}
    modes = {name: {"sampler": specs[name][0], "stride": specs[name][1], "steps": specs[name][2],
                    "curve": list(curves[name]), "per_frame_ms": jbc.PRESETS[name]}
             for name in curves}
    monkeypatch.setattr(tbc, "_ANCHORS", {
        "card": "the JAX package's constants", "batch": 1, "fixed_ms": jbc.BASE_MS,
        "token_curve": list(jbc.TOKEN_CURVE), "tok_ref": 256, "modes": modes})
    return curves


def _traffic(seed, n=200, tail=0.1):
    """A long-tail length distribution (mel frames)."""
    rng = np.random.default_rng(seed)
    short = rng.normal(300.0, 60.0, n)
    long = rng.uniform(700.0, 1500.0, n)
    return np.where(rng.random(n) < tail, long, np.clip(short, 40.0, None))


def _inputs(tmp_path, seed=0):
    """Each traffic input of the two host tools, written from a seed."""
    lengths = _traffic(seed)
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("lengths", "seconds", "stats", "filelist")}
    np.savetxt(paths["lengths"], lengths)
    np.savetxt(paths["seconds"], lengths * 256 / 22050)
    rng = np.random.default_rng(seed + 1)
    with open(paths["stats"], "w") as f:
        json.dump({"recent_frames": [int(x) for x in lengths],
                   "recent_tokens": [int(t) for t in rng.integers(20, 700, len(lengths))]}, f)
    with open(paths["filelist"], "w", encoding="utf-8") as f:
        words = ["hello", "there", "general", "speech", "synthesis", "is", "fun", "today"]
        for i in range(40):
            f.write(f"a{i}.wav|{' '.join(rng.choice(words, int(rng.integers(2, 12))))}.|0\n")
    return paths


def _ns(kind, path, **kw):
    base = dict(lengths=None, stats=None, seconds=None, filelist=None, language="en-us",
                frames_per_token=2.46, hop=256, sr=22050)
    return argparse.Namespace(**{**base, kind: path, **kw})


@pytest.mark.parametrize("kind", ["lengths", "seconds", "stats", "filelist"])
def test_traffic_inputs_match_jax(kind, tmp_path):
    """load_lengths / load_tokens read every input as JAX's do."""
    jab = _root_module("tools/analyze_buckets.py", "jax_analyze_buckets")
    path = _inputs(tmp_path)[kind]
    np.testing.assert_array_equal(analyze_buckets.load_lengths(_ns(kind, path)),
                                  jab.load_lengths(_ns(kind, path)))
    got, want = analyze_buckets.load_tokens(_ns(kind, path)), jab.load_tokens(_ns(kind, path))
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,preset,extra", [
    ("lengths", "ddpm50", []), ("stats", "dpm2_16_cs2", ["--max-branches", "2"]),
    ("seconds", "dpm2_25", ["--tok-bucket", "512"]), ("lengths", "dpm2_16", []),
    ("lengths", "ddpm50", ["--per-frame-ms", "0.5"])])
def test_analyze_buckets_matches_jax(kind, preset, extra, tmp_path, jax_constants, monkeypatch):
    """At JAX's constants and its overflow price the port's analysis is the
    JAX tool's: the same JSON (best, policy, the gap) and the same rows."""
    jab = _root_module("tools/analyze_buckets.py", "jax_analyze_buckets")
    path = _inputs(tmp_path)[kind]
    if "--per-frame-ms" in extra:  # JAX's legacy linear model: its floor alone
        monkeypatch.setitem(tbc._ANCHORS, "fixed_ms", jbc.FIXED_MS)
    want = json.loads(_run_jax_main(jab, [f"--{kind}", path, "--preset", preset, "--json",
                                          *extra], monkeypatch))
    ns = _ns(kind, path)
    opts = {"--max-branches": 3, "--tok-bucket": 256, "--per-frame-ms": None}
    opts.update({k: float(v) if "." in v else int(v) for k, v in zip(extra[::2], extra[1::2])})
    result, rows = analyze_buckets.analyze(
        analyze_buckets.load_lengths(ns), analyze_buckets.load_tokens(ns), preset,
        opts["--per-frame-ms"], opts["--tok-bucket"], opts["--max-branches"],
        top_pass_ms=jbc.SYNC_MS)
    assert json.loads(json.dumps(result)) == want
    lengths = jab.load_lengths(ns)
    cost = want["per_frame_ms"]
    cost = tuple(cost) if isinstance(cost, list) else cost
    tok_ms = 0.0 if opts["--per-frame-ms"] else (
        float(np.mean([jbc.token_cost_ms(jab.choose_bucket(int(t), jab.TOKEN_LADDER))
                       for t in jab.load_tokens(ns)])) if kind == "stats"
        else jbc.token_cost_ms(opts["--tok-bucket"]))
    jrows = sorted((jbc.window_cost(lengths, w, cost, jax_frame_buckets(4096), tok_ms=tok_ms)
                    for w in jbc.enumerate_windows(lengths, jax_frame_buckets(4096),
                                                   opts["--max-branches"])),
                   key=lambda r: r["mean_proc_ms"])
    assert rows == jrows


def test_host_tools_json_keys_are_jax_keys(tmp_path, monkeypatch):
    """--json: the JAX tools' keys, and the card the prices were measured on."""
    jab = _root_module("tools/analyze_buckets.py", "jax_analyze_buckets")
    jcp = _root_module("tools/capacity_plan.py", "jax_capacity_plan")
    path = _inputs(tmp_path)["stats"]
    flags = ["--stats", path, "--json", "--target-qps", "20", "--target-streams", "40",
             "--chips", "4"]
    for port, jax_tool, argv in ((analyze_buckets, jab, ["--stats", path, "--json"]),
                                 (capacity_plan, jcp, flags)):
        want = json.loads(_run_jax_main(jax_tool, argv, monkeypatch))
        got = port.main([*argv, *(["--utilization", "0.8"] if port is capacity_plan else [])])
        assert set(got) == set(want) | {"card"}
        assert got["card"] == tbc.anchors()["card"]


def test_analyze_buckets_ranks_windows_that_hold_the_traffic(tmp_path):
    """The port's rule: an overflow runs its exact bucket alone, so the
    ranked windows are those that hold every observed length; the table
    prints them with the quantile window marked."""
    path = _inputs(tmp_path)["lengths"]
    lengths = np.loadtxt(path)
    result, rows = analyze_buckets.analyze(lengths, preset="ddpm50")
    need = tbc._needs(lengths, 3).max()
    assert rows and all(r["window"][-1] >= need and r["overflow_pct"] == 0.0 for r in rows)
    assert result["best"]["window"] == rows[0]["window"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        printed = analyze_buckets.main(["--lengths", path, "--top", "3"])
    assert "<- quantile" in buf.getvalue() and printed["card"].startswith("NVIDIA H100")


@pytest.mark.parametrize("seed,batch,tail", [(0, 1, 0.1), (1, 4, 0.1), (2, 8, 0.0),
                                             (3, 2, 0.3)])
def test_capacity_plan_matches_jax_plan(seed, batch, tail):
    """plan() at JAX's constants (A = 1, F = FIXED_MS, its overflow price)
    is JAX's plan on the same curve, lengths and utilization."""
    jcp = _root_module("tools/capacity_plan.py", "jax_capacity_plan")
    lengths = _traffic(seed, tail=tail)
    got = capacity_plan.plan(lengths, CURVE, LADDER, batch=batch, tok_ms=4.5, utilization=0.6,
                             floor=(1, jbc.FIXED_MS), top_pass_ms=jbc.SYNC_MS)
    assert got == jcp.plan(lengths, CURVE, jax_frame_buckets(4096), batch=batch, tok_ms=4.5,
                           utilization=0.6)


@pytest.mark.parametrize("flags", [["--target-qps", "25"], ["--target-streams", "60"],
                                   ["--chips", "3"], ["--target-qps", "9", "--chips", "2"]])
def test_capacity_plan_main_matches_jax(flags, tmp_path, jax_constants, monkeypatch):
    """The CLI at JAX's constants on traffic whose optimal window holds every
    length under both overflow prices: JAX's JSON, whatever the target."""
    jcp = _root_module("tools/capacity_plan.py", "jax_capacity_plan")
    monkeypatch.setattr(capacity_plan, "dispatch_floor", lambda: (1, jbc.FIXED_MS))
    path = str(tmp_path / "tight.txt")
    np.savetxt(path, np.random.default_rng(5).uniform(290.0, 340.0, 120))
    argv = ["--lengths", path, "--batch", "4", "--utilization", "0.75", "--json", *flags]
    want = json.loads(_run_jax_main(jcp, argv, monkeypatch))
    got = capacity_plan.main(argv)
    assert {k: v for k, v in got.items() if k != "card"} == want


def test_capacity_plan_prices_from_the_anchors_batch():
    """The card's curves are per request in a batch of A: at B = A the plan
    prices the curve's own cost (no second amortization of the floor), at
    B = 1 a request pays the whole dispatch floor A * fixed_ms."""
    a, fixed = capacity_plan.dispatch_floor()
    assert (a, fixed) == (tbc.anchors()["batch"], tbc.anchors()["fixed_ms"]) and a == 8
    lengths = _traffic(7)
    curve = tbc.frame_cost_curve("ddpm", 50)
    at_a = capacity_plan.plan(lengths, curve, LADDER, batch=a, utilization=1.0)
    at_1 = capacity_plan.plan(lengths, curve, LADDER, batch=1, utilization=1.0)
    assert at_a["mean_proc_ms_batched"] == at_a["mean_proc_ms_single"]
    assert at_1["mean_proc_ms_batched"] == pytest.approx(
        at_a["mean_proc_ms_single"] + (a - 1) * fixed, abs=0.1)


@pytest.mark.parametrize("frames", [48, 175, 344, 500])
def test_stale_window_matches_jax(frames):
    """refresh_under_load's stale window is JAX's on the same curve, under
    JAX's overflow price and under the port's (constant traffic: both hold
    every length)."""
    ladder = jax_frame_buckets(4096)
    want = jbc.optimal_window(np.full(64, frames * 4.0), ladder, CURVE, max_branches=2,
                              num_down=3, headroom=1)[0]
    assert refresh_under_load.stale_window(frames, LADDER, CURVE, 3,
                                           top_pass_ms=jbc.SYNC_MS) == want
    assert refresh_under_load.stale_window(frames, LADDER, CURVE, 3) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ab_windows_match_jax(seed):
    """bucket_policy_ab's two windows and their predicted rows are JAX's
    (its quantile policy, its optimal window, its window_cost with the
    traffic's token cost) on the same long-tail lengths."""
    jab = _root_module("tools/analyze_buckets.py", "jax_analyze_buckets")
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.uniform(150, 200, 27), rng.uniform(1150, 1450, 3)])
    ladder = jax_frame_buckets(4096)
    win_q = jab.policy_window(lengths, ladder, max_branches=2, num_down=3)
    win_c, _ = jbc.optimal_window(lengths, ladder, CURVE, 2, 3)
    want = tuple((w, jbc.window_cost(lengths, w, CURVE, ladder, 3, tok_ms=12.5))
                 for w in (win_q, win_c))
    assert bucket_policy_ab.ab_windows(lengths, LADDER, CURVE, 3, 12.5,
                                       top_pass_ms=jbc.SYNC_MS) == want


def _jax_source_keys(relpath, func):
    """The keys of the result dict literal (the one with "metric") that a
    function of a root tool builds."""
    tree = ast.parse(open(os.path.join(ROOT, relpath)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError(f"{relpath}:{func} builds no result dict")


def _jax_record_keys(name):
    with open(os.path.join(ROOT, name)) as f:
        return set(json.load(f))


@contextlib.contextmanager
def _nothing_written_at_root():
    """The repository's root and its chiprun_out/ hold the same files after."""
    def listing():
        out = set(os.listdir(ROOT))
        d = os.path.join(ROOT, "chiprun_out")
        return out | ({f"chiprun_out/{f}" for f in os.listdir(d)} if os.path.isdir(d) else set())

    before = listing()
    yield
    assert listing() == before


SMALL = ["--small", "--device", "cpu"]


def test_bench_server_small_run(tmp_path):
    """3 clients in a child process, 6 requests, 2 steps, the TTFA probe: every
    request answered (the tool holds the replies' samples to the served
    lengths), JAX's keys, the /stats snapshot for the host tools."""
    stats = tmp_path / "stats.json"
    with _nothing_written_at_root():
        res = bench_server.main([*SMALL, "--clients", "3", "--requests", "6", "--steps", "2",
                                 "--ttfa-sentences", "2", "--stats-out", str(stats)])
    assert _jax_source_keys("tools/bench_server.py", "run_bench") | {
        "stream_sentences", "stream_ttfa_s", "stream_total_s", "stream_speech_s",
        "card"} == set(res)
    snap = json.loads(stats.read_text())
    assert res["requests"] == snap["requests"] == 6 and snap["errors"] == 0
    assert sum(snap["batch_sizes"].values()) == snap["batches"] and res["value"] > 0
    assert res["stream_speech_s"] > 0 and res["card"].startswith("cpu")
    plan = capacity_plan.main(["--stats", str(stats), "--preset", "ddpm50", "--utilization",
                               "1.0", "--json"])
    assert plan["n_requests"] == 6 and plan["window"]


def test_refresh_under_load_small_run():
    """The stale window swapped for the served traffic's under load, no
    request failed (the tool raises otherwise), JAX's keys."""
    with _nothing_written_at_root():
        res = refresh_under_load.main(SMALL)
    assert _jax_record_keys("REFRESH_LOAD.json") | {"card"} == set(res)
    assert res["decision"]["refreshed"] and res["decision"]["window"] != res["stale_window"]
    assert res["n_before"] and res["n_after"] and res["smoke"]


def test_bucket_policy_ab_small_run():
    """Both windows served every request (the tool checks each waveform
    against its frames), JAX's keys."""
    with _nothing_written_at_root():
        res = bucket_policy_ab.main(SMALL)
    assert _jax_record_keys("BUCKET_AB.json") | {"card"} == set(res)
    for k in ("cost", "quantile"):
        assert set(res[k]) == set(json.load(open(os.path.join(ROOT, "BUCKET_AB.json")))[k])
        assert res[k]["measured_mean_ms"] > 0


def test_bench_serving_small_run():
    with _nothing_written_at_root():
        res = bench_serving.main([*SMALL, "--reps", "1"])
    for mode in ("exact", "speculative"):
        assert res[mode]["samples"] > 0 and res[mode]["rtf"] > 0


@pytest.mark.parametrize("step2", [False, True])
def test_bench_train_small_run(step2):
    """One STEP1 (STEP2) step differenced against two, the loss finite,
    JAX's keys (and M1's share for STEP1)."""
    with _nothing_written_at_root():
        res = bench_train.main([*SMALL, "--k1", "1", "--k2", "2", *(["--step2"] if step2 else [])])
    extra = {"card", "peak_gib", "loss"} | (set() if step2 else {"m1_ms", "m1_share"})
    assert _jax_source_keys("tools/bench_train.py", "run_bench") | extra == set(res)
    assert np.isfinite(res["loss"]) and res["batch"] == 2
    assert res["metric"] == ("step2" if step2 else "step1") + "_train_step_seconds"


def test_bench_ssl_small_run():
    """Two sessions at the test widths, the adapted voice served: JAX's keys
    (but finetune_aot_hit), a finite mel of its frames."""
    with _nothing_written_at_root():
        res = bench_ssl.main([*SMALL, "--seconds", "0.5", "--n-iters", "2"])
    jax_keys = json.load(open(os.path.join(ROOT, "SSL_BENCH.json")))
    assert set(jax_keys) - {"finetune_aot_hit"} <= set(res)
    for part in ("spk_embedder", "unit_extractor", "adapt_voice"):
        assert set(jax_keys[part]) <= set(res[part])
    ad = res["adapted_request"]
    assert ad["finite"] and ad["samples"] == ad["frames"] * 16


def test_sv56_matches_root_script(tmp_path):
    """The port's batch normalizer against the root sv56.py --no-native on a
    seeded tree of wavs (nested, two rates), to another directory and in
    place: the same samples within 1e-6."""
    from unitspeech_tpu_torch.utils.audio import load_wav, write_wav

    root_sv56 = _root_module("sv56.py", "root_sv56")
    src = tmp_path / "in"
    rng = np.random.default_rng(9)
    for i, (sub, sr) in enumerate([("", 16000), ("a", 22050), ("a/b", 16000)]):
        (src / sub).mkdir(parents=True, exist_ok=True)
        n = int(sr * rng.uniform(0.4, 0.9))
        t = np.arange(n) / sr
        env = (np.sin(2 * np.pi * 3 * t) > -0.3).astype(np.float64)
        wav = 0.05 * (i + 1) * env * np.sin(2 * np.pi * 180 * t) + 0.002 * rng.standard_normal(n)
        write_wav(str(src / sub / f"u{i}.wav"), wav, sr)
    assert root_sv56.main(["--input-dir", str(src), "--output-dir", str(tmp_path / "jax"),
                           "--no-native"]) == 0
    assert sv56.main(["--input-dir", str(src), "--output-dir", str(tmp_path / "port")]) == {
        "files": 3, "target_dbov": -26.0}
    inplace = tmp_path / "inplace"
    shutil.copytree(src, inplace)
    sv56.main(["--input-dir", str(inplace), "--inplace"])
    for rel in ("u0.wav", "a/u1.wav", "a/b/u2.wav"):
        want, sr = load_wav(str(tmp_path / "jax" / rel))
        for d in ("port", "inplace"):
            got, got_sr = load_wav(str(tmp_path / d / rel))
            assert got_sr == sr
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(SystemExit):
        sv56.main(["--input-dir", str(src)])


@pytest.mark.parametrize("units", [False, True])
def test_validate_dataloader_prints_the_root_scripts_lines(units, tmp_path):
    """The same item and batch shapes, dtypes and wav range, line for line."""
    from unitspeech_tpu_torch.utils.audio import write_wav

    root_vd = _root_module("scripts/validate_dataloader.py", "root_validate_dataloader")
    rng = np.random.default_rng(4)
    lines = []
    for i, text in enumerate(["həloʊ.", "ðə dɑɡ.", "ðə kwɪk bɹaʊn.", "fɑks.", "ə sɛntəns."]):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, 0.3 * rng.standard_normal(int(22050 * rng.uniform(0.2, 0.5))), 22050)
        n = int(rng.integers(5, 12))
        np.savez(str(tmp_path / f"u{i}.units.npz"), units=rng.integers(0, 100, n),
                 durations=rng.integers(1, 4, n))
        lines.append(f"{path}|{text}|{i % 2}")
    fl = tmp_path / "list.txt"
    fl.write_text("\n".join(lines) + "\n", encoding="utf-8")
    argv = ["--filelist", str(fl), "--batch-size", "4", *(["--units"] if units else [])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert root_vd.main(argv) == 0
    want = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = validate_dataloader.main(argv)
    assert buf.getvalue() == want
    assert res["entries"] == 5 and res["batch"]["wav"][0][0] == 4
