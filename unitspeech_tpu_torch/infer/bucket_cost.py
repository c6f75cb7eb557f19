"""Measured cost model for the serving frame-bucket window (counterpart of
unitspeech_tpu/infer/bucket_cost.py).

Bucket-switch serving (infer/tts.py `Synthesizer._switch_dispatch`) pads
every request onto one of a small set of frame buckets. Which window of
ladder buckets to serve on is a cost tradeoff:

  in-window request:  proc = proc_ms(padded_bucket)
  overflow request:   proc = proc_ms(exact_bucket)

The port's switch brings the predicted lengths to the host before it picks
a bucket (eager PyTorch needs the bucket to shape the sampler), so it knows
an overflow before it samples and runs the exact bucket alone. JAX's model
also charges a wasted pass at the top bucket and a host sync (its switch
decides on the device, inside one executable); `top_pass_ms` (the sync's
ms) prices an overflow so, as the tests do to hold these functions to
JAX's.

with proc_ms either a quadratic curve per sampler mode (frame_cost_curve:
c0 + c1*b + c2*b^2; the U-Net's attention is O(frames^2)) or the legacy
linear model FIXED + per_frame * b (any scalar passed where a curve is
accepted). The window functions (quantile_window, window_cost,
enumerate_windows, optimal_window) are the JAX module's, with that one
change to the overflow's price; candidate_windows, which optimal_window and
tools/analyze_buckets.py rank, follows from it.

The constants are the card's own: `cost_anchors_h100.json` beside this
module, which `python -m unitspeech_tpu_torch.tools.cost_anchors` measures
(forced batches of the served size at frame buckets 216 / 344 / 696 / 1256
and token buckets 64 / 256 / 1024, each priced per request) and fits,
naming the card, its power limit and the batch size. Without that file
frame_cost_curve, preset_per_frame_ms, token_cost_ms and the legacy scalar
model raise; the quantile policy and an explicit (c0, c1, c2) curve need no
constant.

Everything here is host-side numpy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the file tools/cost_anchors.py writes; None until first read
ANCHORS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cost_anchors_h100.json")
_ANCHORS = None


def anchors() -> dict:
    """The measured constants (cost_anchors_h100.json), read once. Raises
    FileNotFoundError, naming the tool that writes them, when absent."""
    global _ANCHORS
    if _ANCHORS is None:
        if not os.path.exists(ANCHORS_PATH):
            raise FileNotFoundError(
                f"{ANCHORS_PATH}: no measured serving cost constants; run python -m "
                "unitspeech_tpu_torch.tools.cost_anchors on the card, or use the quantile "
                "bucket policy or an explicit (c0, c1, c2) per_frame_ms curve")
        with open(ANCHORS_PATH) as f:
            _ANCHORS = json.load(f)
    return _ANCHORS


def _modes(sampler: str, stride: int) -> list:
    """The measured modes of one sampler and guidance stride."""
    return [m for m in anchors()["modes"].values()
            if (m["sampler"], m["stride"]) == (sampler, stride)]


def _e_tok(tok: float) -> float:
    t1, t2 = anchors()["token_curve"]
    return t1 * tok + t2 * tok * tok


def token_cost_ms(tok_bucket: int) -> float:
    """Per-request encoder cost delta (ms) of serving at `tok_bucket`
    vs the curves' token anchor (256). Independent of the frame window, so
    it never changes a window RANKING — add it when absolute latency
    numbers matter (offline analysis, capacity planning)."""
    return _e_tok(float(tok_bucket)) - _e_tok(float(anchors()["tok_ref"]))


def preset_per_frame_ms(sampler: str = "ddpm", steps: int = 50) -> float:
    """Per-padded-frame cost (ms) for a sampler spec ("ddpm", "dpm2",
    "dpm2:cs2", ...) at `steps`, from the measured anchors: each measured
    mode's (ms at 344 frames - fixed_ms) / 344, scaled linearly in steps
    from the nearest measured step count. Other specs take plain ddpm's
    per-step price (a stride-1 dpm2 step is one 3-row estimator call, as a
    ddpm step is)."""
    base, _, stride_s = sampler.partition(":cs")
    stride = int(stride_s) if stride_s else 1
    rows = [(m["steps"], m["per_frame_ms"]) for m in _modes(base, stride)]
    if not rows:
        ref = _modes("ddpm", 1)[0]
        return ref["per_frame_ms"] / ref["steps"] * steps
    a_steps, a_cost = min(rows, key=lambda r: abs(r[0] - steps))
    return a_cost / a_steps * steps


def frame_cost_curve(sampler: str = "ddpm", steps: int = 50):
    """(c0, c1, c2) quadratic frame-cost curve for a sampler spec at
    `steps`, from the measured anchors: a measured mode's fit, its frame
    terms and the per-step share of c0 (c0 - fixed_ms) scaled linearly in
    steps from the nearest measured step count; other specs scale the
    production fast mode's (dpm2:cs2@16) curve by the preset_per_frame_ms
    ratio. Pass the result anywhere a scalar `per_frame_ms` is accepted
    (window_cost / optimal_window / make_switch_buckets)."""
    base_ms = float(anchors()["fixed_ms"])  # measured at the token anchor: E(256) is in it
    base, _, stride_s = sampler.partition(":cs")
    stride = int(stride_s) if stride_s else 1
    refs = _modes(base, stride)
    if not refs:
        prod = _modes("dpm2", 2)[0]
        c0, c1, c2 = prod["curve"]
        r = preset_per_frame_ms(sampler, steps) / preset_per_frame_ms("dpm2:cs2", prod["steps"])
    else:
        ref = min(refs, key=lambda m: abs(m["steps"] - steps))
        c0, c1, c2 = ref["curve"]
        r = steps / ref["steps"]
    return (base_ms + (c0 - base_ms) * r, c1 * r, c2 * r)


def _proc_ms(frames, cost):
    """Vectorized per-request cost at padded frame count(s) `frames`.
    `cost` is either a (c0, c1, c2) curve (frame_cost_curve) or a scalar
    per-frame price (the legacy linear model FIXED + per_frame * b)."""
    b = np.asarray(frames, np.float64)
    if isinstance(cost, (tuple, list)):
        c0, c1, c2 = (float(c) for c in cost)
        return c0 + c1 * b + c2 * b * b
    return float(anchors()["fixed_ms"]) + float(cost) * b


def _needs(lengths: np.ndarray, num_down: int) -> np.ndarray:
    """Vectorized fix_len_compatibility: frame needs rounded up to the
    U-Net's 2**num_down granularity."""
    m = 2 ** num_down
    return (np.ceil(np.ceil(np.asarray(lengths, np.float64)) / m) * m
            ).astype(np.int64)


def _bucket(length: int, ladder: Sequence[int]) -> int:
    """Smallest ladder bucket >= length (ops.masking.choose_bucket
    semantics, re-stated here so this module stays numpy-only); beyond the
    ladder, the 2**3-rounded length itself."""
    for b in ladder:
        if b >= length:
            return int(b)
    return int(-(-length // 8) * 8)


def quantile_window(
    lengths: Sequence[float],
    ladder: Sequence[int],
    lo_q: float = 0.05,
    hi_q: float = 1.0,
    max_branches: int = 3,
    num_down: int = 3,
) -> Tuple[int, ...]:
    """The quantile bucket-window heuristic (Synthesizer.make_switch_buckets
    policy="quantile", which delegates here): every ladder bucket between
    ~P(lo_q) and ~P(hi_q) of the observed lengths plus one ladder step of
    headroom, keeping the LARGEST max_branches. Cheap and near-optimal on
    tight distributions; on long-tail traffic prefer `optimal_window`.
    `lengths` are post-length_scale mel frames."""
    lengths = np.asarray(lengths, np.float64)
    if lengths.size == 0:
        raise ValueError("quantile_window needs at least one length")
    m = 2 ** num_down
    lo = float(np.quantile(lengths, lo_q))
    hi = float(np.quantile(lengths, hi_q))
    lo_b = _bucket(int(-(-int(lo) // m) * m), ladder)
    hi_b = _bucket(int(-(-int(np.ceil(hi)) // m) * m), ladder)
    # one ladder step of headroom above the observed hi_q: an overflow
    # runs at a bucket outside the warmed window (refused under
    # strict_grid) while the extra branch only costs warm-up time, so err
    # on covering the tail
    above = [b for b in ladder if b > hi_b]
    if above:
        hi_b = above[0]
    window = [b for b in ladder if lo_b <= b <= hi_b]
    if not window:
        window = [hi_b]
    return tuple(window[-max_branches:])


def window_cost(
    lengths: np.ndarray,
    window: Sequence[int],
    per_frame_ms,
    ladder: Sequence[int],
    num_down: int = 3,
    tok_ms: float = 0.0,
    top_pass_ms=None,
) -> Dict[str, object]:
    """Expected per-request proc cost (ms) of serving `lengths` (mel frames,
    pre-rounding) on a bucket `window`, plus padding/overflow stats.
    Vectorized (one searchsorted per array) so enumerating ~1e3 candidate
    windows over a 4096-entry /stats ring stays sub-second.

    per_frame_ms: a (c0, c1, c2) curve from `frame_cost_curve` (the
    measured quadratic model — use this for absolute numbers and tail-heavy
    ranking) or a scalar per-frame price (the legacy linear model).
    tok_ms: optional per-request token-cost delta (token_cost_ms) — a
    constant offset for absolute reporting, never affects ranking.
    top_pass_ms: None (the port's switch) prices an overflow at its exact
    bucket alone; a number prices it as JAX's model does, a wasted pass at
    the top bucket plus this many ms of host sync before the exact one."""
    lengths = np.asarray(lengths, np.float64)
    win = np.asarray(sorted(int(b) for b in window), np.int64)
    top = int(win[-1])
    need = _needs(lengths, num_down)
    over = need > top
    # in-window: smallest branch >= need (choose_bucket semantics)
    in_b = win[np.minimum(np.searchsorted(win, need), len(win) - 1)]
    in_cost = _proc_ms(in_b, per_frame_ms) + tok_ms
    # overflow: the exact-path fallback at the global-ladder bucket (beyond
    # the ladder, choose_bucket falls back to the rounded length itself)
    lad = np.asarray(ladder, np.int64)
    fb = np.where(
        need > lad[-1], need,
        lad[np.minimum(np.searchsorted(lad, need), len(lad) - 1)],
    )
    ov_cost = _proc_ms(fb, per_frame_ms) + tok_ms
    wasted = 0
    if top_pass_ms is not None:
        # JAX's model: a wasted padded sampler run at the top branch first
        # (the fallback re-runs the whole pipeline, so the token delta, like
        # the encoder cost inside c0, is paid once per dispatch)
        ov_cost = _proc_ms(top, per_frame_ms) + float(top_pass_ms) + _proc_ms(
            fb, per_frame_ms) + 2.0 * tok_ms
        wasted = top
    cost = np.where(over, ov_cost, in_cost)
    # a wasted top-bucket run counts as padding waste
    padded = np.where(over, wasted + fb, in_b).astype(np.float64)
    waste = float(padded.sum() / lengths.sum() - 1.0)
    return {
        "window": [int(b) for b in win],
        "branches": len(win),
        "overflow_pct": round(100.0 * float(over.mean()), 2),
        "padding_waste_pct": round(100.0 * waste, 2),
        "mean_proc_ms": round(float(cost.mean()), 2),
        "p95_proc_ms": round(float(np.percentile(cost, 95)), 2),
    }


def enumerate_windows(
    lengths: np.ndarray,
    ladder: Sequence[int],
    max_branches: int,
    num_down: int = 3,
) -> List[Tuple[int, ...]]:
    """Candidate windows: every ascending subset of 1..max_branches ladder
    buckets within the traffic's span whose top covers at least the traffic
    median (narrower tops drown in overflow). Windows need NOT be
    contiguous ladder spans — the switch accepts any ascending bucket
    tuple, and on bimodal traffic {short-bucket, tail-bucket} beats every
    contiguous span. The span pruning (no branch below the smallest
    request's bucket — it would never be chosen — and at most one ladder
    step of headroom past the largest) keeps the subset count ~1e3 for a
    typical 20-bucket traffic span at max_branches=3."""
    from itertools import combinations

    need = _needs(lengths, num_down)
    med = int(_needs([float(np.median(lengths))], num_down)[0])
    lo, hi = int(need.min()), int(need.max())
    cands = [int(b) for b in ladder if b >= lo]
    n_cover = sum(1 for b in cands if b < hi) + 1  # first bucket >= hi ...
    cands = cands[: n_cover + 1]  # ... plus one ladder step of headroom
    out: List[Tuple[int, ...]] = []
    for n in range(1, max_branches + 1):
        for c in combinations(cands, n):
            if c[-1] >= med:
                out.append(c)
    return out


def candidate_windows(
    lengths: np.ndarray,
    ladder: Sequence[int],
    max_branches: int,
    num_down: int = 3,
    top_pass_ms=None,
) -> List[Tuple[int, ...]]:
    """The windows a cost policy chooses among: enumerate_windows, and with
    the port's price of an overflow (top_pass_ms None) only those that hold
    every observed length, where the ladder has such a bucket. At that
    price an overflow costs no more than its exact bucket, which would make
    leaving traffic outside the window look free; but an overflow runs a
    bucket the warm-up did not (cold, and refused under strict_grid)."""
    cands = enumerate_windows(lengths, ladder, max_branches, num_down)
    if top_pass_ms is None:
        cover = int(_needs(lengths, num_down).max())
        cands = [w for w in cands if w[-1] >= cover] or cands
    return cands


def optimal_window(
    lengths: Sequence[float],
    ladder: Sequence[int],
    per_frame_ms,
    max_branches: int = 3,
    num_down: int = 3,
    headroom: int = 0,
    top_pass_ms=None,
) -> Tuple[Tuple[int, ...], Dict[str, object]]:
    """The ascending bucket subset (<= max_branches branches, see
    enumerate_windows) minimizing expected per-request cost on the
    observed `lengths`. Returns (window, cost_row). ~1e3 candidates x one
    vectorized cost pass each — sub-second at serving startup.
    `per_frame_ms`: a frame_cost_curve tuple (preferred — the measured
    quadratic model prices tail branches correctly) or a legacy scalar.

    headroom: EXTRA ladder steps appended above the optimal top (the
    serving policies pass 1). The optimum is fit to observed traffic only;
    an unseen length one frame past the top pays the overflow penalty,
    while an insurance branch costs warm-up time and never increases any
    observed request's cost (it can only convert observed overflow into
    in-window padding). Branch count may thus reach max_branches +
    headroom.

    top_pass_ms: the overflow's price, as in window_cost; the candidates
    are candidate_windows'."""
    lengths = np.asarray(lengths, np.float64)
    if lengths.size == 0:
        raise ValueError("optimal_window needs at least one observed length")
    cands = candidate_windows(lengths, ladder, max_branches, num_down, top_pass_ms)
    best_w: Tuple[int, ...] | None = None
    best_row: Dict[str, object] | None = None
    for w in cands:
        row = window_cost(lengths, w, per_frame_ms, ladder, num_down,
                          top_pass_ms=top_pass_ms)
        if best_row is None or row["mean_proc_ms"] < best_row["mean_proc_ms"]:
            best_w, best_row = w, row
    assert best_w is not None and best_row is not None
    if headroom > 0:
        above = [int(b) for b in ladder if b > best_w[-1]][:headroom]
        if above:
            best_w = best_w + tuple(above)
            best_row = window_cost(lengths, best_w, per_frame_ms, ladder,
                                   num_down, top_pass_ms=top_pass_ms)
    return best_w, best_row
