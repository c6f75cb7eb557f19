"""Offline bucket-window analysis of a traffic's length distribution on the
card's cost model (counterpart of the root tools/analyze_buckets.py).

The serving daemon pads every request onto a frame-bucket window
(`Synthesizer.make_switch_buckets`); this tool prices candidate windows
against your own traffic with the port's cost model (infer/bucket_cost.py,
its constants measured on the card: infer/cost_anchors_h100.json, each a
request of a forced batch of the anchors' batch size):

  proc(request)  = curve(padded_frames) + tok_ms        (in window)
  proc(overflow) = curve(ladder(L)) + tok_ms            (exact bucket)

with curve(b) = c0 + c1*b + c2*b^2 the measured curve of the sampler mode.
The port's switch brings the predicted lengths to the host before it
samples, so an overflow runs its exact bucket alone (no wasted top pass,
no extra sync: the JAX model's price); the ranked windows are therefore
those that hold every observed length (bucket_cost.candidate_windows).

Input lengths (mel frames per request), one of:
  --lengths FILE      one frame count per line (or a JSON list)
  --stats FILE        a `cli serve` /stats snapshot (recent_frames)
  --seconds FILE      speech seconds per line (converted via hop/sr)
  --filelist FILE     `path|transcript|spk` lines: tokens x --frames-per-token

    python -m unitspeech_tpu_torch.tools.analyze_buckets --lengths frames.txt \\
        --preset dpm2_16_cs2 --max-branches 3 --top 8 [--json] [--out FILE]

Host-side numpy only: no device is used; the JSON's `card` names the card
the prices were measured on. `--out` writes the JSON (no default file).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from unitspeech_tpu_torch.infer.bucket_cost import (
    anchors,
    candidate_windows,
    frame_cost_curve,
    quantile_window,
    token_cost_ms,
    window_cost,
)
from unitspeech_tpu_torch.ops.masking import choose_bucket, default_frame_buckets

# preset name -> the (sampler, steps) spec frame_cost_curve understands
PRESET_SPECS = {
    "ddpm50": ("ddpm", 50),
    "dpm2_25": ("dpm2", 25),
    "dpm2_16": ("dpm2", 16),
    "dpm2_16_cs2": ("dpm2:cs2", 16),
}
# the Synthesizer's default encoder-side padding ladder (infer/tts.py)
TOKEN_LADDER = tuple(2 ** i for i in range(4, 11))
# the serving daemon's quantile heuristic (make_switch_buckets policy="quantile")
policy_window = quantile_window


def add_traffic_flags(ap: argparse.ArgumentParser):
    """The traffic inputs this tool and capacity_plan share."""
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--lengths", help="frame counts, one per line or JSON")
    src.add_argument("--stats", help="`cli serve` /stats snapshot (JSON file)")
    src.add_argument("--seconds", help="speech seconds, one per line")
    src.add_argument("--filelist", help="reference-format filelist (path|transcript|spk): "
                                        "transcripts are phonemized and frames modeled as "
                                        "tokens * --frames-per-token")
    ap.add_argument("--language", default="en-us", help="phonemizer language for --filelist")
    ap.add_argument("--frames-per-token", type=float, default=2.46,
                    help="linear frames~tokens surrogate for --filelist (2.46 = the published "
                         "model's 344 frames / 140 tokens operating point, BASELINE.md)")
    ap.add_argument("--ladder-max", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--sr", type=int, default=22050)


def load_lengths(args) -> np.ndarray:
    """Mel frames per request from the traffic flag that is set."""
    if args.stats:
        with open(args.stats) as f:
            frames = json.load(f).get("recent_frames")
        if not frames:
            raise SystemExit("stats snapshot has no recent_frames (no traffic yet)")
        return np.asarray(frames, np.float64)
    if args.filelist:
        # the transcripts' token counts (espeak if present, else the rule
        # G2P) times a linear frames-per-token surrogate, the calibrator's
        # own: enough for window ranking, which needs the distribution's shape
        from unitspeech_tpu_torch import text as text_frontend

        ph = text_frontend.get_phonemizer(args.language, fallback=True)
        if ph is None:
            raise SystemExit(f"no phonemizer/G2P for {args.language!r}")
        toks = []
        with open(args.filelist, encoding="utf-8") as f:
            for ln in f:
                parts = ln.rstrip("\n").split("|")
                if len(parts) >= 2 and parts[1].strip():
                    toks.append(len(text_frontend.text_to_sequence(parts[1], ph)))
        if not toks:
            raise SystemExit("filelist has no 'path|transcript' lines")
        return np.asarray(toks, np.float64) * args.frames_per_token
    with open(args.lengths or args.seconds) as f:
        text = f.read().strip()
    if text.startswith("["):
        vals = np.asarray(json.loads(text), np.float64)
    else:
        vals = np.asarray([float(x) for x in text.split()], np.float64)
    if args.seconds:
        vals = vals * args.sr / args.hop
    return vals


def load_tokens(args):
    """Served token counts a request (a /stats snapshot's recent_tokens), or
    None for the other inputs."""
    if args.stats:
        with open(args.stats) as f:
            toks = json.load(f).get("recent_tokens")
        if toks:
            return np.asarray(toks, np.float64)
    return None


def served_tok_ms(tok_counts) -> float:
    """Mean encoder cost delta of the served token counts at their buckets."""
    return float(np.mean([token_cost_ms(choose_bucket(int(t), TOKEN_LADDER))
                          for t in tok_counts]))


def analyze(lengths, tok_counts=None, preset="ddpm50", per_frame_ms=None, tok_bucket=256,
            max_branches=3, ladder_max=4096, hop=256, sr=22050, top_pass_ms=None):
    """(result, rows): every candidate window's cost row sorted by mean ms,
    the best and the quantile policy's with their expected RTF.
    per_frame_ms: a flat per-frame price in place of the preset's curve
    (the legacy linear model, no token term); tok_counts: served token
    counts, whose mean token cost replaces tok_bucket's. top_pass_ms prices
    an overflow as JAX's model does (window_cost); None is the port's rule."""
    lengths = np.asarray(lengths, np.float64)
    cost = per_frame_ms or frame_cost_curve(*PRESET_SPECS[preset])
    tok_ms = 0.0
    if per_frame_ms is None:
        tok_ms = served_tok_ms(tok_counts) if tok_counts is not None else token_cost_ms(
            tok_bucket)
    ladder = default_frame_buckets(ladder_max)
    rows = [window_cost(lengths, w, cost, ladder, tok_ms=tok_ms, top_pass_ms=top_pass_ms)
            for w in candidate_windows(lengths, ladder, max_branches, top_pass_ms=top_pass_ms)]
    rows.sort(key=lambda r: r["mean_proc_ms"])
    pol = policy_window(lengths, ladder, max_branches=max_branches)
    pol_row = window_cost(lengths, pol, cost, ladder, tok_ms=tok_ms, top_pass_ms=top_pass_ms)
    speech_ms = float(lengths.mean()) * hop / sr * 1000.0
    result = {
        "n_requests": int(len(lengths)),
        "frames_p50": float(np.median(lengths)),
        "frames_p95": float(np.percentile(lengths, 95)),
        "preset": preset,
        "per_frame_ms": cost,
        "best": {**rows[0], "expected_rtf": round(rows[0]["mean_proc_ms"] / speech_ms, 4)},
        "policy": {**pol_row, "expected_rtf": round(pol_row["mean_proc_ms"] / speech_ms, 4)},
        "policy_gap_pct": round(100.0 * (pol_row["mean_proc_ms"] / rows[0]["mean_proc_ms"]
                                         - 1.0), 2),
    }
    return result, rows


def _row_line(r, speech_ms, mark=""):
    return (f"{str(r['window']):>28} {r['overflow_pct']:>6} {r['padding_waste_pct']:>7} "
            f"{r['mean_proc_ms']:>8} {r['p95_proc_ms']:>8} "
            f"{r['mean_proc_ms'] / speech_ms:>7.4f}{mark}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.analyze_buckets",
                                 description=__doc__.split("\n")[0])
    add_traffic_flags(ap)
    ap.add_argument("--preset", default="ddpm50", choices=sorted(PRESET_SPECS),
                    help="sampler mode (selects the measured cost curve)")
    ap.add_argument("--per-frame-ms", type=float, default=None,
                    help="a flat per-padded-frame price instead (the legacy linear model)")
    ap.add_argument("--tok-bucket", type=int, default=256,
                    help="typical token bucket of the traffic: shifts absolute costs by the "
                         "measured token curve (never the ranking)")
    ap.add_argument("--max-branches", type=int, default=3,
                    help="window branch budget (warm-up time scales with it)")
    ap.add_argument("--top", type=int, default=8, help="rows to print")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    lengths = load_lengths(args)
    result, rows = analyze(lengths, load_tokens(args), args.preset, args.per_frame_ms,
                           args.tok_bucket, args.max_branches, args.ladder_max, args.hop,
                           args.sr)
    result["card"] = anchors()["card"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.json:
        print(json.dumps(result))
        return result

    speech_ms = float(lengths.mean()) * args.hop / args.sr * 1000.0
    cost = result["per_frame_ms"]
    cost_desc = (f"{cost} ms/frame linear" if args.per_frame_ms else
                 "measured quadratic curve " + str(tuple(round(c, 5) for c in cost)))
    print(f"{len(lengths)} requests | frames p50 {result['frames_p50']:.0f} p95 "
          f"{result['frames_p95']:.0f} max {lengths.max():.0f} | preset {args.preset} "
          f"({cost_desc}; {result['card']})")
    print(f"{'window':>28} {'ovfl%':>6} {'waste%':>7} {'mean ms':>8} {'p95 ms':>8} {'RTF':>7}")
    pol = result["policy"]["window"]
    for r in rows[:args.top]:
        print(_row_line(r, speech_ms, " <- quantile" if r["window"] == pol else ""))
    if pol not in [r["window"] for r in rows[:args.top]]:
        print(_row_line(result["policy"], speech_ms, " <- quantile"))
    print(f"the quantile heuristic's window {pol} is within {result['policy_gap_pct']}% of the "
          "best enumerated window (the serving default, policy='cost', picks the best)")
    return result


if __name__ == "__main__":
    main()
