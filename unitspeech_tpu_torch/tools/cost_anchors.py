"""Measure the serving cost model's anchors on the card and fit its curves
(counterpart of the root tools/cost_anchors.py and tools/refit_cost_model.py):

  * a frame sweep at token bucket 256 (140 tokens): a forced batch of
    BATCH requests, the batch the server fills (`Synthesizer._single_dispatch`
    with forced durations: the token axis padded to its bucket, encode ->
    sample -> vocode at an exact frame bucket, then the waveforms on the
    host) at frames 216 / 344 / 696 / 1256, for ddpm@50 and the fast mode
    dpm2:cs2@16;
  * a token sweep at 344 frames: token buckets 64 (48 tokens) and 1024
    (600 tokens), dpm2:cs2@16;
  * the per-request floor `fixed_ms`: ddpm@1 at 344 frames, token bucket 256.

Each point is the median wall time of `--repeats` batches after one warm
batch, divided by the batch size: the cost of a request in a full batch
(one request alone is host-bound on the H100, its time nearly flat in the
frames; at 8 rows the device is busy). The fits are the JAX refit's (`fit`): the token curve
t1*tok + t2*tok^2 from the three token points, an LSQ quadratic
c0 + c1*b + c2*b^2 over dpm2:cs2@16's frame points, and ddpm@50 on that
curve's shape (scale and offset from its first and last points). The file
names the card and its power limit (nvidia-smi), the routes and the script;
infer/bucket_cost.py reads it.

    python -m unitspeech_tpu_torch.tools.cost_anchors [--repeats 5] [--out FILE]
    python -m unitspeech_tpu_torch.tools.cost_anchors --device cpu --small   # smoke run
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import device_line, resolve_device

FRAMES = (216, 344, 696, 1256)
MODES = (("dpm2:cs2", 16), ("ddpm", 50))
# (n_tok, token bucket): 140 tokens pad to 256, the frame curves' anchor
TOKENS = ((48, 64), (140, 256), (600, 1024))
TOK_REF, TOK_FRAMES = 256, 344
BATCH = 8  # requests a forced batch: `cli serve`'s default --max-batch
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "infer", "cost_anchors_h100.json")


def _mode_name(sampler: str, steps: int) -> str:
    """ddpm@50 -> "ddpm50", dpm2@16 -> "dpm2_16", dpm2:cs2@16 -> "dpm2_16_cs2"."""
    base, _, cs = sampler.partition(":cs")
    if base == "ddpm" and not cs:
        return f"ddpm{steps}"
    return f"{base}_{steps}" + (f"_cs{cs}" if cs else "")


def _rows(data, sampler, steps, tok_ref=256):
    """Frame-sweep (frames, ms) points of one mode at the reference token
    bucket; where a recheck row exists for a frame count, the original is
    kept only if the two agree within 10%."""
    orig, rech = {}, {}
    for r in data["rows"]:
        if (r["sampler"], r["steps"], r["tok_bucket"]) == (sampler, steps, tok_ref):
            (rech if r.get("recheck") else orig)[r["frames"]] = r["ms"]
    pts = [(b, ms) for b, ms in sorted(orig.items())
           if not (b in rech and abs(ms / rech[b] - 1.0) > 0.10)]
    pts.extend(sorted(rech.items()))
    return sorted(pts)


def fit(data, production=None, tok_ref=TOK_REF, tok_frames=TOK_FRAMES):
    """(curves {name: (c0, c1, c2)}, (t1, t2), info) from measured rows,
    the JAX refit's method: the token curve from the production mode's
    three token points at tok_frames, an LSQ quadratic over its frame
    sweep at token bucket tok_ref, every other mode on that shape (offset
    and scale from its first and last frame points). production: (sampler,
    steps), by default the one mode with token points."""
    production = production or next((r["sampler"], r["steps"]) for r in data["rows"]
                                     if r["tok_bucket"] != tok_ref)
    tok = {r["tok_bucket"]: r["ms"] for r in data["rows"]
           if (r["sampler"], r["steps"]) == production and r["frames"] == tok_frames
           and not r.get("recheck")}
    toks = sorted(tok)
    if len(toks) < 3:
        raise ValueError(f"need 3 token points, have {toks}")
    a, b, c = toks[:3]
    s1 = (tok[b] - tok[a]) / (b - a)  # = t1 + t2*(a+b)
    s2 = (tok[c] - tok[b]) / (c - b)  # = t1 + t2*(b+c)
    t2 = (s2 - s1) / (c - a)
    t1 = s1 - t2 * (a + b)

    pts = _rows(data, *production, tok_ref=tok_ref)
    if len(pts) < 3:
        raise ValueError(f"need 3 frame points, have {pts}")
    bs = np.array([p[0] for p in pts], np.float64)
    ys = np.array([p[1] for p in pts], np.float64)
    c0, c1, c2 = np.linalg.lstsq(np.stack([np.ones_like(bs), bs, bs * bs], axis=1), ys,
                                 rcond=None)[0]
    curves = {_mode_name(*production): (float(c0), float(c1), float(c2))}
    scales, mode_pts = {}, {_mode_name(*production): pts}
    for sampler, steps in sorted({(r["sampler"], r["steps"]) for r in data["rows"]}
                                 - {tuple(production)}):
        mp = _rows(data, sampler, steps, tok_ref=tok_ref)
        if len(mp) < 2:
            raise ValueError(f"need 2 points for {sampler}@{steps}: {mp}")
        (b1, y1), (b2, y2) = mp[0], mp[-1]
        f1, f2 = c1 * b1 + c2 * b1 * b1, c1 * b2 + c2 * b2 * b2
        s = (y2 - y1) / (f2 - f1)
        name = _mode_name(sampler, steps)
        curves[name] = (float(y1 - s * f1), float(s * c1), float(s * c2))
        scales[name] = float(s)
        mode_pts[name] = mp
    return curves, (float(t1), float(t2)), {"scales": scales, "mode_pts": mode_pts,
                                            "tok_pts": sorted(tok.items())}


def time_point(synth, n_tok, frames, sampler, steps, repeats, batch=1):
    """(median wall ms a request, every repeat's ms a request, token
    bucket) of a forced batch of `batch` copies of one request: n_tok
    tokens (seeded) padded to their token bucket, forced durations summing
    to `frames` (an exact frame bucket), the waveforms copied to the host;
    one warm batch first."""
    from unitspeech_tpu_torch.infer.tts import forced_durations

    dev = synth.models.device
    rng = np.random.default_rng(0)
    toks = [int(t) for t in rng.integers(1, synth.models.cfg.text_encoder.n_vocab - 1, n_tok)]
    tokens, lengths = synth._pack([toks] * batch)
    w = np.zeros(tokens.shape, np.float32)
    w[:, :n_tok] = forced_durations(n_tok, frames)

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = synth._single_dispatch(tokens, lengths, w, frames, gen, steps, 1.0, 1.0, 1.0,
                                   sampler)
        return d.wav.cpu()

    run(99)
    times = []
    for i in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(i)
        times.append((time.perf_counter() - t0) * 1e3 / batch)
    return float(np.median(times)), times, tokens.shape[1]


def measure(synth, repeats, frames=FRAMES, modes=MODES, tokens=TOKENS, tok_ref=TOK_REF,
            tok_frames=TOK_FRAMES, batch=BATCH, log=print):
    """The anchor rows and the floor, each in ms a request of a forced
    batch of `batch`: {"rows": [...], "fixed_ms": ms, "batch": batch}.
    tokens: (n_tok, token bucket) pairs, one of them at tok_ref."""
    rows = []

    def point(sampler, steps, n_tok, tb, f):
        ms, all_ms, got = time_point(synth, n_tok, f, sampler, steps, repeats, batch)
        if got != tb:
            raise ValueError(f"{n_tok} tokens pad to {got}, not {tb}")
        rows.append({"sampler": sampler, "steps": steps, "tok_bucket": tb, "frames": f,
                     "ms": ms, "all_ms": all_ms})
        log(f"  {sampler}@{steps} tok{tb} f{f}: {ms:.1f} ms (" +
            " ".join(f"{t:.1f}" for t in all_ms) + ")")

    n_ref, tb_ref = next(t for t in tokens if t[1] == tok_ref)
    for sampler, steps in modes:
        for f in frames:
            point(sampler, steps, n_ref, tb_ref, f)
    for n_tok, tb in tokens:
        if tb != tb_ref:
            point(*modes[0], n_tok, tb, tok_frames)
    fixed, fixed_all, _ = time_point(synth, n_ref, tok_frames, "ddpm", 1, repeats, batch)
    log(f"  fixed (ddpm@1 tok{tb_ref} f{tok_frames}): {fixed:.1f} ms")
    return {"rows": rows, "fixed_ms": fixed, "fixed_all_ms": fixed_all, "tok_ref": tok_ref,
            "tok_frames": tok_frames, "batch": batch}


def anchors_file(meas: dict, card: str, routes: dict, repeats: int):
    """The file infer/bucket_cost.py reads: the rows, the fits, each fitted
    mode's legacy per-frame price (ms at tok_frames - fixed_ms) / tok_frames,
    and the fit residuals."""
    tok_frames = meas["tok_frames"]
    curves, token_curve, info = fit(meas, tok_ref=meas["tok_ref"], tok_frames=tok_frames)
    modes = {}
    for name, curve in curves.items():
        pts = info["mode_pts"][name]
        row = next(r for r in meas["rows"] if _mode_name(r["sampler"], r["steps"]) == name)
        at = dict(pts)[tok_frames] if tok_frames in dict(pts) else float(np.polyval(
            curve[::-1], tok_frames))
        modes[name] = {
            "sampler": row["sampler"].partition(":cs")[0],
            "stride": int(row["sampler"].partition(":cs")[2] or 1), "steps": row["steps"],
            "curve": list(curve), "per_frame_ms": (at - meas["fixed_ms"]) / tok_frames,
            "residual_pct": {str(b): 100.0 * ((curve[0] + curve[1] * b + curve[2] * b * b)
                                              / y - 1.0) for b, y in pts}}
    return {"card": card, "script": "python -m unitspeech_tpu_torch.tools.cost_anchors",
            "routes": routes, "repeats": repeats, "batch": meas["batch"], "tok_ref": meas["tok_ref"],
            "tok_frames": tok_frames, "fixed_ms": meas["fixed_ms"],
            "fixed_all_ms": meas["fixed_all_ms"], "token_curve": list(token_curve),
            "modes": modes, "rows": meas["rows"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.cost_anchors")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="the port's combined checkpoint (default: random full-width "
                         "weights, seed 0)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help=f"where to write the file (default: {DEFAULT_OUT} on the card; "
                         "nothing on the CPU)")
    ap.add_argument("--small", action="store_true",
                    help="a tiny config and sweep (a smoke run of the tool on the CPU)")
    args = ap.parse_args(argv)
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.params import random_params

    dev = resolve_device(args.device)
    routes = dict(use_kernels=True, use_int8_deep=True)  # the serving default
    if args.checkpoint:
        ckpt = artifacts.read(args.checkpoint)
    else:
        ckpt = random_params(_small_config() if args.small else MainConfig(), 0)
    synth = Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, **routes))
    card = device_line(dev)
    print(f"serving cost anchors on {card} (int8 default, bf16, dual CFG 1.0/1.0; ms a "
          f"request of a batch of {BATCH}):", flush=True)
    if args.small:
        meas = measure(synth, args.repeats, frames=(16, 24, 32), modes=(("dpm2:cs2", 2),
                       ("ddpm", 3)), tokens=((3, 16), (20, 32), (40, 64)), tok_ref=32,
                       tok_frames=24, log=lambda s: print(s, flush=True))
    else:
        meas = measure(synth, args.repeats, log=lambda s: print(s, flush=True))
    out = anchors_file(meas, card, routes, args.repeats)
    for name, m in out["modes"].items():
        print(f"  {name}: c0 {m['curve'][0]:.2f} c1 {m['curve'][1]:.5f} c2 {m['curve'][2]:.3e}"
              f", per frame {m['per_frame_ms']:.4f} ms; residuals " + ", ".join(
                  f"f{b} {r:+.1f}%" for b, r in m["residual_pct"].items()), flush=True)
    print(f"  token curve t1 {out['token_curve'][0]:.5f} t2 {out['token_curve'][1]:.3e}; "
          f"fixed {out['fixed_ms']:.1f} ms", flush=True)
    path = args.out or (DEFAULT_OUT if dev.type == "cuda" else None)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}", flush=True)
    return out


def _small_config():
    """A tiny config for the CPU smoke run (the tests' widths)."""
    from unitspeech_tpu_torch.config import config_from_dict

    return config_from_dict({
        "data": {"n_feats": 16, "hop_length": 4},
        "text_encoder": {"n_vocab": 180, "n_feats": 16, "n_channels": 16, "filter_channels": 32,
                         "n_layers": 1, "n_heads": 2},
        "duration_predictor": {"in_channels": 16, "filter_channels": 16, "spk_emb_dim": 8},
        "decoder": {"n_feats": 16, "dim": 8, "dim_mults": [1, 2], "groups": 4,
                    "spk_emb_dim": 8},
        "vocoder": {"num_mels": 16, "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]}})


if __name__ == "__main__":
    main()
    sys.exit(0)
