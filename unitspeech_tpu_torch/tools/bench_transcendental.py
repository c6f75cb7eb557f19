"""The cost of one elementwise op on the card (P1): the port's counterpart
of tools/bench_transcendental.py. For each body of ops/probes.BODIES it
times the kernel that applies k0 and k rounds of acc = body(acc) * 0.5 + x
to a (rows, 128) f32 array (reps interleaved across the bodies, so that
drift of the card hits all alike) and reports the difference per element
and round:

    python -m unitspeech_tpu_torch.tools.bench_transcendental [--rows 4096] [--k 64]
        [--k0 8] [--reps 7] [--variants mul,jnp_sin,...] [--device cuda]

ms is the median of (t_k - t_k0), each one call's device time under CUDA
events (tools.median_ms); ps/elem divides it by
rows * 128 * (k - k0); ops/elem converts that time into instruction slots
of the card's f32 lanes at its maximum SM clock (SMs x 128 lanes, the
clock from nvidia-smi): the count of f32 lane operations one application
costs. The JAX tool counted TPU lane-ops at the TPU's clock; the number
here is the card's own. The last column is the kernel's largest
difference from its plain version at k rounds.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from unitspeech_tpu_torch.ops.probes import (
    BODIES,
    transcendental_chain,
    transcendental_chain_plain,
)
from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device


def lane_rate(device) -> tuple:
    """(f32 lanes, maximum SM clock in Hz) of the card."""
    lanes = torch.cuda.get_device_properties(device).multi_processor_count * 128
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return lanes, float(mhz) * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("bench_transcendental")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--k0", type=int, default=8)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--variants", default=",".join(BODIES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [v for v in args.variants.split(",") if v]
    lanes, clock = lane_rate(dev) if dev.type == "cuda" else (None, None)
    clock_txt = f"{lanes} f32 lanes at {clock / 1e9:.3f} GHz" if lanes else "no card"
    print(f"{device_line(dev)}; rows={args.rows} k={args.k0}->{args.k}; {clock_txt}", flush=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((args.rows, 128))
                         .astype(np.float32)).to(dev)
    for name in names:  # build, load and warm every variant
        transcendental_chain(x, args.k0, name)
        transcendental_chain(x, args.k, name)
    times = {n: [] for n in names}
    for _ in range(args.reps):
        for name in names:
            lo = median_ms(lambda: transcendental_chain(x, args.k0, name), dev, 1, 0)
            hi = median_ms(lambda: transcendental_chain(x, args.k, name), dev, 1, 0)
            times[name].append(hi - lo)
    n_el = args.rows * 128 * (args.k - args.k0)
    out = {}
    for name in names:
        dt_ms = float(statistics.median(times[name]))
        err = (transcendental_chain(x, args.k, name)
               - transcendental_chain_plain(x, args.k, name)).abs().max().item()
        ps = dt_ms * 1e-3 / n_el * 1e12
        ops = dt_ms * 1e-3 / n_el * clock * lanes if lanes else None
        ops_txt = f"{ops:8.2f} ops/elem" if ops is not None else "   (no card)"
        print(f"{name:10s} {dt_ms:8.4f} ms  {ps:8.3f} ps/elem  {ops_txt}  "
              f"max|kernel - plain| {err:.3e}", flush=True)
        out[name] = {"ms": dt_ms, "ps_per_elem": ps, "ops_per_elem": ops, "max_abs_err": err}
    return out


if __name__ == "__main__":
    main()
