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
here is the card's own. Beside it: call_ms, one whole call at k rounds
(the time chip_smoke.py reports), and its least times: by operations
(probes.ROUND_OPS per round over 67 T f32 op/s, a transcendental counting
one) and by bytes (one read and one write of the array over 3.35 TB/s).
The last column is the kernel's largest difference from its plain version
at k rounds; the floor line is one empty kernel under the same timing.

On the card it also reads the built library with the toolkit's
cuobjdump: for each body the instructions of one round (the round loop's
instructions over its rounds, the loop found as a backward branch in the
kernel's SASS and its rounds counted by the chain's multiply by 0.5; code
a branch jumps over is left out where it holds a loop, as the accurate
sinf's reduction of large arguments does), by
pipe: FP32 (FADD, FMUL, FFMA, FMNMX, FSETP, FSEL, FSET, FCHK), MUFU and
conversions (MUFU, F2I, I2F, FRND, F2F: 16 lanes an SM), and the rest
(integer and moves), the kernel's registers, and the issue-slot least
time: rows * 128 * k rounds of the larger of (FP32 + rest) / (SMs x 128 x
clock) and (MUFU + conversions) / (SMs x 16 x clock). A multiply and an
add that must not contract take two issue slots where one FMA counts two
operations, so this bound sits above the operations bound.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from unitspeech_tpu_torch.ops.probes import (
    BODIES,
    ROUND_OPS,
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


F32_PEAK, BYTES_PEAK = 67e12, 3.35e12  # H100 SXM: f32 op/s outside the tensor cores, HBM B/s
FP32_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"}
SLOW_OPS = {"MUFU", "F2I", "I2F", "FRND", "F2F"}  # 16 lanes an SM
CONTROL_OPS = {"BRA", "EXIT", "NOP", "BSSY", "BSYNC", "RET", "CALL", "WARPSYNC", "BAR"}
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\s*$")


def parse_sass(text: str) -> dict:
    """cuobjdump -sass text -> {function name: [(address, opcode,
    operands, branch target address or None)]}; a branch's target is an
    address or a label (`.L_x_N:` lines, resolved to the next address)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur, labels, pending = funcs.setdefault(m.group(1), []), {}, []
            funcs[m.group(1) + "@labels"] = labels
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append((addr, m.group(3), m.group(4)))
    out = {}
    for name, instrs in funcs.items():
        if name.endswith("@labels"):
            continue
        labels = funcs[name + "@labels"]
        rows = []
        for addr, op, args in instrs:
            m = _TARGET.search(args) if op.split(".")[0] == "BRA" else None
            target = None
            if m:
                target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            rows.append((addr, op, args, target))
        out[name] = rows
    return out


def _is_round_marker(op: str, args: str) -> bool:
    """The chain's multiply by 0.5, one an element and round: an FMUL by the
    immediate 0.5, or FMUL.D2 where the compiler folded it into the body's
    last multiply (expf's scale)."""
    return op == "FMUL.D2" or (op.split(".")[0] == "FMUL"
                               and re.search(r",\s*0\.5\s*$", args) is not None)


def round_counts(instrs) -> dict:
    """The instructions of one round of a chain kernel, on its common path:
    code a forward branch jumps over is left out where it holds a loop of
    its own (the accurate sinf's reduction of large arguments, which these
    inputs never reach). Among the innermost remaining loops (a backward
    branch and the instructions from its target on) the one with the most
    rounds (_is_round_marker) is the round loop; its instructions by class
    over its rounds."""
    loops = [(t, a) for a, _, _, t in instrs if t is not None and t <= a]
    best = None
    for a, b in loops:
        # forward branches inside this loop over a loop: their insides are skipped
        skips = [(x, t) for x, _, _, t in instrs if t is not None and a <= x < t <= b
                 and any(x < la and lb < t for la, lb in loops)]

        def live(addr, skips=skips):
            return not any(x < addr < y for x, y in skips)

        if any(a <= c and d <= b and (c, d) != (a, b) and live(d) for c, d in loops):
            continue  # not innermost
        body = [(op, args) for addr, op, args, _ in instrs if a <= addr <= b and live(addr)]
        rounds = sum(_is_round_marker(op, args) for op, args in body)
        if rounds and (best is None or rounds > best[0]):
            best = (rounds, body)
    if best is None:
        return {}
    rounds, body = best
    cls = {"fp32": 0, "mufu_conv": 0, "other": 0}
    for op, _ in body:
        base = op.split(".")[0]
        if base in CONTROL_OPS and base != "BRA":
            continue
        key = "fp32" if base in FP32_OPS else "mufu_conv" if base in SLOW_OPS else "other"
        cls[key] += 1
    return {"rounds_in_loop": rounds, **{k: v / rounds for k, v in cls.items()}}


def sass_counts() -> dict:
    """{body: {fp32, mufu_conv, other (instructions a round), rounds_in_loop,
    registers}} from the built kernel library (cuobjdump from the CUDA
    toolkit that built it)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from unitspeech_tpu_torch.ops import _cuda

    lib = str(_cuda.build())
    tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    sass = parse_sass(subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                                     check=True).stdout)
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    regs = dict(re.findall(r"Function (\S+):\s*\n\s*REG:(\d+)", res))
    names = list(BODIES)
    out = {}
    for fn, instrs in sass.items():
        m = re.search(r"chainILi(\d+)E", fn)
        if m and int(m.group(1)) < len(names):
            out[names[int(m.group(1))]] = {**round_counts(instrs),
                                           "registers": int(regs.get(fn, -1))}
    return out


def issue_ms(counts: dict, n_round_elems: float, sms: int, clock: float) -> float:
    """The issue-slot least time of n_round_elems element rounds."""
    wide = (counts["fp32"] + counts["other"]) / (sms * 128 * clock)
    narrow = counts["mufu_conv"] / (sms * 16 * clock)
    return max(wide, narrow) * n_round_elems * 1e3


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
    calls = {n: [] for n in names}
    for _ in range(args.reps):
        for name in names:
            lo = median_ms(lambda: transcendental_chain(x, args.k0, name), dev, 1, 0)
            hi = median_ms(lambda: transcendental_chain(x, args.k, name), dev, 1, 0)
            times[name].append(hi - lo)
            calls[name].append(hi)
    sass = sass_counts() if dev.type == "cuda" else {}
    floor = median_ms(lambda: torch.cuda._sleep(1), dev) if dev.type == "cuda" else None
    n_el = args.rows * 128 * (args.k - args.k0)
    n_all = args.rows * 128 * args.k
    out = {}
    for name in names:
        dt_ms = float(statistics.median(times[name]))
        call_ms = float(statistics.median(calls[name]))
        err = (transcendental_chain(x, args.k, name)
               - transcendental_chain_plain(x, args.k, name)).abs().max().item()
        ps = dt_ms * 1e-3 / n_el * 1e12
        ops = dt_ms * 1e-3 / n_el * clock * lanes if lanes else None
        ops_txt = f"{ops:8.2f} ops/elem" if ops is not None else "   (no card)"
        rec = {"ms": dt_ms, "ps_per_elem": ps, "ops_per_elem": ops, "max_abs_err": err,
               "call_ms": call_ms,
               "ops_bound_ms": ROUND_OPS[name] * n_all / F32_PEAK * 1e3,
               "bytes_bound_ms": 8 * args.rows * 128 / BYTES_PEAK * 1e3}
        print(f"{name:10s} {dt_ms:8.4f} ms  {ps:8.3f} ps/elem  {ops_txt}  call {call_ms:.4f} ms "
              f"(least: operations {rec['ops_bound_ms']:.4f}, bytes {rec['bytes_bound_ms']:.4f})"
              f"  max|kernel - plain| {err:.3e}", flush=True)
        if name in sass and "fp32" in sass[name]:
            c = sass[name]
            rec["sass"] = c
            rec["issue_bound_ms"] = issue_ms(c, n_all, lanes // 128, clock)
            print(f"{'':10s} a round: {c['fp32']:.2f} FP32, {c['mufu_conv']:.2f} MUFU/conversion, "
                  f"{c['other']:.2f} other instructions ({c['rounds_in_loop']} rounds a loop "
                  f"trip), {c['registers']} registers; issue-slot least "
                  f"{rec['issue_bound_ms']:.4f} ms", flush=True)
        elif dev.type == "cuda":
            print(f"{'':10s} no round loop found in the SASS: {sass.get(name)}", flush=True)
        out[name] = rec
    if floor is not None:
        print(f"floor: one empty kernel {floor:.4f} ms (CUDA events behind the spin)", flush=True)
        out["floor_ms"] = floor
    return out


if __name__ == "__main__":
    main()
