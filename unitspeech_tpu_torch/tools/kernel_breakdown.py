"""Per-launch device time inside the rezero attention (K4), the int8 deep
ResnetBlock (K9), the in-kernel int8 ResnetBlock of the early stages (K10a,
at the six sites of the kernel benchmark's path), the row abs-max (K7),
the GroupNorm row statistics (K3: the `row_stats` form and the served
`group_mean_inv` call, at its 8 sites
in bf16 and f32) and the final block (K2: its conv, then its tail) at the
sites one estimator call at the 344-frame bucket runs them (3 rows,
lengths 344/301/344), and inside the anti-aliased snake kernels (K5 at its
24 sites of one vocoder call at that bucket, K6 at its one): each wrapper
call may run several kernels (and small PyTorch launches around them), and
this shows which of them takes the time.

    python -m unitspeech_tpu_torch.tools.kernel_breakdown [--reps 20] [--out FILE]
        [--kernels K4 K9 K10a K7 K5 K6 K3 K2]

Each site's wrapper runs `reps` times under torch.profiler after a warm-up;
a kernel's time is its device time summed over the window divided by
`reps` (CUPTI's per-kernel device durations), beside the wrapper's own
time under CUDA events (tools.median_ms). Needs the card: a C entry point
launches several kernels, and only the profiler sees them apart. Where a
kernel is a programmatic dependent launch (K4's, K9's and K10a's chains) it may start
before its predecessor ends and wait for it, so its device time includes
that wait and a call's launches sum to more than the wrapper's time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import torch

from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device

FRAMES, PADDED = 344, 301
# seconds of idle device between the trace's edges and the profiled calls
EDGE_S = 0.02
# (N, C): the five attention sites of one estimator call
K4_SITES = [(27520, 128), (6880, 256), (6880, 128), (1720, 512), (1720, 256)]
# (F, T, Cin, Cout): the deep blocks with Cout <= 512 (K9 on --deep --i8pre)
K9_SITES = [(20, 86, 256, 512), (20, 86, 512, 512), (10, 43, 512, 1024),
            (10, 43, 2048, 512), (10, 43, 512, 512), (20, 86, 1024, 256)]
K9_SITES = [s for s in K9_SITES if s[3] <= 512]
# (F, Cin, Cout): K10a's sites, the early-stage blocks of one estimator call
# (chip_smoke.py K1_SITES), T = 344 F / 80, JAX's tiles
K10A_SITES = [(80, 2, 128), (80, 128, 128), (40, 128, 256), (40, 256, 256), (40, 512, 128),
              (40, 128, 128)]
# (rows, C, launches per estimator call on the serving default): the int8
# activation scale of every flat deep-stage conv input
K7_SITES = [(1720, 256, 2), (1720, 512, 3), (1720, 1024, 1), (430, 512, 4), (430, 1024, 7),
            (430, 2048, 1)]
# BigVGAN at the 344-frame bucket: (T, C) after each upsample stage; each
# AMP block (k = 3, 7, 11) runs K5 at d = 1, 3, 5 and three times at d = 1
# with the residual. (T, C, k, d, residual, launches per vocoder call)
VOC_STAGES = [(2752, 256), (22016, 128), (44032, 64), (88064, 32)]
K5_SITES = [(t, c, k, d, res, 3 if res else 1) for t, c in VOC_STAGES for k in (3, 7, 11)
            for d, res in ((1, False), (3, False), (5, False), (1, True))]
K6_SITE = (88064, 32)
# (rows, C, input dtype, launches per estimator call on the serving default
# (int8), with --no-int8 (bf16) and on each fused deep path): the GroupNorm
# statistics of the flat deep blocks, on their conv outputs (rounded to
# bf16 in int8 mode; f32 accumulators with --no-int8) and on the bf16
# output of the one deep block that runs as plain Blocks (up_1_res2, on
# every path; the fused deep paths have no flat block at this bucket)
K3_SITES = [(1720, 512, "bfloat16", 4, 0, 0), (430, 1024, "bfloat16", 8, 0, 0),
            (430, 512, "bfloat16", 4, 0, 0), (1720, 256, "bfloat16", 4, 2, 2),
            (1720, 512, "float32", 0, 4, 0), (430, 1024, "float32", 0, 8, 0),
            (430, 512, "float32", 0, 4, 0), (1720, 256, "float32", 0, 2, 0)]
K3_GROUPS = 8
# (F, T, C): the estimator's final block, C -> C conv3x3 + GroupNorm + mish
# and the 1-channel final conv, once per estimator call
K2_SITE = (80, 344, 128)


def short_name(name: str) -> str:
    """A kernel's name without its namespace and parameter list; PyTorch's
    elementwise kernels by their functor ("torch exp")."""
    if name.startswith(("at::native::", "void at::native::")):
        ops = [g for m in re.findall(r"(\w+?)_kernel_cuda|CUDAFunctorOnSelf_(\w+?)<|"
                                     r"(\w+?)Functor<float>", name) for g in m if g]
        return f"torch {ops[-1].lower() if ops else name.split('<')[0]}"
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:  # drop the outermost parameter list, keep template arguments
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)


# the CUDA runtime and driver calls that put work on the card, as the
# profiler records them on the host: kernel launches, graph launches (one
# call whatever the graph holds), copies and sets
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                     "cuMemcpy", "cudaMemset", "cuMemset")


def _device_events(fn, reps: int) -> list:
    """The device activities of `reps` profiled calls of fn (_profiled)."""
    return _profiled(fn, reps)[0]


def _profiled(fn, reps: int, warmup: int = 3) -> tuple:
    """The device activities (kernels and copies) of `reps` profiled calls
    of fn, after 3 unprofiled ones. The calls run EDGE_S after the trace
    starts and end EDGE_S before it stops: a kernel right at either edge
    may be left out of the trace (one call in 20, up to five, on the H100),
    which would show as a fraction of a launch per call. Each is read
    from the trace's raw records (name, time_range.start and device_time
    in us, as the profiler's events have them): building the profiler's
    event tree takes seconds for a call of 60 000 launches. warmup: the
    unprofiled calls before the window. Returns (the device activities, the
    names of the host's calls of HOST_LAUNCH_CALLS in the window)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() != DeviceType.CUDA
            and e.name().startswith(HOST_LAUNCH_CALLS)]
    return [SimpleNamespace(name=e.name(), time_range=SimpleNamespace(start=e.start_ns() / 1e3),
                            device_time=e.duration_ns() / 1e3)
            for e in events if e.device_type() == DeviceType.CUDA], host


def _device_us(e) -> float:
    return e.device_time if hasattr(e, "device_time") else e.cuda_time


def launch_times(fn, reps: int) -> list[dict]:
    """[{name, launches, ms}] per call of fn: each kernel's device time
    and launches over `reps` profiled calls (_device_events), divided by
    `reps`, in the order the kernels first ran."""
    rows: dict[str, dict] = {}
    for e in _device_events(fn, reps):
        r = rows.setdefault(short_name(e.name), {"name": short_name(e.name), "launches": 0,
                                                 "ms": 0.0, "start": e.time_range.start})
        r["launches"] += 1
        r["ms"] += _device_us(e) / 1e3
        r["start"] = min(r["start"], e.time_range.start)
    out = sorted(rows.values(), key=lambda r: r["start"])
    for r in out:
        r.pop("start")
        r["ms"] /= reps
        r["launches"] /= reps
    return out


def device_activity(fn, reps: int, names: bool = False, host: bool = False,
                    warmup: int = 3) -> dict:
    """{sum_ms, busy_ms, launches} per call of fn over `reps` profiled calls
    (_device_events): the summed durations of its device activities, the
    time at least one of them ran (the union of their intervals, which is
    below the sum where activities overlap), and their count; with `names`
    also by_name, their count per call by short_name; with `host` (after
    `warmup` unprofiled calls) also host_calls, the host's calls that put
    work on the card (HOST_LAUNCH_CALLS), and graph_launches, those that
    launch a CUDA graph, per call."""
    if host:
        events, calls = _profiled(fn, reps, warmup)
    else:
        events = _device_events(fn, reps)
    events = sorted(events, key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for e in events:
        a, b = e.time_range.start, e.time_range.start + _device_us(e)
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    out = {"sum_ms": sum(_device_us(e) for e in events) / 1e3 / reps,
           "busy_ms": busy_us / 1e3 / reps, "launches": len(events) / reps}
    if host:
        out["host_calls"] = len(calls) / reps
        out["graph_launches"] = sum(c.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
                                    for c in calls) / reps
    if names:
        raw: dict[str, int] = {}
        for e in events:
            raw[e.name] = raw.get(e.name, 0) + 1
        out["by_name"] = {}
        for name, k in raw.items():  # a few hundred names for 60 000 records
            short = short_name(name)
            out["by_name"][short] = out["by_name"].get(short, 0) + k / reps
    return out


def _lens_mask(t, dev):
    lens = torch.tensor([t, -(-PADDED * t // FRAMES), t], device=dev)
    return (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()[:, :, None, None]


def k4_calls(dev, seed=0):
    """[(site, wrapper call)] at K4_SITES, inputs from `seed`."""
    from unitspeech_tpu_torch.ops import fused_attention

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for n, c in K4_SITES:
        r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)  # noqa: E731
        x = r(3, n, c).to(torch.bfloat16)
        w_qkv, w_out, b_out = r(c, 384, scale=c ** -0.5), r(128, c, scale=128 ** -0.5), r(c)
        gate = torch.tensor([0.7], device=dev)
        lens = torch.tensor([n, n * PADDED // FRAMES, n], dtype=torch.int32, device=dev)
        # packed once, as at load
        packed = fused_attention.pack_attention_weights(w_qkv, w_out)
        out.append((f"N={n} C={c}", lambda x=x, w_qkv=w_qkv, w_out=w_out, b_out=b_out, gate=gate,
                    lens=lens, packed=packed: fused_attention.fused_rezero_attention(
                        x, w_qkv, w_out, b_out, gate, lens, packed=packed)))
    return out


def k9_calls(dev, seed=0):
    """[(site, wrapper call)] at K9_SITES, weights quantized and packed
    once as at load, inputs from `seed`."""
    from unitspeech_tpu_torch.ops import fused_resnet, fused_resnet_deep

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for f, t, cin, cout in K9_SITES:
        r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)  # noqa: E731
        x = r(3, t, f, cin).to(torch.bfloat16)
        # the FiLM bias in the activation dtype, as the estimator's MLP gives it
        p = dict(t_bias=r(3, cout).to(torch.bfloat16),
                 w1=r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                 b1=r(cout, scale=0.1), gn1_scale=1 + r(cout, scale=0.1),
                 gn1_bias=r(cout, scale=0.1), w2=r(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                 b2=r(cout, scale=0.1), gn2_scale=1 + r(cout, scale=0.1),
                 gn2_bias=r(cout, scale=0.1))
        if cin != cout:
            p.update(wres=r(1, 1, cin, cout, scale=cin ** -0.5), bres=r(cout, scale=0.1))
        wq = (fused_resnet_deep.quant_w(p["w1"]), fused_resnet_deep.quant_w(p["w2"]))
        packed = fused_resnet_deep.pack_block_weights_i8(p["w1"], wq, p.get("wres"))
        mask = _lens_mask(t, dev)
        # the valid rows counted once, as the estimator counts them a level
        lens_rows = fused_resnet.lens_rows_from_mask(mask, f)
        out.append((f"F={f} T={t} {cin}->{cout}",
                    lambda x=x, mask=mask, p=p, wq=wq, packed=packed, lens_rows=lens_rows:
                    fused_resnet_deep.fused_resnet_block_deep_i8(
                        x, mask, groups=8, wq=wq, packed=packed, lens_rows=lens_rows, **p)))
    return out


def k10a_calls(dev, seed=0):
    """[(site, wrapper call)] at K10A_SITES, the int8 weights quantized and
    packed once (pack_block_weights_int8), inputs from `seed`."""
    from unitspeech_tpu_torch.ops import fused_resnet

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for f, cin, cout in K10A_SITES:
        t = FRAMES * f // 80
        r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)  # noqa: E731
        x = r(3, t, f, cin).to(torch.bfloat16)
        p = dict(t_bias=r(3, cout).to(torch.bfloat16),
                 w1=r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                 b1=r(cout, scale=0.1), gn1_scale=1 + r(cout, scale=0.1),
                 gn1_bias=r(cout, scale=0.1), w2=r(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                 b2=r(cout, scale=0.1), gn2_scale=1 + r(cout, scale=0.1),
                 gn2_bias=r(cout, scale=0.1))
        if cin != cout:
            p.update(wres=r(1, 1, cin, cout, scale=cin ** -0.5), bres=r(cout, scale=0.1))
        wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
        packed = fused_resnet.pack_block_weights_int8(wq, p.get("wres"))
        mask = _lens_mask(t, dev)
        fpt = fused_resnet.pick_frames_per_tile(t, f, max(cin, cout))
        out.append((f"F={f} T={t} {cin}->{cout} tiles of {fpt} frames",
                    lambda x=x, mask=mask, p=p, wq=wq, packed=packed:
                    fused_resnet.fused_resnet_block(x, mask, groups=8, int8=True, wq=wq,
                                                    packed=packed, **p)))
    return out


def k7_calls(dev, seed=0):
    """[(site, wrapper call, launches per estimator call)] at K7_SITES, bf16
    rows from `seed`."""
    from unitspeech_tpu_torch.ops import row_stats

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for n, c, per_call in K7_SITES:
        x = torch.randn(3, n, c, generator=g).to(dev, torch.bfloat16)
        out.append((f"n={n} C={c}", lambda x=x: row_stats.row_absmax(x), per_call))
    return out


def _snake_params(g, dev, c):
    return tuple((torch.randn(c, generator=g) * 0.3).to(dev) for _ in range(2))


def k5_calls(dev, seed=0):
    """[(site, wrapper call, launches per vocoder call)] at K5_SITES: bf16
    activations, weights and the residual, f32 snake parameters and bias
    from `seed`; the weights packed once, as the vocoder packs them at
    load."""
    from unitspeech_tpu_torch.ops import aa_snake

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for t, c, k, d, res, per_call in K5_SITES:
        x = (torch.randn(1, c, t, generator=g) * 0.5).to(dev, torch.bfloat16)
        alpha, beta = _snake_params(g, dev, c)
        w = (torch.randn(k, c, c, generator=g) * (k * c) ** -0.5).to(dev, torch.bfloat16)
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        r = (torch.randn(1, c, t, generator=g) * 0.5).to(dev, torch.bfloat16) if res else None
        packed = aa_snake.pack_aa_conv(alpha, beta, w, bias)
        out.append((f"T={t} C={c} k={k} d={d}{' +res' if res else ''}",
                    lambda x=x, alpha=alpha, beta=beta, w=w, bias=bias, d=d, r=r, packed=packed:
                    aa_snake.fused_aa_snake_conv(x, alpha, beta, w, bias, d, r, packed=packed),
                    per_call))
    return out


def k6_calls(dev, seed=0):
    """[(site, wrapper call, launches per vocoder call)] at K6_SITE, the
    snake coefficients packed once."""
    from unitspeech_tpu_torch.ops import aa_snake

    g = torch.Generator(device="cpu").manual_seed(seed)
    t, c = K6_SITE
    x = (torch.randn(1, c, t, generator=g) * 0.5).to(dev, torch.bfloat16)
    alpha, beta = _snake_params(g, dev, c)
    packed = aa_snake.pack_snake(alpha, beta)
    return [(f"T={t} C={c}", lambda: aa_snake.fused_aa_snake(x, alpha, beta, packed=packed), 1)]


def k3_calls(dev, seed=0):
    """[(site, wrapper call, {path: launches per estimator call})] at
    K3_SITES, each site twice: the `row_stats` form (weight 0 on every path)
    and the served call, `group_mean_inv` over K3_GROUPS groups; rows N(0.5,
    1) from `seed`."""
    from unitspeech_tpu_torch.ops import row_stats

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for n, c, dt, i8, bf, deep in K3_SITES:
        x = (torch.randn(3, n, c, generator=g) + 0.5).to(dev, getattr(torch, dt))
        site = f"n={n} C={c} {dt}"
        out.append((f"{site} row_stats", lambda x=x: row_stats.row_stats(x), {}))
        out.append((f"{site} group_mean_inv",
                    lambda x=x: row_stats.group_mean_inv(x, K3_GROUPS),
                    {"int8": i8, "bf16": bf, "deep": deep}))
    return out


def k2_calls(dev, seed=0):
    """[(site, wrapper call, 1)] at K2_SITE, the conv weights packed once as
    at load, inputs from `seed`."""
    from unitspeech_tpu_torch.ops import fused_resnet

    g = torch.Generator(device="cpu").manual_seed(seed)
    f, t, c = K2_SITE
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)  # noqa: E731
    x = r(3, t, f, c).to(torch.bfloat16)
    w1, b1 = r(3, 3, c, c, scale=(9 * c) ** -0.5), r(c, scale=0.1)
    s1, be1 = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wo, bo = r(1, 1, c, 1, scale=c ** -0.5), r(1, scale=0.1)
    mask = _lens_mask(t, dev)
    packed = fused_resnet.pack_conv_weight(w1)
    return [(f"F={f} T={t} {c}->1",
             lambda: fused_resnet.fused_final_block(x, mask, w1, b1, s1, be1, wo, bo, groups=8,
                                                    packed=packed), 1)]


CALLS = {"K4": k4_calls, "K9": k9_calls, "K10a": k10a_calls, "K7": k7_calls, "K5": k5_calls,
         "K6": k6_calls, "K3": k3_calls, "K2": k2_calls}
# the paths whose estimator call K3's sums are taken on
K3_PATHS = ("int8", "bf16", "deep")


def breakdown(dev, reps: int = 20, kernels=tuple(CALLS)) -> dict:
    """{kernel: [{site, ms (the wrapper under CUDA events), per_call,
    launches: [{name, launches, ms}]}]} for each of `kernels`; prints one
    line a site, and for K5, K6, K7 and K3 the sums a call of the estimator
    (K7; K3 on each of K3_PATHS) or vocoder (K5, K6) makes, by launch name,
    weighted by each site's launches per call (K5 also by stage), and
    `chain_ms`: that call's wrapper calls back to back, each site as often
    as the call makes it, under one pair of events. `floor_ms`: one empty
    kernel under the same timing (the least a single timed call can
    show)."""
    floor = median_ms(lambda: torch.cuda._sleep(1), dev)
    print(f"  one empty kernel: {floor:.4f} ms (CUDA events behind the spin)", flush=True)
    result = {"floor_ms": floor, "chain_ms": {}}
    for kernel in kernels:
        result[kernel] = []
        calls = CALLS[kernel](dev)
        for site, fn, *per_call in calls:
            rec = {"site": site, "ms": median_ms(fn, dev), "per_call": per_call[0] if per_call else 1,
                   "launches": launch_times(fn, reps)}
            print(f"  {kernel} {site}: {rec['ms']:.4f} ms a call (CUDA events); per launch "
                  "(profiler): " + "; ".join(f"{r['name']} x{r['launches']:g} {r['ms']:.4f} ms"
                                              for r in rec["launches"]), flush=True)
            result[kernel].append(rec)
        if kernel in ("K5", "K6", "K7", "K3"):
            for path in K3_PATHS if kernel == "K3" else (None,):
                weighted = [(fn, _weight(per_call[0], path)) for _, fn, *per_call in calls]
                _summary(kernel, result[kernel], path)

                def chain(weighted=weighted):
                    for fn, n in weighted:
                        for _ in range(n):
                            fn()

                ms = median_ms(chain, dev, reps=10)
                key = kernel if path is None else f"{kernel} {path}"
                result["chain_ms"][key] = ms
                print(f"  {key} a call's {sum(n for _, n in weighted)} wrapper calls back to "
                      f"back: {ms:.4f} ms (CUDA events)", flush=True)
    return result


def _weight(per_call, path):
    """A site's launches per call: an int, or (K3) {path: launches}."""
    return per_call.get(path, 0) if isinstance(per_call, dict) else per_call


def _summary(kernel, recs, path=None):
    """Print the per-call sums of one kernel's sites (K5 also per stage; K3
    on `path`)."""
    groups = {"all" if path is None else f"{path} path": recs}
    if kernel == "K5":
        for t, c in VOC_STAGES:
            groups[f"T={t} C={c}"] = [r for r in recs if r["site"].startswith(f"T={t} ")]
    for what, rs in groups.items():
        names: dict = {}
        for r in rs:
            w = _weight(r["per_call"], path)
            for ln in r["launches"]:
                e = names.setdefault(ln["name"], [0.0, 0.0])
                e[0] += ln["launches"] * w
                e[1] += ln["ms"] * w
        wrapper = sum(r["ms"] * _weight(r["per_call"], path) for r in rs)
        print(f"  {kernel} {what}, a call: wrapper {wrapper:.4f} ms over "
              f"{sum(_weight(r['per_call'], path) for r in rs)} calls; launches: " +
              "; ".join(f"{n} x{v[0]:g} {v[1]:.4f} ms" for n, v in names.items() if v[0]),
              flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("kernel_breakdown")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    ap.add_argument("--kernels", nargs="+", choices=tuple(CALLS), default=tuple(CALLS),
                    help="the kernels to break down: K4, K9, K10a, K7, K5, K6, K3 (both forms), K2 "
                         "(default: all)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(device_line(dev), flush=True)
    result = {"card": device_line(dev), **breakdown(dev, args.reps, args.kernels)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
