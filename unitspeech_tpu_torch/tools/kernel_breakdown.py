"""Per-launch device time inside the rezero attention (K4) and the int8
deep ResnetBlock (K9) at the sites one estimator call at the 344-frame
bucket runs them (3 rows, lengths 344/301/344): each wrapper call runs
several kernels, and this shows which of them takes the time.

    python -m unitspeech_tpu_torch.tools.kernel_breakdown [--reps 20] [--out FILE]

Each site's wrapper runs `reps` times under torch.profiler after a warm-up;
a kernel's time is its device time summed over the window divided by
`reps` (CUPTI's per-kernel device durations), beside the wrapper's own
time under CUDA events (tools.median_ms). Needs the card: a C entry point
launches several kernels, and only the profiler sees them apart. Where a
kernel is a programmatic dependent launch (K4's, K9's chain) it may start
before its predecessor ends and wait for it, so its device time includes
that wait and a call's launches sum to more than the wrapper's time.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch

from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device

FRAMES, PADDED = 344, 301
# (N, C): the five attention sites of one estimator call
K4_SITES = [(27520, 128), (6880, 256), (6880, 128), (1720, 512), (1720, 256)]
# (F, T, Cin, Cout): the deep blocks with Cout <= 512 (K9 on --deep --i8pre)
K9_SITES = [(20, 86, 256, 512), (20, 86, 512, 512), (10, 43, 512, 1024),
            (10, 43, 2048, 512), (10, 43, 512, 512), (20, 86, 1024, 256)]
K9_SITES = [s for s in K9_SITES if s[3] <= 512]


def short_name(name: str) -> str:
    """A kernel's name without its namespace and parameter list."""
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


def launch_times(fn, reps: int) -> list[dict]:
    """[{name, launches, ms}] per call of fn: each kernel's device time
    and launches over `reps` profiled calls, divided by `reps`, in the
    order the kernels first ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows: dict[str, dict] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.device_time if hasattr(e, "device_time") else e.cuda_time
        r = rows.setdefault(short_name(e.name), {"name": short_name(e.name), "launches": 0,
                                                 "ms": 0.0, "start": e.time_range.start})
        r["launches"] += 1
        r["ms"] += us / 1e3
        r["start"] = min(r["start"], e.time_range.start)
    out = sorted(rows.values(), key=lambda r: r["start"])
    for r in out:
        r.pop("start")
        r["ms"] /= reps
        r["launches"] /= reps
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


def breakdown(dev, reps: int = 20) -> dict:
    """{kernel: [{site, ms (the wrapper under CUDA events), launches:
    [{name, launches, ms}]}]} for K4 and K9; prints one line a launch."""
    result = {}
    for kernel, calls in (("K4", k4_calls(dev)), ("K9", k9_calls(dev))):
        result[kernel] = []
        for site, fn in calls:
            rec = {"site": site, "ms": median_ms(fn, dev), "launches": launch_times(fn, reps)}
            print(f"  {kernel} {site}: {rec['ms']:.4f} ms a call (CUDA events); per launch "
                  "(profiler): " + "; ".join(f"{r['name']} x{r['launches']:g} {r['ms']:.4f} ms"
                                              for r in rec["launches"]), flush=True)
            result[kernel].append(rec)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("kernel_breakdown")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(device_line(dev), flush=True)
    result = {"card": device_line(dev), **breakdown(dev, args.reps)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
