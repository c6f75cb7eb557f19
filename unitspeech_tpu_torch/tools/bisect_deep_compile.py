"""The deep ResnetBlock and its kernels alone at the shapes of the JAX
package's compile bisection (P3): the port's counterpart of
tools/bisect_deep_compile.py.

    python -m unitspeech_tpu_torch.tools.bisect_deep_compile [CASE ...] [--reps 10]
        [--device cuda]

JAX's tool lowered and compiled the whole-layer deep kernel (K8) and its
kernels A and C alone at 14 shapes (CASES), one subprocess each, to find
which shapes blew up Mosaic's compile. Here nothing is compiled per shape:
nvcc builds each CUDA source once, and the build's per-source seconds are
printed first (`_cuda.build_seconds`). For every case (batch 1, every frame
valid) one JSON line then gives, for K8 (`fused_resnet_block_deep`), kernel
A alone (`resnet_conv3x3`: conv3x3 + bias + GroupNorm statistics) and
kernel C alone (`resnet_out`) in JAX's three residual modes (identity only
where Cin == Cout; "none" returns the f32 GN2 + mish + mask term; "matmul"
adds the 1x1 conv), the first call's milliseconds (host clock, synchronised:
in place of JAX's lower_s / compile_s) and the steady milliseconds (CUDA
events, median of --reps).

JAX's run_probe("a") calls _kernel_a_deep without its n_true, int8 and
sw_ref arguments, so it no longer runs against the current kernel; the
port follows the current kernel.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.fused_resnet import (
    OUT_MODES,
    _group_stats,
    pack_block_weights,
    pack_conv_weight,
    resnet_conv3x3,
    resnet_out,
)
from unitspeech_tpu_torch.ops.fused_resnet_deep import fused_resnet_block_deep
from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device

CASES = {
    # name: (t, f, cin, cout)  — n_rows = t*f
    "t43_f10_c1024": (43, 10, 1024, 1024),   # stage3: the known ~17 min case
    "t9_f10_c1024": (9, 10, 1024, 1024),     # n=90 (misaligned), C=1024
    "t21_f10_c1024": (21, 10, 1024, 1024),   # n=210 (misaligned), C=1024
    "t43_f10_c512": (43, 10, 512, 512),
    "t43_f10_c256": (43, 10, 256, 256),
    "t8_f10_c1024": (8, 10, 1024, 1024),     # tiny n, same misaligned f
    "t16_f10_c1024": (16, 10, 1024, 1024),
    "t43_f8_c1024": (43, 8, 1024, 1024),     # ALIGNED f, same t/C
    "t27_f16_c1024": (27, 16, 1024, 1024),   # aligned f, n=432
    "t86_f20_c512": (86, 20, 512, 512),      # stage2 shape (f=20 misaligned)
    "t86_f24_c512": (86, 24, 512, 512),      # aligned neighbor of stage2
    # cin != cout (wres 1x1-residual path) — the in-model down/up blocks
    "t43_f10_c512_1024": (43, 10, 512, 1024),
    "t43_f10_c2048_1024": (43, 10, 2048, 1024),
    "t86_f20_c1024_512": (86, 20, 1024, 512),
}


def case_inputs(name: str, dev) -> dict:
    """The case's operands, drawn as JAX's tool draws them (numpy seed 0,
    normal * 0.05; bf16 activations and kernels, f32 vectors), plus kernel
    C's c2 with its own GroupNorm statistics."""
    t, f, cin, cout = CASES[name]
    n = t * f
    rng = np.random.default_rng(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32)).to(
            dev, dtype)

    def rf(*shape):
        return r(*shape, dtype=torch.float32)

    p = dict(x=r(1, t, f, cin), mask=torch.ones((1, t, 1, 1), device=dev, dtype=torch.bfloat16),
             t_bias=r(1, cout), w1=r(3, 3, cin, cout), b1=rf(cout), s1=rf(cout), be1=rf(cout),
             w2=r(3, 3, cout, cout), b2=rf(cout), s2=rf(cout), be2=rf(cout),
             wres=r(1, 1, cin, cout) if cin != cout else None,
             bres=rf(cout) if cin != cout else None)
    p["lens"] = torch.full((1,), n, dtype=torch.int32, device=dev)
    p["c2"] = r(1, n, cout)
    mean, inv = _group_stats(p["c2"].float(), 8)
    p["mean"], p["inv"] = mean[:, 0].contiguous(), inv[:, 0].contiguous()
    p["wres_c"] = r(cin, cout)  # kernel C's 1x1 conv (its "matmul" mode)
    p["bres_c"] = rf(cout)
    return p


def probes(name: str, p: dict) -> dict:
    """The calls of one case: the block, kernel A alone and kernel C alone
    in each of its modes that the shapes allow, with the weights packed once
    (as the estimator packs them at load)."""
    t, f, cin, cout = CASES[name]
    x_rows = p["x"].reshape(1, t * f, cin)
    packed = pack_block_weights(p["w1"], p["w2"], p["wres"])
    wres_c = pack_conv_weight(p["wres_c"].reshape(1, 1, cin, cout))
    calls = {
        "block": lambda: fused_resnet_block_deep(
            p["x"], p["mask"], p["t_bias"], p["w1"], p["b1"], p["s1"], p["be1"], p["w2"],
            p["b2"], p["s2"], p["be2"], wres=p["wres"], bres=p["bres"], groups=8,
            packed=packed),
        "a": lambda: resnet_conv3x3(x_rows, p["lens"], p["w1"].reshape(9 * cin, cout), p["b1"],
                                    f, groups=8, packed=packed[0]),
    }
    for mode in OUT_MODES:
        if mode == "identity" and cin != cout:
            continue
        wres = (p["wres_c"], p["bres_c"]) if mode == "matmul" else (None, None)
        calls[f"c_{mode}"] = (lambda m=mode, w=wres: resnet_out(
            p["c2"], x_rows, p["mean"], p["inv"], p["s2"], p["be2"], p["lens"], m, *w,
            packed=wres_c if m == "matmul" else None))
    return calls


def _first_ms(fn, dev) -> float:
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser("bisect_deep_compile")
    ap.add_argument("cases", nargs="*", help=f"case names (default all): {', '.join(CASES)}")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.cases or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}")
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    if dev.type == "cuda":
        _cuda.lib()
        print(json.dumps({"nvcc_s": _cuda.build_seconds}), flush=True)
    results = []
    with torch.no_grad():
        for name in names:
            t, f, cin, cout = CASES[name]
            rec = {"case": name, "t": t, "f": f, "cin": cin, "cout": cout}
            p = case_inputs(name, dev)
            for what, fn in probes(name, p).items():
                rec[what] = {"first_ms": _first_ms(fn, dev),
                             "steady_ms": median_ms(fn, dev, args.reps, warmup=1)}
            print(json.dumps(rec), flush=True)
            results.append(rec)
    return results


if __name__ == "__main__":
    main()
