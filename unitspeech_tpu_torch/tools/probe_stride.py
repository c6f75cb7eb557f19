"""The row-subsample forms of a stride-2 resample on the card (P2): the
port's counterpart of tools/probe_stride.py.

    python -m unitspeech_tpu_torch.tools.probe_stride [--reps 50] [--device cuda]

JAX's probe asked which forms Mosaic lowers inside a kernel; here each
case computes the same function with the port's kernels (ops/probes.py)
on a (512, 128) bf16 array: the strided getitem x[::2], lax.slice with
stride 2 and the sublane reshape x.reshape(R/2, 2, C)[:, 0] are one row
gather (row_select with period 2); the selection matmul S @ x is a 0/1
product on the tensor cores; the stack interleave writes rows half[i] and
half[i] + 1 (rounded to bf16) in turn; the frame-block select keeps the
first F = 16 of every 2F rows. Each case prints whether it equals the
numpy expectation, its microseconds per call (CUDA events, median of
--reps), the least time its bytes allow (each input row it needs read
once, each output row written once, at 3.35 TB/s) and, where one PyTorch
call computes the form, that call's time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unitspeech_tpu_torch.ops.probes import (
    interleave_rows,
    interleave_rows_plain,
    row_select,
    row_select_plain,
    selection_matmul,
    selection_matmul_plain,
    selection_matrix,
)
from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device

R, C, F_BLOCK = 512, 128, 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def expectations(xn: np.ndarray) -> dict:
    """probe_stride's numpy expectations (tools/probe_stride.py:102-121)
    for x (R, C) in f32: every other row, the interleave of the first half
    with itself + 1, and the first F of every 2F rows."""
    r, c = xn.shape
    inter = np.empty_like(xn)
    inter[0::2] = xn[: r // 2]
    inter[1::2] = xn[: r // 2] + 1.0
    return {"half": xn[::2, :], "inter": inter,
            "frame_block": xn.reshape(r // (2 * F_BLOCK), 2 * F_BLOCK, c)[:, :F_BLOCK, :]
            .reshape(-1, c)}


def needed_bytes(key: str, y: torch.Tensor) -> int:
    """Bytes the form must move: the input rows it reads (the interleave
    reads half as many rows as it writes) and its output, once each."""
    out = y.numel() * y.element_size()
    return out // 2 + out if key == "inter" else 2 * out


# (case, kernel wrapper, its arguments after x, expectation)
FORMS = [
    ("strided getitem", row_select, (2, 1), "half"),
    ("lax.slice stride2", row_select, (2, 1), "half"),
    ("sublane reshape", row_select, (2, 1), "half"),
    ("selection matmul", selection_matmul, (), "half"),
    ("stack interleave", interleave_rows, (), "inter"),
    ("frame-block reshape", row_select, (2 * F_BLOCK, F_BLOCK), "frame_block"),
]
PLAIN = {row_select: row_select_plain, selection_matmul: selection_matmul_plain,
         interleave_rows: interleave_rows_plain}


def library_calls(x: torch.Tensor) -> dict:
    """The one PyTorch call that computes each case's form, where there is
    one (the interleave takes two: an add and a stack)."""
    s = selection_matrix(x.shape[0], x.dtype, x.device)
    c = x.shape[1]
    return {"strided getitem": lambda: x[::2].contiguous(),
            "lax.slice stride2": lambda: x[0::2, 0::1].contiguous(),
            "sublane reshape": lambda: x.reshape(x.shape[0] // 2, 2, c)[:, 0].contiguous(),
            "selection matmul": lambda: s @ x,
            "stack interleave": None,
            "frame-block reshape": lambda: x.reshape(-1, 2 * F_BLOCK, c)[:, :F_BLOCK].reshape(-1, c)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("probe_stride")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{device_line(dev)}; x ({R}, {C}) bf16", flush=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((R, C)).astype(np.float32))
    x = x.to(torch.bfloat16).to(dev)
    want = expectations(x.float().cpu().numpy())
    # the interleave rounds half + 1 to bf16, as the TPU kernel's bf16 add does
    want["inter"] = torch.from_numpy(want["inter"]).to(torch.bfloat16).float().numpy()
    out = {}
    libs = library_calls(x)
    for name, kernel, kernel_args, key in FORMS:
        lib = libs[name]

        def fn(kernel=kernel, kernel_args=kernel_args):
            return kernel(x, *kernel_args)

        y = fn()
        ok = bool(np.array_equal(y.float().cpu().numpy(), want[key]))
        us = median_ms(fn, dev, args.reps) * 1e3
        bound_us = needed_bytes(key, y) / HBM_BYTES_PER_S * 1e6
        lib_us = None if lib is None else median_ms(lib, dev, args.reps) * 1e3
        lib_txt = "" if lib_us is None else f"  library {lib_us:7.2f} us"
        print(f"{name:>24}: correct={ok}  {us:7.2f} us/call  bound {bound_us:6.3f} us (bytes)"
              f"{lib_txt}", flush=True)
        out[name] = {"correct": ok, "us": us, "bound_us": bound_us, "lib_us": lib_us}
    return out


if __name__ == "__main__":
    main()
