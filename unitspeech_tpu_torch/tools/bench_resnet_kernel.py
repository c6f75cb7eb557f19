"""Microbenchmark of the fused ResnetBlock kernels against the plain block
at the estimator's stage shapes (dim 128, mults (1, 2, 4, 8), the 344-frame
bucket, the dual-CFG batch of 3): the port's counterpart of
tools/bench_resnet_kernel.py.

    python -m unitspeech_tpu_torch.tools.bench_resnet_kernel [--int8] [--deep] [--i8pre]
        [--stages 0,1,2,3] [--reps 20] [--device cuda]

Each stage takes the identity-residual block (T, F, C) = (344, 80, 128),
(172, 40, 256), (86, 20, 512), (43, 10, 1024), random weights from a seed,
and times the plain block (models/unet.py ResnetBlock without kernels)
against the fused kernel: K1 at F % 8 == 0; at F = 20/10 with --deep the
whole-layer K8, or K9 with --i8pre; otherwise the stage is skipped and
counts as the plain time on both sides. --int8 puts int8 convs on both
sides: the plain block takes the flat int8 route at the deep stages, and
the fused side runs the in-kernel int8 modes, K10a at F % 8 == 0 (per-tile
quantized copies read by the int8 Hopper conv) and K10b with --deep (K9's
chain), each with its int8 weights packed once. (JAX's tool left its early
stages in bf16 under --int8; K10a has no other caller.) Each prints both
times (CUDA events, median of --reps), their ratio and the relative error
max|fused - plain| / max|plain|; the WEIGHTED line sums the stages by their
blocks per estimator call {0: 3, 1: 5, 2: 5, 3: 6}.

JAX's --tap-mode (Mosaic's matmul structure) and --mish-mode (TPU
diagnostics) have no counterpart here. JAX timed K chained blocks and took
a difference to cancel the TPU's dispatch latency; CUDA events time one
block on the device.
"""

from __future__ import annotations

import argparse

import torch

from unitspeech_tpu_torch.models.unet import ResnetBlock, fused_kernel_shape, mish
from unitspeech_tpu_torch.ops.fused_resnet import (
    fused_resnet_block,
    pack_block_weights,
    pack_block_weights_int8,
    quant_w,
)
from unitspeech_tpu_torch.ops.fused_resnet_deep import (
    fused_resnet_block_deep,
    fused_resnet_block_deep_i8,
    pack_block_weights_i8,
)
from unitspeech_tpu_torch.tools import device_line, median_ms, resolve_device

STAGES = [(344, 80, 128), (172, 40, 256), (86, 20, 512), (43, 10, 1024)]
WEIGHTS = {0: 3, 1: 5, 2: 5, 3: 6}  # blocks per estimator call (res2 of down/up + mid)
BATCH, T_DIM = 3, 384


def _init_block(c: int, g: torch.Generator, dev) -> ResnetBlock:
    """An identity-residual ResnetBlock with flax's default initialisation
    (lecun-normal kernels, zero biases, unit GroupNorm scales), drawn from g."""
    block = ResnetBlock(c, c, T_DIM, 8)
    for name, p in block.named_parameters():
        if name.endswith("kernel"):
            fan_in = p[..., 0].numel()
            p.data = torch.randn(p.shape, generator=g) * fan_in ** -0.5
        elif name.endswith("norm.scale"):
            p.data = torch.ones(p.shape)
        else:
            p.data = torch.zeros(p.shape)
    return block.to(dev)


def _fused_fn(block, x, mask, t_emb, dtype, args):
    """The fused kernel of the stage and its name, or None to skip."""
    c1, c2 = block.block1.conv, block.block2.conv
    t_bias = block.mlp(mish(t_emb), dtype=dtype)
    params = (t_bias, c1.kernel, c1.bias, *block.block1.norm.params(), c2.kernel, c2.bias,
              *block.block2.norm.params())
    # quantized and packed once, as at load (the int8 blocks K9, K10a and
    # K10b read their int8 packing)
    wq = (quant_w(c1.kernel), quant_w(c2.kernel))
    packed = pack_block_weights(c1.kernel, c2.kernel)
    if fused_kernel_shape(x.shape[2]):
        if args.int8:
            packed_a = pack_block_weights_int8(wq)
            return "K10a", lambda: fused_resnet_block(x, mask, *params, groups=8, int8=True,
                                                      wq=wq, packed=packed_a)
        return "K1", lambda: fused_resnet_block(x, mask, *params, groups=8, packed=packed)
    if not args.deep:
        return None
    packed_i8 = pack_block_weights_i8(c1.kernel, wq)
    if args.i8pre:
        return "K9", lambda: fused_resnet_block_deep_i8(x, mask, *params, groups=8, wq=wq,
                                                        packed=packed_i8)
    name, pk = ("K10b", packed_i8) if args.int8 else ("K8", packed)
    return name, lambda: fused_resnet_block_deep(x, mask, *params, groups=8, int8=args.int8,
                                                 wq=wq, packed=pk)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("bench_resnet_kernel")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--deep", action="store_true",
                    help="fused deep-stage blocks at F = 20/10 (K8; K10b with --int8; K9 "
                         "with --i8pre) instead of skipping them")
    ap.add_argument("--int8", action="store_true",
                    help="int8 convs on both sides: the plain block's flat int8 route, the "
                         "in-kernel int8 modes K10a / K10b")
    ap.add_argument("--i8pre", action="store_true",
                    help="with --deep: K9 (int8 on pre-quantized activations)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=344,
                    help="stage 0's frames (stage i takes frames >> i); the bucket is 344")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    print(f"{device_line(dev)}; dtype={args.dtype} batch={BATCH} int8={args.int8} "
          f"deep={args.deep} i8pre={args.i8pre}", flush=True)
    g = torch.Generator().manual_seed(0)
    total_plain = total_fused = 0.0
    rows = []
    with torch.no_grad():
        for si in [int(s) for s in args.stages.split(",")]:
            _, f, c = STAGES[si]
            t = args.frames >> si
            block = _init_block(c, g, dev)
            if args.int8:
                block.quantize_int8()
            x = (torch.randn((BATCH, t, f, c), generator=g) * 0.3).to(dev, dtype)
            t_emb = torch.randn((BATCH, T_DIM), generator=g).to(dev, dtype)
            mask = torch.ones((BATCH, t, 1, 1), device=dev, dtype=dtype)

            def plain():
                return block(x, mask, t_emb, dtype, use_kernels=False, use_int8=args.int8)

            ms_plain = median_ms(plain, dev, args.reps)
            fused = _fused_fn(block, x, mask, t_emb, dtype, args)
            w = WEIGHTS[si]
            total_plain += w * ms_plain
            head = f"stage{si} T={t} F={f} C={c}: plain {ms_plain:.3f} ms/block"
            if fused is None:
                print(f"{head}  fused SKIP (F % 8 != 0 without --deep)", flush=True)
                total_fused += w * ms_plain
                rows.append({"stage": si, "plain_ms": ms_plain, "kernel": None})
                continue
            name, fn = fused
            ms_fused = median_ms(fn, dev, args.reps)
            ref = plain().float()
            err = ((fn().float() - ref).abs().max() / (ref.abs().max() + 1e-6)).item()
            total_fused += w * ms_fused
            print(f"{head}  fused {name} {ms_fused:.3f} ms/block  ({ms_plain / ms_fused:.2f}x)"
                  f"  relerr={err:.2e}", flush=True)
            rows.append({"stage": si, "plain_ms": ms_plain, "kernel": name,
                         "fused_ms": ms_fused, "relerr": err})
    print(f"WEIGHTED estimator-resblocks: plain {total_plain:.2f} ms/step  "
          f"fused {total_fused:.2f} ms/step  ({total_plain / total_fused:.2f}x)", flush=True)
    return {"stages": rows, "weighted_plain_ms": total_plain, "weighted_fused_ms": total_fused}


if __name__ == "__main__":
    main()
