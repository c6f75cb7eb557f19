"""Fused U-Net ResnetBlock and final block (kernels K1 and K2; counterpart of
unitspeech_tpu/ops/pallas_resnet.py `fused_resnet_block` and
`fused_final_block`).

One ResnetBlock runs as three steps over (B, T*F, C) rows:

  A: mask input rows, conv3x3 + bias -> c1 (bf16) + GroupNorm statistics
  B: GN1-apply + mish + FiLM + re-mask, conv3x3 + bias -> c2 + statistics
  C: GN2-apply + mish + mask + residual (1x1 conv or identity)

and the final block as A followed by D: GN + mish + mask + the 1-channel
1x1 final_conv, giving an f32 score. CUDA source: csrc/resnet_block.cu,
which states what bounds the kernels and how they are laid out.

Numerics contract (the Pallas kernels'): convs accumulate in f32 and round
once to the activation dtype; the statistics come from the f32
accumulators and pool over every row of the padded bucket; GN math and
mish run in f32.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.conv_matmul import conv3x3_rows

GN_EPS = 1e-5


def mish_one_exp(x: torch.Tensor) -> torch.Tensor:
    """mish with one exp, as the kernels compute it (pallas_resnet.py
    _mish_f32): tanh(softplus(x)) = ((1+e^x)^2 - 1) / ((1+e^x)^2 + 1), and
    x itself past 20 where the factor is 1.0 in f32."""
    e = torch.exp(torch.clamp(x, max=30.0))
    t = (1.0 + e) * (1.0 + e)
    return torch.where(x > 20.0, x, x * ((t - 1.0) / (t + 1.0)))


def lens_rows_from_mask(mask: torch.Tensor, f: int) -> torch.Tensor:
    """(B, T, ...) prefix mask -> (B,) int32 valid row counts len*F. The sum
    runs in f32: a bf16 sum rounds odd lengths above 256."""
    b = mask.shape[0]
    lens = mask.reshape(b, -1).to(torch.float32).sum(dim=1)
    return (lens.to(torch.int32) * f).to(torch.int32)


def block_rows_args(x, mask, t_bias, w1, b1, s1, be1, w2, b2, s2, be2, wres, bres):
    """A ResnetBlock's arguments (x (B, T, F, Cin), mask (B, T, 1, 1), flax
    kernels) on rows, as resnet_block_plain and the kernels take them."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    return (x.reshape(bsz, t * f, cin), lens_rows_from_mask(mask, f), t_bias,
            w1.reshape(9 * cin, cout), b1, s1, be1, w2.reshape(9 * cout, cout), b2, s2, be2,
            None if wres is None else wres.reshape(cin, cout), bres)


def _valid(lens_rows: torch.Tensor, n: int) -> torch.Tensor:
    pos = torch.arange(n, device=lens_rows.device)
    return (pos[None, :] < lens_rows[:, None]).to(torch.float32)[..., None]


def _group_stats(acc: torch.Tensor, groups: int, eps: float = GN_EPS):
    """f32 accumulators (B, n, C) -> per-channel (mean, inv), each (B, 1, C)."""
    b, n, c = acc.shape
    cg = c // groups
    m = float(n * cg)
    s = acc.sum(dim=1).reshape(b, groups, cg).sum(-1) / m
    ex2 = (acc * acc).sum(dim=1).reshape(b, groups, cg).sum(-1) / m
    inv = torch.rsqrt(ex2 - s * s + eps)
    return (s.repeat_interleave(cg, dim=1)[:, None, :],
            inv.repeat_interleave(cg, dim=1)[:, None, :])


def _gn_mish(c: torch.Tensor, mean, inv, scale, shift) -> torch.Tensor:
    h = (c.to(torch.float32) - mean) * inv
    return mish_one_exp(h * scale.to(torch.float32) + shift.to(torch.float32))


def resnet_block_plain(x, lens_rows, t_bias, w1, b1, s1, be1, w2, b2, s2, be2,
                       wres, bres, f: int, groups: int):
    """The K1 kernel's plain version on rows: x (B, N, Cin) in the
    activation dtype, w1 (9*Cin, Cout), w2 (9*Cout, Cout), wres (Cin, Cout)
    or None for the identity residual, t_bias (B, Cout). -> (B, N, Cout)."""
    dt = x.dtype
    n = x.shape[1]
    valid = _valid(lens_rows, n)
    acc1 = conv3x3_rows(x.to(torch.float32) * valid, w1.to(dt).to(torch.float32), f) + b1
    mean1, inv1 = _group_stats(acc1, groups)
    h = _gn_mish(acc1.to(dt), mean1, inv1, s1, be1)
    h = ((h + t_bias.to(dt).to(torch.float32)[:, None, :]) * valid).to(dt)
    acc2 = conv3x3_rows(h.to(torch.float32), w2.to(dt).to(torch.float32), f) + b2
    mean2, inv2 = _group_stats(acc2, groups)
    h2 = _gn_mish(acc2.to(dt), mean2, inv2, s2, be2) * valid
    xv = x.to(torch.float32) * valid
    if wres is None:
        res = xv
    else:
        res = (xv @ wres.to(dt).to(torch.float32) + bres) * valid
    return (h2 + res).to(dt)


def final_block_plain(x, lens_rows, w1, b1, s1, be1, wo, bo, f: int, groups: int):
    """The K2 kernel's plain version: x (B, N, Cin), w1 (9*Cin, C), wo (C,)
    -> (B, N) f32 score."""
    dt = x.dtype
    n = x.shape[1]
    valid = _valid(lens_rows, n)
    acc1 = conv3x3_rows(x.to(torch.float32) * valid, w1.to(dt).to(torch.float32), f) + b1
    mean1, inv1 = _group_stats(acc1, groups)
    h = (_gn_mish(acc1.to(dt), mean1, inv1, s1, be1) * valid).to(dt)
    y = h.to(torch.float32) @ wo.to(dt).to(torch.float32) + bo
    return y * valid[..., 0]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _conv_stats(lib, x, w, bias, lens, f, groups):
    """Launch kernel A, then reduce its tile statistics. -> (c, mean, inv)."""
    b, n, cin = x.shape
    cout = w.shape[-1]
    st = _cuda.stream(x)
    nt = lib.us_n_row_tiles(n)
    part = torch.empty((b, nt, 2, cout), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n, cout), dtype=x.dtype, device=x.device)
    mean = torch.empty((b, cout), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    _cuda.check(
        lib.us_resnet_conv3x3(x.data_ptr(), w.data_ptr(), bias.data_ptr(), lens.data_ptr(),
                              *(None,) * 5, out.data_ptr(), part.data_ptr(), b, n, f, cin, cout,
                              st),
        "resnet conv3x3",
    )
    _cuda.check(
        lib.us_gn_finalize(part.data_ptr(), b, nt, cout, groups, n, GN_EPS,
                           mean.data_ptr(), inv.data_ptr(), st),
        "groupnorm statistics",
    )
    return out, mean, inv


def _check_shapes(what, x, cout, groups):
    """Cout: a multiple of the 64-column tile; at most 8192, so that kernel
    B's transform table (5 * Cout floats) fits the block's 227 KB of shared
    memory."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 activations, got {x.dtype}")
    if cout % 64 or cout > 8192 or cout % groups:
        raise ValueError(f"{what}: unsupported Cout={cout} (multiple of 64, <= 8192, "
                         f"divisible by groups={groups})")


def _resnet_block_cuda(x, lens, t_bias, w1, b1, s1, be1, w2, b2, s2, be2, wres, bres,
                       f, groups, what="fused_resnet_block"):
    """K1 (and K8, ops/fused_resnet_deep.py): the block's five launches in
    one call of us_resnet_block."""
    b, n, cin = x.shape
    cout = w1.shape[-1]
    _check_shapes(what, x, cout, groups)
    if wres is None and cin != cout:
        raise ValueError(f"{what}: identity residual needs Cin == Cout")
    dt, dev = x.dtype, x.device
    _cuda.require(x, "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    w1 = _cuda.require(w1.to(dt).contiguous(), "w1", shape=(9 * cin, cout), device=dev)
    w2 = _cuda.require(w2.to(dt).contiguous(), "w2", shape=(9 * cout, cout), device=dev)
    film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
    if wres is not None:
        wres = _cuda.require(wres.to(dt).contiguous(), "wres", shape=(cin, cout), device=dev)
        bres = _f32(bres)
    lib = _cuda.lib()
    c1, c2, out = (torch.empty((b, n, cout), dtype=dt, device=dev) for _ in range(3))
    part = torch.empty((b, lib.us_n_row_tiles(n), 2, cout), dtype=torch.float32, device=dev)
    stats = torch.empty((4, b, cout), dtype=torch.float32, device=dev)  # mean/inv x 2
    operands = (x, w1, _f32(b1), _f32(s1), _f32(be1), film, w2, _f32(b2), _f32(s2), _f32(be2))
    _cuda.check(lib.us_resnet_block(
        *(t.data_ptr() for t in operands), _cuda.ptr(wres), _cuda.ptr(bres), lens.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), part.data_ptr(), *(t.data_ptr() for t in stats),
        out.data_ptr(), b, n, f, cin, cout, groups, GN_EPS, _cuda.stream(x)), what)
    return out


def fused_resnet_block(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                       w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                       groups: int = 8):
    """One U-Net ResnetBlock (plain twin: models/unet.py ResnetBlock).

    x (B, T, F, Cin); mask (B, T, 1, 1) prefix mask; t_bias (B, Cout) the
    FiLM bias Dense(mish(t_emb)); w1/w2 (3, 3, Cin|Cout, Cout) flax conv
    kernels (spatial (t, f)); wres/bres the optional 1x1 residual.
    -> (B, T, F, Cout). CUDA tensors launch the kernel, CPU tensors take
    resnet_block_plain."""
    bsz, t, f, _ = x.shape
    args = block_rows_args(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale,
                           gn2_bias, wres, bres)
    if _cuda.route(x, "fused_resnet_block"):
        out = _resnet_block_cuda(*args, f=f, groups=groups)
        fused_resnet_block.launches += 1
    else:
        out = resnet_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, -1)


fused_resnet_block.launches = 0


def _final_block_cuda(x, lens, w1, b1, s1, be1, wo, bo, f, groups):
    b, n, cin = x.shape
    cout = w1.shape[-1]
    _check_shapes("fused_final_block", x, cout, groups)
    dt, dev = x.dtype, x.device
    _cuda.require(x, "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    w1 = _cuda.require(w1.to(dt).contiguous(), "w1", shape=(9 * cin, cout), device=dev)
    wo = _cuda.require(wo.to(dt).contiguous(), "w_out", shape=(cout,), device=dev)
    lib = _cuda.lib()
    c1, mean, inv = _conv_stats(lib, x, w1, _f32(b1), lens, f, groups)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _cuda.check(
        lib.us_final_out(c1.data_ptr(), mean.data_ptr(), inv.data_ptr(), _f32(s1).data_ptr(),
                         _f32(be1).data_ptr(), wo.data_ptr(), _f32(bo).data_ptr(),
                         lens.data_ptr(), out.data_ptr(), b, n, cout, _cuda.stream(x)),
        "final block output",
    )
    return out


def fused_final_block(x, mask, w1, b1, gn_scale, gn_bias, w_out, b_out, groups: int = 8):
    """conv3x3 + GN + mish + mask (the estimator's final_block) fused with
    the 1-channel final_conv: x (B, T, F, C) -> (B, T, F) f32 score. CUDA
    tensors launch the kernel, CPU tensors take final_block_plain."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    args = (
        x.reshape(bsz, t * f, cin), lens_rows_from_mask(mask, f),
        w1.reshape(9 * cin, cout), b1, gn_scale, gn_bias, w_out.reshape(cout), b_out,
    )
    if _cuda.route(x, "fused_final_block"):
        out = _final_block_cuda(*args, f=f, groups=groups)
        fused_final_block.launches += 1
    else:
        out = final_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f)


fused_final_block.launches = 0
