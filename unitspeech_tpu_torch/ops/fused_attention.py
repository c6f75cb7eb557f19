"""Fused Rezero linear attention (kernel K4; counterpart of
unitspeech_tpu/ops/pallas_attention.py `fused_rezero_attention`).

y = mask * (x + g * LinearAttention(x)) over flattened (time x freq)
tokens, with the key softmax taken over tokens (reference
unitspeech.py:78-106). CUDA source: csrc/rezero_attention.cu, which states
what bounds the kernel and how it is laid out.

Rounding points (the Pallas kernel's): projections and the context in
f32; attn rounded to the activation dtype before the output projection;
the output projection rounded, then `+ b_out` and `x + g * out` in the
activation dtype.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda

HEADS, DIM_HEAD = 4, 32  # the only head layout the CUDA kernel takes


def rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens_rows, heads: int,
                           dim_head: int):
    """The K4 kernel's plain version: x (B, N, C), w_qkv (C, 3*H*d)
    [q|k|v], w_out (H*d, C), b_out (C,), g (1,), lens_rows (B,) or None."""
    dt = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    xf = x.to(torch.float32)
    w = w_qkv.to(dt).to(torch.float32)
    q = (xf @ w[:, :hd]).reshape(b, n, heads, dim_head)
    k = (xf @ w[:, hd:2 * hd]).reshape(b, n, heads, dim_head)
    v = (xf @ w[:, 2 * hd:]).reshape(b, n, heads, dim_head)
    e = torch.exp(k - k.amax(dim=1, keepdim=True))
    ctx = torch.einsum("bnhi,bnhj->bhij", e, v) / e.sum(dim=1)[..., None]
    attn = torch.einsum("bnhi,bhij->bnhj", q, ctx).reshape(b, n, hd).to(dt)
    out = (attn.to(torch.float32) @ w_out.to(dt).to(torch.float32)).to(dt)
    out = out + b_out.to(dt)
    y = x + g.to(dt) * out
    if lens_rows is not None:
        valid = torch.arange(n, device=x.device)[None, :] < lens_rows[:, None]
        y = y * valid[..., None].to(dt)
    return y


def _rezero_attention_cuda(x, w_qkv, w_out, b_out, g, lens_rows):
    b, n, c = x.shape
    hd = HEADS * DIM_HEAD
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_rezero_attention: the kernel takes bf16, got {x.dtype}")
    if c % 128:
        raise ValueError(f"fused_rezero_attention: C={c} must be a multiple of 128")
    dev = x.device
    _cuda.require(x, "x")
    wq = _cuda.require(w_qkv.to(x.dtype).contiguous(), "w_qkv", shape=(c, 3 * hd), device=dev)
    wo = _cuda.require(w_out.to(x.dtype).contiguous(), "w_out", shape=(hd, c), device=dev)
    bo = _cuda.require(b_out.to(torch.float32).contiguous(), "b_out", shape=(c,), device=dev)
    gg = _cuda.require(g.to(torch.float32).reshape(1).contiguous(), "g", device=dev)
    if lens_rows is None:
        lens_rows = torch.full((b,), n, dtype=torch.int32, device=dev)
    lens = _cuda.require(lens_rows.to(torch.int32).contiguous(), "lens", shape=(b,), device=dev)
    lib = _cuda.lib()
    nt = lib.us_attn_n_tiles(n)
    f32 = dict(dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nt, hd), **f32)
    part_den = torch.empty((b, nt, hd), **f32)
    part_num = torch.empty((b, nt, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    ctx = torch.empty((b, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    y = torch.empty_like(x)
    _cuda.check(
        lib.us_rezero_attention(x.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                gg.data_ptr(), lens.data_ptr(), y.data_ptr(),
                                part_m.data_ptr(), part_den.data_ptr(), part_num.data_ptr(),
                                ctx.data_ptr(), b, n, c, _cuda.stream(x)),
        "rezero attention",
    )
    return y


def fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens_rows=None,
                           heads: int = HEADS, dim_head: int = DIM_HEAD):
    """x (B, N, C) flattened tokens -> mask * (x + g * LinearAttention(x)).

    lens_rows: optional (B,) valid-row counts; the OUTPUT is zeroed at/after
    them (keys keep the reference's no-mask semantics, so zero padding rows
    enter the softmax). None = no output masking. CUDA tensors launch the
    kernel (4 heads of 32 only), CPU tensors take rezero_attention_plain."""
    if _cuda.route(x, "fused_rezero_attention"):
        if (heads, dim_head) != (HEADS, DIM_HEAD):
            raise ValueError(f"fused_rezero_attention: the kernel takes {HEADS} heads of "
                             f"{DIM_HEAD}, got {heads} x {dim_head}")
        y = _rezero_attention_cuda(x, w_qkv, w_out, b_out, g, lens_rows)
        fused_rezero_attention.launches += 1
        return y
    return rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens_rows, heads, dim_head)


fused_rezero_attention.launches = 0
