"""Fused Rezero linear attention (kernel K4; counterpart of
unitspeech_tpu/ops/pallas_attention.py `fused_rezero_attention`).

y = mask * (x + g * LinearAttention(x)) over flattened (time x freq)
tokens, with the key softmax taken over tokens (reference
unitspeech.py:78-106). CUDA source: csrc/rezero_attention.cu, which states
what bounds the kernel, how it is laid out and its schedule (`attn_plan`
asks it); `pack_attention_weights` is its weights' layout (made once at
load by the estimator).

Rounding points (the Pallas kernel's): projections and the context in
f32; attn rounded to the activation dtype before the output projection;
the output projection rounded, then `+ b_out` and `x + g * out` in the
activation dtype.

On a frame slice of the seq axis (`seq=`, a parallel.FrameSlice) the
kernel runs as two calls: phase 1 (`attn_kv`) writes the slice's softmax
partials (each with its own maxima), every rank's are gathered into one
buffer in rank order (one collective), and the merge and phase 2
(`attn_merge_out`) give every rank the whole sequence's context and the
slice's output rows. The plain twins (attn_kv_plain, attn_merge_out_plain)
keep the card's partial layout.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.resample import KC, swizzle128

HEADS, DIM_HEAD = 4, 32  # the only head layout the CUDA kernel takes
MERGE_MAX = 1024  # partials the merge takes (csrc/rezero_attention.cu P_MERGE)


def takes(c: int, heads: int = HEADS, dim_head: int = DIM_HEAD) -> bool:
    """The widths the CUDA kernel takes: C a multiple of 128 (above 512 its
    weight tiles stream through the ring: kv_smem / out_slots in
    csrc/rezero_attention.cu) and 4 heads of 32."""
    return c % 128 == 0 and (heads, dim_head) == (HEADS, DIM_HEAD)


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


def attn_kv_plain(x, w_qkv, p: int = 1, heads: int = HEADS, dim_head: int = DIM_HEAD):
    """Phase 1's plain twin: the softmax partials of x (B, N, C) in the
    card's layout, partial q over the tokens of the 128-row tiles q, q + p,
    ...: (m, den) (B, 2 head pairs, p, 64), column 32 hh + i the key
    dimension i of head 2 hp + hh (m the column maximum over the partial's
    tokens, den the sum of exp(k - m)), and num (B, 2, p, 2, 32, 32) =
    exp(k - m)^T v; a partial with no tokens is (-inf, 0, 0)."""
    b, n, _ = x.shape
    hd = heads * dim_head
    xf = x.to(torch.float32)
    w = w_qkv.to(x.dtype).to(torch.float32)
    k = (xf @ w[:, hd:2 * hd]).reshape(b, n, heads, dim_head)
    v = (xf @ w[:, 2 * hd:]).reshape(b, n, heads, dim_head)
    block = (torch.arange(n, device=x.device) // 128) % p
    ms, dens, nums = [], [], []
    for q in range(p):
        sel = block == q
        if not bool(sel.any()):
            ms.append(torch.full((b, heads, dim_head), float("-inf"), device=x.device))
            dens.append(torch.zeros((b, heads, dim_head), device=x.device))
            nums.append(torch.zeros((b, heads, dim_head, dim_head), device=x.device))
            continue
        kq = k[:, sel]
        m = kq.amax(dim=1)
        e = torch.exp(kq - m[:, None])
        ms.append(m)
        dens.append(e.sum(dim=1))
        nums.append(torch.einsum("bnhi,bnhj->bhij", e, v[:, sel]))
    pairs = heads // 2
    m, den = (torch.stack(t, dim=1).reshape(b, p, pairs, 2 * dim_head).transpose(1, 2)
              for t in (ms, dens))
    num = torch.stack(nums, dim=1).reshape(b, p, pairs, 2, dim_head, dim_head).transpose(1, 2)
    return m.contiguous(), den.contiguous(), num.contiguous()


def merge_partials(part_m, part_den, part_num, heads: int = HEADS,
                   dim_head: int = DIM_HEAD) -> torch.Tensor:
    """attn_merge's plain twin: partials (attn_kv_plain's layout, any
    number P) -> ctx (B, heads, d, d) f32 = sum_p num_p w_p / sum_p den_p
    w_p, w_p = exp(m_p - M), M the largest m_p."""
    b, pairs, p, _ = part_m.shape
    mx = part_m.amax(dim=2, keepdim=True)
    wp = torch.exp(part_m - mx)
    den = (part_den * wp).sum(dim=2).reshape(b, pairs, 2, dim_head)
    num = (part_num * wp.reshape(b, pairs, p, 2, dim_head)[..., None]).sum(dim=2)
    return (num / den[..., None]).reshape(b, heads, dim_head, dim_head)


def attn_merge_out_plain(x, w_qkv, w_out, b_out, g, lens_rows, parts, heads: int = HEADS,
                         dim_head: int = DIM_HEAD):
    """The merge and phase 2, plain: parts = (m, den, num) of any tokens
    (every seq rank's, gathered) -> mask * (x + g * (attn Wout + b_out)) over
    x's rows, with rezero_attention_plain's rounding points."""
    dt = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    ctx = merge_partials(*parts, heads=heads, dim_head=dim_head)
    q = (x.to(torch.float32) @ w_qkv.to(dt).to(torch.float32)[:, :hd]).reshape(
        b, n, heads, dim_head)
    attn = torch.einsum("bnhi,bhij->bnhj", q, ctx).reshape(b, n, hd).to(dt)
    out = (attn.to(torch.float32) @ w_out.to(dt).to(torch.float32)).to(dt)
    y = x + g.to(dt) * (out + b_out.to(dt))
    if lens_rows is not None:
        valid = torch.arange(n, device=x.device)[None, :] < lens_rows[:, None]
        y = y * valid[..., None].to(dt)
    return y


def attn_plan(b: int, n: int) -> dict:
    """The CUDA kernel's schedule at B rows of N tokens on this card, as
    csrc/rezero_attention.cu makes it (us_attn_plan): its 128-row tiles,
    the phase-1 blocks a (batch element, head pair) (p1, each writing one
    partial) and the phase-2 blocks a batch element (p2)."""
    import ctypes

    info = (ctypes.c_int * 3)()
    _cuda.check(_cuda.lib().us_attn_plan(b, n, info), "us_attn_plan")
    return dict(zip(("tiles", "p1", "p2"), info))


def pack_attention_weights(w_qkv, w_out):
    """w_qkv (C, 384) [q|k|v] and w_out (128, C) -> what the CUDA kernel
    reads, made once at load: K-major bf16 tiles of 128 columns x 64 k in
    the 128-byte swizzle. wkv (2 head pairs, C / 64, 128, 64), each head
    pair's columns [K_h | V_h | K_h+1 | V_h+1]; wq (C / 64, 128, 64); wo
    (C / 128, 2, 128, 64)."""
    c = w_qkv.shape[0]
    hd = HEADS * DIM_HEAD
    w = w_qkv.detach().to(torch.bfloat16)
    heads = [torch.cat([w[:, hd + DIM_HEAD * h:hd + DIM_HEAD * (h + 1)],
                        w[:, 2 * hd + DIM_HEAD * h:2 * hd + DIM_HEAD * (h + 1)]], dim=1)
             for h in range(HEADS)]
    kv = torch.stack([torch.cat(heads[2 * hp:2 * hp + 2], dim=1) for hp in range(2)])
    wkv = swizzle128(kv.reshape(2, c // KC, KC, 128).transpose(-1, -2)).contiguous()
    wq = swizzle128(w[:, :hd].reshape(c // KC, KC, 128).transpose(-1, -2)).contiguous()
    wo = w_out.detach().to(torch.bfloat16).reshape(2, KC, c // 128, 128).permute(2, 0, 3, 1)
    return wkv, wq, swizzle128(wo).contiguous()


def _rezero_attention_cuda(x, w_qkv, w_out, b_out, g, lens_rows, packed):
    b, n, c = x.shape
    hd = HEADS * DIM_HEAD
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_rezero_attention: the kernel takes bf16, got {x.dtype}")
    if not takes(c):
        raise ValueError(f"fused_rezero_attention: C={c} must be a multiple of 128")
    dev = x.device
    _cuda.require(x, "x")
    wkv, wq, wo = pack_attention_weights(w_qkv, w_out) if packed is None else packed
    _cuda.require(wkv, "wkv", dtype=torch.bfloat16, shape=(2, c // KC, 128, KC), device=dev)
    _cuda.require(wq, "wq", dtype=torch.bfloat16, shape=(c // KC, 128, KC), device=dev)
    _cuda.require(wo, "wo", dtype=torch.bfloat16, shape=(c // 128, 2, 128, KC), device=dev)
    bo = _cuda.require(b_out.to(torch.float32).contiguous(), "b_out", shape=(c,), device=dev)
    gg = _cuda.require(g.to(torch.float32).reshape(1).contiguous(), "g", device=dev)
    if lens_rows is None:
        lens_rows = torch.full((b,), n, dtype=torch.int32, device=dev)
    lens = _cuda.require(lens_rows.to(torch.int32).contiguous(), "lens", shape=(b,), device=dev)
    p1 = attn_plan(b, n)["p1"]
    f32 = dict(dtype=torch.float32, device=dev)
    part_m = torch.empty((b, 2, p1, 2 * DIM_HEAD), **f32)
    part_den = torch.empty((b, 2, p1, 2 * DIM_HEAD), **f32)
    part_num = torch.empty((b, 2, p1, 2, DIM_HEAD, DIM_HEAD), **f32)
    ctx = torch.empty((b, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    y = torch.empty_like(x)
    _cuda.check(
        _cuda.lib().us_rezero_attention(
            x.data_ptr(), wkv.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            gg.data_ptr(), lens.data_ptr(), y.data_ptr(), part_m.data_ptr(),
            part_den.data_ptr(), part_num.data_ptr(), ctx.data_ptr(), b, n, c, _cuda.stream(x)),
        "rezero attention",
    )
    return y


def _rezero_attention_seq(x, w_qkv, w_out, b_out, g, lens_rows, packed, seq, heads, dim_head):
    """K4 on a frame slice: phase 1 on the slice's tokens, every rank's
    partials gathered in rank order (one collective; each rank's count
    from the card's plan at its own tokens, one partial on the CPU), then
    the merge and phase 2 on the slice's rows."""
    b, n, c = x.shape
    cuda = _cuda.route(x, "fused_rezero_attention")
    f = n // seq.length
    sizes = ([attn_plan(b, m * f)["p1"] for _, m in seq.bounds] if cuda
             else [1] * len(seq.bounds))
    if not cuda:
        parts = attn_kv_plain(x, w_qkv, 1, heads, dim_head)
    else:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"fused_rezero_attention: the kernel takes bf16, got {x.dtype}")
        if not takes(c):
            raise ValueError(f"fused_rezero_attention: C={c} must be a multiple of 128")
        if sum(sizes) > MERGE_MAX:
            raise ValueError(f"fused_rezero_attention: {sum(sizes)} partials over the seq axis, "
                             f"the merge takes {MERGE_MAX}")
        _cuda.require(x, "x")
        wkv, wq, wo = pack_attention_weights(w_qkv, w_out) if packed is None else packed
        f32 = dict(dtype=torch.float32, device=x.device)
        p1 = sizes[seq.shard.rank]
        parts = (torch.empty((b, 2, p1, 2 * DIM_HEAD), **f32),
                 torch.empty((b, 2, p1, 2 * DIM_HEAD), **f32),
                 torch.empty((b, 2, p1, 2, DIM_HEAD, DIM_HEAD), **f32))
        _cuda.check(_cuda.lib().us_attn_kv(x.data_ptr(), wkv.data_ptr(),
                                           *(t.data_ptr() for t in parts), b, n, c,
                                           _cuda.stream(x)), "attention partials")
    # one buffer (B, 2, P, 64 + 64 + 2048): the three partials of every rank
    flat = torch.cat([parts[0], parts[1], parts[2].reshape(b, 2, -1, 2 * DIM_HEAD ** 2)], -1)
    flat = seq.cat(flat, sizes, dim=2)
    d = 2 * DIM_HEAD
    parts = (flat[..., :d].contiguous(), flat[..., d:2 * d].contiguous(),
             flat[..., 2 * d:].reshape(b, 2, -1, 2, DIM_HEAD, DIM_HEAD).contiguous())
    if not cuda:
        return attn_merge_out_plain(x, w_qkv, w_out, b_out, g, lens_rows, parts, heads, dim_head)
    dev = x.device
    _cuda.require(wq, "wq", dtype=torch.bfloat16, shape=(c // KC, 128, KC), device=dev)
    _cuda.require(wo, "wo", dtype=torch.bfloat16, shape=(c // 128, 2, 128, KC), device=dev)
    bo = _cuda.require(b_out.to(torch.float32).contiguous(), "b_out", shape=(c,), device=dev)
    gg = _cuda.require(g.to(torch.float32).reshape(1).contiguous(), "g", device=dev)
    if lens_rows is None:
        lens_rows = torch.full((b,), n, dtype=torch.int32, device=dev)
    lens = _cuda.require(lens_rows.to(torch.int32).contiguous(), "lens", shape=(b,), device=dev)
    ctx = torch.empty((b, HEADS, DIM_HEAD, DIM_HEAD), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    _cuda.check(_cuda.lib().us_attn_merge_out(
        x.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(), gg.data_ptr(),
        lens.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in parts), sum(sizes),
        ctx.data_ptr(), b, n, c, _cuda.stream(x)), "attention merge + out")
    return y


def fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens_rows=None,
                           heads: int = HEADS, dim_head: int = DIM_HEAD, packed=None, seq=None):
    """x (B, N, C) flattened tokens -> mask * (x + g * LinearAttention(x)).

    lens_rows: optional (B,) valid-row counts; the OUTPUT is zeroed at/after
    them (keys keep the reference's no-mask semantics, so zero padding rows
    enter the softmax). None = no output masking. packed: the weights'
    pack_attention_weights when made at load (else packed here). CUDA
    tensors launch the kernel (4 heads of 32 only), CPU tensors take
    rezero_attention_plain. seq: x holds a frame slice's tokens (frames x
    F) on the seq axis (parallel.FrameSlice): the split kernel with the
    partials merged over the axis (the module docstring), or its plain
    twins on CPU tensors."""
    if seq is not None:
        if x.is_cuda and not takes(HEADS * DIM_HEAD, heads, dim_head):
            raise ValueError(f"fused_rezero_attention: the kernel takes {HEADS} heads of "
                             f"{DIM_HEAD}, got {heads} x {dim_head}")
        y = _rezero_attention_seq(x, w_qkv, w_out, b_out, g, lens_rows, packed, seq, heads,
                                  dim_head)
        if x.is_cuda:
            fused_rezero_attention.launches += 1
        return y
    if _cuda.route(x, "fused_rezero_attention"):
        if not takes(HEADS * DIM_HEAD, heads, dim_head):
            raise ValueError(f"fused_rezero_attention: the kernel takes {HEADS} heads of "
                             f"{DIM_HEAD}, got {heads} x {dim_head}")
        y = _rezero_attention_cuda(x, w_qkv, w_out, b_out, g, lens_rows, packed)
        fused_rezero_attention.launches += 1
        return y
    return rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens_rows, heads, dim_head)


fused_rezero_attention.launches = 0
