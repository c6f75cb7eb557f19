"""The estimator's strided resampling convs (kernels K11a and K11b;
counterpart of unitspeech_tpu/ops/pallas_resample.py `fused_downsample_conv`
and `fused_upsample_conv`).

Downsample is conv3x3 stride 2 'SAME', Upsample ConvTranspose 4x4 stride 2
with flax padding (2, 2) (torch padding 1). Both take the unmasked
activation and the (B, T, 1, 1) prefix mask: input rows at/after the
length read zero, so the estimator skips its `h * mask` pass, and the bias
lands on every output row, as nn.Conv / nn.ConvTranspose put it. CUDA
source: csrc/resample.cu, which states what bounds the kernels and how
they are laid out.

Numerics contract (the Pallas kernels'): bf16 products (the flax kernel is
rounded to the activation dtype), an f32 accumulator plus the f32 bias,
rounded once to the activation dtype.

The gates `supports_downsample` / `supports_upsample` are the JAX
package's own (TPU tilings that fit VMEM with 8-aligned blocks); the port
keeps them so that it routes the sites JAX routes.

On a frame slice of the seq axis (`seq=`, a parallel.FrameSlice; slices
start on 8-frame boundaries, so every stride-2 output is whole) each
kernel reads a halo'd input: the downsample the one frame before the slice
(output frame j reads input frames 2 j - 1 .. 2 j + 1), the upsample one
frame a side; the frames arrive masked by the sender (zeros at the global
ends), `lens` masks the slice's own (the kernels' hb / ha frames before and
after the slice). On a column slice of the model axis (`model=`, a
parallel.ModelShard) the kernel and bias are the rank's Cout columns,
packed from them, and the output is gathered over the axis. The gates
read the global frames and widths; `kernel_takes` and `tile_cols` apply
to the rank's slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.models.layers import conv_transpose_weight
from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.masking import frames_from_mask


def _pick_fpt_down(t_out: int, f: int, c_max: int, budget_bytes: int = 6 * 1024 * 1024):
    """pallas_resample._pick_fpt_down: output frames per TPU tile, or None."""
    best, best_key = None, None
    for k in range(1, t_out + 1):
        if t_out % k:
            continue
        if (k * (f // 2)) % 8:
            continue
        rows = (2 * k + 1) * f
        if rows * c_max * 6 + 9 * c_max * c_max * 2 > budget_bytes:
            continue
        key = (abs(rows - 1024), -k)
        if best_key is None or key < best_key:
            best, best_key = k, key
    return best


def _pick_fpt_up(t: int, f: int, c_max: int, budget_bytes: int = 6 * 1024 * 1024):
    """pallas_resample._pick_fpt_up: input frames per TPU tile, or None."""
    best, best_key = None, None
    for k in range(1, t + 1):
        if t % k:
            continue
        if (2 * k * f) % 8:
            continue
        rows = (k + 2) * f
        if (rows * c_max * 2 + 4 * k * f * c_max * 4
                + 16 * c_max * c_max * 2 + 8 * k * f * c_max) > budget_bytes:
            continue
        key = (abs(rows - 1024), -k)
        if best_key is None or key < best_key:
            best, best_key = k, key
    return best


def supports_downsample(t: int, f: int, c_max: int) -> bool:
    """The JAX gate (pallas_resample.supports_downsample): the estimator's
    F = 80 and F = 40 downsamples."""
    return t % 2 == 0 and f % 8 == 0 and _pick_fpt_down(t // 2, f, c_max) is not None


def supports_upsample(t: int, f: int, c_max: int) -> bool:
    """The JAX gate (pallas_resample.supports_upsample): the estimator's
    F = 40 upsample."""
    return f % 8 == 0 and _pick_fpt_up(t, f, c_max) is not None


def _masked_nchw(x, mask):
    """(B, T, F, C) in the activation dtype -> masked f32 (B, C, T, F)."""
    return (x * mask.to(x.dtype)).to(torch.float32).permute(0, 3, 1, 2)


def downsample_conv_plain(x, mask, kernel, bias):
    """The K11a kernel's plain version: x (B, T, F, Cin), kernel (3, 3, Cin,
    Cout) flax layout -> (B, T/2, F/2, Cout) in x's dtype."""
    w = kernel.to(x.dtype).to(torch.float32).permute(3, 2, 0, 1)
    y = F.conv2d(_masked_nchw(x, mask), w, bias.to(torch.float32), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_conv_plain(x, mask, kernel, bias):
    """The K11b kernel's plain version: x (B, T, F, Cin), kernel (4, 4, Cin,
    Cout) flax ConvTranspose layout (unflipped) -> (B, 2T, 2F, Cout)."""
    w = conv_transpose_weight(kernel.to(x.dtype).to(torch.float32))
    y = F.conv_transpose2d(_masked_nchw(x, mask), w, bias.to(torch.float32), stride=2,
                           padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


# --- the kernels' weight layout (csrc/resample.cu) --------------------------

KC = 64  # input channels per chunk: one 128-byte row of a weight tile


def kernel_takes(cin: int, cout: int) -> bool:
    """The channel counts the CUDA kernels take (16-byte rows, whole
    64-column wgmma tiles)."""
    return cin % 8 == 0 and cout % 64 == 0


def tile_cols(up: bool, cout: int) -> int:
    """The Cout tile (BN) of the packed weights, which the launch takes from
    them: the whole Cout up to 256 for K11a, up to 128 for K11b (two 64 x BN
    accumulators a thread allow no more)."""
    for bn in (128, 64) if up else (256, 128, 64):
        if cout % bn == 0:
            return bn
    raise ValueError(f"Cout={cout} is not a multiple of 64")


def up_stage_taps():
    """K11b's weight stages: stage q = (it, jf) holds the tiles of phases
    p = (a, b) in order, phase (a, b) taking flax tap (a + 2 it, b + 2 jf);
    [q][p] -> kt * 4 + kf."""
    return [[(a + 2 * (q >> 1)) * 4 + b + 2 * (q & 1) for a in (0, 1) for b in (0, 1)]
            for q in range(4)]


def swizzle128(t):
    """(..., BN, 128 bytes: 64 bf16 or 128 int8) -> the 128-byte swizzle of a
    K-major wgmma tile: the 16-byte chunk j of row n is stored at chunk
    j ^ (n % 8). Its own inverse."""
    *lead, bn, k = t.shape
    v = t.reshape(*lead, bn // 8, 8, 8, k // 8)
    r = torch.arange(8, device=t.device)
    return v[..., r[:, None], r[:, None] ^ r[None, :], :].reshape(*lead, bn, k)


def pad_chunks(w, cin):
    """(taps..., Cin, Cout) -> Cin padded with zero rows to whole chunks."""
    nc = -(-cin // KC)
    return F.pad(w, (0, 0, 0, nc * KC - cin)), nc


def pack_downsample_weight(kernel):
    """(3, 3, Cin, Cout) flax kernel -> K11a's bf16 tiles, made once at load:
    (Cout / BN, chunks, 9 taps, BN, 64), each tile K-major in the 128-byte
    swizzle."""
    _, _, cin, cout = kernel.shape
    bn = tile_cols(False, cout)
    w, nc = pad_chunks(kernel.detach().to(torch.bfloat16).reshape(9, cin, cout), cin)
    w = w.reshape(9, nc, KC, cout // bn, bn).permute(3, 1, 0, 4, 2)
    return swizzle128(w).contiguous()


def pack_upsample_weight(kernel):
    """(4, 4, Cin, Cout) flax ConvTranspose kernel -> K11b's bf16 tiles, made
    once at load: (Cout / BN, chunks, 4 steps, 4 phases, BN, 64) in
    up_stage_taps() order, each tile K-major in the 128-byte swizzle."""
    _, _, cin, cout = kernel.shape
    bn = tile_cols(True, cout)
    taps = torch.tensor(up_stage_taps(), device=kernel.device)
    w = kernel.detach().to(torch.bfloat16).reshape(16, cin, cout)[taps]
    w, nc = pad_chunks(w, cin)
    w = w.reshape(4, 4, nc, KC, cout // bn, bn).permute(4, 2, 0, 1, 5, 3)
    return swizzle128(w).contiguous()


HALO = {False: (1, 0), True: (1, 1)}  # (frames before, after) the slice a kernel reads


def _resample_cuda(fn, what, up, x, bias, packed, lens, rows_out, halo=(0, 0)):
    """Launch K11a / K11b (fn) on x (B, T, F, Cin); halo: (before, after),
    the frames of a halo'd x around the slice's T."""
    b, t, f, cin = x.shape
    t -= sum(halo)
    cout = bias.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 activations, got {x.dtype}")
    if not kernel_takes(cin, cout):
        raise ValueError(f"{what}: unsupported Cin={cin}, Cout={cout} (Cin % 8, Cout % 64)")
    if not up and (t % 2 or f % 2):
        raise ValueError(f"{what}: T={t} and F={f} must be even")
    dev = x.device
    x = _cuda.require(x.contiguous(), "x", dtype=torch.bfloat16)
    steps = (4, 4) if up else (9,)
    bn = packed.shape[-2] if packed.dim() == len(steps) + 4 else 0  # the packer's choice
    if not bn or cout % bn:
        raise ValueError(f"{what}: packed kernel {tuple(packed.shape)} for Cout={cout}")
    _cuda.require(packed, "packed kernel", dtype=torch.bfloat16, device=dev,
                  shape=(cout // bn, -(-cin // KC), *steps, bn, KC))
    if bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != dev:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    _cuda.require(bias, "bias", shape=(cout,))
    if lens.dtype != torch.int32 or tuple(lens.shape) != (b,) or lens.device != dev:
        raise ValueError(f"{what}: lens must be ({b},) int32 on {dev}")
    if not lens.is_contiguous():
        raise ValueError(f"{what}: lens must be contiguous")
    out = torch.empty((b, rows_out, cout), dtype=x.dtype, device=dev)
    _cuda.check(fn(x.data_ptr(), packed.data_ptr(), bias.data_ptr(), lens.data_ptr(),
                   out.data_ptr(), b, t, f, cin, cout, bn, *halo, _cuda.stream(x)), what)
    return out


def fused_downsample_conv(x, mask, kernel, bias, *, packed=None, lens=None, seq=None,
                          model=None):
    """Masked conv3x3 stride 2: x (B, T, F, Cin), T and F even, mask
    (B, T, 1, 1), kernel (3, 3, Cin, Cout) -> (B, T/2, F/2, Cout). packed:
    the kernel from pack_downsample_weight, lens: (B,) int32 valid frames of
    `mask`. The estimator makes both ahead (once at load, once per call);
    the kernel launch takes them, made here from `kernel` and `mask` when
    absent. CUDA tensors launch the kernel, CPU tensors take
    downsample_conv_plain. seq: x is a frame slice of the seq axis (mask
    and lens its frames'); model: kernel and bias are this rank's Cout
    columns of the model axis, the output every channel (resample_sharded)."""
    b, t, f, _ = x.shape
    if seq is not None or model is not None:
        out = resample_sharded(False, x, mask, kernel, bias, packed, lens, seq, model)
        if x.is_cuda:
            fused_downsample_conv.launches += 1
        return out
    if _cuda.route(x, "fused_downsample_conv"):
        out = _resample_cuda(
            _cuda.lib().us_downsample_conv, "fused_downsample_conv", False, x, bias,
            pack_downsample_weight(kernel) if packed is None else packed,
            frames_from_mask(mask) if lens is None else lens, (t // 2) * (f // 2))
        fused_downsample_conv.launches += 1
        return out.reshape(b, t // 2, f // 2, -1)
    return downsample_conv_plain(x, mask, kernel, bias)


fused_downsample_conv.launches = 0


def fused_upsample_conv(x, mask, kernel, bias, *, packed=None, lens=None, seq=None,
                        model=None):
    """Masked ConvTranspose 4x4 stride 2 (flax padding 2): x (B, T, F, Cin),
    mask (B, T, 1, 1), kernel (4, 4, Cin, Cout) unflipped -> (B, 2T, 2F,
    Cout). packed (pack_upsample_weight), lens, seq and model as
    fused_downsample_conv's. CUDA tensors launch the kernel, CPU tensors
    take upsample_conv_plain."""
    b, t, f, _ = x.shape
    if seq is not None or model is not None:
        out = resample_sharded(True, x, mask, kernel, bias, packed, lens, seq, model)
        if x.is_cuda:
            fused_upsample_conv.launches += 1
        return out
    if _cuda.route(x, "fused_upsample_conv"):
        out = _resample_cuda(
            _cuda.lib().us_upsample_conv, "fused_upsample_conv", True, x, bias,
            pack_upsample_weight(kernel) if packed is None else packed,
            frames_from_mask(mask) if lens is None else lens, 4 * t * f)
        fused_upsample_conv.launches += 1
        return out.reshape(b, 2 * t, 2 * f, -1)
    return upsample_conv_plain(x, mask, kernel, bias)


fused_upsample_conv.launches = 0


def resample_halo_plain(up: bool, xh, lens, kernel, bias, halo):
    """K11a / K11b on a halo'd input, plain: xh (B, before + T + after, F,
    Cin) with halo = (before, after) frames of the neighbours around the
    slice's T, read as they are; the slice's frames at/after lens (B,)
    read zero -> the slice's (B, T/2, F/2, Cout) or (B, 2T, 2F, Cout) in
    xh's dtype."""
    before, after = halo
    t = xh.shape[1] - before - after
    inner = torch.arange(t, device=xh.device)[None, :] < lens[:, None]
    one = torch.ones((xh.shape[0], before), dtype=torch.bool, device=xh.device)
    valid = torch.cat([one, inner, one[:, :after]], dim=1)
    xm = (xh * valid[:, :, None, None].to(xh.dtype)).to(torch.float32).permute(0, 3, 1, 2)
    if up:
        w = conv_transpose_weight(kernel.to(xh.dtype).to(torch.float32))
        y = F.conv_transpose2d(xm, w, bias.to(torch.float32), stride=2, padding=1)
        y = y[:, :, 2 * before:2 * before + 2 * t]
    else:
        w = kernel.to(xh.dtype).to(torch.float32).permute(3, 2, 0, 1)
        y = F.conv2d(xm, w, bias.to(torch.float32), stride=2, padding=(0, 1))
    return y.permute(0, 2, 3, 1).to(xh.dtype)


def resample_sharded(up: bool, x, mask, kernel, bias, packed, lens, seq, model):
    """K11a (up False) or K11b on a frame slice of the seq axis and / or a
    column slice of the model axis: on a frame slice the kernel over x's
    halo'd frames (HALO[up], sent masked by `mask`; one collective), on a
    column slice the rank's Cout columns gathered (one collective). CUDA
    tensors launch the kernel (with the halo's frames on a frame slice),
    CPU tensors take the plain twins."""
    what = "fused_upsample_conv" if up else "fused_downsample_conv"
    b, t, f, _ = x.shape
    if lens is None:
        lens = frames_from_mask(mask)
    halo = (0, 0) if seq is None else HALO[up]
    xin = x if seq is None else seq.halo(x, *halo, mask=mask)
    rows = 4 * t * f if up else (t // 2) * (f // 2)
    if _cuda.route(x, what):
        lib = _cuda.lib()
        if packed is None:
            packed = (pack_upsample_weight if up else pack_downsample_weight)(kernel)
        out = _resample_cuda(lib.us_upsample_conv if up else lib.us_downsample_conv, what, up,
                             xin, bias, packed, lens, rows, halo)
        out = out.reshape(b, 2 * t if up else t // 2, 2 * f if up else f // 2, -1)
    elif seq is None:
        out = (upsample_conv_plain if up else downsample_conv_plain)(x, mask, kernel, bias)
    else:
        out = resample_halo_plain(up, xin, lens, kernel, bias, halo)
    return out if model is None else model.gather(out)


def resample_plan(up: bool, b: int, t: int, f: int, cin: int, cout: int) -> dict:
    """The kernel's launch plan at a site with the packer's Cout tile, as
    csrc/resample.cu makes it (the card's us_resample_plan): row tile, Cout
    tile, blocks, threads, dynamic shared memory, box slots and blocks an SM
    holds."""
    import ctypes

    info = (ctypes.c_int * 8)()
    _cuda.check(_cuda.lib().us_resample_plan(int(up), b, t, f, cin, cout,
                                             tile_cols(up, cout), info), "us_resample_plan")
    keys = ("tt", "tf", "bn", "blocks", "threads", "smem", "box_slots", "blocks_per_sm")
    return dict(zip(keys, info))
