"""K9's int8 convs in their Hopper form (csrc/resnet_block.cu conv_tc with
I8, ops/fused_resnet_deep.py) on the CPU: the K-major swizzled int8 weight
tiles read back, and the kernel's data path replayed in numpy at the five
K9 sites with ragged lengths, lane by lane where it matters: per
128-channel chunk the TMA box (one 128-byte row of int8 a box row, zero
outside the tensor and past Cin, 16-byte pieces swizzled), each warp's
ldmatrix.x4 addresses (the tap's box row, the zero row outside the grid or
at/after the length) and the m64nNk32 s8 A fragment those four 8 x 16-byte
matrices form, the B operand read through the descriptor's swizzled
addresses, integer accumulation. The replay equals _conv3x3_i8_plain bit
for bit (integer products are exact); the card's kernel is held to the
same (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from test_torch_port_conv import pick_tile
from unitspeech_tpu_torch.ops import fused_resnet_deep as frd

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

KC8 = frd.I8_KC  # int8 channels a chunk: one 128-byte row
TILE_ROWS = 128
# (F, T, Cin, Cout): the K9 int8 convs at the 344-frame bucket (conv1 where
# Cin <= Cout, conv2), with a Cin of a partial chunk added
K9_CONV_SITES = [(20, 86, 256, 512), (20, 86, 512, 512), (10, 43, 512, 512),
                 (20, 86, 256, 256), (10, 43, 48, 128)]


def test_int8_weight_pack_reads_back():
    """pack_conv_weight_i8: tile (Cout tile, chunk, tap) row n holds the
    output channel's 128 int8 k values of that tap and chunk, 16-byte piece
    j at j ^ (n % 8), zero past Cin; BN = 128 where it divides Cout."""
    g = torch.Generator().manual_seed(0)
    for cin, cout in ((256, 512), (48, 192)):
        w8t = torch.randint(-127, 128, (cout, 9 * cin), generator=g).to(torch.int8)
        p = frd.pack_conv_weight_i8(w8t, cin)
        bn = 128 if cout % 128 == 0 else 64
        nc = -(-cin // KC8)
        assert p.shape == (cout // bn, nc, 9, bn, KC8) and p.dtype == torch.int8
        w = torch.zeros(cout, 9, nc * KC8, dtype=torch.int8)
        w[:, :, :cin] = w8t.reshape(cout, 9, cin)
        n = torch.arange(bn)
        for ct in range(cout // bn):
            for c in range(nc):
                for tap in range(9):
                    tile = p[ct, c, tap].reshape(bn, 8, 16)
                    back = tile[n[:, None], torch.arange(8)[None, :] ^ (n[:, None] % 8)]
                    want = w[ct * bn:(ct + 1) * bn, tap, c * KC8:(c + 1) * KC8]
                    assert torch.equal(back.reshape(bn, KC8), want)


def _box(x_b, ti0, fi0, bt_n, bf_n, chunk):
    """One TMA copy of a 128-channel int8 chunk: (box rows, 8 pieces, 16)
    with row R = bt * BF + bf at (ti0 + bt, fi0 + bf), zero outside the
    tensor and past Cin, piece j stored at j ^ (R % 8)."""
    t, f, cin = x_b.shape
    box = np.zeros((bt_n * bf_n, 8, 16), np.int64)
    for bt in range(bt_n):
        for bf in range(bf_n):
            ti, fi = ti0 + bt, fi0 + bf
            if 0 <= ti < t and 0 <= fi < f:
                v = np.zeros(KC8, np.int64)
                part = x_b[ti, fi, chunk * KC8:(chunk + 1) * KC8]
                v[:part.size] = part
                R = bt * bf_n + bf
                box[R, np.arange(8) ^ (R & 7)] = v.reshape(8, 16)
    return box


def _a_fragment(box, R, ok, kk):
    """The A operand of one k32 step for the tile's 128 rows (8 warps of 16),
    as the kernel forms it: lane L of warp w gives ldmatrix.x4 the address
    of its row r = 16 w + L % 16 (box row R[r], or the zero row where not
    ok) at piece (2 kk + L / 16) ^ (R % 8); matrix q takes its 8 rows from
    lanes 8 q .. 8 q + 7 and gives lane l bytes 4 (l % 4) .. +3 of its row
    l / 4, which the s8 fragment reads as row l / 4 + 8 (q % 2), k 16 (q /
    2) + 4 (l % 4) .. +3: matrix q is the 8 x 16 block at rows 8 (q % 2),
    k 16 (q / 2) of the warp's 16 x 32 A. -> (128, 32) int."""
    lane = np.arange(32)
    rr = 16 * np.arange(8)[:, None] + (lane % 16)[None, :]  # (warp, lane) -> row
    rx = np.where(ok[rr], R[rr] & 7, 0)
    piece = ((2 * kk + lane // 16)[None, :] ^ rx) & 7
    data = np.where(ok[rr][..., None], box[R[rr], piece], 0)  # (8 warps, 32 lanes, 16)
    a = np.zeros((8, 16, 32), np.int64)
    for q in range(4):
        a[:, 8 * (q % 2):8 * (q % 2) + 8, 16 * (q // 2):16 * (q // 2) + 16] = (
            data[:, 8 * q:8 * q + 8])
    return a.reshape(128, 32)


def _b_operand(packed, ct, c, tap, kk, bn):
    """B of one k32 step through the descriptor: the stage's row n, logical
    piece 2 kk + k / 16 stored at (2 kk + k / 16) ^ (n % 8). -> (32, BN)."""
    tile = packed[ct, c, tap].reshape(bn, 8, 16).numpy().astype(np.int64)
    n = np.arange(bn)[None, :]
    k = np.arange(32)[:, None]
    return tile[n, ((2 * kk + k // 16) ^ (n % 8)), k % 16]


def _i8_conv_replay(x8, lens_rows, packed, f, cout):
    """conv_tc<I8>'s blocks: x8 (B, T*F, Cin) int8 -> int64 (B, T*F, Cout)."""
    b, n, cin = x8.shape
    t = n // f
    tt_n, tf_n = pick_tile(t, f)
    bt_n, bf_n = tt_n + 2, tf_n + 2
    tiles_f = f // tf_n
    n_tiles = -(-t // tt_n) * tiles_f
    bn = packed.shape[-2]
    nc = -(-cin // KC8)
    xb = x8.reshape(b, t, f, cin).numpy().astype(np.int64)
    # f64 products are exact here (sums stay far below 2^53) and take BLAS;
    # a chunk's four k32 steps side by side
    bmat = {(c, tap): np.concatenate([np.concatenate(
        [_b_operand(packed, ct, c, tap, kk, bn) for ct in range(cout // bn)], 1)
        for kk in range(4)], 0).astype(np.float64) for c in range(nc) for tap in range(9)}
    r = np.arange(TILE_ROWS)
    tr, ff = r // tf_n, r % tf_n
    out = np.full((b, n, cout), np.iinfo(np.int64).min)
    for bb in range(b):
        for tile in range(n_tiles):
            to0, fo0 = (tile // tiles_f) * tt_n, (tile % tiles_f) * tf_n
            row_ok = (tr < tt_n) & (to0 + tr < t)
            acc = np.zeros((TILE_ROWS, cout))
            for c in range(nc):
                box = _box(xb[bb], to0 - 1, fo0 - 1, bt_n, bf_n, c)
                for tap in range(9):
                    dt, df = divmod(tap, 3)
                    R = np.where(row_ok, (tr + dt) * bf_n + ff + df, 0)
                    ti, fi = to0 + tr + dt - 1, fo0 + ff + df - 1
                    ok = row_ok & (ti >= 0) & (ti < t) & (fi >= 0) & (fi < f)
                    ok &= ti * f + fi < lens_rows[bb]
                    a = np.concatenate([_a_fragment(box, R, ok, kk) for kk in range(4)], 1)
                    acc += a.astype(np.float64) @ bmat[c, tap]
            m = (to0 + tr) * f + fo0 + ff
            assert (out[bb, m[row_ok]] == np.iinfo(np.int64).min).all()  # stored once
            out[bb, m[row_ok]] = acc[row_ok].astype(np.int64)
    return out


@pytest.mark.parametrize("f,t,cin,cout", K9_CONV_SITES)
def test_int8_conv_replay_bit_exact(f, t, cin, cout):
    """At each K9 conv site (3 rows, lengths full / ending mid-tile / 2
    frames; rows at/after each length zero, as the quantize writes them),
    the replayed box, zero row, ldmatrix A fragments and swizzled B equal
    _conv3x3_i8_plain exactly."""
    g = torch.Generator().manual_seed(f * cin + cout)
    n = t * f
    lens = np.array([n, (t - 5) * f, 2 * f])
    x8 = torch.randint(-127, 128, (3, n, cin), generator=g).to(torch.int8)
    for i in range(3):
        x8[i, lens[i]:] = 0
    w = torch.randn(3, 3, cin, cout, generator=g)
    wq = frd.quant_w(w)
    packed = frd.pack_conv_weight_i8(wq[0], cin)
    got = _i8_conv_replay(x8, lens, packed, f, cout)
    want = frd._conv3x3_i8_plain(x8, wq, f).numpy()
    assert np.array_equal(got, want)


def test_int8_conv_wrapper_plain_is_dequant():
    """On the CPU the int8 conv's wrapper is _conv3x3_i8_plain + _dequant
    in bf16, with the kernel's arguments."""
    g = torch.Generator().manual_seed(3)
    x8 = torch.randint(-127, 128, (2, 60, 32), generator=g).to(torch.int8)
    wq = frd.quant_w(torch.randn(3, 3, 32, 64, generator=g))
    sx, bias = torch.tensor([20.0, 31.0]), torch.randn(64, generator=g)
    got = frd.resnet_conv3x3_i8(x8, sx, wq, bias, torch.tensor([60, 40]), 6)
    want = frd._dequant(frd._conv3x3_i8_plain(x8, wq, 6), sx, wq[1], bias)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
