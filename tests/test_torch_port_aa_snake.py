"""K5 / K6's Hopper form (csrc/aa_snake.cu, ops/aa_snake.py) on the CPU, and
the vocoder's packing of what the kernels read:

  * the activation pass replayed in numpy (f64) as aa_kernel computes it:
    per block of 64 samples x 32 channels the clamped x window, z once per
    even / odd upsampled pair (a pair before 0 is z[0], past 2T - 1 is
    z[2T - 1]) in two parity rows, and the downsample from them, written
    channels-last for K5 and (B, C, T) for K6; against the plain version at
    every sample, lengths shorter than the filters' reach included;
  * the conv replayed on that activation at the served (C, k, d) and at
    the widths past them K5 takes (C = 96 on 32-column tiles, reaches over
    64 whose box comes in pieces): per 128-sample tile and Cout tile, per
    64-channel chunk the TMA box of 128 + 2 R rows from t0 - R (zero
    outside [0, T) and past C: the conv's padding) in the 128-byte swizzle,
    one copy up to 256 rows, above it pieces of whole 8-row swizzle atoms
    each swizzled on its own, tap j of row r read through the
    swizzled ldmatrix address of box row r + j d, the weights read back
    from the packed tiles by the stage addressing, the epilogue's bias and
    residual, each output stored once; against aa_snake_conv_plain;
  * the packed weights read back, the widths K5 takes;
  * the vocoder's load hook: a second load_state_dict re-packs, an
    in-place update followed by pack() too, only where K5 takes the widths.

Tolerance: the replay is f64 against the plain f32 path, 2e-5 abs / 1e-4
rel (f32 sums in another order); the packing is exact."""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.models import vocoder as tvoc
from unitspeech_tpu_torch.ops import aa_snake

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
KC = 64
AA_TT, AA_CB = 64, 32  # aa_kernel's block: samples x channels
BM = aa_snake.CONV_BM
# the served (C, k, d) of K5: BigVGAN's four stages, three AMP kernels, the
# dilations 1, 3, 5 (the residual convs at d = 1)
SERVED = [(c, k, d) for c in (256, 128, 64, 32) for k in (3, 7, 11) for d in (1, 3, 5)]
# widths K5 takes that no served stage has: a 96-wide stage (BigVGAN-v2's
# 1536-channel generators) and 160 on 32-column tiles, and reaches over 64
# (boxes of more than 256 rows: 80 and MAX_REACH = 128, two pieces each)
WIDER = [(96, 11, 5), (160, 3, 3), (32, 5, 40), (96, 3, 128), (64, 9, 16)]


def _box_pieces(reach):
    """The TMA copies of K5's box (csrc/aa_snake.cu make_conv_plan): one of
    128 + 2 R rows up to 256 rows, else the fewest pieces of at most 256
    rows, each a whole number of 8-row swizzle atoms. (pieces, rows each)."""
    rows = BM + 2 * reach
    pieces = -(-rows // 256)
    each = -(-rows // pieces)
    return (1, rows) if pieces == 1 else (pieces, -(-each // 8) * 8)


def _inputs(seed, b, c, t, k=None):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    p = dict(x=r(b, c, t, scale=0.7), alpha=r(c, scale=0.3), beta=r(c, scale=0.3))
    if k is not None:
        p.update(w=r(k, c, c, scale=(k * c) ** -0.5), bias=r(c, scale=0.1),
                 res=r(b, c, t, scale=0.5))
    return p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _aa_replay(x, alpha, beta, logscale=True, channels_last=False):
    """aa_kernel's blocks in numpy (f64): x (B, C, T) -> y (B, C, T), or
    (B, T, C) with channels_last."""
    f0, f1, g, off0, off1, dn_off = aa_snake.phase_filters()
    assert (off0, off1, dn_off) == (-3, -2, -5)
    f0, f1, g = (np.asarray(v, np.float64) for v in (f0, f1, g))
    b, c, t = x.shape
    a, bb = alpha.astype(np.float64), beta.astype(np.float64)
    if logscale:
        a, bb = np.exp(a), np.exp(bb)
    ib = 1.0 / (bb + 1e-9)
    y = np.full((b, c, t), np.nan)
    for t0 in range(0, t, AA_TT):
        for c0 in range(0, c, AA_CB):
            ch = slice(c0, min(c, c0 + AA_CB))
            # the x window x[t0 - 6 .. t0 + TT + 5], clamped (the replicate pad)
            xs = x[:, ch][..., np.clip(t0 - 6 + np.arange(AA_TT + 12), 0, t - 1)]
            u = t0 - 3 + np.arange(AA_TT + 6)  # the tile's TT + 6 pairs
            uc = np.clip(u, 0, t - 1)
            win = np.stack([xs[..., uc - t0 + 3 + k] for k in range(7)], -1)  # x[uc - 3 + k]
            e, o = win[..., :6] @ f0, win[..., 1:] @ f1
            ac, ibc = a[ch, None], ib[ch, None]
            ze = e + ibc * np.sin(e * ac) ** 2
            zo = o + ibc * np.sin(o * ac) ** 2
            zo = np.where(u < 0, ze, zo)
            ze = np.where(u > t - 1, zo, ze)
            r = np.arange(min(AA_TT, t - t0))
            out = sum(g[2 * s] * zo[..., r + s] + g[2 * s + 1] * ze[..., r + 1 + s]
                      for s in range(6))
            assert np.isnan(y[:, ch, t0 + r]).all()  # each output written once
            y[:, ch, t0 + r] = out
    assert not np.isnan(y).any()
    return np.swapaxes(y, 1, 2).copy() if channels_last else y


def _swizzled_box(y_b, lo, rows, chunk):
    """One TMA copy: box row R holds y[lo + R, chunk's 64 channels], zero
    outside [0, T) and past C, its 16-byte piece j at j ^ (R % 8)."""
    t, c = y_b.shape
    box = np.zeros((rows, 8, 8))
    for R in range(rows):
        if 0 <= lo + R < t:
            v = np.zeros(KC)
            part = y_b[lo + R, chunk * KC:(chunk + 1) * KC]
            v[:part.size] = part
            box[R, np.arange(8) ^ (R & 7)] = v.reshape(8, 8)
    return box


def _read_stage(flat, stage, bn):
    """The (64, BN) weights of one ring stage: element (k, n) in row n,
    16-byte piece (k / 8) ^ (n % 8)."""
    n, kk = np.meshgrid(np.arange(bn), np.arange(KC), indexing="ij")
    elem = n * KC + (((kk >> 3) ^ (n & 7)) << 3) + (kk & 7)
    return flat[stage + elem].T


def _conv_replay(y_btc, packed, k, d, bias, res=None):
    """aa_conv_kernel's blocks in numpy: y (B, T, C) channels-last,
    `packed` pack_conv_weight's tiles -> out (B, C, T)."""
    b, t, c = y_btc.shape
    bn = aa_snake.conv_cols(c)
    reach = (k - 1) // 2 * d
    pieces, piece_rows = _box_pieces(reach)
    rows = pieces * piece_rows
    assert rows >= BM + 2 * reach and piece_rows <= 256
    nc = -(-c // KC)
    halves = 2 if c >= KC else 1  # C = 32: the last two k16 steps hold no channel
    flat = packed.float().reshape(-1).numpy().astype(np.float64)
    assert flat.size == (c // bn) * nc * k * bn * KC
    out = np.full((b, c, t), np.nan)
    r = np.arange(BM)
    for bb in range(b):
        for t0 in range(0, t, BM):
            for ct in range(c // bn):
                acc = np.zeros((BM, bn))
                for ch in range(nc):
                    # each piece a TMA copy swizzled from its own first
                    # row: the same box where a piece is whole 8-row atoms
                    box = np.concatenate([_swizzled_box(y_btc[bb], t0 - reach + i * piece_rows,
                                                        piece_rows, ch)
                                          for i in range(pieces)])
                    for j in range(k):
                        R = r + j * d  # the tap's box row: y[t0 + r + (j - (k-1)/2) d]
                        assert R.max() < rows
                        a = box[R[:, None], np.arange(8)[None, :] ^ (R[:, None] & 7)]
                        a = a.reshape(BM, KC)
                        wst = _read_stage(flat, ((ct * nc + ch) * k + j) * bn * KC, bn)
                        kmax = 16 * 2 * halves
                        assert not a[:, kmax:].any() and not wst[kmax:].any()
                        acc += a[:, :kmax] @ wst[:kmax]
                # (rows, channels) of this tile: the epilogue's transpose
                # into (B, C, T) is the indexing's
                idx = (bb, slice(ct * bn, (ct + 1) * bn), t0 + r[t0 + r < t])
                v = acc[t0 + r < t] + bias[ct * bn:(ct + 1) * bn]
                if res is not None:
                    v = v + res[idx]
                assert np.isnan(out[idx]).all()  # each output stored once
                out[idx] = v
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("c,t", [(32, 1), (32, 3), (64, 11), (32, 64), (24, 65), (64, 300),
                                 (32, 129)])
@pytest.mark.parametrize("logscale", [True, False])
def test_aa_pass_replay_matches_plain(c, t, logscale):
    """The activation pass, both layouts, against aa_snake_plain at every
    sample: lengths below the filters' reach, one sample past a tile, C not
    a multiple of the 32-channel block (K6)."""
    p = _inputs(c + t, 2, c, t)
    want = aa_snake.aa_snake_plain(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]), logscale).numpy()
    got = _aa_replay(p["x"], p["alpha"], p["beta"], logscale)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if c % AA_CB == 0:
        got_cl = _aa_replay(p["x"], p["alpha"], p["beta"], logscale, channels_last=True)
        np.testing.assert_array_equal(np.swapaxes(got_cl, 1, 2), got)


@pytest.mark.parametrize("c,k,d", SERVED + WIDER)
def test_conv_replay_matches_plain(c, k, d):
    """K5 replayed at each served (C, k, d) and the wider ones it takes
    (WIDER): the activation pass, then the
    conv's boxes, shifted tap rows, packed weights and epilogue, at a
    length shorter than the conv's reach (5 samples: most box rows are TMA
    zero fill) and one over two tiles with the residual; against
    aa_snake_conv_plain at every sample."""
    for t, residual in ((5, False), (133, True)):
        p = _inputs(c + k * d + t, 1, c, t, k)
        w = p["w"].astype(np.float32)
        res = p["res"] if residual else None
        want = aa_snake.aa_snake_conv_plain(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]), _t(w),
                                            _t(p["bias"]), d,
                                            None if res is None else _t(res)).numpy()
        y = _aa_replay(p["x"], p["alpha"], p["beta"], channels_last=True)
        # the packed tiles hold bf16 weights: the replay reads the same
        # layout in f32 (_pack_f32), so that only the tiling is under test
        packed = _pack_f32(_t(w))
        assert packed.shape == aa_snake.pack_conv_weight(_t(w)).shape
        got = _conv_replay(y, packed, k, d, p["bias"], res)
        np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()),
                                   rtol=RTOL)


def _pack_f32(w):
    """pack_conv_weight's layout in f32 (the same permutation and swizzle
    without the bf16 rounding)."""
    from unitspeech_tpu_torch.ops.resample import pad_chunks, swizzle128

    k, cin, cout = w.shape
    bn = aa_snake.conv_cols(cout)
    wp, nc = pad_chunks(w, cin)
    wp = wp.reshape(k, nc, KC, cout // bn, bn).permute(3, 1, 0, 4, 2)
    return swizzle128(wp).contiguous()


@pytest.mark.parametrize("c", [32, 64, 96, 128, 160, 256, 512])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_packed_weights_read_back(c, k):
    """pack_conv_weight's tiles (C / BN, chunks, k, BN, 64), read back
    through the conv's stage addressing, give the bf16 kernel, with zero
    rows past C (C = 32, 96 and 160 fill half a chunk)."""
    rng = np.random.default_rng(c + k)
    w = torch.from_numpy(rng.standard_normal((k, c, c)).astype(np.float32))
    packed = aa_snake.pack_conv_weight(w)
    bn = aa_snake.conv_cols(c)
    nc = -(-c // KC)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (c // bn, nc, k, bn, KC)
    flat = packed.float().reshape(-1).numpy()
    got = np.zeros((k, nc * KC, c))
    for ct in range(c // bn):
        for ch in range(nc):
            for j in range(k):
                got[j, ch * KC:(ch + 1) * KC, ct * bn:(ct + 1) * bn] = _read_stage(
                    flat, ((ct * nc + ch) * k + j) * bn * KC, bn)
    assert not got[:, c:].any()
    np.testing.assert_array_equal(got[:, :c], w.to(torch.bfloat16).float().numpy())


def test_widths_k5_takes():
    """takes: C a multiple of 32 (its Cout tile, conv_cols: the whole width
    up to 128, above it 64 where 64 divides C, else 32), odd k, a reach
    (k-1)/2 d of at most MAX_REACH = 128 samples; a box over 256 rows comes
    in pieces of whole swizzle atoms."""
    assert [aa_snake.conv_cols(c) for c in (32, 64, 96, 128, 160, 256, 512)] == [
        32, 64, 32, 128, 32, 64, 64]
    assert aa_snake.MAX_REACH == 128
    assert all(aa_snake.takes(c, k, d) for c, k, d in SERVED + WIDER)
    for c, k, d in ((16, 3, 1), (48, 3, 1), (0, 3, 1), (32, 4, 1), (32, 3, 0), (256, 11, 26),
                    (32, 3, 129)):
        assert not aa_snake.takes(c, k, d)
    assert aa_snake.takes(256, 11, 13) and aa_snake.takes(32, 3, 128)
    assert [_box_pieces(r) for r in (25, 64, 65, 80, 128)] == [
        (1, 178), (1, 256), (2, 136), (2, 144), (2, 192)]
    for c in (16, 48):
        with pytest.raises(ValueError):
            aa_snake.conv_cols(c)


def _small_vocoder(channel=128, use_kernels=True):
    return tvoc.BigVGAN(num_mels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=channel, resblock_kernel_sizes=(3, 7),
                        resblock_dilation_sizes=((1, 3), (1, 5)), use_kernels=use_kernels)


def _random_sd(voc, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
            for k, v in voc.state_dict().items()}


def _acts(voc):
    """(activation, its conv, dilation) of every AMP block."""
    out = []
    for name, m in voc.named_modules():
        if isinstance(m, tvoc.AMPBlock1):
            for i, d in enumerate(m.dilation):
                out.append((getattr(m, f"act1_{i}"), getattr(m, f"conv1_{i}"), d))
                out.append((getattr(m, f"act2_{i}"), getattr(m, f"conv2_{i}"), 1))
    return out


def _assert_packed(voc):
    """Every activation K5 takes carries pack_aa_conv of its current
    parameters, the others nothing; the final activation its pack_snake."""
    for act, conv, d in _acts(voc):
        k, c = conv.kernel.shape[:2]
        if not aa_snake.takes(c, k, d):
            assert act.packed is None
            continue
        want = aa_snake.pack_aa_conv(*act.act.params_ab(), conv.kernel, conv.bias,
                                     act.act.logscale)
        got = act.packed
        assert got.bn == want.bn
        for a, b in zip((got.snake.a, got.snake.ib, got.bias, got.w),
                        (want.snake.a, want.snake.ib, want.bias, want.w)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    post = aa_snake.pack_snake(*voc.act_post.params_ab(), voc.act_post.logscale)
    assert all(torch.equal(a, b) for a, b in zip(voc.post_packed, post))


def test_vocoder_repacks_on_load():
    """The load hook packs; a second load_state_dict with changed weights
    re-packs (the tiles, the coefficients and the bias all change); an
    in-place update followed by pack() re-packs too. The plain vocoder
    packs nothing."""
    voc = _small_vocoder()
    sd = _random_sd(voc, 1)
    voc.load_state_dict(sd)
    _assert_packed(voc)
    act = voc.resblock_0_0.act1_0
    old = (act.packed.w.clone(), act.packed.snake.a.clone(), act.packed.bias.clone(),
           voc.post_packed.ib.clone())
    for k in ("resblock_0_0.conv1_0.kernel", "resblock_0_0.act1_0.act.alpha",
              "resblock_0_0.conv1_0.bias", "act_post.beta"):
        sd[k] = sd[k] * -1.5 + 0.01
    voc.load_state_dict(sd)
    new = (act.packed.w, act.packed.snake.a, act.packed.bias, voc.post_packed.ib)
    assert not any(torch.equal(a, b) for a, b in zip(old, new))
    _assert_packed(voc)
    with torch.no_grad():
        voc.resblock_1_1.conv2_1.kernel.mul_(-0.5)
        voc.resblock_1_1.act2_1.act.beta.add_(0.2)
    before = voc.resblock_1_1.act2_1.packed.w.clone()
    voc.pack()
    assert not torch.equal(before, voc.resblock_1_1.act2_1.packed.w)
    _assert_packed(voc)
    plain = _small_vocoder(use_kernels=False)
    plain.load_state_dict(sd)
    assert all(a.packed is None for a, _, _ in _acts(plain)) and plain.post_packed is None


def test_vocoder_packs_only_what_k5_takes():
    """A 192-wide vocoder packs its 96-channel first stage and not its
    48-wide second (not a width K5 takes); a 96-wide one neither of its 48
    and 24; a 64-wide one its 32 and, at k = 7, d = 5, its 16-channel stage
    not. The CPU forward reads the raw parameters and equals the plain
    vocoder's."""
    for channel in (192, 96, 64):
        voc = _small_vocoder(channel)
        sd = _random_sd(voc, channel)
        voc.load_state_dict(sd)
        _assert_packed(voc)
        packed = {act.packed is not None for act, conv, _ in _acts(voc)
                  if conv.kernel.shape[1] == channel // 2}
        assert packed == {channel // 2 in (96, 32)}
        plain = _small_vocoder(channel, use_kernels=False)
        plain.load_state_dict(sd)
        mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 9, 8))
                               .astype(np.float32))
        with torch.no_grad():
            assert torch.equal(voc(mel), plain(mel))
