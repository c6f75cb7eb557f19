"""The port's strided resampling convs (kernel K11, ops/resample.py) against
the JAX package on the CPU: the plain versions against the Pallas kernels
`fused_downsample_conv` / `fused_upsample_conv` in interpret mode at the JAX
tests' shapes (odd tile counts, heavy padding), the convs written out as
per-row gathers in numpy (the upsample as its four phases), the CUDA
kernels' tiling, box staging and packed weight layout replayed in numpy,
all against the plain versions, and the routing gates against JAX's.

Tolerances: 2e-5 abs / 1e-4 rel in f32 (the JAX tests' own); bf16 outputs
within one bf16 step (both round the f32 accumulator once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitspeech_tpu.models.unet import Downsample, Upsample
from unitspeech_tpu.ops import pallas_resample as jrs
from unitspeech_tpu_torch.ops import resample

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _mask(t, lens):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)[
        :, :, None, None]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _case(mod, b, t, f, cin, lens, seed):
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (b, t, f, cin)))
    params = mod.init(key, x)["params"]["conv"]
    return x, _mask(t, lens), np.asarray(params["kernel"]), np.asarray(params["bias"])


@pytest.mark.parametrize("b,t,f,cin,cout,lens,fpt", [
    (2, 16, 8, 4, 4, [16, 16], 0),   # full mask
    (2, 16, 8, 4, 8, [16, 10], 0),   # padded batch, channel change
    (1, 8, 16, 4, 4, [8], 2),        # explicit small tile
    (2, 12, 8, 4, 4, [12, 5], 3),    # odd tile count, heavy padding
])
def test_downsample_plain_matches_pallas(b, t, f, cin, cout, lens, fpt):
    x, mask, k, bias = _case(Downsample(cout), b, t, f, cin, lens, 0)
    want = np.asarray(jrs.fused_downsample_conv(x, mask, k, bias, interpret=True, fpt=fpt))
    before = resample.fused_downsample_conv.launches
    got = resample.fused_downsample_conv(_t(x), _t(mask), _t(k), _t(bias))
    assert resample.fused_downsample_conv.launches == before  # CPU: the plain version
    assert got.shape == (b, t // 2, f // 2, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,f,cin,cout,lens,fpt", [
    (2, 8, 8, 4, 4, [8, 8], 0),      # full mask
    (2, 8, 8, 8, 4, [8, 5], 0),      # padded batch, channel change
    (1, 6, 8, 4, 4, [6], 2),         # explicit small tile
    (2, 12, 16, 4, 4, [12, 7], 3),   # odd tile count, heavy padding
])
def test_upsample_plain_matches_pallas(b, t, f, cin, cout, lens, fpt):
    x, mask, k, bias = _case(Upsample(cout), b, t, f, cin, lens, 1)
    want = np.asarray(jrs.fused_upsample_conv(x, mask, k, bias, interpret=True, fpt=fpt))
    before = resample.fused_upsample_conv.launches
    got = resample.fused_upsample_conv(_t(x), _t(mask), _t(k), _t(bias))
    assert resample.fused_upsample_conv.launches == before
    assert got.shape == (b, 2 * t, 2 * f, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_bf16_rounds_once_as_pallas(up):
    """bf16 activations: the plain version and the Pallas kernel both round
    the f32 accumulator plus bias once, so they differ by at most one bf16
    step (f32 sums in another order)."""
    mod = Upsample(8) if up else Downsample(8)
    x, mask, k, bias = _case(mod, 2, 8, 16, 8, [8, 5], 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    fn = jrs.fused_upsample_conv if up else jrs.fused_downsample_conv
    want = np.asarray(fn(xb, mask, k, bias, interpret=True), np.float32)
    port = resample.fused_upsample_conv if up else resample.fused_downsample_conv
    got = port(_t(x).to(torch.bfloat16), _t(mask), _t(k), _t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


def _down_index_replay(x, lens_rows, w, bias):
    """The strided conv as a per-row gather in numpy (f64): output row m =
    (to, fo) takes tap (dt, df) from input row (2 to + dt - 1, 2 fo + df -
    1), zero outside the grid and at/after lens_rows; w (9*Cin, Cout)."""
    b, t, f, cin = x.shape
    to_, fo_ = t // 2, f // 2
    xr = x.reshape(b, t * f, cin).astype(np.float64)
    out = np.zeros((b, to_ * fo_, w.shape[1]))
    for bb in range(b):
        for m in range(to_ * fo_):
            to, fo = divmod(m, fo_)
            for tap in range(9):
                ti, fi = 2 * to + tap // 3 - 1, 2 * fo + tap % 3 - 1
                if not (0 <= ti < t and 0 <= fi < f):
                    continue
                src = ti * f + fi
                if src >= lens_rows[bb]:
                    continue
                out[bb, m] += xr[bb, src] @ w[tap * cin:(tap + 1) * cin]
    return (out + bias).reshape(b, to_, fo_, -1)


def _up_index_replay(x, lens_rows, w, bias):
    """The transposed conv as four phases of per-row gathers in numpy (f64),
    the decomposition the CUDA kernel computes by: phase (pa, pb), input
    row m = (mt, mf), tap q = it * 2 + jf reads input (mt + it - 1 + pa,
    mf + jf - 1 + pb) with kernel tap (pa + 2 it, pb + 2 jf) of w (16*Cin,
    Cout), written to output row (2 mt + pa, 2 mf + pb)."""
    b, t, f, cin = x.shape
    xr = x.reshape(b, t * f, cin).astype(np.float64)
    out = np.zeros((b, 2 * t, 2 * f, w.shape[1]))
    for bb in range(b):
        for pa in (0, 1):
            for pb in (0, 1):
                for m in range(t * f):
                    mt, mf = divmod(m, f)
                    acc = np.zeros(w.shape[1])
                    for q in range(4):
                        ti, fi = mt + (q >> 1) - 1 + pa, mf + (q & 1) - 1 + pb
                        if not (0 <= ti < t and 0 <= fi < f) or ti * f + fi >= lens_rows[bb]:
                            continue
                        kt, kf = pa + 2 * (q >> 1), pb + 2 * (q & 1)
                        row = (kt * 4 + kf) * cin
                        acc += xr[bb, ti * f + fi] @ w[row:row + cin]
                    out[bb, 2 * mt + pa, 2 * mf + pb] = acc + bias
    return out


@pytest.mark.parametrize("t,f,lens", [(6, 8, [6, 3]), (4, 6, [2, 4])])
def test_kernel_index_arithmetic_matches_plain(t, f, lens):
    """The convs' source rows and the upsample's phase taps, written out as
    gathers in numpy, give the plain versions' convs (f32 vs f64: 1e-5
    relative)."""
    rng = np.random.default_rng(t * f)
    b, cin, cout = 2, 3, 5
    x = rng.standard_normal((b, t, f, cin)).astype(np.float32)
    mask = _mask(t, lens)
    lens_rows = np.asarray(lens) * f
    for replay, plain, taps in ((_down_index_replay, resample.downsample_conv_plain, 3),
                                (_up_index_replay, resample.upsample_conv_plain, 4)):
        k = rng.standard_normal((taps, taps, cin, cout)).astype(np.float32)
        bias = rng.standard_normal(cout).astype(np.float32)
        want = replay(x, lens_rows, k.reshape(taps * taps * cin, cout), bias)
        got = plain(_t(x), _t(mask), _t(k), _t(bias)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("f", [80, 40, 20, 16, 10, 8])
def test_gates_match_jax(f):
    """supports_downsample / supports_upsample are the JAX package's, at the
    estimator's widths for every frame count up to 700."""
    for c in (128, 256, 512):
        for t in range(1, 701):
            assert resample.supports_downsample(t, f, c) == jrs.supports_downsample(t, f, c)
            assert resample.supports_upsample(t, f, c) == jrs.supports_upsample(t, f, c)
    if f in (80, 40):
        assert resample.supports_downsample(344 * f // 80, f, 128 * 80 // f)


# --- the redesigned kernels' tiling (csrc/resample.cu), replayed in numpy ---

KC = resample.KC


def _row_tile(n_freq):
    """resample.cu pick_tf: a block's 64 rows as TT frames x TF frequencies,
    TF the largest of 8, 4, 2, 1 dividing the frequency count (the card test
    holds the kernel's plan to it)."""
    tf = next(v for v in (8, 4, 2, 1) if n_freq % v == 0)
    return 64 // tf, tf


def _tma_box(x_b, ti0, fi0, bt_n, bf_n, chunk):
    """The producer's 4-D TMA copy of one 64-channel chunk: box row R = bt *
    BF + bf holds input (ti0 + bt, fi0 + bf), zero outside the tensor and
    past Cin, its 16-byte piece j (8 channels) at j ^ (R % 8), the 128-byte
    swizzle. Rows at/after the length are copied like any other. Returns the
    box (rows, 8 pieces, 8 channels) and the frames copied from the tensor."""
    t, f, cin = x_b.shape
    box = np.zeros((bt_n * bf_n, 8, 8))
    copied = set()
    for bt in range(bt_n):
        for bf in range(bf_n):
            ti, fi = ti0 + bt, fi0 + bf
            if 0 <= ti < t and 0 <= fi < f:
                v = np.zeros(KC)
                part = x_b[ti, fi, chunk * KC:(chunk + 1) * KC]
                v[:part.size] = part
                R = bt * bf_n + bf
                box[R, np.arange(8) ^ (R & 7)] = v.reshape(8, 8)
                copied.add(ti)
    return box, copied


def _ldmatrix_rows(box, R, ok):
    """The consumers' A rows: box row R through the kernel's addresses
    (piece j read at j ^ (R % 8)), the zero row where `ok` is false."""
    rx = np.where(ok, R & 7, 0)
    a = box[np.where(ok, R, 0)[:, None], np.arange(8)[None, :] ^ rx[:, None]]
    return np.where(ok[:, None], a.reshape(len(R), KC), 0.0)


def _assert_tile_frames(copied, read, ti0, n, t, tlim):
    """A tile copies the frames its taps reach inside the tensor (the halo
    frames -1 and T are zero fill) and reads those before the length."""
    assert copied == set(range(max(ti0, 0), min(ti0 + n, t)))
    assert read == {ti for ti in copied if ti < tlim}


def _down_tiling_replay(x, frames, k, bias):
    """K11a's blocks in numpy (f64): each 64-row tile of TT x TF output rows
    copies, per 64-channel chunk, the box of input frames 2 to0 - 1 .. 2 to0
    + 2 TT - 1 and frequencies 2 fo0 - 1 .. 2 fo0 + 2 TF - 1; A row (tt, ff)
    reads tap (dt, df) at box row R = (2 tt + dt) * BF + 2 ff + df (the
    stride 2 in the row addresses), the zero row outside the grid or at/after
    the length; rows with to < T/2 are stored once each."""
    b, t, f, cin = x.shape
    to_, fo_ = t // 2, f // 2
    tt, tf = _row_tile(fo_)
    lg = tf.bit_length() - 1
    bt_n, bf_n = 2 * tt + 1, 2 * tf + 1
    kp = np.zeros((3, 3, -(-cin // KC) * KC, k.shape[-1]))
    kp[:, :, :cin] = k  # the packed weights' zero rows past Cin
    out = np.full((b, to_, fo_, k.shape[-1]), np.nan)
    r = np.arange(64)
    tr, ff = r >> lg, r & (tf - 1)
    for bb in range(b):
        tlim = min(t, frames[bb])
        for tile in range(-(-to_ // tt) * (fo_ // tf)):
            to0, fo0 = (tile // (fo_ // tf)) * tt, (tile % (fo_ // tf)) * tf
            ti0, fi0 = 2 * to0 - 1, 2 * fo0 - 1
            acc = np.zeros((64, k.shape[-1]))
            read = set()
            for c in range(-(-cin // KC)):
                box, copied = _tma_box(x[bb], ti0, fi0, bt_n, bf_n, c)
                for dt in range(3):
                    for df in range(3):
                        R = (2 * tr + dt) * bf_n + 2 * ff + df
                        # stride 2: neighbouring frequencies of a fragment are
                        # two box rows apart, neighbouring frames 2 BF
                        same_t = tr[1:] == tr[:-1]
                        assert (np.diff(R)[same_t] == 2).all()
                        assert (R[tr == 1] - R[tr == 0] == 2 * bf_n).all()
                        ti, fi = ti0 + 2 * tr + dt, fi0 + 2 * ff + df
                        ok = (ti >= 0) & (ti < tlim) & (fi >= 0) & (fi < f)
                        read |= set(ti[ok].tolist())
                        acc += _ldmatrix_rows(box, R, ok) @ kp[dt, df, c * KC:(c + 1) * KC]
            _assert_tile_frames(copied, read, ti0, bt_n, t, tlim)
            to, fo = to0 + tr, fo0 + ff
            keep = to < to_
            assert np.isnan(out[bb, to[keep], fo[keep]]).all()  # each row stored once
            out[bb, to[keep], fo[keep]] = acc[keep] + bias
    assert not np.isnan(out).any()
    return out


def _up_tiling_replay(x, frames, k, bias):
    """K11b's blocks in numpy (f64): each tile of TT x TF input positions
    copies, per chunk, the box of frames mt0 - 1 .. mt0 + TT and frequencies
    mf0 - 1 .. mf0 + TF; warpgroup a computes phases (a, 0) and (a, 1), step
    q = (it, jf) reading box row (tt + it + a) * BF + ff + jf + b with tap
    (a + 2 it, b + 2 jf); the epilogue stages phase (a, b) of row (tt, ff) at
    (2 tt + a) * 2 TF + 2 ff + b and stores output frames 2 mt0 .. as runs
    of 2 TF rows, those before 2 T once each."""
    b, t, f, cin = x.shape
    tt, tf = _row_tile(f)
    lg = tf.bit_length() - 1
    bt_n, bf_n = tt + 2, tf + 2
    kp = np.zeros((4, 4, -(-cin // KC) * KC, k.shape[-1]))
    kp[:, :, :cin] = k
    out = np.full((b, 2 * t, 2 * f, k.shape[-1]), np.nan)
    r = np.arange(64)
    tr, ff = r >> lg, r & (tf - 1)
    for bb in range(b):
        tlim = min(t, frames[bb])
        for tile in range(-(-t // tt) * (f // tf)):
            mt0, mf0 = (tile // (f // tf)) * tt, (tile % (f // tf)) * tf
            ti0, fi0 = mt0 - 1, mf0 - 1
            acc = np.zeros((2, 2, 64, k.shape[-1]))
            read = set()
            for c in range(-(-cin // KC)):
                box, copied = _tma_box(x[bb], ti0, fi0, bt_n, bf_n, c)
                for pa in (0, 1):
                    for pb in (0, 1):
                        for q in range(4):
                            bt, bf = tr + (q >> 1) + pa, ff + (q & 1) + pb
                            ti, fi = ti0 + bt, fi0 + bf
                            ok = (ti >= 0) & (ti < tlim) & (fi >= 0) & (fi < f)
                            read |= set(ti[ok].tolist())
                            a = _ldmatrix_rows(box, bt * bf_n + bf, ok)
                            w = kp[pa + 2 * (q >> 1), pb + 2 * (q & 1), c * KC:(c + 1) * KC]
                            acc[pa, pb] += a @ w
            _assert_tile_frames(copied, read, ti0, bt_n, t, tlim)
            staging = np.full((4 * 64, k.shape[-1]), np.nan)
            for pa in (0, 1):
                for pb in (0, 1):
                    rows = ((2 * tr + pa) << (lg + 1)) + 2 * ff + pb
                    assert np.isnan(staging[rows]).all()
                    staging[rows] = acc[pa, pb] + bias
            assert not np.isnan(staging).any()  # the four phases fill the tile
            rr = np.arange(4 * 64)
            ot, of = 2 * mt0 + (rr >> (lg + 1)), 2 * mf0 + (rr & (2 * tf - 1))
            # each output frame of the tile is one run of 2 TF whole rows
            assert (np.diff(of.reshape(-1, 2 * tf), axis=1) == 1).all()
            keep = ot < 2 * t
            assert np.isnan(out[bb, ot[keep], of[keep]]).all()
            out[bb, ot[keep], of[keep]] = staging[keep]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("t", [72, 216, 344, 552])
@pytest.mark.parametrize("site", ["down_f80", "down_f40", "up_f40"])
def test_kernel_tiling_replay_matches_plain(site, t):
    """The redesigned kernels' tiling, replayed in numpy at the served
    buckets' frame counts (ragged last tiles: 72 / 2 = 36 and 552 / 2 = 276
    frames are not multiples of TT = 8; at F = 40 the downsample's TT is 16),
    with a full row, one ending mid-tile and one of 5 frames, gives the plain
    versions' convs (f32 vs f64: 1e-5 relative). Few channels: the replay
    checks indices."""
    up, f = site.startswith("up"), int(site.split("_f")[1])
    if up or f == 40:
        t //= 2  # the F = 40 stage runs at half the frames
    rng = np.random.default_rng(t + f + up)
    b, cin, cout = 3, 3, 2
    lens = [t, t - 11, 5]
    x = rng.standard_normal((b, t, f, cin)).astype(np.float32)
    taps = 4 if up else 3
    k = rng.standard_normal((taps, taps, cin, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    replay = _up_tiling_replay if up else _down_tiling_replay
    plain = resample.upsample_conv_plain if up else resample.downsample_conv_plain
    want = replay(x.astype(np.float64), lens, k.astype(np.float64), bias)
    got = plain(_t(x), _t(_mask(t, lens)), _t(k), _t(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _read_packed(packed, up, cin, cout):
    """The weights as the kernels read the packed tiles back: Cout tile y,
    chunk c, stage s (K11a: tap s; K11b: step q = (it, jf), then phase p = (a,
    b)) is tile ((y * chunks + c) * stages + s) of BN x 64 bf16; its element
    (k, n) lies in row n, 16-byte piece (k / 8) ^ (n % 8). Returns the flax
    kernel (taps, taps, Cin, Cout) it holds and checks the zero rows past
    Cin."""
    bn = packed.shape[-2]
    nc, taps = -(-cin // KC), 4 if up else 3
    flat = packed.float().reshape(-1).numpy()
    y, c, n, kk = np.ix_(range(cout // bn), range(nc), range(bn), range(KC))
    elem = n * KC + (((kk >> 3) ^ (n & 7)) << 3) + (kk & 7)
    out = np.zeros((taps, taps, nc * KC, cout))
    for s in range(16 if up else 9):
        if up:
            q, ph = divmod(s, 4)
            kt, kf = (ph >> 1) + 2 * (q >> 1), (ph & 1) + 2 * (q & 1)
        else:
            kt, kf = divmod(s, 3)
        tile = (y * nc + c) * (16 if up else 9) + s
        v = flat[tile * bn * KC + elem]  # (y, c, n, k)
        out[kt, kf] = v.transpose(1, 3, 0, 2).reshape(nc * KC, cout)
    assert not out[:, :, cin:].any()
    return out[:, :, :cin]


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("cin,cout", [(128, 128), (72, 192), (8, 64)])
def test_packed_weights_and_frames_match_raw_call(up, cin, cout):
    """The estimator's call form: the kernel packed once into the tiles the
    CUDA kernels read (their tile addressing replayed in numpy gives back
    the bf16 flax kernel, Cout in tiles of the whole Cout up to 256, 128 for
    the upsample), the valid frames given, gives the raw-kernel call's
    output on the CPU."""
    rng = np.random.default_rng(cin + cout + up)
    t, f, lens = 12, 8, [12, 7]
    taps = 4 if up else 3
    x = torch.from_numpy(rng.standard_normal((2, t, f, cin)).astype(np.float32)).to(
        torch.bfloat16)
    k = _t(rng.standard_normal((taps, taps, cin, cout)) * 0.1)
    bias = _t(rng.standard_normal(cout))
    pack = resample.pack_upsample_weight if up else resample.pack_downsample_weight
    fn = resample.fused_upsample_conv if up else resample.fused_downsample_conv
    packed = pack(k)
    bn = resample.tile_cols(up, cout)
    assert bn == min(cout & -cout, 128 if up else 256)
    steps = (4, 4) if up else (9,)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (cout // bn, -(-cin // KC), *steps, bn, KC)
    np.testing.assert_array_equal(_read_packed(packed, up, cin, cout),
                                  k.to(torch.bfloat16).float().numpy())
    frames = torch.tensor(lens, dtype=torch.int32)
    mask = _t(_mask(t, lens))
    assert torch.equal(resample.frames_from_mask(mask), frames)
    want = fn(x, mask, k, bias)
    got = fn(x, mask, k, bias, packed=packed, lens=frames)
    assert torch.equal(got, want)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("cin,cout", [(128, 128), (256, 256), (24, 192), (8, 64)])
def test_cuda_wrapper_arguments(monkeypatch, up, cin, cout):
    """The wrappers' launch branch, driven on the CPU against a stand-in for
    the CUDA library: the raw call and the estimator's call pass the library
    the same sizes and the packed weights' Cout tile, and packed weights of
    another layout are refused before any launch."""
    from unitspeech_tpu_torch.ops import _cuda

    launched = []

    class Lib:
        def us_downsample_conv(self, *a):
            launched.append(("down", a[5:11]))
            return 0

        def us_upsample_conv(self, *a):
            launched.append(("up", a[5:11]))
            return 0

    def require(t, what, dtype=None, shape=None, device=None):
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t

    monkeypatch.setattr(_cuda, "route", lambda x, what: True)
    monkeypatch.setattr(_cuda, "lib", lambda: Lib())
    monkeypatch.setattr(_cuda, "require", require)
    monkeypatch.setattr(_cuda, "stream", lambda x: None)
    taps = 4 if up else 3
    x = torch.zeros(3, 8, 6, cin, dtype=torch.bfloat16)
    k, bias = torch.randn(taps, taps, cin, cout), torch.zeros(cout)
    mask = _t(_mask(8, [8, 5, 8]))
    fn = resample.fused_upsample_conv if up else resample.fused_downsample_conv
    pack = resample.pack_upsample_weight if up else resample.pack_downsample_weight
    before = fn.launches
    out = fn(x, mask, k, bias)
    fn(x, mask, k, bias, packed=pack(k), lens=torch.tensor([8, 5, 8], dtype=torch.int32))
    assert fn.launches == before + 2
    assert out.shape == ((3, 16, 12, cout) if up else (3, 4, 3, cout))
    want = ("up" if up else "down", (3, 8, 6, cin, cout, resample.tile_cols(up, cout)))
    assert launched == [want, want]
    with pytest.raises(ValueError):
        fn(x, mask, k, bias, packed=pack(torch.randn(taps, taps, cin, 2 * cout)))
    with pytest.raises(ValueError):
        fn(x, mask, k, bias, packed=pack(k)[0])
    assert fn.launches == before + 2
