"""The ResnetBlock convs' Hopper form (K1 / K2 / K8 / K9 kernels A, B, C in
csrc/resnet_block.cu, ops/fused_resnet.py) on the CPU, and the routes that
send a site to a kernel only where the kernel takes its widths:

  * the kernels' tiling replayed in numpy (f64) at small analogues of the
    served sites (F = 80/40/20/10, ragged lengths, T not a multiple of the
    tile): per 64-channel chunk the TMA box with its zero fill, the nine
    taps' box rows through the swizzled ldmatrix addresses, a zero row past
    the grid and the length, each output row stored once, the tiles' column
    sums; against conv3x3_rows and the plain GroupNorm statistics;
  * the packed weights read back through the kernels' tile addressing;
  * the transform-once input of kernel B against the per-tap transform the
    loader used to apply, bit for bit;
  * the estimator and the vocoder at decoder.dim 32 and 64 (and a vocoder
    with a 96-wide stage K5 takes and a 48-wide one it does not) driven through
    stand-ins that run each kernel wrapper's launch branch against a stub
    library before its plain version: no wrapper refuses a site its route
    sends it, and each route matches the kernel's `takes` predicate; the
    K5 wrapper refuses exactly the (C, k, d) its `takes` refuses.

Tolerances: the replay is f64 against the plain f32 conv, 1e-5 of the
largest value; everything else is exact."""

import contextlib

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.models import unet as tunet
from unitspeech_tpu_torch.models import vocoder as tvoc
from unitspeech_tpu_torch.ops import _cuda, aa_snake, fused_attention, resample
from unitspeech_tpu_torch.ops import fused_resnet as fr
from unitspeech_tpu_torch.ops import fused_resnet_deep as frd
from unitspeech_tpu_torch.ops.conv_matmul import conv3x3_rows, im2col

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

KC = fr.KC
TILE_ROWS = 128  # rows of the Hopper loop's tile (two warpgroups of 64)
# the row tile (TT, TF) the card's plan takes at the served grids (T, F),
# which tests/test_torch_port_cuda.py holds us_conv_plan to
SERVED_TILES = {(344, 80): (8, 16), (172, 40): (16, 8), (86, 20): (6, 20), (43, 10): (12, 10)}


def pick_tile(t: int, f: int, taps: int = 9):
    """The row tile of csrc/resnet_block.cu pick_tile, which the replay
    follows: TT frames x TF frequencies on the (T, F) grid, TF dividing F
    and TT = min(128 / TF, T), the fewest tiles, then the smallest box of
    (TT + 2) x (TF + 2) rows (no halo for the 1x1 conv, which tiles T*F
    rows with F = 1)."""
    if taps == 1:
        t, f = t * f, 1
    halo = 1 if taps == 9 else 0
    best = None
    for tf in range(1, min(f, TILE_ROWS) + 1):
        if f % tf:
            continue
        tt = min(TILE_ROWS // tf, t)
        key = (-(-t // tt) * (f // tf), (tt + 2 * halo) * (tf + 2 * halo))
        if best is None or key < best[0]:
            best = (key, tt, tf)
    return best[1], best[2]


def n_conv_tiles(n: int, f: int, cin: int) -> int:
    """The tiles a conv3x3 writes statistics for (us_conv_n_tiles): the
    Hopper loop's 2-D tiles for Cin % 8 == 0, else whole-row tiles of 128."""
    if cin % 8:
        return -(-n // TILE_ROWS)
    tt, tf = pick_tile(n // f, f)
    return -(-(n // f) // tt) * (f // tf)


def _tma_box(x_b, ti0, fi0, bt_n, bf_n, chunk):
    """One TMA copy of a 64-channel chunk: box row R = bt * BF + bf holds
    input (ti0 + bt, fi0 + bf), zero outside the tensor and past Cin, its
    16-byte piece j at j ^ (R % 8) (the 128-byte swizzle)."""
    t, f, cin = x_b.shape
    box = np.zeros((bt_n * bf_n, 8, 8))
    for bt in range(bt_n):
        for bf in range(bf_n):
            ti, fi = ti0 + bt, fi0 + bf
            if 0 <= ti < t and 0 <= fi < f:
                v = np.zeros(KC)
                part = x_b[ti, fi, chunk * KC:(chunk + 1) * KC]
                v[:part.size] = part
                R = bt * bf_n + bf
                box[R, np.arange(8) ^ (R & 7)] = v.reshape(8, 8)
    return box


def _ldmatrix_rows(box, R, ok):
    """The A rows of the consumers: box row R read through the swizzled
    addresses (piece j at j ^ (R % 8)), the zero row where `ok` is false."""
    rx = np.where(ok, R & 7, 0)
    a = box[np.where(ok, R, 0)[:, None], np.arange(8)[None, :] ^ rx[:, None]]
    return np.where(ok[:, None], a.reshape(len(R), KC), 0.0)


def _conv_tiling_replay(x, lens_rows, k, bias, taps=9):
    """conv_tc's blocks in numpy: x (B, T, F, Cin), k (taps, Cin, Cout).
    Each tile of TT x TF rows (pick_tile; tile row r = (r / TF, r % TF),
    128 rows of which those past TT x TF or T are idle) copies per chunk the
    box of frames to0 - 1 .. to0 + TT and frequencies fo0 - 1 .. fo0 + TF
    (no halo for the 1x1, whose grid is T*F rows of F = 1); tap (dt, df)
    reads box row (tt + dt) * BF + ff + df, the zero row outside the grid or
    at/after the length. -> (out (B, T*F, Cout), part (B, tiles, 2, Cout))."""
    b, t, f, cin = x.shape
    if taps == 1:
        x = x.reshape(b, t * f, 1, cin)
        t, f = t * f, 1
    halo = 1 if taps == 9 else 0
    tt_n, tf_n = pick_tile(t, f, taps)
    cout = k.shape[-1]
    nc = -(-cin // KC)
    kp = np.zeros((taps, nc * KC, cout))
    kp[:, :cin] = k  # the packed weights' zero rows past Cin
    bt_n, bf_n = tt_n + 2 * halo, tf_n + 2 * halo
    tiles_f = f // tf_n
    n_tiles = -(-t // tt_n) * tiles_f
    assert n_tiles == (n_conv_tiles(t * f, f, cin) if taps == 9 else -(-t // 128))
    r = np.arange(TILE_ROWS)
    tr, ff = r // tf_n, r % tf_n
    out = np.full((b, t * f, cout), np.nan)
    part = np.zeros((b, n_tiles, 2, cout))
    for bb in range(b):
        for tile in range(n_tiles):
            to0, fo0 = (tile // tiles_f) * tt_n, (tile % tiles_f) * tf_n
            row_ok = (tr < tt_n) & (to0 + tr < t)
            acc = np.zeros((TILE_ROWS, cout))
            for c in range(nc):
                box = _tma_box(x[bb], to0 - halo, fo0 - halo, bt_n, bf_n, c)
                for tap in range(taps):
                    dt, df = divmod(tap, 3) if taps == 9 else (0, 0)
                    R = (tr + dt) * bf_n + ff + df
                    ti, fi = to0 + tr + dt - halo, fo0 + ff + df - halo
                    ok = row_ok & (ti >= 0) & (ti < t) & (fi >= 0) & (fi < f)
                    ok &= ti * f + fi < lens_rows[bb]
                    acc += _ldmatrix_rows(box, R, ok) @ kp[tap, c * KC:(c + 1) * KC]
            v = acc + bias
            m = (to0 + tr) * f + fo0 + ff
            assert np.isnan(out[bb, m[row_ok]]).all()  # each row stored once
            out[bb, m[row_ok]] = v[row_ok]
            part[bb, tile, 0] = v[row_ok].sum(0)
            part[bb, tile, 1] = (v[row_ok] ** 2).sum(0)
    assert not np.isnan(out).any()
    return out, part


# (T, F, Cin): small analogues of the served sites (F = 80/40/20/10), T not
# a multiple of the tile's TT, Cin over one or two chunks (72: a partial one)
REPLAY_CASES = [(11, 80, 8), (9, 40, 72), (13, 20, 16), (17, 10, 8), (5, 6, 24), (50, 2, 8)]


@pytest.mark.parametrize("t,f,cin", REPLAY_CASES)
def test_conv_tiling_replay_matches_plain(t, f, cin):
    """The redesigned kernel A's tiling, replayed in numpy with one row
    full, one ending mid-tile and one of 2 frames, gives conv3x3_rows of
    the masked input plus the bias, and its tiles' column sums give the
    plain GroupNorm statistics."""
    rng = np.random.default_rng(t * f + cin)
    b, cout = 3, 4
    frames = [t, t - 4, 2]
    lens_rows = np.asarray(frames) * f
    x = rng.standard_normal((b, t, f, cin))
    k = rng.standard_normal((3, 3, cin, cout))
    bias = rng.standard_normal(cout)
    out, part = _conv_tiling_replay(x, lens_rows, k.reshape(9, cin, cout), bias)
    xm = torch.from_numpy(x.reshape(b, t * f, cin)).float()
    valid = torch.arange(t * f)[None, :, None] < torch.from_numpy(lens_rows)[:, None, None]
    want = (conv3x3_rows(xm * valid, torch.from_numpy(k).float(), f)
            + torch.from_numpy(bias).float()).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5 * scale)
    # the statistics of every row of the bucket, padding rows included
    np.testing.assert_allclose(part[:, :, 0].sum(1), want.sum(1), rtol=1e-5,
                               atol=1e-5 * scale * t * f)
    np.testing.assert_allclose(part[:, :, 1].sum(1), (want.astype(np.float64) ** 2).sum(1),
                               rtol=1e-5)


@pytest.mark.parametrize("n,cin", [(430, 64), (300, 72)])
def test_residual_tiling_replay_matches_plain(n, cin):
    """Kernel C's 1x1 residual on the same loop: tiles of 128 whole rows, no
    halo, rows at/after the length zero."""
    rng = np.random.default_rng(n + cin)
    x = rng.standard_normal((2, n, 1, cin))
    lens_rows = np.array([n, n - 77])
    k = rng.standard_normal((1, cin, 8))
    out, _ = _conv_tiling_replay(x, lens_rows, k, np.zeros(8), taps=1)
    valid = np.arange(n)[None, :, None] < lens_rows[:, None, None]
    np.testing.assert_allclose(out, (x[:, :, 0] * valid) @ k[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t,f", [(344, 80), (172, 40), (86, 20), (43, 10), (552, 80),
                                 (138, 20), (69, 10), (9, 10), (50, 2), (7, 6)])
def test_tile_choice(t, f):
    """pick_tile: TF divides F, TT = min(128 / TF, T) frames; no other
    divisor gives fewer tiles, nor as few with a smaller box of (TT + 2) x
    (TF + 2) rows; the served sites' tiles are 8 x 16 at F = 80, 16 x 8 at
    F = 40, 6 x 20 at F = 20 and 12 x 10 at F = 10."""
    def frames(d):
        return min(128 // d, t)

    tt, tf = pick_tile(t, f)
    assert f % tf == 0 and tt == frames(tf)
    tiles = -(-t // tt) * (f // tf)
    for d in range(1, f + 1):
        if f % d == 0:
            td = frames(d)
            other = -(-t // td) * (f // d)
            assert other > tiles or (other == tiles and (td + 2) * (d + 2) >= (tt + 2) * (tf + 2))
    if (t, f) in SERVED_TILES:
        assert (tt, tf) == SERVED_TILES[(t, f)]


def _read_packed(packed, taps, cin, cout, bn):
    """The weights as the Hopper loop reads the packed tiles back with Cout
    tiles of bn columns (the packer's PBN or, split, 64 of 128): the block
    of Cout tile y streams, for chunk c and tap s, the stage at element
    ((y / split * chunks + c) * taps + s) * PBN * 64 + (y % split) * bn * 64;
    its element (k, n) lies in row n, 16-byte piece (k / 8) ^ (n % 8).
    Returns (taps, Cin, Cout) and checks the zero rows past Cin."""
    pbn = packed.shape[-2]
    split = pbn // bn
    nc = -(-cin // KC)
    flat = packed.float().reshape(-1).numpy()
    y, c, n, kk = np.ix_(range(cout // bn), range(nc), range(bn), range(KC))
    elem = n * KC + (((kk >> 3) ^ (n & 7)) << 3) + (kk & 7)
    out = np.zeros((taps, nc * KC, cout))
    for s in range(taps):
        stage = ((y // split * nc + c) * taps + s) * pbn * KC + (y % split) * bn * KC
        v = flat[stage + elem]  # (y, c, n, k)
        out[s] = v.transpose(1, 3, 0, 2).reshape(nc * KC, cout)
    assert not out[:, cin:].any()
    return out[:, :cin]


@pytest.mark.parametrize("taps", [9, 1])
@pytest.mark.parametrize("cin,cout", [(128, 128), (72, 192), (8, 64), (1024, 256), (2, 128)])
def test_packed_weights_match_raw(taps, cin, cout):
    """pack_conv_weight: Cin % 8 == 0 gives the tiles the Hopper loop reads
    (Cout tiles of 128 where they divide Cout, else 64), which read back as
    the bf16 kernel, also as the launch reads 128-column packing in tiles of
    64; other Cin (element loads) the (taps*Cin, Cout) rows."""
    rng = np.random.default_rng(cin + cout + taps)
    kt = 3 if taps == 9 else 1
    k = torch.from_numpy(rng.standard_normal((kt, kt, cin, cout)).astype(np.float32))
    packed = fr.pack_conv_weight(k)
    want = k.to(torch.bfloat16).float().reshape(taps, cin, cout).numpy()
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    if cin % 8:
        assert packed.shape == (taps * cin, cout)
        np.testing.assert_array_equal(packed.float().numpy(), want.reshape(taps * cin, cout))
        return
    bn = fr.tile_cols(cout)
    assert bn == (128 if cout % 128 == 0 else 64)
    assert packed.shape == (cout // bn, -(-cin // KC), taps, bn, KC)
    for run_bn in (bn, 64):
        np.testing.assert_array_equal(_read_packed(packed, taps, cin, cout, run_bn), want)


@pytest.mark.parametrize("f,lens", [(10, [7, 4]), (8, [6, 1])])
def test_transform_once_bit_equal_to_per_tap(f, lens):
    """Kernel B's input made once per element (gn_film: bf16(mish(GN1(c1) *
    scale + shift) + FiLM) on valid rows, 0 after) and gathered by the nine
    taps equals, bit for bit, the transform the loader applied to every
    tap's gathered value (zero outside the grid and at/after the length),
    rounded to bf16 there. One thread, and each tap's values transformed as
    one tensor of c1's shape, so that every value takes the same vectorised
    exp on both sides."""
    rng = np.random.default_rng(f)
    b, t, c, groups = 2, 7, 64, 8
    n = t * f

    def rt(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    c1 = rt(b, n, c, scale=3.0).to(torch.bfloat16)
    lens_rows = torch.tensor(lens) * f
    valid = fr._valid(lens_rows, n)
    mean, inv = fr._group_stats(c1.float(), groups)
    s1, be1, film = 1 + rt(c, scale=0.1), rt(c, scale=0.1), rt(b, c)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h = fr._film_masked(c1, mean, inv, s1, be1, film, valid, torch.bfloat16)
        once = im2col(h, f)
        # the loader: each tap's gathered c1 (zero outside the grid), its
        # rows at/after the length masked, transformed, rounded
        cols = im2col(c1.float(), f).reshape(b, n, 9, c)
        src_valid = im2col(valid.expand(b, n, c).contiguous(), f).reshape(b, n, 9, c) > 0
        ones = torch.ones(b, n, 1)
        per_tap = [torch.where(src_valid[:, :, k],
                               fr._film_masked(cols[:, :, k].contiguous().to(torch.bfloat16),
                                               mean, inv, s1, be1, film, ones, torch.bfloat16),
                               torch.zeros((), dtype=torch.bfloat16)) for k in range(9)]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(once, torch.cat(per_tap, dim=-1))


# --- the routes at widths the kernels do not all take ------------------------


class _StubLib:
    """The CUDA library's stand-in: every launch returns 0 (success); the
    size queries return the counts the wrappers allocate by."""

    def __getattr__(self, name):
        offsets = aa_snake.phase_filters()[3:]
        sizes = {"us_conv_n_tiles": n_conv_tiles,
                 "us_n_row_tiles": lambda n: -(-n // 128),
                 "us_aa_offsets": lambda i: offsets[i]}
        return sizes.get(name, lambda *a: 1 if name.endswith(("_chunks", "_tiles")) else 0)


def _require(t, what, dtype=None, shape=None, device=None):
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t


@contextlib.contextmanager
def _launch_branch(monkeypatch):
    """Wrappers take their CUDA branch against the stub library."""
    with monkeypatch.context() as m:
        m.setattr(_cuda, "route", lambda x, what: True)
        m.setattr(_cuda, "lib", lambda: _StubLib())
        m.setattr(_cuda, "require", _require)
        m.setattr(_cuda, "stream", lambda x: None)
        yield


WRAPPERS = {tunet: ("fused_resnet_block", "fused_resnet_block_deep",
                    "fused_resnet_block_deep_i8", "fused_final_block", "fused_rezero_attention",
                    "fused_downsample_conv", "fused_upsample_conv"),
            tvoc: ("fused_aa_snake_conv", "fused_aa_snake")}


def _stand_ins(monkeypatch, calls):
    """Each kernel wrapper the models call runs its launch branch first (its
    argument checks raise on widths the kernel does not take), then its
    plain version, whose result it returns; calls logs (name, input width,
    output width)."""
    for mod, names in WRAPPERS.items():
        for name in names:
            real = getattr(mod, name)

            def stand_in(x, *a, _real=real, _name=name, **kw):
                with _launch_branch(monkeypatch):
                    _real(x, *a, **kw)
                out = _real(x, *a, **kw)
                calls.append((_name, x.shape[-1 if _name != "fused_aa_snake_conv" else 1],
                              out.shape[-1 if _name != "fused_aa_snake_conv" else 1]))
                return out

            monkeypatch.setattr(mod, name, stand_in)


FLAGS = dict(use_kernels=True, use_int8_deep=True, use_deep=True, use_resample=True)


@pytest.mark.parametrize("dim", [32, 64])
@pytest.mark.parametrize("i8pre", [False, True], ids=["deep", "deep_i8"])
def test_estimator_routes_at_narrow_widths(monkeypatch, dim, i8pre):
    """decoder.dim 32 and 64 with every kernel switch, 64 frames: each site
    goes to a kernel only where the kernel's predicate takes its widths, and
    then the wrapper's launch branch accepts it; the others take JAX's
    fallback route (plain Blocks, the XLA attention, the library resample,
    the plain final block). dim 64: K1 at the 64- and 128-wide stages (the
    first block with Cin = 2), K4 only at C = 128 (the 64-wide F = 80 and
    F = 40 attentions fall back), K11 at every JAX site, K2; dim 32: the
    32-wide blocks, resample convs, attentions and final block fall back, K1
    runs at the 64-wide stage. The deep blocks (max width >= 512) take K8,
    or K9 with i8pre."""
    from unitspeech_tpu_torch.utils.params import _random_leaf

    t = 64  # the F = 80 and F = 40 attentions pass JAX's token gate
    rng = np.random.default_rng(dim)
    est = tunet.GradLogPEstimator2d(dim=dim, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8,
                                    dtype=torch.bfloat16, use_i8pre_deep=i8pre, **FLAGS)
    sd = {k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape)).astype(np.float32))
          for k, v in est.state_dict().items()}
    for k in sd:
        if k.endswith(".g"):
            sd[k] *= 0.1
    est.load_state_dict(sd)
    calls = []
    _stand_ins(monkeypatch, calls)
    x, mu = (torch.from_numpy(rng.standard_normal((2, t, 80)).astype(np.float32))
             for _ in range(2))
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 41])[:, None]).float()
    with torch.no_grad():
        out = est(x, mask, mu, torch.tensor([0.5, 0.2]), torch.zeros(2, 8))
    assert out.shape == (2, t, 80) and torch.isfinite(out).all()

    def sites(name):
        return [(cin, cout) for n, cin, cout in calls if n == name]

    k1 = sites("fused_resnet_block")
    assert all(fr.takes(cout) for _, cout in k1)
    assert k1 == ([(32, 64), (64, 64)] if dim == 32 else
                  [(2, 64), (64, 64), (64, 128), (128, 128), (256, 64), (64, 64)])
    deep = "fused_resnet_block_deep_i8" if i8pre else "fused_resnet_block_deep"
    assert not sites("fused_resnet_block_deep" if i8pre else "fused_resnet_block_deep_i8")
    assert sites(deep) == ([(512, 128)] if dim == 32 else
                           [(256, 512), (512, 512), (512, 512), (512, 512), (1024, 256),
                            (512, 128)])
    assert sites("fused_rezero_attention") == ([] if dim == 32 else [(128, 128)])
    assert all(fused_attention.takes(c) for c, _ in sites("fused_rezero_attention"))
    assert sites("fused_downsample_conv") == ([(64, 64)] if dim == 32 else
                                              [(64, 64), (128, 128)])
    assert sites("fused_upsample_conv") == ([] if dim == 32 else [(64, 64)])
    assert bool(sites("fused_final_block")) == (dim == 64)


@pytest.mark.parametrize("channel", [64, 32, 192, 256])
def test_vocoder_routes_at_narrow_widths(monkeypatch, channel):
    """BigVGAN with a narrow first stage: K5 runs only on the stages whose
    width it takes (a multiple of 32: 96 too, not 48), the others take the
    plain AA-snake conv; K6 takes any width."""
    rng = np.random.default_rng(channel)
    voc = tvoc.BigVGAN(num_mels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                       upsample_initial_channel=channel, resblock_kernel_sizes=(3,),
                       resblock_dilation_sizes=((1, 3),), dtype=torch.bfloat16,
                       use_kernels=True)
    for name, prm in voc.named_parameters():
        prm.data = torch.from_numpy(
            (rng.standard_normal(tuple(prm.shape)) * 0.1).astype(np.float32))
    calls = []
    _stand_ins(monkeypatch, calls)
    with torch.no_grad():
        wav = voc(torch.from_numpy(rng.standard_normal((1, 12, 8)).astype(np.float32)))
    assert wav.shape == (1, 48) and torch.isfinite(wav).all()
    widths = [c for n, c, _ in calls if n == "fused_aa_snake_conv"]
    want = [c for c in (channel // 2, channel // 4) if aa_snake.takes(c, 3)]
    assert sorted(set(widths)) == sorted(want)
    assert len(widths) == 4 * len(want)  # two act + conv pairs of two dilations a stage
    assert [n for n, _, _ in calls].count("fused_aa_snake") == 1


@pytest.mark.parametrize("cout", [32, 64, 96, 128])
def test_wrappers_refuse_what_takes_refuses(monkeypatch, cout):
    """The K1 / K8 / kernel A wrappers' launch branch accepts a width
    exactly where `takes` does, and raises (no fallback) otherwise."""
    from unitspeech_tpu_torch.ops import fused_resnet_deep as frd

    cin, t, f = 16, 4, 10
    x = torch.zeros(2, t, f, cin, dtype=torch.bfloat16)
    mask = torch.ones(2, t, 1, 1)
    p = dict(t_bias=torch.zeros(2, cout), w1=torch.randn(3, 3, cin, cout),
             b1=torch.zeros(cout), gn1_scale=torch.ones(cout), gn1_bias=torch.zeros(cout),
             w2=torch.randn(3, 3, cout, cout), b2=torch.zeros(cout),
             gn2_scale=torch.ones(cout), gn2_bias=torch.zeros(cout),
             wres=torch.randn(1, 1, cin, cout), bres=torch.zeros(cout))
    lens = torch.full((2,), t * f, dtype=torch.int32)
    calls = [lambda: fr.fused_resnet_block(x, mask, **p),
             lambda: frd.fused_resnet_block_deep(x, mask, **p),
             lambda: frd.fused_resnet_block_deep_i8(x, mask, **p),
             lambda: fr.resnet_conv3x3(x.reshape(2, t * f, cin), lens,
                                       p["w1"].reshape(9 * cin, cout), p["b1"], f)]
    with _launch_branch(monkeypatch):
        for call in calls:
            if fr.takes(cout):
                call()
            else:
                with pytest.raises(ValueError):
                    call()


@pytest.mark.parametrize("c,k,d", [(32, 3, 1), (64, 11, 5), (128, 7, 3), (256, 11, 5),
                                   (512, 3, 1), (96, 3, 1), (48, 3, 1), (16, 3, 1),
                                   (32, 4, 1), (64, 11, 13), (32, 3, 64), (32, 3, 65),
                                   (160, 5, 2), (96, 3, 128), (96, 3, 129), (64, 11, 26)])
def test_aa_snake_conv_refuses_what_takes_refuses(monkeypatch, c, k, d):
    """K5's wrapper takes its launch branch exactly where `takes` accepts
    (C, k, d), packed or not, and raises (no fallback) otherwise."""
    rng = np.random.default_rng(c + k + d)
    x = torch.zeros(1, c, 20, dtype=torch.bfloat16)
    a, b = (torch.from_numpy(rng.standard_normal(c).astype(np.float32)) for _ in range(2))
    w, bias = torch.randn(k, c, c), torch.zeros(c)
    with _launch_branch(monkeypatch):
        if aa_snake.takes(c, k, d):
            out = aa_snake.fused_aa_snake_conv(x, a, b, w, bias, d)
            assert out.shape == x.shape
            aa_snake.fused_aa_snake_conv(x, a, b, w, bias, d,
                                         packed=aa_snake.pack_aa_conv(a, b, w, bias))
        else:
            with pytest.raises(ValueError):
                aa_snake.fused_aa_snake_conv(x, a, b, w, bias, d)


# dim 64 at 80 mel bins -> the ResnetBlocks each route reads packed weights
# for: K1 at F = 80 / 40, K8 or K9 at the 512-wide (flat) F = 20 / 10 blocks;
# the 256-wide blocks at F = 20 take plain Blocks; K9 reads its int8 convs'
# tiles (conv1's in bf16 for Cin > Cout) and the 1x1 residual
K1_BLOCKS = {"down_0_res1", "down_0_res2", "down_1_res1", "down_1_res2", "up_0_res1",
             "up_0_res2"}
DEEP_BLOCKS = {"down_3_res1", "down_3_res2", "mid_res1", "mid_res2", "up_2_res1", "up_1_res1"}


@pytest.mark.parametrize("path", ["int8", "bf16", "deep", "deep_i8", "plain"])
def test_pack_only_what_routes_read(path):
    """The load hook packs a ResnetBlock's convs only where its route at
    its stage's F reads them: on the serving default (int8) and bf16 paths
    only the K1 blocks carry packed weights (none of the deep-stage flat
    blocks), on the deep path the K8 blocks too, on deep_i8 the K9 blocks'
    int8 tiles of quant_w's values (conv1 in bf16 for Cin > Cout) and 1x1
    residual; the plain path packs nothing. Each block's route at F
    agrees: a packed block is one a kernel takes."""
    from unitspeech_tpu_torch.utils.params import _random_leaf

    flags = {"int8": dict(use_kernels=True, use_int8_deep=True),
             "bf16": dict(use_kernels=True),
             "deep": dict(use_kernels=True, use_deep=True, use_resample=True),
             "deep_i8": dict(use_kernels=True, use_int8_deep=True, use_deep=True,
                             use_i8pre_deep=True, use_resample=True),
             "plain": {}}[path]
    rng = np.random.default_rng(3)
    est = tunet.GradLogPEstimator2d(dim=64, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8,
                                    dtype=torch.bfloat16, **flags)
    est.load_state_dict({k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape))
                                             .astype(np.float32))
                         for k, v in est.state_dict().items()})
    blocks = {n: m for n, m in est.named_modules() if isinstance(m, tunet.ResnetBlock)}
    packed = {n for n, m in blocks.items() if m.packed is not None}
    want = {"plain": set(), "deep": K1_BLOCKS | DEEP_BLOCKS,
            "deep_i8": K1_BLOCKS | DEEP_BLOCKS}
    assert packed == want.get(path, K1_BLOCKS)
    for name in packed:
        m = blocks[name]
        cin, cout = m.block1.conv.kernel.shape[2:]
        if name in K1_BLOCKS or path == "deep":
            assert all(p is not None for p in m.packed[:2])
            assert (m.packed[2] is None) == (m.res_conv is None)
        else:  # K9
            w1, w2 = m.block1.conv.kernel, m.block2.conv.kernel
            want1 = (fr.pack_conv_weight(w1) if cin > cout
                     else frd.pack_conv_weight_i8(fr.quant_w(w1)[0], cin))
            assert torch.equal(m.packed[0], want1)
            assert torch.equal(m.packed[1], frd.pack_conv_weight_i8(fr.quant_w(w2)[0], cout))
            assert (m.packed[2] is None) == (m.res_conv is None)
            if m.res_conv is not None:
                assert torch.equal(m.packed[2], fr.pack_conv_weight(m.res_conv.kernel))
    assert (est.final_packed is not None) == bool(flags)
