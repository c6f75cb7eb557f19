"""K3 (GroupNorm row statistics with the group fold in the same launch) and
K2's tail (the final block's tile sums reduced in the tail, the fold, the
GroupNorm + mish + final conv) as their Hopper kernels compute them
(csrc/row_stats.cu, csrc/resnet_block.cu), replayed in numpy on the CPU:

  * K3's partition at its served sites, with fewer rows than the cluster's
    ranks, C not a multiple of 128 or of 8, and the group widths of
    decoder.dim 32 and 64: every row of every channel read once, the row
    groups, ranks and group runs summed in the kernel's order, against
    row_stats_plain and the JAX package's group_mean_inv;
  * K2's tail: kernel A's per-tile sums over the conv plan's tiles, the
    block's tile slices, the fold and the row sums across a row's threads,
    against final_block_plain and the JAX fused_final_block (interpret);
  * the routes: K3 and K2 take every width the kernels before them took,
    and group_mean_inv launches the fold form where the groups fit a
    cluster's slice and the sums form plus the plain fold elsewhere.

The partition constants live here; the card's are in the CUDA sources, and
tests/test_torch_port_cuda.py holds the kernels to the plain versions.

Tolerances: the sums 1e-4 of the largest (f32 in another order); the fold
2e-4 (var = E[x^2] - mean^2 cancels at most a fifth of E[x^2] here); K2
2^-6 of max|plain| (bf16 h on both sides, f32 sums in another order)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_conv import n_conv_tiles, pick_tile
from unitspeech_tpu.ops.pallas_resnet import fused_final_block as j_final
from unitspeech_tpu.ops.pallas_stats import group_mean_inv as j_group_mean_inv
from unitspeech_tpu_torch.ops import _cuda, fused_resnet, row_stats
from unitspeech_tpu_torch.ops.conv_matmul import conv3x3_rows

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

F32 = np.float32
SUMS_REL, FOLD_REL, BF16_REL = 1e-4, 2e-4, 2.0 ** -6
EPS = 1e-5

# K3's partition as csrc/row_stats.cu launches it (RS_CL, RS_CPB, RS_RG,
# RS_UNROLL there): a cluster of CLUSTER blocks per CHANNELS channels of a
# batch element, rank q one slice of ceil(n / CLUSTER) rows walked by
# ROW_GROUPS row groups, UNROLL rows at a time while that many remain, then
# one; a warp holds 32 consecutive channels of one of the two sums
CLUSTER, CHANNELS, ROW_GROUPS, UNROLL, WARP = 8, 128, 16, 8, 32
# K3's served sites (rows, C): chip_smoke.py K3_SITES
K3_SERVED = [(1720, 512), (430, 1024), (430, 512), (1720, 256)]


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in f64."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _butterfly(t, run):
    """A butterfly of xor shuffles over aligned runs of `run` lanes: every
    lane of a run ends with the same f32 sum."""
    idx = np.arange(t.size)
    off = 1
    while off < run:
        t = (t + t[idx ^ off]).astype(F32)
        off *= 2
    return t


def _k3_replay(x, groups=None, eps=EPS):
    """row_stats_kernel in numpy on (B, n, C) f32 values. Returns the sums
    (B, 2, C) (groups None) or (mean, inv) each (B, C), and the reads."""
    b, n, c = x.shape
    rows = -(-n // CLUSTER)
    reads = np.zeros(x.shape, np.int64)
    stats = np.zeros((b, 2, c), F32)
    mean, inv = np.zeros((b, c), F32), np.zeros((b, c), F32)
    for bb in range(b):
        for c0 in range(0, c, CHANNELS):
            w = min(CHANNELS, c - c0)
            parts = []
            for q in range(CLUSTER):
                r1 = min(n, (q + 1) * rows)
                red = np.zeros((2, ROW_GROUPS, CHANNELS), F32)
                for g in range(ROW_GROUPS):
                    r = q * rows + g
                    visit = []
                    while r + (UNROLL - 1) * ROW_GROUPS < r1:
                        visit += [r + u * ROW_GROUPS for u in range(UNROLL)]
                        r += UNROLL * ROW_GROUPS
                    while r < r1:
                        visit.append(r)
                        r += ROW_GROUPS
                    s, ss = np.zeros(w, F32), np.zeros(w, F32)
                    for rr in visit:
                        reads[bb, rr, c0:c0 + w] += 1
                        v = x[bb, rr, c0:c0 + w]
                        s = (s + v).astype(F32)
                        ss = _fma(v, v, ss)
                    red[0, g, :w], red[1, g, :w] = s, ss
                part = red[:, 0]
                for g in range(1, ROW_GROUPS):
                    part = (part + red[:, g]).astype(F32)
                parts.append(part)
            tot = np.zeros((2, CHANNELS), F32)
            for p in parts:  # the ranks' partials in rank order
                tot = (tot + p).astype(F32)
            if groups is None:
                stats[bb, :, c0:c0 + w] = tot[:, :w]
                continue
            cg = c // groups
            run = min(cg, WARP)
            gs = np.stack([_butterfly(tot[k], run) for k in range(2)])
            if cg > WARP:  # the group's warps' runs in order
                warp_sums = gs[:, ::WARP]
                per = cg // WARP
                for j in range(CHANNELS // cg):
                    t = warp_sums[:, j * per]
                    for wi in range(1, per):
                        t = (t + warp_sums[:, j * per + wi]).astype(F32)
                    gs[:, j * cg:(j + 1) * cg] = t[:, None]
            m = F32(n * cg)
            mu = (gs[0, :w] / m).astype(F32)
            var = (gs[1, :w] / m - mu * mu + F32(eps)).astype(F32)
            mean[bb, c0:c0 + w], inv[bb, c0:c0 + w] = mu, (1 / np.sqrt(var)).astype(F32)
    return (stats if groups is None else (mean, inv)), reads


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


def _k3_check(x, groups):
    """Both forms of the replay: every element read once, the sums against
    row_stats_plain, the fold against the plain fold and JAX's."""
    xt = torch.from_numpy(x)
    st, reads = _k3_replay(x)
    assert (reads == 1).all()
    _close(st, row_stats.row_stats_plain(xt).numpy(), SUMS_REL)
    (mean, inv), _ = _k3_replay(x, groups)
    want = row_stats.group_mean_inv_plain(xt, groups)
    _close(np.stack([mean, inv]), torch.stack(want).numpy(), FOLD_REL)
    jm, ji = j_group_mean_inv(jnp.asarray(x), groups)
    _close(np.stack([mean, inv]), np.stack([np.asarray(jm), np.asarray(ji)]), FOLD_REL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,c", K3_SERVED)
def test_k3_replay_served_sites(n, c, bf16):
    """K3 at its served sites, three rows of the batch (inputs N(0.5, 1),
    bf16-rounded where the site is bf16), groups of 8."""
    x = np.random.default_rng(n + c).standard_normal((3, n, c)).astype(F32) + F32(0.5)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert row_stats.takes(c, n) and row_stats.fold_takes(c, 8)
    _k3_check(x, 8)


@pytest.mark.parametrize("n", [1, 3, 7, 45])
@pytest.mark.parametrize("c,groups", [(32, 8), (64, 8), (128, 8), (256, 8), (320, 10),
                                      (200, 25), (54, 27)])
def test_k3_replay_few_rows_narrow_groups(n, c, groups):
    """Fewer rows than ranks (ranks with no rows add zeros), the group
    widths of decoder.dim 32 and 64 (cg 4-32), a slice narrower than 128
    channels and C not a multiple of 8 (channel pairs)."""
    assert row_stats.takes(c, n) and row_stats.fold_takes(c, groups)
    x = np.random.default_rng(n * c).standard_normal((2, n, c)).astype(F32) + F32(0.5)
    _k3_check(x, groups)


def test_k3_takes_every_width_the_parent_took():
    """The parent's K3 took any even C and any n >= 1; so does this one,
    in the sums form at every such width (the fold form where groups fit a
    slice, the sums form and the plain fold elsewhere)."""
    for c in range(1, 2100):
        for n in (1, 2, 7, 430):
            assert row_stats.takes(c, n) == (c % 2 == 0)
        assert not row_stats.takes(c, 0)
    served = [(c, 8) for _, c in K3_SERVED] + [(4 * d, 8) for d in (32, 64)]
    served += [(8 * d, 8) for d in (32, 64)]
    assert all(row_stats.fold_takes(c, g) for c, g in served)
    assert not any(row_stats.fold_takes(c, g) for c, g in [(96, 8), (384, 2), (2048, 8)])


class _RecordingLib:
    """The CUDA library's stand-in: records which K3 entry ran."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*a):
            self.calls.append(name)
            return 0
        return launch


@contextlib.contextmanager
def _card(monkeypatch, lib):
    with monkeypatch.context() as m:
        m.setattr(_cuda, "route", lambda x, what: True)
        m.setattr(_cuda, "lib", lambda: lib)
        m.setattr(_cuda, "require", lambda t, what, **kw: t)
        m.setattr(_cuda, "stream", lambda x: None)
        yield


@pytest.mark.parametrize("c,groups,want", [
    (512, 8, ["us_group_mean_inv"]), (1024, 8, ["us_group_mean_inv"]),
    (128, 8, ["us_group_mean_inv"]), (54, 27, ["us_group_mean_inv"]),
    (96, 8, ["us_row_stats"]), (384, 2, ["us_row_stats"]), (2048, 8, ["us_row_stats"]),
])
def test_group_mean_inv_routes(monkeypatch, c, groups, want):
    """On the card group_mean_inv is one K3 launch: the fold form where each
    group fits a cluster's slice, else the sums form and the plain fold; a
    stats function passed in keeps the plain fold and launches nothing."""
    x = torch.zeros(2, 10, c)
    lib = _RecordingLib()
    with _card(monkeypatch, lib):
        before = row_stats.row_stats.launches
        mean, inv = row_stats.group_mean_inv(x, groups)
        assert row_stats.row_stats.launches == before + 1
        assert mean.shape == inv.shape == (2, c)
        assert lib.calls == want
        row_stats.group_mean_inv(x, groups, stats=row_stats.row_stats_plain)
        assert lib.calls == want


# K2's tail as csrc/resnet_block.cu launches it: blocks of THREADS threads,
# each summing its batch element's tile rows in slices of 4-column pieces;
# TPR threads a row, 8 channels each
THREADS = 1024


def _k2_tail_replay(x, lens_rows, w1, b1, s1, be1, wo, bo, f, groups):
    """x (B, N, Cin) bf16-valued f32, w1 (9 Cin, C): kernel A's values and
    per-tile sums (the conv plan's tiles), then final_tail: the block's
    tile slices, the fold, h = bf16(mish(c1 a + b)) with a = inv scale and
    b = shift - mean a, the row's threads summed by a butterfly. -> (B, N)."""
    b, n, cin = x.shape
    c = w1.shape[-1]
    t = n // f
    valid = (np.arange(n)[None, :] < lens_rows[:, None]).astype(F32)
    acc = conv3x3_rows(torch.from_numpy(x * valid[..., None]), torch.from_numpy(w1), f)
    v = (acc + torch.from_numpy(b1)).numpy()
    c1 = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    tt, tf = pick_tile(t, f)
    tiles_f = f // tf
    n_tiles = n_conv_tiles(n, f, cin)
    tile_of = ((np.arange(n) // f) // tt) * tiles_f + (np.arange(n) % f) // tf
    seen = np.zeros(n_tiles, np.int64)
    out = np.zeros((b, n), F32)
    cg = c // groups
    tpr = 32 if c // 8 >= 32 else 16 if c // 8 >= 16 else 8
    wo16 = torch.from_numpy(wo).to(torch.bfloat16).float().numpy()
    for bb in range(b):
        part = np.stack([np.stack([v[bb, tile_of == j].sum(0, dtype=F32),
                                   (v[bb, tile_of == j] ** 2).sum(0, dtype=F32)])
                         for j in range(n_tiles)]).reshape(n_tiles, 2 * c)
        pieces = c // 2  # float4 pieces of a tile's 2C sums
        slices = max(1, THREADS // pieces)
        sp = -(-n_tiles // slices)
        stats = np.zeros(2 * c, F32)
        for sl in range(slices):  # each slice's tiles in order, the slices in order
            a = np.zeros(2 * c, F32)
            for j in range(sl * sp, min(n_tiles, (sl + 1) * sp)):
                a = (a + part[j]).astype(F32)
                seen[j] += bb == 0
            stats = (stats + a).astype(F32)
        m = F32(n * cg)
        s = np.array([stats[g * cg:(g + 1) * cg].sum(dtype=F32) for g in range(groups)])
        ss = np.array([stats[c + g * cg:c + (g + 1) * cg].sum(dtype=F32) for g in range(groups)])
        mu = (s / m).astype(F32)
        inv = (1 / np.sqrt((ss / m - mu * mu + F32(EPS)).astype(F32))).astype(F32)
        a_c = (np.repeat(inv, cg) * s1).astype(F32)
        b_c = (be1 - np.repeat(mu, cg) * a_c).astype(F32)
        hn = (c1[bb] * a_c + b_c).astype(F32)
        e = np.exp(np.minimum(hn, F32(30.0)), dtype=F32)
        tt2 = ((1 + e) * (1 + e)).astype(F32)
        mish = np.where(hn > 20, hn, hn * ((tt2 - 1) / (tt2 + 1))).astype(F32)
        h = torch.from_numpy(mish * valid[bb][:, None]).to(torch.bfloat16).float().numpy()
        prod = (h * wo16).astype(F32)
        lanes = np.zeros((n, tpr), F32)  # each thread its pieces' channels in order
        for pc in range(c // 8):
            for ch in range(8):
                lanes[:, pc % tpr] = (lanes[:, pc % tpr] + prod[:, pc * 8 + ch]).astype(F32)
        off = tpr // 2
        while off:  # the butterfly across the row's threads
            lanes = (lanes + lanes[:, np.arange(tpr) ^ off]).astype(F32)
            off //= 2
        out[bb] = ((lanes[:, 0] + bo[0]) * valid[bb]).astype(F32)
    assert (seen == 1).all()  # every tile row summed once
    return out


def _k2_inputs(rng, b, t, f, c):
    x = torch.from_numpy(rng.standard_normal((b, t * f, c)).astype(F32))
    x = x.to(torch.bfloat16).float().numpy()
    w1 = (rng.standard_normal((9 * c, c)) * (9 * c) ** -0.5).astype(F32)
    w1 = torch.from_numpy(w1).to(torch.bfloat16).float().numpy()
    b1, be1 = (rng.standard_normal((2, c)) * 0.1).astype(F32)
    s1 = (1 + rng.standard_normal(c) * 0.1).astype(F32)
    wo, bo = (rng.standard_normal(c) * c ** -0.5).astype(F32), np.array([0.1], F32)
    return x, w1, b1, s1, be1, wo, bo


@pytest.mark.parametrize("b,t,f,c,lens", [
    (2, 12, 80, 128, [12, 7]),  # 10 tiles: slices 10-15 have none
    (2, 60, 80, 128, [60, 33]),  # 40 tiles, 3 a slice
    (1, 44, 40, 64, [41]),  # C = 64: 32 slices
    (3, 9, 80, 256, [9, 9, 2]),  # C = 256: 32 threads a row, 8 slices
])
def test_k2_tail_replay_matches_plain(b, t, f, c, lens):
    rng = np.random.default_rng(t * c)
    x, w1, b1, s1, be1, wo, bo = _k2_inputs(rng, b, t, f, c)
    lens_rows = np.array(lens, np.int64) * f
    got = _k2_tail_replay(x, lens_rows, w1, b1, s1, be1, wo, bo, f, 8)
    tt = torch.from_numpy
    want = fused_resnet.final_block_plain(
        tt(x).to(torch.bfloat16), tt(lens_rows), tt(w1), tt(b1), tt(s1), tt(be1), tt(wo),
        tt(bo), f=f, groups=8).numpy()
    _close(got, want, BF16_REL)
    assert not got[-1, lens_rows[-1]:].any()


def test_k2_tail_replay_matches_jax():
    """The replay against JAX's fused_final_block in bf16 (interpret)."""
    rng = np.random.default_rng(5)
    b, t, f, c, lens = 2, 16, 16, 64, [16, 9]
    x, w1, b1, s1, be1, wo, bo = _k2_inputs(rng, b, t, f, c)
    mask = (np.arange(t)[None, :] < np.array(lens)[:, None]).astype(F32)[:, :, None, None]
    got = _k2_tail_replay(x, np.array(lens) * f, w1, b1, s1, be1, wo, bo, f, 8)
    want = np.asarray(j_final(jnp.asarray(x.reshape(b, t, f, c), jnp.bfloat16),
                              jnp.asarray(mask), jnp.asarray(w1.reshape(3, 3, c, c)),
                              jnp.asarray(b1), jnp.asarray(s1), jnp.asarray(be1),
                              jnp.asarray(wo.reshape(1, 1, c, 1)), jnp.asarray(bo), groups=8,
                              interpret=True)).reshape(b, t * f)
    _close(got, want, BF16_REL)


def test_k2_takes_every_width_the_parent_took():
    """K2's widths are the parent's: Cout in whole 64-column tiles, groups
    of a multiple of 8 channels (any Cin: Cin % 8 != 0 takes element
    loads)."""
    for c in range(8, 2100, 8):
        for g in (1, 2, 4, 8, 16, 32):
            assert fused_resnet.takes(c, g) == (c % 64 == 0 and c % g == 0
                                                and (c // g) % 8 == 0)
