"""The rezero attention kernel's Hopper form (K4, csrc/rezero_attention.cu)
replayed on the CPU: its schedule (the blocks a batch element of the
card's plan, the tiles each block walks with the online softmax carried
across them, the partials' merge) against the plain version and the Pallas kernel in
interpret mode; the three-product bf16 split of its small products
against an f32 matmul; and the register fragments (the wgmma accumulator,
its movmatrix transposes, the mma.sync operands) as the kernel indexes
them, replayed lane by lane. The kernel itself runs on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: the replay and the plain version differ by f32 sums in another
order (1e-5 of max|y| in f32); the split product keeps about 16 bits of
each operand (2^-14 of the products' scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitspeech_tpu.ops.pallas_attention import fused_rezero_attention as j_attention
from unitspeech_tpu_torch.ops import fused_attention
from unitspeech_tpu_torch.ops.resample import swizzle128

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

SMS = 132  # the H100's SMs
H, D = 4, 32
TILE, P_MAX = 128, 128  # the kernel's token rows a tile, partials a head pair at most
K4_SITES = [27520, 6880, 1720]  # the N of the estimator's attention sites
# (B, N) -> the schedule csrc/rezero_attention.cu makes on the H100: (tiles,
# P phase-1 blocks a (batch element, head pair), P2 phase-2 blocks a batch
# element); tests/test_torch_port_cuda.py holds the card's us_attn_plan to
# these. The sites at B = 3 and 1, and ragged N (a tile count P does not
# divide, a 1-row last tile).
K4_PLANS = {(3, 27520): (215, 22, 44), (3, 6880): (54, 22, 44), (3, 1720): (14, 14, 14),
            (3, 1000): (8, 8, 8), (3, 129): (2, 2, 2), (1, 27520): (215, 66, 132),
            (3, 4096): (32, 22, 32)}


def _inputs(rng, b, n, c):
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = r(b, n, c, scale=0.5)
    w_qkv, w_out = r(c, 3 * H * D, scale=c ** -0.5), r(H * D, c, scale=(H * D) ** -0.5)
    lens = np.array([n, n * 301 // 344, n][:b], np.int32)
    return x, w_qkv, w_out, r(c, scale=0.1), np.array([0.7], np.float32), lens


def replay(x, w_qkv, w_out, b_out, g, lens, p1):
    """The kernel's schedule in f32 torch: per (batch, head pair) P = p1
    blocks, block p carrying (m, den, num) over tiles p, p + P, ... of 128
    rows (rows past N out of the softmax), then the merge in partial order,
    then phase 2 with the plain version's rounding points."""
    b, n, c = x.shape
    tiles, tile = -(-n // TILE), TILE
    hd = H * D
    k = (x @ w_qkv[:, hd:2 * hd]).reshape(b, n, H, D)
    v = (x @ w_qkv[:, 2 * hd:]).reshape(b, n, H, D)
    ctx = torch.empty(b, H, D, D)
    for bi in range(b):
        for h in range(H):
            parts = []
            for p in range(p1):
                m = torch.full((D,), -torch.inf)
                den, num = torch.zeros(D), torch.zeros(D, D)
                for t in range(p, tiles, p1):
                    kt, vt = k[bi, t * tile:(t + 1) * tile, h], v[bi, t * tile:(t + 1) * tile, h]
                    mn = torch.maximum(m, kt.amax(0))
                    sc = torch.exp(m - mn)
                    e = torch.exp(kt - mn)
                    den = den * sc + e.sum(0)
                    num = num * sc[:, None] + e.T @ vt
                    m = mn
                parts.append((m, den, num))
            mm = torch.stack([q[0] for q in parts])
            w = torch.exp(mm - mm.amax(0))
            den = sum(w[i] * parts[i][1] for i in range(p1))
            num = sum(w[i][:, None] * parts[i][2] for i in range(p1))
            ctx[bi, h] = num / den[:, None]
    q = (x @ w_qkv[:, :hd]).reshape(b, n, H, D)
    attn = torch.einsum("bnhi,bhij->bnhj", q, ctx).reshape(b, n, hd)
    y = x + g * (attn @ w_out + b_out)
    return y * (torch.arange(n)[None, :, None] < lens[:, None, None])


@pytest.mark.parametrize("n", K4_SITES + [1000, 129])
def test_schedule_replay_matches_plain(n):
    """At each site's N (and a ragged N, one that leaves a 1-row tile), in
    f32: the tiles, blocks and merge of the card's plan equal the plain
    version to f32 round-off."""
    rng = np.random.default_rng(n)
    args = [torch.from_numpy(a) for a in _inputs(rng, 3, n, 128)]
    want = fused_attention.rezero_attention_plain(*args, H, D)
    got = replay(*args, p1=K4_PLANS[(3, n)][1])
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_schedule_replay_matches_pallas():
    """At a small N and 4 heads of 32, the replay equals the Pallas kernel
    run in interpret mode."""
    rng = np.random.default_rng(5)
    x, w_qkv, w_out, b_out, g, lens = _inputs(rng, 2, 300, 128)
    want = np.asarray(j_attention(*map(jnp.asarray, (x, w_qkv, w_out, b_out, g)),
                                  lens_rows=jnp.asarray(lens.reshape(2, 1, 1)), heads=H,
                                  dim_head=D, t_tile=128, interpret=True))
    # 3 tiles over 2 blocks: block 0 carries its state across tiles 0 and 2
    got = replay(*map(torch.from_numpy, (x, w_qkv, w_out, b_out, g, lens)), p1=2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n", list(K4_PLANS))
def test_partials_scale_with_sms(b, n):
    """A batch element has 2 P partials (P ~ SMs / 2B): O(SMs), not one a
    tile."""
    tiles, p1, p2 = K4_PLANS[(b, n)]
    assert tiles == -(-n // TILE)
    assert 2 * p1 <= -(-SMS // b) + 1  # bounded by the SMs, whatever N
    assert b != 3 or n < 8192 or 8 * 2 * p1 < n // 64  # the served batch
    assert p1 <= P_MAX
    assert b * 2 * p1 <= SMS + 2 * b and b * p2 <= SMS + b  # about one wave
    assert 1 <= p1 <= tiles and 1 <= p2 <= tiles  # every block has a tile


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def split(a):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def mma3(a, b):
    """a_hi b_hi + a_hi b_lo + a_lo b_hi with f32 accumulation."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float32
    return (ah.astype(f) @ bh.astype(f)) + (ah @ bl).astype(f) + (al @ bh).astype(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_product_matches_f32(seed):
    """The split products (exp(K)^T V over a 128-row tile, Q ctx) agree
    with an f32 matmul, where one bf16 pass would not."""
    rng = np.random.default_rng(seed)
    e = np.exp(rng.standard_normal((128, 32)).astype(np.float32) - 2.0)
    v = (rng.standard_normal((128, 32)) * 3).astype(np.float32)
    want = e.T.astype(np.float64) @ v.astype(np.float64)
    scale = np.abs(e.T) @ np.abs(v)
    assert np.all(np.abs(mma3(e.T, v) - want) <= 2.0 ** -14 * scale + 1e-6)
    one = _bf16(e.T) @ _bf16(v)
    assert np.max(np.abs(one - want) / scale) > 2.0 ** -10  # a single pass is coarser
    q, ctx = rng.standard_normal((64, 32)).astype(np.float32), rng.standard_normal((32, 32))
    want = q.astype(np.float64) @ ctx
    assert np.all(np.abs(mma3(q, ctx.astype(np.float32)) - want)
                  <= 2.0 ** -14 * (np.abs(q) @ np.abs(ctx)) + 1e-6)


# --- register fragments, lane by lane ------------------------------------

def acc_frag(m):
    """The wgmma accumulator of a warp's 16 rows x (8 J) columns: lane l,
    element 4 j + e at row l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2."""
    lanes = np.arange(32)
    out = np.zeros((32, m.shape[1] // 2))
    for j in range(m.shape[1] // 8):
        for e in range(4):
            out[:, 4 * j + e] = m[lanes // 4 + 8 * (e // 2), 8 * j + 2 * (lanes % 4) + e % 2]
    return out


def pair(a0, a1):
    """A 32-bit register of two values per lane: (32, 2)."""
    return np.stack([a0, a1], axis=1)


def movmatrix_t(r):
    """movmatrix.trans: lane l holds row l / 4, columns 2 (l % 4), +1 of an
    8 x 8 matrix; the result holds the transpose the same way."""
    mat = np.zeros((8, 8))
    lanes = np.arange(32)
    mat[lanes // 4, 2 * (lanes % 4)] = r[:, 0]
    mat[lanes // 4, 2 * (lanes % 4) + 1] = r[:, 1]
    mt = mat.T
    return pair(mt[lanes // 4, 2 * (lanes % 4)], mt[lanes // 4, 2 * (lanes % 4) + 1])


def mma16816(a, b):
    """mma.sync m16n8k16 on lane fragments -> D (16 x 8): a[0..3], b[0..1]
    registers of (32, 2) as the PTX ISA lays them out."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for (r, k), reg in zip(((0, 0), (8, 0), (0, 8), (8, 8)), a):
        for s in range(2):
            A[g + r, 2 * t + k + s] = reg[:, s]
    for k, reg in zip((0, 8), b):
        for s in range(2):
            B[2 * t + k + s, g] = reg[:, s]
    return A @ B


def test_context_fragments_replay():
    """exp(K)^T V of a warp's 16 rows from the accumulator as attn_kv takes
    it: e and V pairs transposed by movmatrix into the A (key rows i) and B
    (value columns j) fragments, one m16n8k16 per (16 i, 8 j) block."""
    rng = np.random.default_rng(3)
    kv = rng.standard_normal((16, 128))  # the head pair's [K0 | V0 | K1 | V1] columns
    acc = acc_frag(kv)
    for hh in range(2):
        e = {(jb, h2): movmatrix_t(pair(acc[:, (8 * hh + jb) * 4 + 2 * h2],
                                        acc[:, (8 * hh + jb) * 4 + 2 * h2 + 1]))
             for jb in range(4) for h2 in range(2)}
        v = {(jb, h2): movmatrix_t(pair(acc[:, (8 * hh + 4 + jb) * 4 + 2 * h2],
                                        acc[:, (8 * hh + 4 + jb) * 4 + 2 * h2 + 1]))
             for jb in range(4) for h2 in range(2)}
        num = np.zeros((32, 32))
        for ib in range(2):
            a = [e[2 * ib, 0], e[2 * ib + 1, 0], e[2 * ib, 1], e[2 * ib + 1, 1]]
            for jv in range(4):
                num[16 * ib:16 * ib + 16, 8 * jv:8 * jv + 8] = mma16816(a, [v[jv, 0], v[jv, 1]])
        k_h, v_h = kv[:, 64 * hh:64 * hh + 32], kv[:, 64 * hh + 32:64 * hh + 64]
        np.testing.assert_allclose(num, k_h.T @ v_h, atol=1e-12)


def test_output_fragments_replay():
    """attn_out: Q's accumulator as the A fragment of Q_h ctx_h (B from the
    staged ctx^T), then attn's accumulator as the output projection's A
    fragments (wgmma's A from registers: the m16n8k16 layout per warp)."""
    rng = np.random.default_rng(4)
    q, ctx = rng.standard_normal((16, 128)), rng.standard_normal((H, D, D))
    acc = acc_frag(q)
    lanes = np.arange(32)
    at = np.zeros((16, 128))
    for h in range(H):
        for s in range(2):
            j0, j1 = (4 * h + 2 * s) * 4, (4 * h + 2 * s + 1) * 4
            a = [pair(acc[:, j0], acc[:, j0 + 1]), pair(acc[:, j0 + 2], acc[:, j0 + 3]),
                 pair(acc[:, j1], acc[:, j1 + 1]), pair(acc[:, j1 + 2], acc[:, j1 + 3])]
            for jn in range(4):
                ct = ctx[h].T  # cth[h][j][i]
                row, col = 8 * jn + lanes // 4, 16 * s + 2 * (lanes % 4)
                b = [pair(ct[row, col], ct[row, col + 1]), pair(ct[row, col + 8], ct[row, col + 9])]
                at[:, 32 * h + 8 * jn:32 * h + 8 * jn + 8] += mma16816(a, b)
    want = np.concatenate([q[:, 32 * h:32 * h + 32] @ ctx[h] for h in range(H)], axis=1)
    np.testing.assert_allclose(at, want, atol=1e-12)
    fa = acc_frag(at)
    w_out = rng.standard_normal((128, 8))
    out = np.zeros((16, 8))
    for s in range(8):
        h, jn = s >> 1, 2 * (s & 1)
        a = [pair(fa[:, (4 * h + jn) * 4], fa[:, (4 * h + jn) * 4 + 1]),
             pair(fa[:, (4 * h + jn) * 4 + 2], fa[:, (4 * h + jn) * 4 + 3]),
             pair(fa[:, (4 * h + jn + 1) * 4], fa[:, (4 * h + jn + 1) * 4 + 1]),
             pair(fa[:, (4 * h + jn + 1) * 4 + 2], fa[:, (4 * h + jn + 1) * 4 + 3])]
        wk = w_out[16 * s:16 * s + 16]
        b = [pair(wk[2 * (lanes % 4), lanes // 4], wk[2 * (lanes % 4) + 1, lanes // 4]),
             pair(wk[2 * (lanes % 4) + 8, lanes // 4], wk[2 * (lanes % 4) + 9, lanes // 4])]
        out += mma16816(a, b)
    np.testing.assert_allclose(out, at @ w_out, atol=1e-10)


def test_packed_weights_read_back():
    """pack_attention_weights: each 128-column tile, un-swizzled, is the
    head pair's [K | V | K | V] columns, Q's, and Wout's K-major slices."""
    rng = np.random.default_rng(6)
    c = 256
    w_qkv = torch.from_numpy(rng.standard_normal((c, 384)).astype(np.float32))
    w_out = torch.from_numpy(rng.standard_normal((128, c)).astype(np.float32))
    wkv, wq, wo = fused_attention.pack_attention_weights(w_qkv, w_out)
    unsw = swizzle128  # the swizzle is its own inverse (j ^ r ^ r = j)
    wb, ob = w_qkv.to(torch.bfloat16), w_out.to(torch.bfloat16)
    for hp in range(2):
        cols = torch.cat([torch.cat([wb[:, 128 + 32 * h:160 + 32 * h],
                                     wb[:, 256 + 32 * h:288 + 32 * h]], 1)
                          for h in (2 * hp, 2 * hp + 1)], 1)
        assert torch.equal(unsw(wkv[hp]).transpose(-1, -2).reshape(c, 128), cols)
    assert torch.equal(unsw(wq).transpose(-1, -2).reshape(c, 128), wb[:, :128])
    for nt in range(c // 128):
        for kc in range(2):
            assert torch.equal(unsw(wo[nt, kc]).T, ob[64 * kc:64 * kc + 64, 128 * nt:128 * nt + 128])
