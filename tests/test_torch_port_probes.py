"""The kernels of the port's measurement tools against the JAX package on
the CPU: the polynomial transcendentals (ops/fastmath.py), the chain of
tools/bench_transcendental.py (P1), the row-subsample forms of
tools/probe_stride.py (P2) and the shapes and kernels of
tools/bisect_deep_compile.py (P3). Tolerances are stated per case."""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tools import bisect_deep_compile as jax_bisect
from unitspeech_tpu.ops import fastmath as jfm
from unitspeech_tpu.ops import pallas_resnet as jpr
from unitspeech_tpu_torch.ops import fastmath, probes
from unitspeech_tpu_torch.ops import fused_resnet as fr
from unitspeech_tpu_torch.tools import bench_transcendental, bisect_deep_compile, probe_stride

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

# tools/bench_transcendental.py:51-60, written in jnp
JNP_BODIES = {
    "mul": lambda x: x * jnp.float32(1.1),
    "jnp_sin": jnp.sin,
    "fast_sin": jfm.fast_sin,
    "jnp_exp": lambda x: jnp.exp(jnp.minimum(x, 8.0)),
    "fast_exp": lambda x: jfm.fast_exp(jnp.minimum(x, 8.0)),
    "jnp_tanh": jnp.tanh,
    "div": lambda x: jnp.float32(1.3) / (jnp.abs(x) + jnp.float32(1.0)),
    "rsqrt": lambda x: jax.lax.rsqrt(jnp.abs(x) + jnp.float32(1.0)),
}
# bit for bit where both sides do the same f32 operations; XLA's and
# PyTorch's sin / tanh / rsqrt differ by an ulp here and there (the chain
# is contracting, so it stays an ulp), and exp's differences grow by up to
# e^8 / 2 a round until the chain saturates at e^8 (measured 1e-4 of the
# largest value at k = 64 on other seeds, 9.3e-6 on this one)
P1_REL = {"mul": 0.0, "fast_sin": 0.0, "fast_exp": 0.0, "div": 0.0, "jnp_sin": 1e-6,
          "jnp_tanh": 1e-6, "rsqrt": 1e-6, "jnp_exp": 2.0 ** -12}


@pytest.mark.parametrize("name", ["fast_sin", "fast_exp"])
def test_fastmath_bit_equal_to_jax(name):
    """Bit for bit against the JAX functions run op by op (eager). Under
    jit XLA fuses the polynomial and may contract its multiply-adds."""
    rng = np.random.default_rng(1)
    x = np.concatenate([(rng.standard_normal(50000) * s).astype(np.float32)
                        for s in (0.5, 5.0, 50.0)] + [np.float32([-100, -87, 0, 30, 40])])
    got = getattr(fastmath, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jfm, name)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body", list(probes.BODIES))
def test_transcendental_plain_matches_jnp_loop(body):
    """P1's plain version (the wrapper on a CPU tensor) against the same
    loop in jnp, k = 64 rounds, within P1_REL of the largest value."""
    x = np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32)
    acc = xj = jnp.asarray(x)
    for _ in range(64):
        acc = JNP_BODIES[body](acc) * jnp.float32(0.5) + xj
    want = np.asarray(acc)
    before = probes.transcendental_chain.launches
    got = probes.transcendental_chain(torch.from_numpy(x), 64, body).numpy()
    assert probes.transcendental_chain.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=P1_REL[body] * np.abs(want).max())


def test_transcendental_ops_cover_every_body():
    assert set(probes.ROUND_OPS) == set(probes.BODIES) == set(JNP_BODIES)


# cuobjdump -sass of a chain kernel, cut down: an early exit over everything,
# the grid-stride loop, and the round loop (two rounds: a multiply by 0.5
# and one folded into FMUL.D2) with a slow path holding a loop of its own
# that a branch jumps over; the second function branches to labels
SASS = """
\t\tFunction : _ZN12_GLOBAL__N_15chainILi3EEEvPKfPfii
        /*0000*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        /*0010*/               @P0 BRA 0x200 ;                   /* 0x0000000800d80947 */
        /*0020*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0030*/                   FMUL R5, R4, 1.1000000238418579102 ;
        /*0040*/              @!P1 BRA 0x90 ;
        /*0050*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0060*/                   IMAD R8, R7, R7, RZ ;
        /*0070*/               @P2 BRA 0x50 ;
        /*0080*/                   MUFU.RCP R5, R5 ;
        /*0090*/                   FMUL R5, R5, 0.5 ;
        /*00a0*/                   FADD R4, R4, R5 ;
        /*00b0*/                   MUFU.EX2 R6, R4 ;
        /*00c0*/                   FMUL.D2 R6, R6, R9 ;
        /*00d0*/                   FADD R4, R4, R6 ;
        /*00e0*/                   IADD3 R10, R10, 0x2, RZ ;
        /*00f0*/              @!P3 BRA 0x30 ;
        /*0100*/                   STG.E desc[UR4][R2.64], R4 ;
        /*0110*/              @!P4 BRA 0x20 ;
        /*0200*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_15chainILi0EEEvPKfPfii
.L_x_1:
        /*0000*/                   FMUL R5, R4, 1.1000000238418579102 ;
        /*0010*/                   FMUL R5, R5, 0.5 ;
        /*0020*/                   FADD R4, R4, R5 ;
        /*0030*/              @!P0 BRA `(.L_x_1) ;
        /*0040*/                   EXIT ;
"""


def test_sass_round_counts():
    """bench_transcendental reads one round's instructions from a
    chain kernel's SASS: the innermost loop with the most rounds (multiplies
    by 0.5, FMUL.D2 included), by class over its rounds, leaving out a slow
    path a branch jumps over when it holds a loop; branch targets as
    addresses or labels."""
    funcs = bench_transcendental.parse_sass(SASS)
    counts = {name.split("ILi")[1][0]: bench_transcendental.round_counts(ins)
              for name, ins in funcs.items()}
    # 0x30 FMUL, 0x40 BRA, 0x90 FMUL (0.5), 0xa0 FADD, 0xb0 MUFU, 0xc0
    # FMUL.D2, 0xd0 FADD, 0xe0 IADD3, 0xf0 BRA: two rounds
    assert counts["3"] == {"rounds_in_loop": 2, "fp32": 2.5, "mufu_conv": 0.5, "other": 1.5}
    assert counts["0"] == {"rounds_in_loop": 1, "fp32": 3.0, "mufu_conv": 0.0, "other": 1.0}
    # the issue-slot least time: the wide pipes' (FP32 and the rest) over 128
    # lanes against MUFU and conversions over 16, at 132 SMs and 2 GHz
    t = bench_transcendental.issue_ms(counts["3"], 132 * 2e9, 132, 2e9)
    assert t == pytest.approx(max(4.0 / 128, 0.5 / 16) * 1e3)


@pytest.mark.parametrize("case", range(6))
def test_probe_stride_forms_match_numpy(case):
    """P2's six cases on probe_stride's (512, 128) array (the wrappers take
    their plain versions on the CPU) equal its numpy expectations
    (tools/probe_stride.py:102-121) exactly; the interleave's odd rows
    after rounding x + 1 to bf16, as the kernel's bf16 add rounds it."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 128))
                         .astype(np.float32)).to(torch.bfloat16)
    xn = x.float().numpy()
    name, kernel, args, key = probe_stride.FORMS[case]
    lib = probe_stride.library_calls(x)[name]
    want = probe_stride.expectations(xn)[key]
    got = kernel(x, *args).float().numpy()
    np.testing.assert_array_equal(got, probe_stride.PLAIN[kernel](x, *args).float().numpy())
    if key == "inter":
        np.testing.assert_array_equal(got[0::2], want[0::2])
        np.testing.assert_array_equal(
            got[1::2], torch.from_numpy(want[1::2]).to(torch.bfloat16).float().numpy())
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
    if lib is not None:
        np.testing.assert_array_equal(lib().float().numpy(), want)
    # the bytes bound counts the rows the form reads and writes
    assert probe_stride.needed_bytes(key, kernel(x, *args)) == (
        (3 if key == "inter" else 2) * 512 * 128)


def _k_selmat(x_ref, o_ref):
    """tools/probe_stride.py's k_selmat (defined inside its main)."""
    v = x_ref[...]
    rr = v.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (rr // 2, rr), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (rr // 2, rr), 1)
    s = (col == 2 * row).astype(v.dtype)
    o_ref[...] = jnp.dot(s, v, preferred_element_type=jnp.float32).astype(v.dtype)


def _band_product(x: torch.Tensor, bm: int = 64) -> torch.Tensor:
    """P2's band form as the card runs it (csrc/probes.cu selection_band),
    in plain PyTorch: output rows [m0, m0 + bm) are S's (bm, 2 bm) band
    block times x rows [2 m0, 2 m0 + 2 bm), in f32 from zero; an output is
    NaN where its column has a non-finite value in a row other than its own
    x[2i] (the block holds the column's every row and counts them once);
    rounded to x's dtype."""
    r, c = x.shape
    xf = x.float()
    s = probes.selection_matrix(2 * bm, torch.float32)
    out = torch.cat([s @ xf[2 * bm * blk:2 * bm * (blk + 1)] for blk in range(r // (2 * bm))])
    bad = ~torch.isfinite(xf)
    out[bad.sum(0)[None, :] > bad[0::2].int()] = float("nan")
    return out.to(x.dtype)


def _same(a: torch.Tensor, b: np.ndarray) -> None:
    """Equal bit for bit up to the NaN payload: NaN in the same places,
    every other value equal (infinities included)."""
    a = a.float().numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a, nan=0.0, posinf=np.inf, neginf=-np.inf),
                                  np.nan_to_num(b, nan=0.0, posinf=np.inf, neginf=-np.inf))


@pytest.mark.parametrize("bad", [[], [(3, 5, "inf")], [(301, 70, "nan")],
                                 [(3, 5, "inf"), (301, 70, "nan"), (130, 8, "-inf")]])
def test_selection_band_form_matches_pallas(bad):
    """P2's band product on the card skips the rows of x outside each
    block's band; with the non-finite rule (a column with an inf or NaN in
    a skipped row is NaN, as 0 * inf makes the full product's) it equals
    selection_matmul_plain (the wrapper on the CPU) and JAX's k_selmat in
    interpret mode bit for bit, on finite input and with an inf and a NaN in
    odd rows (which every output skips) and a -inf in an even row (kept by
    its own output, NaN in the others), at probe_stride's (512, 128)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((512, 128))
                         .astype(np.float32)).to(torch.bfloat16)
    for r, c, v in bad:
        x[r, c] = float(v)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = np.asarray(pl.pallas_call(
        _k_selmat,
        in_specs=[pl.BlockSpec((512, 128), lambda: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((256, 128), lambda: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((256, 128), jnp.bfloat16), interpret=True,
    )(xj), np.float32)
    assert int(np.isnan(want).any(0).sum()) == len(bad)
    band = _band_product(x)
    _same(band, want)
    _same(probes.selection_matmul(x), want)
    _same(band, probes.selection_matmul_plain(x).float().numpy())


def test_bisect_cases_match_jax():
    """P3 runs the JAX tool's 14 shapes."""
    assert bisect_deep_compile.CASES == jax_bisect.CASES
    assert len(bisect_deep_compile.CASES) == 14


def _specs(n, c):
    return pl.BlockSpec((1, n, c), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.VMEM)


def _lens_spec():
    return pl.BlockSpec((1, 1, 1), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.SMEM)


def _row(c):
    return pl.BlockSpec((1, c), lambda bb, cb: (0, 0), memory_space=pltpu.VMEM)


def _stats_spec(c):
    return pl.BlockSpec((1, 2, c), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.VMEM)


@pytest.mark.parametrize("t,f,cin,cout,length", [(5, 10, 16, 32, 30), (3, 6, 24, 16, 12)])
def test_kernel_a_alone_matches_pallas(t, f, cin, cout, length):
    """P3's kernel A alone (resnet_conv3x3's plain version) against JAX's
    current _kernel_a_deep (with n_true, int8=False and its sw_ref operand,
    which JAX's run_probe("a") no longer passes), interpret mode, f32:
    conv output within 1e-5, and its GroupNorm statistics from JAX's
    (sum, sumsq) within 1e-5 relative. A padded length."""
    b, n = 2, t * f
    rng = np.random.default_rng(t + cin)
    x = rng.standard_normal((b, n, cin)).astype(np.float32)
    w = (rng.standard_normal((9 * cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    lens = np.array([n, length], np.int32)
    c, stats = pl.pallas_call(
        partial(jpr._kernel_a_deep, f=f, n=n, n_true=n, out_dtype=jnp.float32, int8=False),
        grid=(b, 1),
        in_specs=[_lens_spec(), _specs(n, cin),
                  pl.BlockSpec((9 * cin, cout), lambda bb, cb: (0, 0), memory_space=pltpu.VMEM),
                  _row(cout), _row(cout)],
        out_specs=(_specs(n, cout), _stats_spec(cout)),
        out_shape=(jax.ShapeDtypeStruct((b, n, cout), jnp.float32),
                   jax.ShapeDtypeStruct((b, 2, cout), jnp.float32)),
        interpret=True,
    )(jnp.asarray(lens.reshape(b, 1, 1)), jnp.asarray(x), jnp.asarray(w),
      jnp.ones((1, cout), jnp.float32), jnp.asarray(bias[None]))
    got_c, got_mean, got_inv = fr.resnet_conv3x3(torch.from_numpy(x), torch.from_numpy(lens),
                                                 torch.from_numpy(w), torch.from_numpy(bias), f)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(c), atol=1e-5, rtol=1e-5)
    for bb in range(b):
        mean, inv = jpr._group_stats(stats[bb, 0], stats[bb, 1], n, 8)
        np.testing.assert_allclose(got_mean[bb].numpy(), np.asarray(mean)[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_inv[bb].numpy(), np.asarray(inv)[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", fr.OUT_MODES)
def test_kernel_c_alone_matches_pallas(mode):
    """P3's kernel C alone (resnet_out's plain version) against JAX's
    _kernel_c in each res_mode, interpret mode, f32, with a padded length:
    within 1e-5 (GroupNorm statistics pooled in another order)."""
    b, n, cin, cout = 2, 60, 32, 32
    rng = np.random.default_rng(3)
    c2 = rng.standard_normal((b, n, cout)).astype(np.float32)
    x = rng.standard_normal((b, n, cin)).astype(np.float32)
    s, sh = (1 + 0.1 * rng.standard_normal((2, cout))).astype(np.float32)
    wres = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
    bres = rng.standard_normal(cout).astype(np.float32)
    lens = np.array([n, 40], np.int32)
    stats = np.stack([c2.sum(1), (c2 * c2).sum(1)], axis=1)
    matmul = mode == "matmul"
    w_in, b_in = (wres, bres[None]) if matmul else (np.zeros((1, 1), np.float32),) * 2
    w_spec = pl.BlockSpec(w_in.shape, lambda bb, cb: (0, 0), memory_space=pltpu.VMEM)
    b_spec = pl.BlockSpec(b_in.shape, lambda bb, cb: (0, 0), memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        partial(jpr._kernel_c, tile=n, n_rows=n, groups=8, res_mode=mode,
                out_dtype=jnp.float32),
        grid=(b, 1),
        in_specs=[_lens_spec(), _specs(n, cout), _specs(n, cin), _stats_spec(cout), _row(cout),
                  _row(cout), w_spec, b_spec],
        out_specs=_specs(n, cout),
        out_shape=jax.ShapeDtypeStruct((b, n, cout), jnp.float32),
        interpret=True,
    )(jnp.asarray(lens.reshape(b, 1, 1)), jnp.asarray(c2), jnp.asarray(x), jnp.asarray(stats),
      jnp.asarray(s[None]), jnp.asarray(sh[None]), jnp.asarray(w_in), jnp.asarray(b_in))
    mean, inv = fr._group_stats(torch.from_numpy(c2), 8)
    got = fr.resnet_out(torch.from_numpy(c2), torch.from_numpy(x), mean[:, 0], inv[:, 0],
                        torch.from_numpy(s), torch.from_numpy(sh), torch.from_numpy(lens), mode,
                        *((torch.from_numpy(wres), torch.from_numpy(bres)) if matmul else ()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not got[1, 40:].any()
