"""The fused deep-stage configuration of the port against the JAX package on
the CPU: the plain versions of the whole-layer deep ResnetBlock K8 and the
pre-quantized int8 deep block K9 (ops/fused_resnet_deep.py) against the
Pallas kernels `fused_resnet_block_deep` / `fused_resnet_block_deep_i8` in
interpret mode, the estimator with the three switches (use_deep,
use_resample, use_i8pre_deep) against JAX's GradLogPEstimator2d with
use_pallas_deep, use_pallas_resample, use_i8pre_deep, and the routing at
full width. (The CLI's switches: tests/test_torch_port_int8.py.)

Tolerances are stated per case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize
from tests._torch_port import mask as _mask
from unitspeech_tpu.models import unet as junet
from unitspeech_tpu.ops import pallas_resnet as jpr
from unitspeech_tpu_torch.models import unet as tunet
from unitspeech_tpu_torch.ops import fused_resnet_deep as frd
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _block_case(cin, cout, lens, seed):
    """The JAX deep-kernel tests' block: (b, t, f) = (2, 15, 6), odd T and
    F % 8 != 0, groups 4; params from the JAX init redrawn from a seed."""
    b, t, f = 2, 15, 6
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, f, cin)).astype(np.float32)
    t_emb = rng.standard_normal((b, 12)).astype(np.float32)
    mask = _mask(t, lens)[:, :, None, None]
    block = junet.ResnetBlock(cout, groups=4)
    params = randomize(block.init(jax.random.PRNGKey(0), x, mask, t_emb), seed)
    p = jax.device_get(params["params"])
    t_bias = np.asarray(junet.mish(t_emb) @ p["mlp"]["kernel"] + p["mlp"]["bias"])
    args = (p["block1"]["conv"]["kernel"], p["block1"]["conv"]["bias"],
            p["block1"]["norm"]["scale"], p["block1"]["norm"]["bias"],
            p["block2"]["conv"]["kernel"], p["block2"]["conv"]["bias"],
            p["block2"]["norm"]["scale"], p["block2"]["norm"]["bias"])
    res = (p["res_conv"]["kernel"], p["res_conv"]["bias"]) if cin != cout else (None, None)
    ref = np.asarray(block.apply(params, x, mask, t_emb))
    return x, mask, t_bias, args, res, ref


def _port_args(x, mask, t_bias, args, res):
    """The port wrappers' positional arguments and the residual keywords."""
    kw = {k: None if v is None else _t(v) for k, v in zip(("wres", "bres"), res)}
    return (_t(x), _t(mask), _t(t_bias), *map(_t, args)), kw


BLOCK_CASES = [(8, 16, [15, 9]), (16, 16, [15, 15]), (16, 8, [15, 9])]


@pytest.mark.parametrize("cin,cout,lens", BLOCK_CASES)
def test_deep_plain_matches_pallas(cin, cout, lens):
    """K8's plain version against fused_resnet_block_deep (interpret), f32,
    including the cin > cout hybrid; 2e-5 abs / 1e-4 rel."""
    x, mask, t_bias, args, res, ref = _block_case(cin, cout, lens, cin + cout)
    want = np.asarray(jpr.fused_resnet_block_deep(x, mask, t_bias, *args, wres=res[0],
                                                  bres=res[1], groups=4, interpret=True))
    before = frd.fused_resnet_block_deep.launches
    pa, kw = _port_args(x, mask, t_bias, args, res)
    got = frd.fused_resnet_block_deep(*pa, **kw, groups=4).numpy()
    assert frd.fused_resnet_block_deep.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL * 5, rtol=RTOL)  # the XLA twin


def _jax_i8_operands(x, lens, f, w):
    """The int8 operands as _fused_resnet_deep_i8pre forms them
    (pallas_resnet.py:958, 1016-1021): x8 with its per-batch scale, and
    _quant_w of the conv kernel."""
    n = x.shape[1] * f
    rows = (np.arange(n)[None, :, None] < (np.asarray(lens) * f)[:, None, None])
    xm = jnp.where(rows, jnp.asarray(x).reshape(x.shape[0], n, -1), 0.0)
    sx = 127.0 / jnp.maximum(jnp.max(jnp.abs(xm), axis=(1, 2)), 1e-8)
    x8 = jnp.clip(jnp.round(xm * sx[:, None, None]), -127, 127).astype(jnp.int8)
    w8, rsw = jpr._quant_w(jnp.asarray(w).reshape(-1, w.shape[-1]))
    return np.asarray(x8), np.asarray(sx), np.asarray(w8), np.asarray(rsw)[0]


@pytest.mark.parametrize("cin,cout,lens", BLOCK_CASES)
def test_deep_i8_plain_matches_pallas(cin, cout, lens):
    """K9's plain version against fused_resnet_block_deep_i8 (interpret),
    f32. The int8 operands are identical: x8 and its scale, and the weight
    quantization (its reciprocal scales within one f32 step: XLA on the CPU
    divides through a reciprocal). The outputs: conv1 is exact up to the
    dequantize; conv2 quantizes the glue h, whose GroupNorm statistics are
    summed in another order, so a value within f32 round-off of a .5
    boundary may take the other int8 step (test_torch_port_int8.py): atol
    1e-2 on outputs of size ~5, mean error 1e-4."""
    x, mask, t_bias, args, res, ref = _block_case(cin, cout, lens, 3 * cin + cout)
    f = x.shape[2]
    jx8, jsx, jw8, jrsw = _jax_i8_operands(x, lens, f, args[0])
    valid = torch.from_numpy(np.repeat(_mask(x.shape[1], lens), f, axis=1)[..., None])
    x8, sx = frd._quantize_plain(_t(x).reshape(2, -1, cin), valid)
    np.testing.assert_array_equal(x8.numpy(), jx8)
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=2 ** -23, atol=0)
    w8t, rsw = frd.quant_w(_t(args[0]))
    np.testing.assert_array_equal(w8t.t().numpy(), jw8)
    np.testing.assert_allclose(rsw.numpy(), jrsw, rtol=2 ** -23, atol=0)

    want = np.asarray(jpr.fused_resnet_block_deep_i8(x, mask, t_bias, *args, wres=res[0],
                                                     bres=res[1], groups=4, interpret=True))
    pa, kw = _port_args(x, mask, t_bias, args, res)
    got = frd.fused_resnet_block_deep_i8(*pa, **kw, groups=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    assert np.abs(got - want).mean() < 1e-4
    # the error bound of the JAX test against the float block; zero padding
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert 1e-4 < rel < 0.05, rel
    if lens[1] < x.shape[1]:
        assert np.abs(got[1, lens[1]:]).max() == 0.0


def test_deep_i8_precomputed_weights():
    """K9 with the weights quantized once (quant_w at load) gives what it
    computes per call."""
    x, mask, t_bias, args, res, _ = _block_case(16, 16, [15, 9], 5)
    pa, _ = _port_args(x, mask, t_bias, args, res)
    wq = (frd.quant_w(pa[3]), frd.quant_w(pa[7]))
    a = frd.fused_resnet_block_deep_i8(*pa, groups=4)
    b = frd.fused_resnet_block_deep_i8(*pa, groups=4, wq=wq)
    assert torch.equal(a, b)


FULL = dict(dim=128, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=256)


def _full_routes(frames, **flags):
    """Each ResnetBlock's route in the full-width estimator (MainConfig's
    decoder) at a frame bucket, on the kernel path with `flags`."""
    est = tunet.GradLogPEstimator2d(**FULL, use_kernels=True).to("meta")
    routes = {}
    for name, m in est.named_children():
        if isinstance(m, tunet.ResnetBlock):
            # down_i runs at stage i, mid at the last, up_i at stage i + 1
            kind, _, i = name.partition("_")
            stage = 3 if kind == "mid" else int(i.split("_")[0]) + (kind == "up")
            routes[name] = m.route(frames >> stage, 80 >> stage, True, **flags)
    return routes


def test_routes_at_full_width():
    """The JAX routing at MainConfig's widths (unet.py:321-383): at the
    344-frame bucket the fused deep path runs K8 on all nine deep blocks,
    and with int8 + i8pre K9 on the five with Cout <= 512; at 552, up_1_res1
    (1024 -> 256, F = 20, T = 138) fails the 4 MiB gate and runs flat."""
    def tally(routes):
        return {r: sorted(n for n in routes if routes[n] == r) for r in set(routes.values())}

    deep = tally(_full_routes(344, use_deep=True))
    assert len(deep["k8"]) == 9 and len(deep["k1"]) == 6 and deep["blocks"] == ["up_1_res2"]
    i8 = tally(_full_routes(344, use_int8=True, use_deep=True, use_i8pre=True))
    assert i8["k9"] == ["down_2_res1", "down_2_res2", "up_1_res1", "up_2_res1", "up_2_res2"]
    assert i8["k8"] == ["down_3_res1", "down_3_res2", "mid_res1", "mid_res2"]
    i8_552 = tally(_full_routes(552, use_int8=True, use_deep=True, use_i8pre=True))
    assert i8_552["flat"] == ["up_1_res1"] and len(i8_552["k9"]) == 4
    assert len(i8_552["k8"]) == 4
    # i8pre routes only with int8 on; without the switches the flat route
    assert "k9" not in tally(_full_routes(344, use_deep=True, use_i8pre=True))
    assert len(tally(_full_routes(344, use_int8=True))["flat"]) == 9


DIM64 = dict(dim=64, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8)
JAX_FLAGS = {
    "deep": dict(use_pallas_deep=True, use_pallas_resample=True),
    "deep_i8": dict(use_pallas_deep=True, use_pallas_resample=True, use_int8_deep=True,
                    use_i8pre_deep=True),
}
PORT_FLAGS = {
    "deep": dict(use_deep=True, use_resample=True),
    "deep_i8": dict(use_deep=True, use_resample=True, use_int8_deep=True,
                    use_i8pre_deep=True),
}


@pytest.fixture(scope="module")
def dim64():
    """A narrow estimator that still has a 512-wide stage (the deep route
    needs max(cin, cout) >= 512): stages (F, C) = (80, 64), (40, 128),
    (20, 256), (10, 512); 16 frames. JAX init with the fused switches on;
    every leaf redrawn from a numpy seed, rezero gates scaled down."""
    t = 16
    rng = np.random.default_rng(9)
    x, mu = (rng.standard_normal((2, t, 80)).astype(np.float32) for _ in range(2))
    inputs = (x, _mask(t, [16, 11]), mu, np.array([0.6, 0.3], np.float32),
              rng.standard_normal((2, 8)).astype(np.float32))
    jm = junet.GradLogPEstimator2d(**DIM64, **JAX_FLAGS["deep_i8"])
    params = randomize(jm.init(jax.random.PRNGKey(0), *inputs), 11)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 0.1 if str(getattr(p[-1], "key", "")) == "g" else v, params)
    return params, inputs


def test_fused_param_tree_matches_state_dict(dim64):
    """The fused routes (_ResampleParams, _fused_params) keep the estimator's
    parameter tree: the JAX tree with the switches on is the port's state
    dict, name for name and shape for shape."""
    params, _ = dim64
    got = {k: tuple(v.shape) for k, v in params_from_jax(jax.device_get(params)).items()}
    est = tunet.GradLogPEstimator2d(**DIM64, **PORT_FLAGS["deep_i8"])
    assert got == {k: tuple(v.shape) for k, v in est.state_dict().items()}


def _spy(monkeypatch, calls):
    for name in ("fused_resnet_block_deep", "fused_resnet_block_deep_i8",
                 "fused_downsample_conv", "fused_upsample_conv"):
        real = getattr(tunet, name)

        def spy(x, *a, _real=real, _name=name, **kw):
            calls.append((_name, tuple(x.shape)))
            return _real(x, *a, **kw)

        monkeypatch.setattr(tunet, name, spy)


@pytest.mark.parametrize("path", ["deep", "deep_i8"])
def test_estimator_fused_deep_matches_jax(dim64, monkeypatch, path):
    """The port's estimator with the fused switches against JAX's with the
    same switches (Pallas kernels in interpret mode), f32, on the plain path
    otherwise. The deep blocks route as in JAX: the six with max(Cin,
    Cout) >= 512 (down_3 res1/res2, mid res1/res2, up_2_res1, up_1_res1)
    take K8, or K9 with int8 + i8pre (all have Cout <= 512); the F = 80/40
    downsamples and the F = 40 upsample take K11.
    Tolerance: deep, 2e-5 abs per unit of output scale and 1e-4 rel (f32
    sums in another order). deep_i8: a value within f32 round-off of a .5
    int8 boundary may round the other way (test_deep_i8_plain_matches_pallas)
    and the estimator carries such steps on through six int8 blocks, so two
    int8 runs agree only statistically: a 1e-7 relative change of x moves
    JAX's own int8 output by a mean of ~2e-4 of its scale here (the port
    differs from JAX by ~1.8e-4). So the port's int8 error against the JAX
    f32 path must be within 25% of JAX's own int8 error (measured 1% apart),
    the port must lie closer to JAX's int8 output than that error, and no
    output may differ by more than 1e-2 of the scale."""
    params, inputs = dim64
    jm = junet.GradLogPEstimator2d(**DIM64, **JAX_FLAGS[path])
    want = np.asarray(jm.apply(params, *inputs))
    port = load(tunet.GradLogPEstimator2d(**DIM64, **PORT_FLAGS[path]), params)
    calls = []
    _spy(monkeypatch, calls)
    with torch.no_grad():
        got = port(*map(_t, inputs)).numpy()
    deep = "fused_resnet_block_deep" + ("_i8" if path == "deep_i8" else "")
    assert [c for c in calls if c[0].startswith("fused_resnet")] == [
        (deep, (2, 2, 10, 256)), (deep, (2, 2, 10, 512)), (deep, (2, 2, 10, 512)),
        (deep, (2, 2, 10, 512)), (deep, (2, 2, 10, 1024)), (deep, (2, 4, 20, 512))]
    assert [c for c in calls if not c[0].startswith("fused_resnet")] == [
        ("fused_downsample_conv", (2, 16, 80, 64)), ("fused_downsample_conv", (2, 8, 40, 128)),
        ("fused_upsample_conv", (2, 8, 40, 64))]
    scale = max(1.0, np.abs(want).max())
    if path == "deep":
        np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=RTOL)
    else:
        f32 = np.asarray(junet.GradLogPEstimator2d(**DIM64, **JAX_FLAGS["deep"]).apply(
            params, *inputs))
        d_jax, d_port = np.abs(want - f32).mean(), np.abs(got - f32).mean()
        assert abs(d_port - d_jax) <= 0.25 * d_jax, (d_port, d_jax)
        assert np.abs(got - want).mean() < d_jax
        assert np.abs(got - want).max() <= 1e-2 * scale
    if path == "deep_i8":
        # the K9 blocks' weights were quantized once, when they loaded
        blocks = [m for m in port.modules() if isinstance(m, tunet.ResnetBlock) and m.flat]
        assert blocks and all(m.i8pre_weights is not None for m in blocks)
        w8t, rsw = blocks[0].i8pre_weights[1]
        want8, want_rsw = frd.quant_w(blocks[0].block2.conv.kernel)
        assert torch.equal(w8t, want8) and torch.equal(rsw, want_rsw)


def test_pack_requantizes_in_place_update(dim64):
    """A weight changed in place and then `pack()`: each K9 block's packed
    int8 tiles and the scales its epilogue reads come from one quantization
    of the new weights, and the estimator gives what one freshly loaded
    with those weights gives, bit for bit."""
    params, inputs = dim64
    flags = PORT_FLAGS["deep_i8"]
    est = load(tunet.GradLogPEstimator2d(**DIM64, **flags), params)
    blocks = [m for m in est.modules() if isinstance(m, tunet.ResnetBlock)
              and m.packed_for == "k9"]
    assert len(blocks) == 6
    with torch.no_grad():
        for m in blocks:
            for b in (m.block1, m.block2):
                b.conv.kernel.mul_(-1.5).add_(0.01)
    est.pack()
    for m in blocks:
        cin, cout = m.block1.conv.kernel.shape[2:]
        for i, b in enumerate((m.block1, m.block2)):
            w8t, rsw = frd.quant_w(b.conv.kernel)
            assert torch.equal(m.i8pre_weights[i][0], w8t)
            assert torch.equal(m.i8pre_weights[i][1], rsw)
            if i or cin <= cout:
                assert torch.equal(m.packed[i], frd.pack_conv_weight_i8(w8t, w8t.shape[1] // 9))
    fresh = tunet.GradLogPEstimator2d(**DIM64, **flags)
    fresh.load_state_dict(est.state_dict())
    with torch.no_grad():
        assert torch.equal(est(*map(_t, inputs)), fresh.eval()(*map(_t, inputs)))


def test_estimator_resample_frames_per_level(dim64, monkeypatch):
    """Each K11 call of the estimator gets the valid frames of the mask of
    its input's level, counted once per call: the F = 80 and F = 40
    downsamples those of levels 0 and 1, the F = 40 upsample (up stage 0,
    whose input is one level deeper than down stage 0's) those of level 1.
    On the card the kernel trusts these counts; the CPU's plain version
    reads the mask, so only this check sees a wrong count here."""
    params, inputs = dim64
    port = load(tunet.GradLogPEstimator2d(**DIM64, **PORT_FLAGS["deep"]), params)
    calls = []
    for name in ("fused_downsample_conv", "fused_upsample_conv"):
        real = getattr(tunet, name)

        def spy(x, mask, *a, _real=real, _name=name, lens=None, **kw):
            calls.append((_name, x.shape[1], tuple(mask.shape), lens))
            return _real(x, mask, *a, lens=lens, **kw)

        monkeypatch.setattr(tunet, name, spy)
    with torch.no_grad():
        port(*map(_t, inputs))
    assert [c[:3] for c in calls] == [
        ("fused_downsample_conv", 16, (2, 16, 1, 1)),
        ("fused_downsample_conv", 8, (2, 8, 1, 1)),
        ("fused_upsample_conv", 8, (2, 8, 1, 1))]
    lens = [c[3].tolist() for c in calls]
    assert lens == [[16, 11], [8, 6], [8, 6]]  # ceil(11 / 2) = 6 at level 1
    assert all(c[3].dtype == torch.int32 for c in calls)
    assert calls[1][3] is calls[2][3]  # level 1's counts, made once
