"""The port's deep-stage convs against the JAX package on the CPU, in f32
unless a case says otherwise: the row-absmax kernel K7 (plain version vs the
Pallas kernel in interpret mode; the card kernel's cluster partition and
reduction replayed in numpy at its served sites, bit-equal to the plain
version, every row read once, NaN propagating), the int8 conv3x3 (identical int8
operands), the bf16 conv3x3 keeping its f32 accumulator, a deep ResnetBlock
in int8 mode, the tiny Synthesizer with int8 deep convs, and the CLI's
kernel / int8 switches.

Tolerances are stated per case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize, scale_gates
from tests._torch_port import mask as _mask
from tests.test_torch_port_tts import _tiny_checkpoint
from unitspeech_tpu.config import (
    DataConfig,
    DecoderConfig,
    DurationPredictorConfig,
    EncoderConfig,
    MainConfig,
    VocoderConfig,
)
from unitspeech_tpu.infer import tts as jtts
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models import unet as junet
from unitspeech_tpu.ops import conv_matmul as jconv
from unitspeech_tpu.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu.ops.pallas_stats import _row_absmax_pallas
from unitspeech_tpu.ops.pallas_stats import row_absmax as j_row_absmax
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.models import unet as tunet
from unitspeech_tpu_torch.ops import conv_matmul, row_stats
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 430, 64), (3, 100, 24), (1, 7, 8)])
def test_row_absmax_plain_matches_pallas(shape):
    """Exactly equal: a max does not depend on the order."""
    x = _rand(np.random.default_rng(shape[1]), *shape)
    x[0, 3, 1] = -7.5  # the largest magnitude is negative
    want = np.asarray(_row_absmax_pallas(jnp.asarray(x), interpret=True))
    got = row_stats.row_absmax(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (shape[0], shape[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_row_absmax(jnp.asarray(x))))


def test_row_absmax_bf16_input():
    """bf16 rows: the f32 max of the bf16 values, exactly."""
    x = torch.from_numpy(_rand(np.random.default_rng(1), 2, 50, 16)).to(torch.bfloat16)
    want = np.asarray(_row_absmax_pallas(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                         interpret=True))
    np.testing.assert_array_equal(row_stats.row_absmax(x).numpy(), want)


# K7's served sites (rows, C): every flat deep-stage conv input of one
# estimator call at the 344-frame bucket (chip_smoke.py K7_SITES)
K7_SITES = [(1720, 256), (1720, 512), (1720, 1024), (430, 512), (430, 1024), (430, 2048)]
# K7's partition as csrc/row_stats.cu launches it (AM_CL, AM_CPB, AM_RG,
# AM_UNROLL there): a cluster of CLUSTER blocks per CHANNELS channels of a
# batch element, each block one slice of ceil(n / CLUSTER) rows walked by
# ROW_GROUPS row groups, UNROLL rows at a time while that many remain
CLUSTER, CHANNELS, ROW_GROUPS, UNROLL = 8, 128, 16, 8


def _nan_max(m, v):
    """csrc/row_stats.cu nan_max: v where v > m or v is NaN, else m."""
    return np.where((v > m) | np.isnan(v), v, m)


def _row_absmax_replay(x):
    """row_absmax_kernel in numpy on (B, n, C) f32 values: a cluster of
    CLUSTER blocks per CHANNELS channels of a batch element; rank q reads
    rows [q rows, (q + 1) rows), rows = ceil(n / cluster), its row group g
    every 16th row from q rows + g, UNROLL rows at a time while that
    many remain, then one; 16 lanes of 8 channels. Each block reduces its row groups in
    order, then rank q reduces the cluster's partials of its 16 channels in
    rank order. Returns (out (B, C), reads (B, n, C))."""
    b, n, c = x.shape
    cl, cpb, rgs, un = CLUSTER, CHANNELS, ROW_GROUPS, UNROLL
    rows = -(-n // cl)
    reads = np.zeros(x.shape, np.int64)
    out = np.full((b, c), -1.0, np.float32)
    ax = np.abs(x)
    for bb in range(b):
        for sl in range(-(-c // cpb)):
            ch = slice(sl * cpb, min(c, (sl + 1) * cpb))
            parts = []
            for q in range(cl):
                r1 = min(n, (q + 1) * rows)
                red = np.zeros((rgs, ch.stop - ch.start), np.float32)
                for g in range(rgs):
                    r = q * rows + g
                    visit = []
                    while r + (un - 1) * rgs < r1:  # un loads in flight
                        visit += [r + u * rgs for u in range(un)]
                        r += un * rgs
                    while r < r1:
                        visit.append(r)
                        r += rgs
                    m = np.zeros(ch.stop - ch.start, np.float32)
                    for rr in visit:
                        reads[bb, rr, ch] += 1
                        m = _nan_max(m, ax[bb, rr, ch])
                    red[g] = m
                part = red[0]
                for g in range(1, rgs):
                    part = _nan_max(part, red[g])
                parts.append(part)
            per = cpb // cl
            for q in range(cl):  # rank q's channels, the ranks' partials in order
                lo, hi = q * per, min((q + 1) * per, ch.stop - ch.start)
                t = np.zeros(max(hi - lo, 0), np.float32)
                for p in parts:
                    t = _nan_max(t, p[lo:hi])
                out[bb, ch.start + lo:ch.start + hi] = t
    return out, reads


@pytest.mark.parametrize("n,c", K7_SITES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_absmax_partition_replay(n, c, b, dtype):
    """The card kernel's partition at each served site reads every row of
    every channel exactly once, and its reduction equals row_absmax_plain
    bit for bit; a NaN in a row propagates to its channel only."""
    rng = np.random.default_rng(n + c + b)
    x = torch.from_numpy(_rand(rng, b, n, c)).to(dtype)
    x[b - 1, n // 3, c // 2] = -11.0
    x[0, n - 1, c - 1] = float("nan")
    xf = x.float().numpy()
    got, reads = _row_absmax_replay(xf)
    assert (reads == 1).all()
    want = row_stats.row_absmax_plain(x).numpy()
    assert np.isnan(got[0, c - 1]) and np.isnan(want[0, c - 1])
    assert np.isnan(got).sum() == 1
    np.testing.assert_array_equal(got, want)  # NaN positions equal, the rest bit for bit


@pytest.mark.parametrize("n", [1, 5, 9, 129])
def test_row_absmax_partition_few_rows(n):
    """Fewer rows than the cluster's slices (ranks with no rows keep 0, the
    identity of a max of magnitudes) and a C not a multiple of 128."""
    x = _rand(np.random.default_rng(n), 2, n, 40)
    got, reads = _row_absmax_replay(x)
    assert (reads == 1).all()
    np.testing.assert_array_equal(got, row_stats.row_absmax_plain(torch.from_numpy(x)).numpy())


def _jax_int8_operands(xf, w):
    """The int8 operands as JAX conv3x3_int8 forms them (conv_matmul.py:106-112)."""
    sx = 127.0 / jnp.maximum(jnp.max(j_row_absmax(xf)), 1e-8)
    x8 = jnp.clip(jnp.round(xf.astype(jnp.float32) * sx), -127, 127).astype(jnp.int8)
    wm = w.astype(jnp.float32).reshape(-1, w.shape[-1])
    sw = 127.0 / jnp.maximum(jnp.max(jnp.abs(wm), axis=0), 1e-8)
    w8 = jnp.clip(jnp.round(wm * sw), -127, 127).astype(jnp.int8)
    return np.asarray(x8), np.asarray(sx), np.asarray(w8), np.asarray(sw)


@pytest.mark.parametrize("b,t,f,cin,cout", [(3, 6, 20, 32, 64), (2, 5, 10, 64, 24)])
def test_conv3x3_int8_matches_jax(b, t, f, cin, cout):
    """Identical int8 operands, scales within one f32 step (XLA on the CPU
    divides through a reciprocal), outputs within 1e-6 relative (the int32
    product is exact)."""
    rng = np.random.default_rng(cin + cout)
    x = _rand(rng, b, t * f, cin, scale=0.7)
    x[:, -f:] = 0.0  # a padded frame
    w = _rand(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    jx8, jsx, jw8, jsw = _jax_int8_operands(jnp.asarray(x), jnp.asarray(w))
    x8, sx = conv_matmul.quantize_activation(torch.from_numpy(x))
    w8t, sw = conv_matmul.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(x8.numpy(), jx8)
    np.testing.assert_array_equal(w8t.t().numpy(), jw8)
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(sw.numpy(), jsw, rtol=2 ** -23, atol=0)
    want = np.asarray(jconv.conv3x3_int8(jnp.asarray(x), jnp.asarray(w), f))
    got = conv_matmul.conv3x3_int8(torch.from_numpy(x), torch.from_numpy(w), f).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # a precomputed weight quantization gives the same result
    got2 = conv_matmul.conv3x3_int8(torch.from_numpy(x), None, f, wq=(w8t, sw)).numpy()
    np.testing.assert_array_equal(got2, got)


def test_conv3x3_rows_bf16_keeps_f32_accumulator():
    """bf16 inputs: the f32 accumulator of the bf16 products, as JAX
    conv3x3_taps gives it with preferred_element_type=f32; rtol 1e-5 (f32
    sums in another order). A bf16-rounded output misses this by up to one
    bf16 step (2^-8 relative)."""
    rng = np.random.default_rng(5)
    b, t, f, cin, cout = 3, 8, 20, 64, 32
    xb = torch.from_numpy(_rand(rng, b, t * f, cin)).to(torch.bfloat16)
    wb = torch.from_numpy(_rand(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5))
    wb = wb.to(torch.bfloat16)
    want = np.asarray(jconv.conv3x3_taps(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                         jnp.asarray(wb.float().numpy(), jnp.bfloat16), f))
    got = conv_matmul.conv3x3_rows(xb, wb, f)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the value is not bf16-representable in general: the repair is visible
    assert not torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("cin,cout,pre_masked", [(256, 512, False), (512, 512, True)])
def test_resnet_block_int8_matches_jax(cin, cout, pre_masked):
    """A deep ResnetBlock (F=20, B=3, one padded row) in int8 mode against
    JAX ResnetBlock(use_int8=True), both f32. conv1's int8 operands are
    identical; conv2 quantizes h = GN + mish of conv1, whose f32 statistics
    are summed in another order, so a value within f32 round-off of a .5
    rounding boundary may take the other int8 step. One such flip moves a
    conv2 output by max|w| * max|h| / 127 (~2e-3 here) before GroupNorm:
    hence atol 1e-2 on outputs of size ~3, and the mean error 1e-4."""
    rng = np.random.default_rng(cin)
    t, f, groups, t_dim = 8, 20, 8, 12
    mask = _mask(t, [8, 5, 8])[:, :, None, None]
    x = rng.standard_normal((3, t, f, cin)).astype(np.float32)
    if pre_masked:
        x = x * mask
    t_emb = rng.standard_normal((3, t_dim)).astype(np.float32)
    jb = junet.ResnetBlock(cout, groups, input_pre_masked=pre_masked, use_int8=True)
    params = randomize(jb.init(jax.random.PRNGKey(0), x, mask, t_emb), 3)
    want = np.asarray(jb.apply(params, x, mask, t_emb)) * mask
    tb = load(tunet.ResnetBlock(cin, cout, t_dim, groups), params)
    for use_kernels in (True, False):  # K3/K7 plain versions, or plain stats
        with torch.no_grad():
            got = tb(*map(torch.from_numpy, (x, mask, t_emb)), torch.float32, use_kernels,
                     pre_masked=pre_masked, use_int8=True).numpy() * mask
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
        assert np.abs(got - want).mean() < 1e-4
    # int8 really changes the block: the f32 route differs from it by ~1%
    with torch.no_grad():
        f32 = tb(*map(torch.from_numpy, (x, mask, t_emb)), torch.float32, True,
                 pre_masked=pre_masked).numpy() * mask
    assert np.abs(f32 - want).max() > 1e-3


# n_feats 20 puts the stages at F = 20, 10 (as the full model's deep stages)
# and dim 64 x mults (1, 8) puts C = 512 at F = 10: the flat int8 route runs
# for down_1, mid and up_0_res1 on both sides, with the same routing
TINY_I8 = MainConfig(
    data=DataConfig(n_feats=20, hop_length=4),
    text_encoder=EncoderConfig(n_vocab=40, n_feats=20, n_channels=16, filter_channels=32,
                               n_layers=1, n_heads=2),
    duration_predictor=DurationPredictorConfig(in_channels=16, filter_channels=16,
                                               spk_emb_dim=8),
    decoder=DecoderConfig(n_feats=20, dim=64, dim_mults=(1, 8), groups=8, spk_emb_dim=8),
    vocoder=VocoderConfig(num_mels=20, upsample_rates=(2,), upsample_kernel_sizes=(4,),
                          upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1,),)),
)
TOKENS = [1, 5, 9, 3, 7, 2, 11, 4]


def test_synthesizer_int8_matches_jax():
    """The tiny Synthesizer with int8 deep convs against the JAX Synthesizer
    with use_int8_deep=True: same parameters, same injected noise, 3 DDPM
    steps with dual CFG, f32.

    Bound. int8 rounding is discontinuous: a value within f32 round-off of a
    .5 boundary takes either int8 step (test_resnet_block_int8_matches_jax),
    and the estimator carries such flips through its int8 convs and the
    sampler, so two int8 runs cannot agree to f32 round-off: a 1e-7 relative
    change of one estimator input moves JAX's own int8 output by a mean of
    ~0.25% on the CPU. So the f32 mels of the two are held to 1e-3 of the
    mel range (as in tests/test_torch_port_tts.py), which holds the routing;
    the port's int8 error against the JAX f32 mel to within 25% of JAX's own
    int8 error (the INT8_GATE.json measure; measured 2% apart); and the
    port's int8 mel must lie closer to JAX's int8 mel than that error.
    """
    jm = jtts.TTSModels.random_init(TINY_I8, jax.random.PRNGKey(0), with_vocoder=False,
                                    use_int8_deep=True)
    dp = jax.device_get(randomize(jm.duration_predictor_params, 2))
    dp["params"]["proj"]["bias"] = np.array([1.3], np.float32)  # ~4 frames a token
    jm = dataclasses.replace(
        jm, text_encoder_params=randomize(jm.text_encoder_params, 1),
        duration_predictor_params=dp,
        decoder_params=scale_gates(randomize(jm.decoder_params, 3), 0.003))
    ckpt = {name: params_from_jax(jax.device_get(getattr(jm, f"{name}_params")))
            for name in ("text_encoder", "duration_predictor", "decoder")}
    ckpt.update(spk_emb=torch.tensor(np.asarray(jm.spk_emb)),
                mel_min=torch.tensor(np.asarray(jm.mel_min)),
                mel_max=torch.tensor(np.asarray(jm.mel_max)),
                config=dataclasses.asdict(TINY_I8))
    jsynth = {True: jtts.Synthesizer(jm), False: jtts.Synthesizer(dataclasses.replace(
        jm, decoder=jdiff.UnitSpeech.from_config(TINY_I8.decoder)))}
    ports = {i8: ttts.Synthesizer(ttts.TTSModels.from_checkpoint(
        ckpt, device="cpu", dtype=torch.float32, use_kernels=True, use_int8_deep=i8,
        with_vocoder=False))
        for i8 in (True, False)}
    est = ports[True].models.decoder.estimator
    assert est.use_int8_deep
    # the flat blocks' int8 weights were quantized once, at load
    flat = [m for m in est.modules() if isinstance(m, tunet.ResnetBlock) and m.flat]
    assert flat and all(m.int8_weights is not None for m in flat)
    w8t, sw = flat[0].int8_weights[1]
    want8, want_sw = conv_matmul.quantize_weight(flat[0].block2.conv.kernel)
    assert torch.equal(w8t, want8) and torch.equal(sw, want_sw)
    assert all(m.int8_weights is None for m in ports[False].models.decoder.estimator.modules()
               if isinstance(m, tunet.ResnetBlock))
    _, _, w_ceil = ports[True].encode(TOKENS)
    frames = int(w_ceil.sum().item())
    y_pad = choose_bucket(fix_len_compatibility(frames, 1), jsynth[True].frame_buckets)
    rng = np.random.default_rng(0)
    steps = 3
    noise_z = rng.standard_normal((1, y_pad, 20)).astype(np.float32)
    noises = rng.standard_normal((steps, 1, y_pad, 20)).astype(np.float32)
    guidance = dict(text_gradient_scale=1.0, spk_gradient_scale=1.0)
    want, got = {}, {}
    for i8 in (True, False):
        w, w_len, _ = jsynth[i8].synthesize_mel(
            TOKENS, jax.random.PRNGKey(0), diffusion_steps=steps,
            noise_z=jnp.asarray(noise_z), noises=jnp.asarray(noises), **guidance)
        g, g_len, _ = ports[i8].synthesize_mel(
            TOKENS, diffusion_steps=steps, noise_z=torch.from_numpy(noise_z),
            noises=torch.from_numpy(noises), **guidance)
        assert g_len == w_len == frames
        want[i8], got[i8] = np.asarray(w), g.numpy()
        assert np.isfinite(got[i8]).all() and np.ptp(want[i8]) > 1.0
    tol = 1e-3 * float((ckpt["mel_max"] - ckpt["mel_min"]).max())
    np.testing.assert_allclose(got[False], want[False], rtol=0, atol=tol)
    d_port = np.abs(got[True] - want[False]).mean()
    d_jax = np.abs(want[True] - want[False]).mean()
    assert abs(d_port - d_jax) <= 0.25 * d_jax, (d_port, d_jax)
    assert np.abs(got[True] - want[True]).mean() < d_jax


# the stats line's keys and the TTSModels.from_checkpoint switches they report
ROUTE_KEYS = {"kernels": "use_kernels", "int8": "use_int8_deep", "deep": "use_deep",
              "i8pre": "use_i8pre_deep", "resample": "use_resample"}


def _routes(monkeypatch, argv, tmp_path, ckpt):
    """Run `cli inference` on the CPU and report the routing it built
    (ROUTE_KEYS' switches, then the dtype); the stats line reports the
    same."""
    built = {}
    real = ttts.TTSModels.from_state_dicts

    def spy(*a, **kw):
        built.update(kw)
        return real(*a, **kw)

    # every TTSModels constructor goes through from_state_dicts
    monkeypatch.setattr(ttts.TTSModels, "from_state_dicts", spy)
    stats = cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", ckpt,
                                "--output", str(tmp_path / "o.wav"), "--device", "cpu",
                                "--diffusion-steps", "1", *argv])
    assert {k: stats[k] for k in ROUTE_KEYS} == {k: built[v] for k, v in ROUTE_KEYS.items()}
    return (*(built[v] for v in ROUTE_KEYS.values()), built["dtype"])


def test_cli_kernel_and_int8_switches(monkeypatch, tmp_path):
    """The JAX serving defaults: kernels on in bf16 and int8 with them;
    --no-int8 keeps the kernels in bf16, --no-fast-kernels and --fp32 take
    the plain path with no int8. The fused deep-stage switches --deep,
    --i8pre and --resample are off by default, as in JAX, and on only with
    the kernels; --i8pre routes only with int8 on."""
    ckpt = _tiny_checkpoint(tmp_path)
    bf16, off = torch.bfloat16, (False, False, False)
    assert _routes(monkeypatch, [], tmp_path, ckpt) == (True, True, *off, bf16)
    assert _routes(monkeypatch, ["--no-int8"], tmp_path, ckpt) == (True, False, *off, bf16)
    assert _routes(monkeypatch, ["--no-fast-kernels"], tmp_path, ckpt) == \
        (False, False, *off, bf16)
    assert _routes(monkeypatch, ["--fp32"], tmp_path, ckpt) == \
        (False, False, *off, torch.float32)
    deep = ["--deep", "--i8pre", "--resample"]
    assert _routes(monkeypatch, deep, tmp_path, ckpt) == (True, True, True, True, True, bf16)
    assert _routes(monkeypatch, [*deep, "--no-int8"], tmp_path, ckpt) == \
        (True, False, True, False, True, bf16)
    assert _routes(monkeypatch, [*deep, "--no-fast-kernels"], tmp_path, ckpt) == \
        (False, False, *off, bf16)
