"""Reference checkpoints in the port: its own converters (utils/torch_convert,
utils/torch_convert_ssl) against the JAX package's on reference-shaped
state dicts with random values, for the text and unit encoders, the
duration predictor, the diffusion decoder, BigVGAN with weight norm (both
namings), HuBERT, WavLM and the speaker encoder (WavLM + ECAPA); the port
modules with converted weights against their JAX twins; the `.pt` loaders
of utils/artifacts; `cli convert` (k-means included); and `cli inference`
with the per-module flags at tiny widths on the CPU.

The converted state dicts must equal params_from_jax of the JAX
converter's trees bit for bit (keys, shapes, values). The modules are held
to tests/test_torch_port_models.py's tolerance: 2e-5 abs / 1e-4 rel, f32.
No published weights are in the repository, so the state dicts are drawn
from a numpy seed with the reference's key names and shapes."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests.test_torch_port_tts import TINY
from unitspeech_tpu.config import DurationPredictorConfig, EncoderConfig, VocoderConfig
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models import duration as jdur
from unitspeech_tpu.models import encoder as jenc
from unitspeech_tpu.models import vocoder as jvoc
from unitspeech_tpu.utils import torch_convert as jconv
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import config_from_dict
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models import duration as tdur
from unitspeech_tpu_torch.models import encoder as tenc
from unitspeech_tpu_torch.models import vocoder as tvoc
from unitspeech_tpu_torch.utils import artifacts
from unitspeech_tpu_torch.utils import torch_convert as tconv
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4

ENC = dict(n_vocab=40, n_feats=16, n_channels=16, filter_channels=32, n_layers=2, n_heads=2)
UNIT_ENC = dict(ENC, n_vocab=50)
DP = dict(in_channels=16, filter_channels=24, spk_emb_dim=8)
DEC = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)
VOC = dict(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3), (1, 2)))


class RefDict(dict):
    """A reference-format state dict drawn from a numpy seed: each entry
    scaled by its role so that a module run on it stays finite (the rezero
    gates small, as utils/params.random_params draws them)."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def add(self, name, *shape):
        leaf = name.rsplit(".", 1)[-1]
        x = self.rng.standard_normal(shape)
        if name.endswith(".fn.g"):
            x = self.rng.uniform(0.0005, 0.0015, shape)
        elif leaf in ("gamma", "weight_g", "original0") or (
                leaf == "weight" and len(shape) == 1):
            x = 1.0 + 0.05 * x
        elif leaf in ("weight", "weight_v", "original1") and len(shape) > 1:
            x = x / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(("spk_uncon", "text_uncon")):
            x = 0.5 * x
        else:  # biases, betas, snake alpha/beta, relative position embeddings
            x = 0.05 * x
        self[name] = x.astype(np.float32)


def ref_encoder(seed, n_vocab, n_feats, n_channels, filter_channels, n_layers, n_heads,
                kernel_size=3, prenet_kernel_size=5, prenet_layers=3, window_size=4):
    sd, c = RefDict(seed), n_channels
    sd.add("emb.weight", n_vocab, c)
    for i in range(prenet_layers):
        sd.add(f"prenet.conv_layers.{i}.weight", c, c, prenet_kernel_size)
        sd.add(f"prenet.conv_layers.{i}.bias", c)
        sd.add(f"prenet.norm_layers.{i}.gamma", c)
        sd.add(f"prenet.norm_layers.{i}.beta", c)
    sd.add("prenet.proj.weight", c, c, 1)
    sd.add("prenet.proj.bias", c)
    for i in range(n_layers):
        p = f"encoder.attn_layers.{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            sd.add(f"{p}.{name}.weight", c, c, 1)
            sd.add(f"{p}.{name}.bias", c)
        sd.add(f"{p}.emb_rel_k", 1, 2 * window_size + 1, c // n_heads)
        sd.add(f"{p}.emb_rel_v", 1, 2 * window_size + 1, c // n_heads)
        for n in (1, 2):
            sd.add(f"encoder.norm_layers_{n}.{i}.gamma", c)
            sd.add(f"encoder.norm_layers_{n}.{i}.beta", c)
        sd.add(f"encoder.ffn_layers.{i}.conv_1.weight", filter_channels, c, kernel_size)
        sd.add(f"encoder.ffn_layers.{i}.conv_1.bias", filter_channels)
        sd.add(f"encoder.ffn_layers.{i}.conv_2.weight", c, filter_channels, kernel_size)
        sd.add(f"encoder.ffn_layers.{i}.conv_2.bias", c)
    sd.add("proj_m.weight", n_feats, c, 1)
    sd.add("proj_m.bias", n_feats)
    return dict(sd)


def ref_duration_predictor(seed, in_channels, filter_channels, spk_emb_dim, kernel_size=3):
    sd = RefDict(seed)
    sd.add("conv_1.weight", filter_channels, in_channels + spk_emb_dim, kernel_size)
    sd.add("conv_2.weight", filter_channels, filter_channels, kernel_size)
    for n in ("conv_1", "conv_2"):
        sd.add(f"{n}.bias", filter_channels)
    for n in ("norm_1", "norm_2"):
        sd.add(f"{n}.gamma", filter_channels)
        sd.add(f"{n}.beta", filter_channels)
    sd.add("proj.weight", 1, filter_channels, 1)
    sd.add("proj.bias", 1)
    # the reference's projection bias sets the durations' scale: tokens of
    # several frames each
    sd["proj.bias"][:] = 3.0
    return dict(sd)


def ref_decoder(seed, n_feats, dim, dim_mults, groups, spk_emb_dim, prefix=""):
    """The UnitSpeech decoder's 'model' state dict (unitspeech.py:124-233);
    `prefix` "module." as a DataParallel run saves it."""
    sd = RefDict(seed)
    add = lambda name, *shape: sd.add(prefix + name, *shape)  # noqa: E731
    sd.add(prefix + "text_uncon", 1, n_feats, 1)
    sd.add(prefix + "spk_uncon", 1, 1, spk_emb_dim)
    t_dim = dim + spk_emb_dim
    dims = [2] + [dim * m for m in dim_mults]

    def resnet(p, din, dout):
        add(f"{p}.mlp.1.weight", dout, t_dim)
        add(f"{p}.mlp.1.bias", dout)
        for bn, d_in in (("block1", din), ("block2", dout)):
            add(f"{p}.{bn}.block.0.weight", dout, d_in, 3, 3)
            add(f"{p}.{bn}.block.0.bias", dout)
            add(f"{p}.{bn}.block.1.weight", dout)
            add(f"{p}.{bn}.block.1.bias", dout)
        if din != dout:
            add(f"{p}.res_conv.weight", dout, din, 1, 1)
            add(f"{p}.res_conv.bias", dout)

    def attn(p, d):
        add(f"{p}.fn.g", 1)
        add(f"{p}.fn.fn.to_qkv.weight", 128 * 3, d, 1, 1)
        add(f"{p}.fn.fn.to_out.weight", d, 128, 1, 1)
        add(f"{p}.fn.fn.to_out.bias", d)

    add("estimator.mlp.0.weight", dim * 4, dim)
    add("estimator.mlp.0.bias", dim * 4)
    add("estimator.mlp.2.weight", dim, dim * 4)
    add("estimator.mlp.2.bias", dim)
    n = len(dim_mults)
    for i in range(n):
        din, dout = dims[i], dims[i + 1]
        resnet(f"estimator.downs.{i}.0", din, dout)
        resnet(f"estimator.downs.{i}.1", dout, dout)
        attn(f"estimator.downs.{i}.2", dout)
        if i < n - 1:
            add(f"estimator.downs.{i}.3.conv.weight", dout, dout, 3, 3)
            add(f"estimator.downs.{i}.3.conv.bias", dout)
    mid = dims[-1]
    resnet("estimator.mid_block1", mid, mid)
    attn("estimator.mid_attn", mid)
    resnet("estimator.mid_block2", mid, mid)
    pairs = list(zip(dims[1:-1], dims[2:]))[::-1]
    for j in range(n - 1):
        din, dout = pairs[j]
        resnet(f"estimator.ups.{j}.0", dout * 2, din)
        resnet(f"estimator.ups.{j}.1", din, din)
        attn(f"estimator.ups.{j}.2", din)
        add(f"estimator.ups.{j}.3.conv.weight", din, din, 4, 4)
        add(f"estimator.ups.{j}.3.conv.bias", din)
    add("estimator.final_block.block.0.weight", dim, dim, 3, 3)
    add("estimator.final_block.block.0.bias", dim)
    add("estimator.final_block.block.1.weight", dim)
    add("estimator.final_block.block.1.bias", dim)
    add("estimator.final_conv.weight", 1, dim, 1, 1)
    add("estimator.final_conv.bias", 1)
    return dict(sd)


def ref_bigvgan(seed, num_mels, upsample_rates, upsample_kernel_sizes,
                upsample_initial_channel, resblock_kernel_sizes, resblock_dilation_sizes):
    """BigVGAN's 'generator' state dict (vocoder/models.py:121-201) under
    weight norm: conv_pre and the resblock convs with the legacy
    weight_g / weight_v names, the upsamplers and conv_post with the
    parametrize names."""
    sd = RefDict(seed)

    def wn(prefix, legacy, *shape):
        g, v = ("weight_g", "weight_v") if legacy else (
            "parametrizations.weight.original0", "parametrizations.weight.original1")
        sd.add(f"{prefix}.{g}", shape[0], *([1] * (len(shape) - 1)))
        sd.add(f"{prefix}.{v}", *shape)

    c0 = upsample_initial_channel
    wn("conv_pre", True, c0, num_mels, 7)
    sd.add("conv_pre.bias", c0)
    ch = c0
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        out = c0 // 2 ** (i + 1)
        # ConvTranspose1d (in, out, k): weight norm over dim 0 as the
        # reference applies it
        wn(f"ups.{i}.0", False, ch, out, k)
        sd.add(f"ups.{i}.0.bias", out)
        ch = out
        for j, (rk, dil) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
            r = i * len(resblock_kernel_sizes) + j
            for n in range(len(dil)):
                for conv in ("convs1", "convs2"):
                    wn(f"resblocks.{r}.{conv}.{n}", True, ch, ch, rk)
                    sd.add(f"resblocks.{r}.{conv}.{n}.bias", ch)
            for a in range(2 * len(dil)):
                sd.add(f"resblocks.{r}.activations.{a}.act.alpha", ch)
                sd.add(f"resblocks.{r}.activations.{a}.act.beta", ch)
    sd.add("activation_post.act.alpha", ch)
    sd.add("activation_post.act.beta", ch)
    wn("conv_post", False, 1, ch, 7)
    sd.add("conv_post.bias", 1)
    return dict(sd)


FAMILIES = {
    "text_encoder": (lambda: ref_encoder(0, **ENC),
                     lambda sd, c: c.convert_encoder(sd, n_layers=ENC["n_layers"])),
    "unit_encoder": (lambda: ref_encoder(1, **UNIT_ENC),
                     lambda sd, c: c.convert_encoder(sd, n_layers=UNIT_ENC["n_layers"])),
    "duration_predictor": (lambda: ref_duration_predictor(2, **DP),
                           lambda sd, c: c.convert_duration_predictor(sd)),
    "decoder": (lambda: ref_decoder(3, **DEC, prefix="module."),
                lambda sd, c: c.convert_decoder(sd, dim=DEC["dim"],
                                                dim_mults=DEC["dim_mults"])),
    "vocoder": (lambda: ref_bigvgan(4, **VOC),
                lambda sd, c: c.convert_bigvgan(sd, num_upsamples=2, num_kernels=2,
                                                convs_per_block=2)),
}


def _port_module(family):
    if family in ("text_encoder", "unit_encoder"):
        return tenc.Encoder.from_config(EncoderConfig(**(ENC if family == "text_encoder"
                                                         else UNIT_ENC)))
    if family == "duration_predictor":
        return tdur.DurationPredictor.from_config(DurationPredictorConfig(**DP))
    if family == "decoder":
        return tdiff.UnitSpeech(**DEC)
    return tvoc.BigVGAN.from_config(VocoderConfig(**VOC))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_matches_jax_bit_for_bit(family):
    """The port's converted state dict equals params_from_jax of the JAX
    converter's tree (same keys, shapes, values), and is exactly the port
    module's state dict (strict load)."""
    make, convert = FAMILIES[family]
    sd = make()
    got = params_from_jax(convert(sd, tconv))
    want = params_from_jax(convert(sd, jconv))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    mod = _port_module(family)
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    mod.load_state_dict(got)


def test_weight_norm_fold_both_namings():
    """The legacy (weight_g, weight_v) and the parametrize names fold to the
    same weight, the norm taken over every non-output axis per output
    channel, as torch's weight_norm computes it."""
    rng = np.random.default_rng(5)
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 3))
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    want = conv.weight.detach().numpy()
    sd = {f"c.{k}": v.detach().numpy() for k, v in conv.state_dict().items()}
    g, v = sd["c.parametrizations.weight.original0"], sd["c.parametrizations.weight.original1"]
    got = tconv._weight_normed(sd, "c")
    legacy = tconv._weight_normed({"c.weight_g": g, "c.weight_v": v}, "c")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, legacy)
    np.testing.assert_array_equal(got, jconv.fold_weight_norm(g, v))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _pair(family):
    """(port module with the port's converted weights, JAX module, JAX params
    from the JAX converter)."""
    make, convert = FAMILIES[family]
    sd = make()
    port = _port_module(family)
    port.load_state_dict(params_from_jax(convert(sd, tconv)))
    jparams = convert(sd, jconv)
    if family in ("text_encoder", "unit_encoder"):
        jm = jenc.Encoder.from_config(EncoderConfig(**(ENC if family == "text_encoder"
                                                       else UNIT_ENC)))
    elif family == "duration_predictor":
        jm = jdur.DurationPredictor(**DP)
    elif family == "decoder":
        jm = jdiff.UnitSpeech(**DEC)
    else:
        jm = jvoc.BigVGAN.from_config(VocoderConfig(**VOC))
    return port.eval(), jm, jparams


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_module_matches_jax(family):
    """Each port module with the port's converted weights against its JAX
    twin with the JAX converter's, f32 on the CPU."""
    port, jm, jparams = _pair(family)
    rng = np.random.default_rng(9)
    if family in ("text_encoder", "unit_encoder"):
        n_vocab = (ENC if family == "text_encoder" else UNIT_ENC)["n_vocab"]
        tokens = rng.integers(0, n_vocab, size=(2, 11)).astype(np.int32)
        lengths = np.array([11, 7], np.int32)
        want = jm.apply(jparams, tokens, lengths)
        with torch.no_grad():
            got = port(torch.from_numpy(tokens).long(), torch.from_numpy(lengths))
        for g, w in zip(got, want):
            _close(g.numpy(), w)
        return
    if family == "duration_predictor":
        x = rng.standard_normal((2, 9, 16)).astype(np.float32)
        x_mask = (np.arange(9)[None, :, None] < np.array([9, 6])[:, None, None]).astype(
            np.float32)
        spk = rng.standard_normal((2, 8)).astype(np.float32)
        want = jm.apply(jparams, x, x_mask, g=spk, reverse=True)
        with torch.no_grad():
            got = port(*map(torch.from_numpy, (x, x_mask, spk)))
        _close(got.numpy(), want)
        return
    if family == "decoder":
        t = 16
        x, mu = (rng.standard_normal((2, t, 16)).astype(np.float32) for _ in range(2))
        mask = (np.arange(t)[None, :] < np.array([16, 11])[:, None]).astype(np.float32)
        tt = np.array([0.7, 0.2], np.float32)
        spk = rng.standard_normal((2, 8)).astype(np.float32)
        want = np.asarray(jm.apply(jparams, x, mask, mu, tt, spk))
        with torch.no_grad():
            got = port(*map(torch.from_numpy, (x, mask, mu, tt, spk))).numpy()
        _close(got, want, atol=ATOL * max(1.0, np.abs(want).max()))
        return
    mel = rng.standard_normal((2, 10, 16)).astype(np.float32)
    want = np.asarray(jm.apply(jparams, mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 40)
    _close(got, want)


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_pt_loaders_read_reference_and_port_files(tmp_path):
    """utils/artifacts reads the reference's .pt layouts (the decoder under
    'model' with its spk_emb (1, 1, S), mel_min/max (F, 1) and iteration;
    BigVGAN under 'generator'; the encoders and the duration predictor under
    'model' or bare) and the port's own files (a decoder bundle, a module
    file, the combined checkpoint) to the same state dicts."""
    cfg = config_from_dict({"text_encoder": ENC, "unit_encoder": UNIT_ENC,
                            "duration_predictor": DP, "decoder": DEC, "vocoder": VOC})
    want = {f: params_from_jax(FAMILIES[f][1](FAMILIES[f][0](), jconv)) for f in FAMILIES}
    rng = np.random.default_rng(3)
    spk = rng.standard_normal((1, 1, 8)).astype(np.float32)
    mel_min, mel_max = np.full((16, 1), -11.0, np.float32), np.full((16, 1), 2.0, np.float32)
    torch.save({"model": _torch_sd(FAMILIES["decoder"][0]()), "spk_emb": torch.from_numpy(spk),
                "mel_min": torch.from_numpy(mel_min), "mel_max": torch.from_numpy(mel_max),
                "iteration": 1234}, tmp_path / "dec.pt")
    torch.save({"model": _torch_sd(FAMILIES["text_encoder"][0]())}, tmp_path / "te.pt")
    torch.save(_torch_sd(FAMILIES["unit_encoder"][0]()), tmp_path / "ue.pt")
    torch.save({"model": _torch_sd(FAMILIES["duration_predictor"][0]())}, tmp_path / "dp.pt")
    torch.save({"generator": _torch_sd(FAMILIES["vocoder"][0]())}, tmp_path / "voc.pt")

    def same(got, ref):
        assert list(got) == list(ref) and all(torch.equal(got[k], ref[k]) for k in ref)

    bundle = artifacts.load_decoder_bundle(str(tmp_path / "dec.pt"), cfg.decoder)
    same(bundle.state_dict, want["decoder"])
    np.testing.assert_array_equal(bundle.spk_emb.numpy(), spk.reshape(1, 8))
    np.testing.assert_array_equal(bundle.mel_min.numpy(), mel_min.reshape(-1))
    np.testing.assert_array_equal(bundle.mel_max.numpy(), mel_max.reshape(-1))
    assert bundle.step == 1234
    loaded = {
        "text_encoder": artifacts.load_encoder_params(str(tmp_path / "te.pt"), cfg.text_encoder),
        "unit_encoder": artifacts.load_encoder_params(str(tmp_path / "ue.pt"), cfg.unit_encoder,
                                                      "unit_encoder"),
        "duration_predictor": artifacts.load_duration_predictor_params(str(tmp_path / "dp.pt")),
        "vocoder": artifacts.load_vocoder_params(str(tmp_path / "voc.pt"), cfg.vocoder),
    }
    for f, sd in loaded.items():
        same(sd, want[f])

    # the port's formats round-trip
    artifacts.save_decoder_bundle(str(tmp_path / "b.pt"), bundle, cfg)
    again = artifacts.load_decoder_bundle(str(tmp_path / "b.pt"), cfg.decoder)
    same(again.state_dict, want["decoder"])
    assert again.step == 1234 and torch.equal(again.spk_emb, bundle.spk_emb)
    for f, sd in loaded.items():
        artifacts.save_module(str(tmp_path / f"{f}.pt"), f, sd, cfg)
    same(artifacts.load_encoder_params(str(tmp_path / "unit_encoder.pt"), cfg.unit_encoder,
                                       "unit_encoder"), want["unit_encoder"])
    same(artifacts.load_vocoder_params(str(tmp_path / "vocoder.pt"), cfg.vocoder),
         want["vocoder"])
    combined = {**loaded, "decoder": want["decoder"], "config": dataclasses.asdict(cfg)}
    same(artifacts.load_encoder_params(combined, cfg.text_encoder), want["text_encoder"])
    with pytest.raises(ValueError, match="without a 'unit_encoder' entry"):
        artifacts.load_encoder_params(str(tmp_path / "text_encoder.pt"), cfg.unit_encoder,
                                      "unit_encoder")


@pytest.mark.parametrize("kind", ["decoder", "text-encoder", "unit-encoder",
                                  "duration-predictor", "vocoder"])
def test_cli_convert_writes_the_port_format(tmp_path, kind):
    """`cli convert KIND src dest` writes the port's file, which loads back
    to the converter's state dict; the config given is stored with it."""
    family = kind.replace("-", "_")
    cfg = {"text_encoder": ENC, "unit_encoder": UNIT_ENC, "duration_predictor": DP,
           "decoder": dict(DEC, dim_mults=list(DEC["dim_mults"])), "vocoder": VOC}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    sd = _torch_sd(FAMILIES[family][0]())
    key = {"decoder": "model", "vocoder": "generator"}.get(family)
    torch.save({key: sd} if key else sd, tmp_path / "src.pt")
    assert cli.main(["convert", kind, str(tmp_path / "src.pt"), str(tmp_path / "out.pt"),
                     "--config", str(tmp_path / "cfg.json")]) == 0
    out = torch.load(tmp_path / "out.pt", weights_only=True)
    assert out["config"]["decoder"]["dim"] == DEC["dim"]
    want = params_from_jax(FAMILIES[family][1](FAMILIES[family][0](), jconv))
    assert list(out[family]) == list(want)
    assert all(torch.equal(out[family][k], want[k]) for k in want)


@pytest.mark.parametrize("kind", ["contentvec-encoder"])
def test_cli_convert_refuses_unported_kinds(tmp_path, kind):
    """The port refuses no kind of the JAX CLI's `convert` any more (the
    contentvec encoder, the last one, came with voice conversion:
    tests/test_torch_port_vc.py converts it), and still refuses a kind
    neither package has."""
    from unitspeech_tpu_torch.utils import convert_cli

    assert kind in convert_cli.KINDS
    with pytest.raises(SystemExit):
        cli.main(["convert", "no-such-kind", str(tmp_path / "x.pt"), str(tmp_path / "y.pt")])


# --- the SSL checkpoints -----------------------------------------------------

# seven conv layers (the converters' default count) at small widths
SEVEN_CONVS = ((8, 10, 5),) + ((8, 3, 2),) * 4 + ((8, 2, 2),) * 2
SSL_SMALL = dict(conv_layers=SEVEN_CONVS, embed_dim=16, num_layers=2, num_heads=2, ffn_dim=32,
                 conv_pos=8, conv_pos_groups=2)
# the test configurations `cli convert` reads the widths from
SSL_CFG = {"spk_embedder": dict(feat_type="wavlm_test", channels=16, spk_emb_dim=8),
           "unit_extractor": dict(dense_model_name="hubert-test", vocab_size=40)}


def _ssl_ref(kind, seed):
    """A reference-shaped state dict (tools/ssl_reference) with seven conv
    layers and the JAX converter of that kind, at its default conv count."""
    from unitspeech_tpu.models.ssl.hubert import HubertConfig
    from unitspeech_tpu.models.ssl.wavlm import WavLMConfig
    from unitspeech_tpu_torch.tools import ssl_reference

    d = ssl_reference.Draw(seed)
    if kind == "hubert":
        ssl_reference.ssl_encoder_sd(d, HubertConfig(**SSL_SMALL))
        return d.sd, lambda m, sd: m.convert_hubert(sd, 2)
    w = WavLMConfig(**SSL_SMALL, num_buckets=16, max_distance=64)
    if kind == "wavlm":
        ssl_reference.ssl_encoder_sd(d, w, relpos=True, gru_rel_pos=True)
        return d.sd, lambda m, sd: m.convert_wavlm(sd, 2)
    ssl_reference.ssl_encoder_sd(d, w, "feature_extract.model.", relpos=True, gru_rel_pos=True)
    ssl_reference.ecapa_sd(d, 16, 16, 8, 3)
    return d.sd, lambda m, sd: m.convert_speaker_embedder(sd, 2)


@pytest.mark.parametrize("kind", ["hubert", "wavlm", "speaker-embedder"])
def test_ssl_converter_matches_jax_bit_for_bit(kind):
    """The port's SSL converters (utils/torch_convert_ssl) against the JAX
    package's on reference-shaped state dicts with random values: the same
    tree (params, and the ECAPA BatchNorm statistics), bit for bit, and the
    same state dict through params_from_jax; the tree matches what the JAX
    module initializes (names and shapes)."""
    from unitspeech_tpu.models.speaker import SpeakerEmbedder
    from unitspeech_tpu.models.ssl.hubert import HubertConfig, HubertModel
    from unitspeech_tpu.models.ssl.wavlm import WavLMConfig, WavLMModel
    from unitspeech_tpu.utils import torch_convert_ssl as jssl
    from unitspeech_tpu_torch.utils import torch_convert_ssl as tssl

    sd, convert = _ssl_ref(kind, 30)
    npsd = {k: v.numpy() for k, v in sd.items()}
    want, got = convert(jssl, npsd), convert(tssl, npsd)
    same = params_from_jax(want), params_from_jax(got)
    assert list(same[1]) == list(same[0])
    assert all(torch.equal(same[1][k], same[0][k]) for k in same[0])
    w = WavLMConfig(**SSL_SMALL, num_buckets=16, max_distance=64)
    model = {"hubert": HubertModel(HubertConfig(**SSL_SMALL)), "wavlm": WavLMModel(w),
             "speaker-embedder": SpeakerEmbedder(w, channels=16, emb_dim=8)}[kind]
    import jax

    target = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 4000), np.float32))
    for col in target:
        jconv.assert_tree_match(got[col], jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, x.dtype), target[col]))


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations", "folded"])
def test_pos_conv_weight_norm_namings_match_jax(naming):
    """The positional conv's weight norm (dim 2) in the legacy and the
    parametrize names, or already folded: the port's conversion equal to
    JAX's."""
    from unitspeech_tpu.utils import torch_convert_ssl as jssl
    from unitspeech_tpu_torch.utils import torch_convert_ssl as tssl

    sd, _ = _ssl_ref("hubert", 31)
    sd = {k: v.numpy() for k, v in sd.items()}
    g, v = sd.pop("encoder.pos_conv.0.weight_g"), sd.pop("encoder.pos_conv.0.weight_v")
    if naming == "weight_g":
        sd.update({"encoder.pos_conv.0.weight_g": g, "encoder.pos_conv.0.weight_v": v})
    elif naming == "parametrizations":
        sd.update({"encoder.pos_conv.0.parametrizations.weight.original0": g,
                   "encoder.pos_conv.0.parametrizations.weight.original1": v})
    else:
        sd["encoder.pos_conv.0.weight"] = jssl.fold_weight_norm_dim(g, v, dim=2)
    want, got = jssl.convert_hubert(sd, 2), tssl.convert_hubert(sd, 2)
    np.testing.assert_array_equal(got["params"]["encoder"]["pos_conv"]["kernel"],
                                  want["params"]["encoder"]["pos_conv"]["kernel"])


@pytest.mark.parametrize("kind", ["hubert", "wavlm", "speaker-embedder"])
def test_cli_convert_ssl_kinds(tmp_path, kind):
    """`cli convert hubert / wavlm / speaker-embedder` on the reference's
    files at the test configurations (hubert-test, wavlm_test): the port's
    module file, equal to params_from_jax of the JAX converter's tree."""
    from unitspeech_tpu.utils import torch_convert_ssl as jssl
    from unitspeech_tpu_torch.tools import ssl_reference

    cfg = config_from_dict(SSL_CFG)
    if kind == "hubert":
        sd = ssl_reference.hubert_sd(cfg, 32)
        tree = lambda s: jssl.convert_ssl_encoder(s, 3, "group_norm", 3)  # noqa: E731
    else:
        sd = ssl_reference.speaker_encoder_sd(cfg, 33)
        if kind == "wavlm":
            sd = {k.removeprefix("feature_extract.model."): v for k, v in sd.items()
                  if k.startswith("feature_extract.model.")}

        def tree(s):
            enc = jssl.convert_ssl_encoder(s, 2, "layer_norm", 3, gru_rel_pos=True,
                                           relative_position_embedding=True,
                                           prefix="" if kind == "wavlm"
                                           else "feature_extract.model.")
            if kind == "wavlm":
                return enc
            ecapa = jssl.convert_ecapa(s)
            return {"params": {"wavlm": enc["params"], "ecapa": ecapa["params"]},
                    "batch_stats": {"ecapa": ecapa["batch_stats"]}}

    (tmp_path / "cfg.json").write_text(json.dumps(SSL_CFG))
    torch.save({"model": sd}, tmp_path / "src.pt")
    assert cli.main(["convert", kind, str(tmp_path / "src.pt"), str(tmp_path / "out.pt"),
                     "--config", str(tmp_path / "cfg.json")]) == 0
    out = torch.load(tmp_path / "out.pt", weights_only=True)
    assert out["config"]["unit_extractor"]["dense_model_name"] == "hubert-test"
    got = out[kind.replace("-", "_")]
    want = params_from_jax(tree({k: v.numpy() for k, v in sd.items()}))
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("kind", ["hubert", "wavlm"])
def test_ssl_loaders_unpickle_only_reference_files(tmp_path, monkeypatch, kind):
    """load_hubert_params / load_wavlm_params read the port's module file
    tensors-only; a reference file whose "args" entry is a Python object
    (as fairseq and s3prl save it) is unpickled in full after the safe load
    refuses it, and gives the same parameters."""
    import argparse

    from unitspeech_tpu_torch.models.ssl.hubert import hubert_test_config
    from unitspeech_tpu_torch.models.ssl.wavlm import wavlm_test_config
    from unitspeech_tpu_torch.tools import ssl_reference
    from unitspeech_tpu_torch.utils import artifacts

    cfg = config_from_dict(SSL_CFG)
    if kind == "hubert":
        sd, mcfg, load = (ssl_reference.hubert_sd(cfg, 34), hubert_test_config(),
                          artifacts.load_hubert_params)
    else:
        sd = {k.removeprefix("feature_extract.model."): v
              for k, v in ssl_reference.speaker_encoder_sd(cfg, 35).items()
              if k.startswith("feature_extract.model.")}
        mcfg, load = wavlm_test_config(), artifacts.load_wavlm_params
    torch.save({"args": argparse.Namespace(layers=3), "model": sd}, tmp_path / "ref.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(SSL_CFG))
    assert cli.main(["convert", kind, str(tmp_path / "ref.pt"), str(tmp_path / "port.pt"),
                     "--config", str(tmp_path / "cfg.json")]) == 0
    calls, real = [], torch.load

    def spy(*a, **kw):
        calls.append(kw.get("weights_only"))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "load", spy)
    port = load(str(tmp_path / "port.pt"), mcfg)
    assert calls == [True]
    ref = load(str(tmp_path / "ref.pt"), mcfg)
    assert calls == [True, True, False]
    assert list(port) == list(ref) and all(torch.equal(port[k], ref[k]) for k in ref)


def test_cli_convert_kmeans(tmp_path, monkeypatch):
    """`cli convert kmeans` reads sklearn's joblib file (any object with
    cluster_centers_) into a centroids .npz, as JAX's converter; without
    joblib / sklearn it exits naming the .npz route."""
    import sys
    import types

    import joblib

    from unitspeech_tpu.utils import torch_convert_ssl as jssl

    cent = np.random.default_rng(34).standard_normal((40, 16))
    joblib.dump(types.SimpleNamespace(cluster_centers_=cent), tmp_path / "km.bin")
    assert cli.main(["convert", "kmeans", str(tmp_path / "km.bin"), str(tmp_path / "km.npz")]) == 0
    with np.load(tmp_path / "km.npz") as z:
        got = z["centroids"]
    want = jssl.convert_sklearn_kmeans(str(tmp_path / "km.bin"))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(SystemExit, match=r"centroids \.npz"):
        cli.main(["convert", "kmeans", str(tmp_path / "km.bin"), str(tmp_path / "k2.npz")])


def _tiny_reference_files(tmp_path):
    """Reference-format .pt files of the four served modules at
    tests/test_torch_port_tts.py's TINY widths, a speaker embedding and the
    config overlay."""
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the IPA symbol table
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    te, dp, dec, voc = (cfg[k] for k in ("text_encoder", "duration_predictor", "decoder",
                                         "vocoder"))
    files = {
        "decoder": {"model": ref_decoder(11, dec["n_feats"], dec["dim"], tuple(dec["dim_mults"]),
                                         dec["groups"], dec["spk_emb_dim"]),
                    "mel_min": np.full((16, 1), -11.0, np.float32),
                    "mel_max": np.full((16, 1), 2.0, np.float32)},
        "text-encoder": {"model": ref_encoder(12, te["n_vocab"], te["n_feats"], te["n_channels"],
                                              te["filter_channels"], te["n_layers"],
                                              te["n_heads"])},
        "duration-predictor": ref_duration_predictor(13, dp["in_channels"],
                                                     dp["filter_channels"], dp["spk_emb_dim"]),
        "vocoder": {"generator": ref_bigvgan(14, voc["num_mels"], voc["upsample_rates"],
                                             voc["upsample_kernel_sizes"],
                                             voc["upsample_initial_channel"],
                                             voc["resblock_kernel_sizes"],
                                             voc["resblock_dilation_sizes"])},
    }
    args = []
    for flag, obj in files.items():
        obj = {k: (_torch_sd(v) if isinstance(v, dict) else torch.from_numpy(v))
               for k, v in obj.items()}
        torch.save(obj, tmp_path / f"{flag}.pt")
        args += [f"--{flag}", str(tmp_path / f"{flag}.pt")]
    np.save(tmp_path / "spk.npy", np.random.default_rng(15).standard_normal(8).astype(
        np.float32) * 3.0)
    return args + ["--spk-emb", str(tmp_path / "spk.npy"), "--config",
                   str(tmp_path / "tiny.json")]


def test_cli_inference_serves_reference_files(tmp_path):
    """`cli inference` with --decoder/--text-encoder/--duration-predictor/
    --vocoder (reference .pt files) and --spk-emb, no --checkpoint, at tiny
    widths on the CPU (bf16 kernel path, their plain versions): the same
    waveform as a port checkpoint holding the converted weights, and each
    flag overrides its module of --checkpoint."""
    flags = _tiny_reference_files(tmp_path)
    common = ["--ipa", "--text", "həloʊ wɜːld", "--device", "cpu", "--diffusion-steps", "2",
              "--no-sv56"]
    stats = cli.main_inference(common + flags + ["--output", str(tmp_path / "a.wav")])
    assert stats["frames"] > 0

    # the same weights as a port checkpoint: converted, then served
    cfg = config_from_dict(json.loads((tmp_path / "tiny.json").read_text()))
    bundle = artifacts.load_decoder_bundle(str(tmp_path / "decoder.pt"), cfg.decoder)
    spk = torch.from_numpy(np.load(tmp_path / "spk.npy"))
    ckpt = {"decoder": bundle.state_dict,
            "text_encoder": artifacts.load_encoder_params(str(tmp_path / "text-encoder.pt"),
                                                          cfg.text_encoder),
            "duration_predictor": artifacts.load_duration_predictor_params(
                str(tmp_path / "duration-predictor.pt")),
            "vocoder": artifacts.load_vocoder_params(str(tmp_path / "vocoder.pt"), cfg.vocoder),
            "spk_emb": spk, "mel_min": bundle.mel_min, "mel_max": bundle.mel_max,
            "config": dataclasses.asdict(cfg)}
    torch.save(ckpt, tmp_path / "ckpt.pt")
    cli.main_inference(common + ["--checkpoint", str(tmp_path / "ckpt.pt"),
                                 "--output", str(tmp_path / "b.wav")])
    from unitspeech_tpu_torch.utils.audio import load_wav

    a, b = load_wav(str(tmp_path / "a.wav"))[0], load_wav(str(tmp_path / "b.wav"))[0]
    assert a.shape == b.shape and np.any(a)
    np.testing.assert_array_equal(a, b)

    # a checkpoint with another decoder: the --decoder flag overrides it
    other = dict(ckpt, decoder={k: v * 0.5 for k, v in bundle.state_dict.items()})
    torch.save(other, tmp_path / "other.pt")
    cli.main_inference(common + ["--checkpoint", str(tmp_path / "other.pt"), "--decoder",
                                 str(tmp_path / "decoder.pt"), "--output",
                                 str(tmp_path / "c.wav")])
    np.testing.assert_array_equal(load_wav(str(tmp_path / "c.wav"))[0], a)


def test_cli_inference_without_checkpoint_needs_every_module(tmp_path):
    flags = _tiny_reference_files(tmp_path)
    i = flags.index("--vocoder")
    with pytest.raises(SystemExit, match="--vocoder"):
        cli.main_inference(["--ipa", "--text", "hə", "--device", "cpu",
                            *flags[:i], *flags[i + 2:]])
