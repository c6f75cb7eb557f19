"""Random checkpoints of the textlesslib extras in the reference's own
formats, drawn from a numpy seed, for runs without the published files:

  * Tacotron2: {'model_dict', 'hparams'} (vocoder.py:117-127), torch names
    (encoder.convolutions.<i>.0.conv.weight, the BiLSTM's *_reverse, the
    decoder's LSTM cells with bias_ih / bias_hh, ...);
  * WaveGlow: {'model_dict', 'hparams'} with weight-normed convs
    (weight_g / weight_v, so the fold runs), orthogonal 1x1 convs;
  * CPC: {'weights', 'config'} (cpc_feature_reader.py:69-86);
  * a code dict of `n_codes` unit codes, one a line.

The draws keep a random model's signals bounded at full width (fan-in
scaled weights, a small WaveGlow `end` layer so that the affine couplings
stay near 1, a Tacotron2 gate bias far below 0 so that the decoder runs
to max_decoder_steps unless a caller lowers it). write_extras writes all
four files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

from unitspeech_tpu_torch.models.ssl.cpc import ENCODER_CONVS, CpcConfig
from unitspeech_tpu_torch.models.tacotron2 import Tacotron2Config, random_tacotron2_params
from unitspeech_tpu_torch.models.waveglow import WaveGlowConfig

GATE_BIAS = -20.0  # sigmoid(gate) stays far below any threshold


def tacotron2_state_dict(tree: Dict, cfg: Tacotron2Config) -> Dict[str, torch.Tensor]:
    """A JAX Tacotron2 tree -> the reference's state dict, the inverse of
    convert_tacotron2: kernels back to (Cout, Cin, K), each folded LSTM
    bias as bias_ih with a zero bias_hh (so the fold gives it back bit for
    bit)."""
    sd: Dict[str, np.ndarray] = {"embedding.weight": tree["embedding"]["weight"]}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.transpose(p["kernel"], (2, 1, 0))
        if "bias" in p:
            sd[f"{prefix}.bias"] = p["bias"]

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = p["weight"]
        if "bias" in p:
            sd[f"{prefix}.bias"] = p["bias"]

    def bn(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{k}"] = v
        sd[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)

    def cell(prefix, p, suffix=""):
        sd[f"{prefix}.weight_ih{suffix}"] = p["weight_ih"]
        sd[f"{prefix}.weight_hh{suffix}"] = p["weight_hh"]
        sd[f"{prefix}.bias_ih{suffix}"] = p["bias"]
        sd[f"{prefix}.bias_hh{suffix}"] = np.zeros_like(p["bias"])

    enc = tree["encoder"]
    for i in range(cfg.encoder_n_convolutions):
        conv(f"encoder.convolutions.{i}.0.conv", enc[f"conv{i}"]["conv"])
        bn(f"encoder.convolutions.{i}.1", enc[f"conv{i}"]["bn"])
    cell("encoder.lstm", enc["lstm_fwd"], "_l0")
    cell("encoder.lstm", enc["lstm_bwd"], "_l0_reverse")
    if cfg.obs_dim > 0:
        sd["obs_embedding.weight"] = tree["obs_embedding"]["weight"]
    d, att = tree["decoder"], "decoder.attention_layer"
    lin("decoder.prenet.layers.0.linear_layer", d["prenet"]["layer0"])
    lin("decoder.prenet.layers.1.linear_layer", d["prenet"]["layer1"])
    cell("decoder.attention_rnn", d["attention_rnn"])
    lin(f"{att}.query_layer.linear_layer", d["attention"]["query"])
    lin(f"{att}.memory_layer.linear_layer", d["attention"]["memory"])
    lin(f"{att}.v.linear_layer", d["attention"]["v"])
    conv(f"{att}.location_layer.location_conv.conv", d["attention"]["location_conv"])
    lin(f"{att}.location_layer.location_dense.linear_layer", d["attention"]["location_dense"])
    cell("decoder.decoder_rnn", d["decoder_rnn"])
    lin("decoder.linear_projection.linear_layer", d["linear_projection"])
    lin("decoder.gate_layer.linear_layer", d["gate"])
    for i in range(cfg.postnet_n_convolutions):
        conv(f"postnet.convolutions.{i}.0.conv", tree["postnet"][f"conv{i}"]["conv"])
        bn(f"postnet.convolutions.{i}.1", tree["postnet"][f"conv{i}"]["bn"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def random_tacotron2_tree(cfg: Tacotron2Config, seed: int = 0) -> Dict:
    """A Tacotron2 tree at `cfg`'s widths: every weight normal with std
    1 / sqrt(fan in), biases 0.05 normal, BatchNorm near identity, the gate
    bias GATE_BIAS."""
    tree = random_tacotron2_params(cfg, seed=seed, scale=1.0)
    rng = np.random.default_rng(seed + 1)

    def rescale(node, name=""):
        for k, v in node.items():
            if isinstance(v, dict):
                rescale(v, k)
            elif k in ("running_mean", "running_var"):
                continue
            elif name == "bn":
                node[k] = (1.0 if k == "weight" else 0.0) + 0.05 * v
            elif k in ("weight", "weight_ih", "weight_hh", "kernel") and name != "embedding":
                fan_in = int(np.prod(v.shape[:-1])) if k == "kernel" else v.shape[1]
                node[k] = (v / np.sqrt(fan_in)).astype(np.float32)
            elif k == "bias":
                node[k] = (0.05 * v).astype(np.float32)

    rescale(tree)
    for c in list(tree["encoder"].values()) + list(tree["postnet"].values()):
        if "bn" in c:
            c["bn"]["running_mean"] = (0.05 * rng.standard_normal(c["bn"]["running_mean"].shape)
                                       ).astype(np.float32)
            c["bn"]["running_var"] = (1.0 + 0.1 * rng.random(c["bn"]["running_var"].shape)
                                      ).astype(np.float32)
    tree["decoder"]["gate"]["bias"] = np.full((1,), GATE_BIAS, np.float32)
    return tree


def _wn(rng, cout, cin, k, g=1.0):
    """A weight-normed conv's (weight_g, weight_v)."""
    return (np.full((cout, 1, 1), g, np.float32),
            rng.standard_normal((cout, cin, k)).astype(np.float32))


def random_waveglow_state_dict(cfg: WaveGlowConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference WaveGlow's state dict at `cfg`'s widths: weight-normed
    start / in_layers / res_skip_layers / cond_layer, plain upsample and
    end, orthogonal 1x1 convs (det > 0, as the reference initializes
    them)."""
    rng = np.random.default_rng(seed)
    nc, n_mel = cfg.n_channels, cfg.n_mel_channels
    overlap = max(cfg.upsample_kernel // cfg.upsample_stride, 1)
    sd: Dict[str, np.ndarray] = {
        "upsample.weight": (rng.standard_normal((n_mel, n_mel, cfg.upsample_kernel))
                            / np.sqrt(n_mel * overlap)).astype(np.float32),
        "upsample.bias": (0.05 * rng.standard_normal(n_mel)).astype(np.float32),
    }
    for k, c_k in enumerate(cfg.flow_channels()):
        n_half = c_k // 2
        q, _ = np.linalg.qr(rng.standard_normal((c_k, c_k)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        sd[f"convinv.{k}.conv.weight"] = q.astype(np.float32)[:, :, None]
        w = f"WN.{k}"
        layers = [("start", nc, n_half, 1, 1.0),
                  ("cond_layer", 2 * nc * cfg.n_layers, n_mel * cfg.n_group, 1, 1.0)]
        for i in range(cfg.n_layers):
            layers.append((f"in_layers.{i}", 2 * nc, nc, cfg.kernel_size, 1.0))
            layers.append((f"res_skip_layers.{i}", 2 * nc if i < cfg.n_layers - 1 else nc,
                           nc, 1, 0.5))
        for name, cout, cin, ks, g in layers:
            sd[f"{w}.{name}.weight_g"], sd[f"{w}.{name}.weight_v"] = _wn(rng, cout, cin, ks, g)
            sd[f"{w}.{name}.bias"] = (0.05 * rng.standard_normal(cout)).astype(np.float32)
        sd[f"{w}.end.weight"] = (0.05 * rng.standard_normal((2 * n_half, nc, 1))
                                 / np.sqrt(nc)).astype(np.float32)
        sd[f"{w}.end.bias"] = (0.01 * rng.standard_normal(2 * n_half)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def waveglow_hparams(cfg: WaveGlowConfig) -> dict:
    return {"n_mel_channels": cfg.n_mel_channels, "n_flows": cfg.n_flows,
            "n_group": cfg.n_group, "n_early_every": cfg.n_early_every,
            "n_early_size": cfg.n_early_size,
            "WN_config": {"n_layers": cfg.n_layers, "n_channels": cfg.n_channels,
                          "kernel_size": cfg.kernel_size}}


def random_cpc_state_dict(cfg: CpcConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference CPCModel's state dict at `cfg`'s widths."""
    rng = np.random.default_rng(seed)
    h, hg = cfg.hidden_encoder, cfg.hidden_gar
    sd: Dict[str, np.ndarray] = {}
    for i, (k, _, _) in enumerate(ENCODER_CONVS):
        cin = 1 if i == 0 else h
        sd[f"gEncoder.conv{i}.weight"] = (rng.standard_normal((h, cin, k))
                                          / np.sqrt(cin * k)).astype(np.float32)
        sd[f"gEncoder.conv{i}.bias"] = (0.05 * rng.standard_normal(h)).astype(np.float32)
        sd[f"gEncoder.batchNorm{i}.weight"] = (1.0 + 0.1 * rng.standard_normal((1, h, 1))
                                               ).astype(np.float32)
        sd[f"gEncoder.batchNorm{i}.bias"] = (0.1 * rng.standard_normal((1, h, 1))
                                             ).astype(np.float32)
    for lvl in range(cfg.n_levels_lstm):
        d_in = h if lvl == 0 else hg
        for name, shape in ((f"weight_ih_l{lvl}", (4 * hg, d_in)), (f"weight_hh_l{lvl}", (4 * hg, hg)),
                            (f"bias_ih_l{lvl}", (4 * hg,)), (f"bias_hh_l{lvl}", (4 * hg,))):
            sd[f"gAR.baseNet.{name}"] = rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(hg)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def write_extras(directory: str, taco_cfg: Tacotron2Config = Tacotron2Config(),
                 wg_cfg: WaveGlowConfig = WaveGlowConfig(), cpc_cfg: CpcConfig = CpcConfig(),
                 seed: int = 0, n_codes: int = 100) -> Dict[str, str]:
    """Write tacotron2.pt, waveglow.pt, cpc.pt and code_dict.txt under
    `directory` (the published widths by default); returns their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("tacotron", "tacotron2.pt"), ("waveglow", "waveglow.pt"), ("cpc", "cpc.pt"),
        ("code_dict", "code_dict.txt"))}
    hp = {**dataclasses.asdict(taco_cfg), "sampling_rate": 22050}
    torch.save({"model_dict": tacotron2_state_dict(random_tacotron2_tree(taco_cfg, seed), taco_cfg),
                "hparams": hp}, paths["tacotron"])
    torch.save({"model_dict": random_waveglow_state_dict(wg_cfg, seed + 10),
                "hparams": waveglow_hparams(wg_cfg)}, paths["waveglow"])
    torch.save({"weights": random_cpc_state_dict(cpc_cfg, seed + 20),
                "config": {"hiddenEncoder": cpc_cfg.hidden_encoder,
                           "hiddenGar": cpc_cfg.hidden_gar,
                           "nLevelsGRU": cpc_cfg.n_levels_lstm}}, paths["cpc"])
    with open(paths["code_dict"], "w") as f:
        f.write("".join(f"{c}\n" for c in range(n_codes)))
    return paths

