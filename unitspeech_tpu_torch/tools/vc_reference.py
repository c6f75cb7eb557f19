"""Random voice-conversion checkpoints in the reference's file formats, made
from a seed at a configuration's widths (no published weights are in the
repository):

  * contentvec_encoder.pt: {"model": state dict} of the reference's
    Encoder with the contentvec input (encoder.py:253-309; `emb` a
    bias-free Linear(n_contentvec, n_channels));
  * contentvec.pt: an HF `transformers` HubertModel state dict at the top
    level, as lengyue233/content-vec-best ships it (with its final_proj and
    masked_spec_embed, which the encoder does not read), the positional
    conv's weight norm in one of its three forms.

The widths come from cfg.contentvec_encoder, and the HuBERT's from
models/ssl/contentvec.contentvec_config_for(n_contentvec): HuBERT-base at
the defaults. Each weight is scaled by its fan-in (tools/ssl_reference).
`cli convert contentvec-encoder` and `cli voice-conversion --contentvec`
read them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unitspeech_tpu_torch.tools.ssl_reference import Draw, ssl_encoder_sd

# fairseq HuBERT names -> HF transformers names, by prefix and in order
_HF_RENAMES = (
    (".self_attn_layer_norm.", ".layer_norm."),
    (".self_attn.", ".attention."),
    (".fc1.", ".feed_forward.intermediate_dense."),
    (".fc2.", ".feed_forward.output_dense."),
    ("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv."),
    ("post_extract_proj.", "feature_projection.projection."),
)
POS_CONV_FORMS = ("weight_g", "parametrizations", "folded")


def _hf_name(k: str) -> str:
    if k.startswith("feature_extractor.conv_layers."):
        i, rest = k[len("feature_extractor.conv_layers."):].split(".", 1)
        rest = rest.replace("0.", "conv.", 1) if rest.startswith("0.") else rest.replace(
            "2.", "layer_norm.", 1)
        return f"feature_extractor.conv_layers.{i}.{rest}"
    if k.startswith("layer_norm."):
        return "feature_projection." + k
    for a, b in _HF_RENAMES:
        k = k.replace(a, b)
    return k


def hf_hubert_sd(c, seed: int, pos_conv: str = "weight_g") -> dict:
    """A HuBERT (config c: HubertConfig) in HF names, with content-vec-best's
    final_proj (256 wide) and masked_spec_embed. pos_conv: "weight_g"
    (weight_g / weight_v), "parametrizations" (parametrizations.weight.
    original0 / 1) or "folded" (a plain weight)."""
    from unitspeech_tpu_torch.utils.torch_convert_ssl import fold_weight_norm_dim

    d = Draw(seed)
    ssl_encoder_sd(d, c)
    sd = {_hf_name(k): v for k, v in d.sd.items()}
    d.normal("masked_spec_embed", (c.embed_dim,), 0.5)
    d.linear("final_proj", 256, c.embed_dim)
    sd.update({k: d.sd[k] for k in ("masked_spec_embed", "final_proj.weight", "final_proj.bias")})
    pc = "encoder.pos_conv_embed.conv"
    g, v = sd.pop(f"{pc}.weight_g"), sd.pop(f"{pc}.weight_v")
    if pos_conv == "weight_g":
        sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"] = g, v
    elif pos_conv == "parametrizations":
        sd[f"{pc}.parametrizations.weight.original0"] = g
        sd[f"{pc}.parametrizations.weight.original1"] = v
    elif pos_conv == "folded":
        sd[f"{pc}.weight"] = torch.from_numpy(fold_weight_norm_dim(g.numpy(), v.numpy(), dim=2))
    else:
        raise ValueError(f"pos_conv {pos_conv!r}: one of {POS_CONV_FORMS}")
    return sd


def contentvec_encoder_sd(ecfg, seed: int) -> dict:
    """The reference Encoder's state dict with the contentvec input (ecfg:
    the EncoderConfig, n_contentvec > 0)."""
    d = Draw(seed)
    c, w, k = ecfg.n_channels, ecfg.window_size, ecfg.kernel_size
    d.normal("emb.weight", (c, ecfg.n_contentvec), ecfg.n_contentvec ** -0.5)
    for i in range(ecfg.prenet_layers):
        d.conv(f"prenet.conv_layers.{i}", c, c, ecfg.prenet_kernel_size)
        d.normal(f"prenet.norm_layers.{i}.gamma", (c,), 0.05, 1.0)
        d.normal(f"prenet.norm_layers.{i}.beta", (c,), 0.05)
    d.conv("prenet.proj", c, c, 1)
    for i in range(ecfg.n_layers):
        p = f"encoder.attn_layers.{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            d.conv(f"{p}.{name}", c, c, 1)
        for rel in ("emb_rel_k", "emb_rel_v"):
            d.normal(f"{p}.{rel}", (1, 2 * w + 1, c // ecfg.n_heads), (c // ecfg.n_heads) ** -0.5)
        for n in (1, 2):
            d.normal(f"encoder.norm_layers_{n}.{i}.gamma", (c,), 0.05, 1.0)
            d.normal(f"encoder.norm_layers_{n}.{i}.beta", (c,), 0.05)
        d.conv(f"encoder.ffn_layers.{i}.conv_1", ecfg.filter_channels, c, k)
        d.conv(f"encoder.ffn_layers.{i}.conv_2", c, ecfg.filter_channels, k)
    d.conv("proj_m", ecfg.n_feats, c, 1)
    return d.sd


def random_vc_reference(directory: str, cfg, seed: int = 0) -> dict:
    """Write contentvec_encoder.pt and contentvec.pt into `directory`;
    returns their paths by kind ("contentvec-encoder", "contentvec")."""
    from unitspeech_tpu_torch.models.ssl.contentvec import contentvec_config_for

    paths = {"contentvec-encoder": os.path.join(directory, "contentvec_encoder.pt"),
             "contentvec": os.path.join(directory, "contentvec.pt")}
    torch.save({"model": contentvec_encoder_sd(cfg.contentvec_encoder, seed)},
               paths["contentvec-encoder"])
    torch.save(hf_hubert_sd(contentvec_config_for(cfg.contentvec_encoder.n_contentvec),
                            seed + 1), paths["contentvec"])
    return paths


def random_source(path: str, cfg, seconds: float, seed: int = 0) -> str:
    """A source wav for conversion at cfg.data.sampling_rate, made from a
    seed: a voiced sound whose pitch wanders, plus a little noise."""
    from unitspeech_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(seed)
    sr = cfg.data.sampling_rate
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(180.0 + 60.0 * np.sin(2 * np.pi * 0.5 * t)) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 8)) + 0.02 * rng.standard_normal(len(t))
    write_wav(path, 0.8 * wav / np.abs(wav).max(), sr)
    return path
