"""ContentVec, the speaker-invariant content features of voice conversion
(counterpart of unitspeech_tpu/models/ssl/contentvec.py; the reference's HF
`HubertModelWithFinalProj`, scripts/voice_conversion.py:46-68, checkpoint
lengyue233/content-vec-best): a HuBERT-base encoder whose last hidden
state (768-d) conditions the contentvec encoder. It is the port's
HubertModel read at its last layer; this module adds the converter of the
HF `transformers` names and the extractor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from unitspeech_tpu_torch.models.ssl.hubert import (
    HubertConfig,
    HubertFeatureReader,
    HubertModel,
    hubert_test_config,
)
from unitspeech_tpu_torch.utils.params import params_from_jax
from unitspeech_tpu_torch.utils.torch_convert import conv1d_kernel, linear_kernel
from unitspeech_tpu_torch.utils.torch_convert_ssl import fold_weight_norm_dim


def contentvec_config() -> HubertConfig:
    """HuBERT-base with the group_norm extractor."""
    return HubertConfig()


def contentvec_config_for(n_contentvec: int) -> HubertConfig:
    """The contentvec HuBERT whose features a contentvec encoder of input
    width n_contentvec reads: HuBERT-base at 768 (the reference's), the
    test HuBERT (models/ssl/hubert.hubert_test_config) at its width 16."""
    table = {c.embed_dim: c for c in (contentvec_config(), hubert_test_config())}
    if n_contentvec not in table:
        raise KeyError(f"no contentvec HuBERT of width {n_contentvec}; known: {sorted(table)}")
    return table[n_contentvec]


def convert_hubert_hf(sd: Dict[str, np.ndarray], num_layers: int = 12,
                      num_conv_layers: int = 7) -> Dict:
    """An HF `transformers` HubertModel state dict (numpy) -> the flax
    tree of HubertModel ({"params": ...}; utils/params.params_from_jax makes
    the port's state dict). The HF names differ from fairseq's:
    feature_projection.*, encoder.pos_conv_embed.conv (weight norm over
    dim 2 as weight_g / weight_v or parametrizations.weight.original0 / 1,
    or a plain weight), encoder.layers.i.attention.*, feed_forward.
    {intermediate,output}_dense. Entries the encoder does not use (the
    final projection, the masked-spectrogram embedding) are skipped."""

    def ln(prefix):
        return {"scale": np.asarray(sd[f"{prefix}.weight"]),
                "bias": np.asarray(sd[f"{prefix}.bias"])}

    def dense(prefix):
        return {"kernel": linear_kernel(sd[f"{prefix}.weight"]),
                "bias": np.asarray(sd[f"{prefix}.bias"])}

    fe: Dict = {}
    for i in range(num_conv_layers):
        lp = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": conv1d_kernel(sd[f"{lp}.conv.weight"])}
        if f"{lp}.conv.bias" in sd:
            conv["bias"] = np.asarray(sd[f"{lp}.conv.bias"])
        fe[f"conv_{i}"] = conv
        if f"{lp}.layer_norm.weight" in sd:
            fe[f"norm_{i}"] = ln(f"{lp}.layer_norm")
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_v" in sd:
        pos_w = fold_weight_norm_dim(sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"], dim=2)
    elif f"{pc}.parametrizations.weight.original1" in sd:
        pos_w = fold_weight_norm_dim(sd[f"{pc}.parametrizations.weight.original0"],
                                     sd[f"{pc}.parametrizations.weight.original1"], dim=2)
    else:
        pos_w = np.asarray(sd[f"{pc}.weight"])
    enc: Dict = {"pos_conv": {"kernel": conv1d_kernel(pos_w), "bias": np.asarray(sd[f"{pc}.bias"])},
                 "layer_norm": ln("encoder.layer_norm")}
    for i in range(num_layers):
        lp = f"encoder.layers.{i}"
        enc[f"layer_{i}"] = {
            "self_attn": {p: dense(f"{lp}.attention.{p}")
                          for p in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": ln(f"{lp}.layer_norm"),
            "fc1": dense(f"{lp}.feed_forward.intermediate_dense"),
            "fc2": dense(f"{lp}.feed_forward.output_dense"),
            "final_layer_norm": ln(f"{lp}.final_layer_norm"),
        }
    return {"params": {"feature_extractor": fe, "layer_norm": ln("feature_projection.layer_norm"),
                       "post_extract_proj": dense("feature_projection.projection"),
                       "encoder": enc}}


class ContentvecExtractor:
    """wav (16 kHz) -> (T, 768) last-hidden-state features, through the
    bucketed HubertFeatureReader at the model's last layer."""

    def __init__(self, model: HubertModel, max_chunk: int = 1_600_000):
        self.reader = HubertFeatureReader(model, layer=model.config.num_layers,
                                          max_chunk=max_chunk)

    def __call__(self, wav) -> np.ndarray:
        return self.reader(wav)

    @classmethod
    def from_torch(cls, ckpt_path: str, device="cuda",
                   config: HubertConfig | None = None) -> "ContentvecExtractor":
        """From an HF-named checkpoint file (its state dict at the top level
        or under "model"), converted with convert_hubert_hf, the model f32 in
        eval mode on `device` (the card unless the caller asks for the
        CPU). config: the HuBERT's widths (default contentvec_config())."""
        config = config or contentvec_config()
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sd = {k: v.detach().cpu().numpy() for k, v in obj.get("model", obj).items()
              if isinstance(v, torch.Tensor)}
        with torch.device("meta"):
            model = HubertModel(config)
        model.load_state_dict(params_from_jax(convert_hubert_hf(
            sd, config.num_layers, len(config.conv_layers))), assign=True)
        return cls(model.to(device).eval().requires_grad_(False))
