"""Random SSL checkpoints in the reference's file formats, made from a seed
at a configuration's widths (no published weights are in the repository):

  * speaker_encoder.pt: {"model": state dict} of the reference's speaker
    encoder, WavLM under feature_extract.model.* (s3prl's UpstreamExpert
    names) and the ECAPA-TDNN head;
  * hubert.pt: {"model": state dict} in fairseq's HuBERT names;
  * kmeans.npz: {"centroids": (vocab_size, embed_dim)}.

The widths come from cfg.spk_embedder (feat_type, channels, spk_emb_dim)
and cfg.unit_extractor (dense_model_name, vocab_size): WavLM-Large + ECAPA
and mHuBERT-base at the defaults. Each weight is scaled by its fan-in so
that the models' activations stay near unit size, as a trained model's
do. `cli convert speaker-embedder / hubert` and `cli finetune
--speaker-embedder / --hubert / --kmeans` read them.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Draw:
    """A reference-named state dict (`sd`) drawn entry by entry from a seed."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd: dict = {}

    def normal(self, name: str, shape, std: float, mean: float = 0.0):
        x = self.rng.standard_normal(shape, dtype=np.float32)
        self.sd[name] = torch.from_numpy(x * np.float32(std) + np.float32(mean))

    def linear(self, name: str, dout: int, din: int):
        self.normal(f"{name}.weight", (dout, din), din ** -0.5)
        self.normal(f"{name}.bias", (dout,), 0.02)

    def conv(self, name: str, dout: int, din: int, k: int, bias: bool = True):
        self.normal(f"{name}.weight", (dout, din, k), (din * k) ** -0.5)
        if bias:
            self.normal(f"{name}.bias", (dout,), 0.02)

    def norm(self, name: str, c: int, running: bool = False):
        self.normal(f"{name}.weight", (c,), 0.05, 1.0)
        self.normal(f"{name}.bias", (c,), 0.05)
        if running:
            self.normal(f"{name}.running_mean", (c,), 0.05)
            self.sd[f"{name}.running_var"] = torch.from_numpy(
                (1.0 + 0.2 * self.rng.random(c)).astype(np.float32))


def ssl_encoder_sd(d: Draw, c, prefix: str = "", relpos: bool = False,
                   gru_rel_pos: bool = False):
    """A WavLM / HuBERT (config c: WavLMConfig or HubertConfig) in
    fairseq/unilm names, under `prefix`."""
    layer_norm = c.extractor_mode == "layer_norm"
    cin = 1
    for i, (dim, k, _) in enumerate(c.conv_layers):
        d.conv(f"{prefix}feature_extractor.conv_layers.{i}.0", dim, cin, k,
               bias=c.conv_bias or layer_norm)
        if layer_norm:
            d.norm(f"{prefix}feature_extractor.conv_layers.{i}.2.1", dim)
        elif i == 0:
            d.norm(f"{prefix}feature_extractor.conv_layers.0.2", dim)
        cin = dim
    d.norm(f"{prefix}layer_norm", cin)
    e, heads = c.embed_dim, c.num_heads
    if cin != e:
        d.linear(f"{prefix}post_extract_proj", e, cin)
    # weight norm over the kernel axis (dim 2): each kernel position's
    # slice has norm g, sqrt(e / k) for an output of about unit size
    k, groups = c.conv_pos, c.conv_pos_groups
    d.normal(f"{prefix}encoder.pos_conv.0.weight_v", (e, e // groups, k), 1.0)
    d.normal(f"{prefix}encoder.pos_conv.0.weight_g", (1, 1, k), 0.05, (e / k) ** 0.5)
    d.normal(f"{prefix}encoder.pos_conv.0.bias", (e,), 0.02)
    d.norm(f"{prefix}encoder.layer_norm", e)
    for i in range(c.num_layers):
        lp = f"{prefix}encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            d.linear(f"{lp}.self_attn.{p}", e, e)
        if gru_rel_pos:
            d.linear(f"{lp}.self_attn.grep_linear", 8, e // heads)
            d.normal(f"{lp}.self_attn.grep_a", (1, heads, 1, 1), 0.05, 1.0)
        if relpos and i == 0:
            d.normal(f"{lp}.self_attn.relative_attention_bias.weight", (c.num_buckets, heads),
                     0.5)
        d.norm(f"{lp}.self_attn_layer_norm", e)
        d.linear(f"{lp}.fc1", c.ffn_dim, e)
        d.linear(f"{lp}.fc2", e, c.ffn_dim)
        d.norm(f"{lp}.final_layer_norm", e)


def ecapa_sd(d: Draw, feat_dim: int, channels: int, emb_dim: int, n_hidden: int,
             scale: int = 8):
    """The ECAPA-TDNN head in the reference's names (ecapa_tdnn.py)."""
    d.normal("feature_weight", (n_hidden,), 0.1)

    def conv_relu_bn(name, cin, cout, k):
        d.conv(f"{name}.conv", cout, cin, k)
        d.norm(f"{name}.bn", cout, running=True)

    conv_relu_bn("layer1", feat_dim, channels, 5)
    width = channels // scale
    for name in ("layer2", "layer3", "layer4"):
        conv_relu_bn(f"{name}.Conv1dReluBn1", channels, channels, 1)
        conv_relu_bn(f"{name}.Conv1dReluBn2", channels, channels, 1)
        for i in range(scale - 1):
            d.conv(f"{name}.Res2Conv1dReluBn.convs.{i}", width, width, 3)
            d.norm(f"{name}.Res2Conv1dReluBn.bns.{i}", width, running=True)
        d.linear(f"{name}.SE_Connect.linear1", 128, channels)
        d.linear(f"{name}.SE_Connect.linear2", channels, 128)
    d.conv("conv", 1536, 3 * channels, 1)
    d.conv("pooling.linear1", 128, 1536, 1)
    d.conv("pooling.linear2", 1536, 128, 1)
    d.norm("bn", 3072, running=True)
    d.linear("linear", emb_dim, 3072)


def speaker_encoder_sd(cfg, seed: int) -> dict:
    """The reference speaker encoder's 'model' state dict at cfg.spk_embedder."""
    from unitspeech_tpu_torch.models.speaker import WAVLM_CONFIGS

    s = cfg.spk_embedder
    w = WAVLM_CONFIGS[s.feat_type]()
    d = Draw(seed)
    ssl_encoder_sd(d, w, "feature_extract.model.", w.relative_position_embedding, w.gru_rel_pos)
    ecapa_sd(d, w.embed_dim, s.channels, s.spk_emb_dim, w.num_layers + 1)
    return d.sd


def hubert_sd(cfg, seed: int) -> dict:
    """fairseq HuBERT state dict at cfg.unit_extractor.dense_model_name."""
    from unitspeech_tpu_torch.models.ssl.hubert import hubert_config_by_name

    d = Draw(seed)
    ssl_encoder_sd(d, hubert_config_by_name(cfg.unit_extractor.dense_model_name))
    return d.sd


def random_ssl_reference(directory: str, cfg, seed: int = 0) -> dict:
    """Write speaker_encoder.pt, hubert.pt and kmeans.npz (centroids drawn
    N(0, 1), the scale of the LayerNorm-ed features) into `directory`;
    returns their paths by kind."""
    from unitspeech_tpu_torch.models.ssl.hubert import hubert_config_by_name

    paths = {k: os.path.join(directory, f) for k, f in (
        ("speaker-embedder", "speaker_encoder.pt"), ("hubert", "hubert.pt"),
        ("kmeans", "kmeans.npz"))}
    torch.save({"model": speaker_encoder_sd(cfg, seed)}, paths["speaker-embedder"])
    torch.save({"model": hubert_sd(cfg, seed + 1)}, paths["hubert"])
    dim = hubert_config_by_name(cfg.unit_extractor.dense_model_name).embed_dim
    rng = np.random.default_rng(seed + 2)
    np.savez(paths["kmeans"], centroids=rng.standard_normal(
        (cfg.unit_extractor.vocab_size, dim), dtype=np.float32))
    return paths
