"""Converters of the SSL checkpoints the reference reads, to flax-layout
trees of numpy arrays (the port's own numpy copy of
unitspeech_tpu/utils/torch_convert_ssl.py, whose num_conv_layers the
per-model converters also take; utils/params.params_from_jax turns a tree
into a port state dict):

  * fairseq HuBERT (mhubert-base-vp_en_es_fr, as textlesslib loads it);
  * WavLM-Large (as s3prl's UpstreamExpert loads it);
  * the UniSpeech ECAPA-TDNN speaker-verification head (speaker_encoder.pt
    'model');
  * sklearn k-means -> a centroid array (saved as .npz).

Names follow fairseq/unilm: feature_extractor.conv_layers.{i}.0 (conv),
.{i}.2 (GroupNorm, layer 0, group_norm mode) or .{i}.2.1 (LayerNorm,
layer_norm mode); encoder.pos_conv.0 with weight_norm dim=2;
encoder.layers.{i}.self_attn.{q,k,v,out}_proj / grep_linear / grep_a /
relative_attention_bias (layer 0 only).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from unitspeech_tpu_torch.utils.torch_convert import (
    conv1d_kernel,
    dense_from_conv1x1,
    linear_kernel,
)


def fold_weight_norm_dim(g, v, dim: int) -> np.ndarray:
    """weight_norm with arbitrary kept dim (fairseq pos_conv uses dim=2)."""
    v = np.asarray(v, np.float64)
    g = np.asarray(g, np.float64)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return (v * (np.asarray(g).reshape(norm.shape) / norm)).astype(np.float32)


def _ln(sd, prefix):
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _dense(sd, prefix):
    return {
        "kernel": linear_kernel(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def convert_ssl_encoder(
    sd: Dict[str, np.ndarray],
    num_layers: int,
    extractor_mode: str = "group_norm",
    num_conv_layers: int = 7,
    gru_rel_pos: bool = False,
    relative_position_embedding: bool = False,
    prefix: str = "",
) -> Dict:
    """Shared HuBERT/WavLM conversion -> flax params for HubertModel/WavLMModel."""
    if prefix:
        sd = {k.removeprefix(prefix): v for k, v in sd.items() if k.startswith(prefix)}
    p: Dict[str, Any] = {}

    fe: Dict[str, Any] = {}
    for i in range(num_conv_layers):
        conv = {"kernel": conv1d_kernel(sd[f"feature_extractor.conv_layers.{i}.0.weight"])}
        bkey = f"feature_extractor.conv_layers.{i}.0.bias"
        if bkey in sd:
            conv["bias"] = np.asarray(sd[bkey])
        elif extractor_mode == "layer_norm":
            conv["bias"] = np.zeros(conv["kernel"].shape[-1], np.float32)
        fe[f"conv_{i}"] = conv
        if extractor_mode == "group_norm" and i == 0:
            fe[f"norm_{i}"] = {
                "scale": np.asarray(sd["feature_extractor.conv_layers.0.2.weight"]),
                "bias": np.asarray(sd["feature_extractor.conv_layers.0.2.bias"]),
            }
        elif extractor_mode == "layer_norm":
            fe[f"norm_{i}"] = {
                "scale": np.asarray(sd[f"feature_extractor.conv_layers.{i}.2.1.weight"]),
                "bias": np.asarray(sd[f"feature_extractor.conv_layers.{i}.2.1.bias"]),
            }
    p["feature_extractor"] = fe
    p["layer_norm"] = _ln(sd, "layer_norm")
    if "post_extract_proj.weight" in sd:
        p["post_extract_proj"] = _dense(sd, "post_extract_proj")

    enc: Dict[str, Any] = {}
    if "encoder.pos_conv.0.weight_v" in sd:
        pos_w = fold_weight_norm_dim(
            sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"], dim=2
        )
    elif "encoder.pos_conv.0.parametrizations.weight.original1" in sd:
        pos_w = fold_weight_norm_dim(
            sd["encoder.pos_conv.0.parametrizations.weight.original0"],
            sd["encoder.pos_conv.0.parametrizations.weight.original1"],
            dim=2,
        )
    else:
        pos_w = np.asarray(sd["encoder.pos_conv.0.weight"])
    enc["pos_conv"] = {
        "kernel": conv1d_kernel(pos_w),
        "bias": np.asarray(sd["encoder.pos_conv.0.bias"]),
    }
    enc["layer_norm"] = _ln(sd, "encoder.layer_norm")
    for i in range(num_layers):
        lp = f"encoder.layers.{i}"
        attn: Dict[str, Any] = {
            "q_proj": _dense(sd, f"{lp}.self_attn.q_proj"),
            "k_proj": _dense(sd, f"{lp}.self_attn.k_proj"),
            "v_proj": _dense(sd, f"{lp}.self_attn.v_proj"),
            "out_proj": _dense(sd, f"{lp}.self_attn.out_proj"),
        }
        if gru_rel_pos:
            attn["grep_linear"] = _dense(sd, f"{lp}.self_attn.grep_linear")
            attn["grep_a"] = np.asarray(sd[f"{lp}.self_attn.grep_a"])
        if relative_position_embedding and i == 0:
            attn["rel_attn_embed"] = np.asarray(
                sd[f"{lp}.self_attn.relative_attention_bias.weight"]
            )
        enc[f"layer_{i}"] = {
            "self_attn": attn,
            "self_attn_layer_norm": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _dense(sd, f"{lp}.fc1"),
            "fc2": _dense(sd, f"{lp}.fc2"),
            "final_layer_norm": _ln(sd, f"{lp}.final_layer_norm"),
        }
    p["encoder"] = enc
    return {"params": p}


def convert_hubert(sd: Dict[str, np.ndarray], num_layers: int = 12,
                   num_conv_layers: int = 7) -> Dict:
    return convert_ssl_encoder(sd, num_layers, extractor_mode="group_norm",
                               num_conv_layers=num_conv_layers)


def convert_wavlm(sd: Dict[str, np.ndarray], num_layers: int = 24,
                  num_conv_layers: int = 7) -> Dict:
    return convert_ssl_encoder(
        sd, num_layers, extractor_mode="layer_norm", num_conv_layers=num_conv_layers,
        gru_rel_pos=True, relative_position_embedding=True,
    )


def _bn_params(sd, prefix):
    return (
        {
            "scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"]),
        },
        {
            "mean": np.asarray(sd[f"{prefix}.running_mean"]),
            "var": np.asarray(sd[f"{prefix}.running_var"]),
        },
    )


def convert_ecapa(sd: Dict[str, np.ndarray], res2_scale: int = 8) -> Dict:
    """UniSpeech ECAPA state dict (minus the feature_extract.* backbone) ->
    flax {params, batch_stats} for models.speaker.EcapaTdnn."""
    sd = {k: v for k, v in sd.items() if not k.startswith("feature_extract.")}
    params: Dict[str, Any] = {"feature_weight": np.asarray(sd["feature_weight"])}
    stats: Dict[str, Any] = {}

    def conv_relu_bn(src, dst_params, dst_stats):
        bn_p, bn_s = _bn_params(sd, f"{src}.bn")
        dst_params.update(
            conv={
                "kernel": conv1d_kernel(sd[f"{src}.conv.weight"]),
                "bias": np.asarray(sd[f"{src}.conv.bias"]),
            },
            bn=bn_p,
        )
        dst_stats["bn"] = bn_s

    p1: Dict[str, Any] = {}
    s1: Dict[str, Any] = {}
    conv_relu_bn("layer1", p1, s1)
    params["layer1"], stats["layer1"] = p1, s1

    for li, name in ((2, "layer2"), (3, "layer3"), (4, "layer4")):
        lp: Dict[str, Any] = {}
        ls: Dict[str, Any] = {}
        for sub_src, sub_dst in (("Conv1dReluBn1", "conv1"), ("Conv1dReluBn2", "conv2")):
            dp: Dict[str, Any] = {}
            ds: Dict[str, Any] = {}
            conv_relu_bn(f"{name}.{sub_src}", dp, ds)
            lp[sub_dst], ls[sub_dst] = dp, ds
        r2p: Dict[str, Any] = {}
        r2s: Dict[str, Any] = {}
        for i in range(res2_scale - 1):
            r2p[f"conv_{i}"] = {
                "kernel": conv1d_kernel(sd[f"{name}.Res2Conv1dReluBn.convs.{i}.weight"]),
                "bias": np.asarray(sd[f"{name}.Res2Conv1dReluBn.convs.{i}.bias"]),
            }
            bn_p, bn_s = _bn_params(sd, f"{name}.Res2Conv1dReluBn.bns.{i}")
            r2p[f"bn_{i}"] = bn_p
            r2s[f"bn_{i}"] = bn_s
        lp["res2"], ls["res2"] = r2p, r2s
        lp["se"] = {
            "linear1": _dense(sd, f"{name}.SE_Connect.linear1"),
            "linear2": _dense(sd, f"{name}.SE_Connect.linear2"),
        }
        params[name], stats[name] = lp, ls

    params["conv"] = {
        "kernel": dense_from_conv1x1(sd["conv.weight"]),
        "bias": np.asarray(sd["conv.bias"]),
    }
    params["pooling"] = {
        "linear1": {
            "kernel": dense_from_conv1x1(sd["pooling.linear1.weight"]),
            "bias": np.asarray(sd["pooling.linear1.bias"]),
        },
        "linear2": {
            "kernel": dense_from_conv1x1(sd["pooling.linear2.weight"]),
            "bias": np.asarray(sd["pooling.linear2.bias"]),
        },
    }
    bn_p, bn_s = _bn_params(sd, "bn")
    params["bn"], stats["bn"] = bn_p, bn_s
    params["linear"] = _dense(sd, "linear")
    return {"params": params, "batch_stats": stats}


def convert_speaker_embedder(sd: Dict[str, np.ndarray], num_layers: int = 24,
                             num_conv_layers: int = 7) -> Dict:
    """Full reference speaker_encoder.pt 'model' -> flax tree for
    models.speaker.SpeakerEmbedder (WavLM backbone nested under
    feature_extract.model.* per s3prl UpstreamExpert)."""
    wavlm = convert_ssl_encoder(
        sd, num_layers, extractor_mode="layer_norm", num_conv_layers=num_conv_layers,
        gru_rel_pos=True, relative_position_embedding=True,
        prefix="feature_extract.model.",
    )
    ecapa = convert_ecapa(sd)
    return {
        "params": {"wavlm": wavlm["params"], "ecapa": ecapa["params"]},
        "batch_stats": {"ecapa": ecapa["batch_stats"]},
    }


def convert_sklearn_kmeans(path: str) -> np.ndarray:
    """sklearn KMeans joblib checkpoint -> centroid array (K, D). Needs joblib
    and sklearn, imported only here; without them, convert the file where
    they are installed and pass the `.npz` (KMeansQuantizer.save)."""
    try:
        import joblib
        import sklearn  # noqa: F401  (unpickling the estimator needs it)
    except ImportError as e:
        raise SystemExit(f"{path}: reading a sklearn k-means checkpoint needs joblib and "
                         f"sklearn ({e}); convert it to a centroids .npz where they are "
                         "installed (`cli convert kmeans src dest.npz`) and pass that") from e

    km = joblib.load(path)
    return np.asarray(km.cluster_centers_, np.float32)
