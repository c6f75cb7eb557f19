"""Convert reference PyTorch checkpoints (.pt) into the port's parameter
layout (counterpart of unitspeech_tpu/utils/torch_convert.py, kept here as
the port's own numpy-only copy).

The converters return a flax-layout tree of numpy arrays ({"params":
{...}}), which utils/params.params_from_jax turns into a port state dict
with no further transposes (the port keeps flax's layouts, models/layers.py).

Covers the four checkpoint families of the reference (its README.md:53-100):
  * text/unit/contentvec encoder  (Encoder, encoder.py:253-309)
  * duration predictor            (duration_predictor.py:24-63)
  * diffusion decoder             (UnitSpeech, unitspeech.py:220-233)
  * BigVGAN generator             (vocoder/models.py:121-201) with
    weight-norm folding (equivalent to remove_weight_norm, models.py:193-201)

Layout rules:
  Linear (out,in)            -> Dense kernel (in,out)            [transpose]
  Conv1d (out,in,k)          -> NTC conv kernel (k,in,out)
  Conv2d (out,in,kh,kw)      -> NHWC conv kernel (kh,kw,in,out)
  ConvTranspose1d (in,out,k) -> flax ConvTranspose (k,in,out)
  ConvTranspose2d (in,out,kh,kw) -> (kh,kw,in,out)
  Embedding                  -> unchanged
  weight-norm (g, v)         -> w = v * g / ||v||  (norm over non-out dims)

The U-Net's kernels also swap their two spatial axes (conv2d_kernel_tf):
the reference runs on (B, C, feats, time), the estimator on
(B, time, feats, C).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


# ---------------------------------------------------------------------------
# layout primitives
# ---------------------------------------------------------------------------


def linear_kernel(w) -> np.ndarray:
    return np.asarray(w).T


def conv1d_kernel(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 1, 0)


def conv2d_kernel(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)


def conv2d_kernel_tf(w) -> np.ndarray:
    """torch (out, in, kF, kT) -> flax (kT, kF, in, out), swapping the two
    spatial axes: the reference U-Net runs on (B, C, feats, time) while our
    estimator is (B, time, feats, C) (unitspeech.py:171 stacks mel-channels
    as H and frames as W; models/unet.py puts time first)."""
    return np.asarray(w).transpose(3, 2, 1, 0)


def convtranspose1d_kernel(w) -> np.ndarray:
    """torch (in,out,k) -> flax (k,in,out), spatially flipped: flax's
    ConvTranspose (transpose_kernel=False) correlates where torch convolves."""
    w = np.asarray(w)
    return w[:, :, ::-1].transpose(2, 0, 1).copy()


def convtranspose2d_kernel(w) -> np.ndarray:
    w = np.asarray(w)
    return w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy()


def convtranspose2d_kernel_tf(w) -> np.ndarray:
    """torch (in, out, kF, kT) -> flax (kT, kF, in, out) with spatial flip,
    swapping the spatial axes for the time-major estimator layout (see
    conv2d_kernel_tf)."""
    w = np.asarray(w)
    return w[:, :, ::-1, ::-1].transpose(3, 2, 0, 1).copy()


def dense_from_conv1x1(w) -> np.ndarray:
    """Conv kernel-size-1 weight (out,in,1[,1]) -> Dense kernel (in,out)."""
    w = np.asarray(w)
    return w.reshape(w.shape[0], w.shape[1]).T


def fold_weight_norm(g, v) -> np.ndarray:
    """weight_norm(dim=0): w = v * g / ||v|| with the norm over all non-output
    dims, per output channel."""
    v = np.asarray(v, np.float64)
    g = np.asarray(g, np.float64)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return (v * (g.reshape(norm.shape) / norm)).astype(np.float32)


def load_torch_state_dict(path: str, key: str | None = None) -> Dict[str, np.ndarray]:
    """Read a .pt file to {name: np.ndarray}. `key` selects a sub-dict (the
    reference nests under 'model' or 'generator', e.g. util.py:178,186)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        obj = obj[key]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _weight_normed(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """Resolve a possibly weight-normed conv weight under either the legacy
    (weight_g/weight_v) or parametrize (parametrizations.weight.original0/1)
    naming; falls back to a plain .weight."""
    if f"{prefix}.weight_v" in sd:
        return fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    if f"{prefix}.parametrizations.weight.original1" in sd:
        return fold_weight_norm(
            sd[f"{prefix}.parametrizations.weight.original0"],
            sd[f"{prefix}.parametrizations.weight.original1"],
        )
    return sd[f"{prefix}.weight"]


# ---------------------------------------------------------------------------
# module converters — each returns {"params": {...}} ready for .apply
# ---------------------------------------------------------------------------


def convert_encoder(sd: Dict[str, np.ndarray], n_layers: int = 6,
                    prenet_layers: int = 3, contentvec: bool = False) -> Dict:
    p: Dict[str, Any] = {}
    if contentvec:
        p["emb"] = {"kernel": linear_kernel(sd["emb.weight"])}
    else:
        p["emb"] = {"embedding": np.asarray(sd["emb.weight"])}

    prenet: Dict[str, Any] = {}
    for i in range(prenet_layers):
        prenet[f"conv_{i}"] = {
            "kernel": conv1d_kernel(sd[f"prenet.conv_layers.{i}.weight"]),
            "bias": np.asarray(sd[f"prenet.conv_layers.{i}.bias"]),
        }
        prenet[f"norm_{i}"] = {
            "gamma": np.asarray(sd[f"prenet.norm_layers.{i}.gamma"]),
            "beta": np.asarray(sd[f"prenet.norm_layers.{i}.beta"]),
        }
    prenet["proj"] = {
        "kernel": dense_from_conv1x1(sd["prenet.proj.weight"]),
        "bias": np.asarray(sd["prenet.proj.bias"]),
    }
    p["prenet"] = prenet

    enc: Dict[str, Any] = {}
    for i in range(n_layers):
        attn: Dict[str, Any] = {}
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            attn[name] = {
                "kernel": dense_from_conv1x1(sd[f"encoder.attn_layers.{i}.{name}.weight"]),
                "bias": np.asarray(sd[f"encoder.attn_layers.{i}.{name}.bias"]),
            }
        attn["emb_rel_k"] = np.asarray(sd[f"encoder.attn_layers.{i}.emb_rel_k"])[0]
        attn["emb_rel_v"] = np.asarray(sd[f"encoder.attn_layers.{i}.emb_rel_v"])[0]
        enc[f"attn_{i}"] = attn
        enc[f"norm1_{i}"] = {
            "gamma": np.asarray(sd[f"encoder.norm_layers_1.{i}.gamma"]),
            "beta": np.asarray(sd[f"encoder.norm_layers_1.{i}.beta"]),
        }
        enc[f"ffn_{i}"] = {
            "conv_1": {
                "kernel": conv1d_kernel(sd[f"encoder.ffn_layers.{i}.conv_1.weight"]),
                "bias": np.asarray(sd[f"encoder.ffn_layers.{i}.conv_1.bias"]),
            },
            "conv_2": {
                "kernel": conv1d_kernel(sd[f"encoder.ffn_layers.{i}.conv_2.weight"]),
                "bias": np.asarray(sd[f"encoder.ffn_layers.{i}.conv_2.bias"]),
            },
        }
        enc[f"norm2_{i}"] = {
            "gamma": np.asarray(sd[f"encoder.norm_layers_2.{i}.gamma"]),
            "beta": np.asarray(sd[f"encoder.norm_layers_2.{i}.beta"]),
        }
    p["encoder"] = enc
    p["proj_m"] = {
        "kernel": dense_from_conv1x1(sd["proj_m.weight"]),
        "bias": np.asarray(sd["proj_m.bias"]),
    }
    return {"params": p}


def convert_duration_predictor(sd: Dict[str, np.ndarray]) -> Dict:
    return {
        "params": {
            "conv_1": {
                "kernel": conv1d_kernel(sd["conv_1.weight"]),
                "bias": np.asarray(sd["conv_1.bias"]),
            },
            "norm_1": {
                "scale": np.asarray(sd["norm_1.gamma"]),
                "bias": np.asarray(sd["norm_1.beta"]),
            },
            "conv_2": {
                "kernel": conv1d_kernel(sd["conv_2.weight"]),
                "bias": np.asarray(sd["conv_2.bias"]),
            },
            "norm_2": {
                "scale": np.asarray(sd["norm_2.gamma"]),
                "bias": np.asarray(sd["norm_2.beta"]),
            },
            "proj": {
                "kernel": dense_from_conv1x1(sd["proj.weight"]),
                "bias": np.asarray(sd["proj.bias"]),
            },
        }
    }


def _convert_resnet_block(sd, prefix: str, has_res_conv: bool) -> Dict:
    out: Dict[str, Any] = {
        "mlp": {
            "kernel": linear_kernel(sd[f"{prefix}.mlp.1.weight"]),
            "bias": np.asarray(sd[f"{prefix}.mlp.1.bias"]),
        },
    }
    for bn in ("block1", "block2"):
        out[bn] = {
            "conv": {
                "kernel": conv2d_kernel_tf(sd[f"{prefix}.{bn}.block.0.weight"]),
                "bias": np.asarray(sd[f"{prefix}.{bn}.block.0.bias"]),
            },
            "norm": {
                "scale": np.asarray(sd[f"{prefix}.{bn}.block.1.weight"]),
                "bias": np.asarray(sd[f"{prefix}.{bn}.block.1.bias"]),
            },
        }
    if has_res_conv:
        out["res_conv"] = {
            "kernel": conv2d_kernel_tf(sd[f"{prefix}.res_conv.weight"]),
            "bias": np.asarray(sd[f"{prefix}.res_conv.bias"]),
        }
    return out


def _convert_attn(sd, prefix: str) -> Dict:
    return {
        "g": np.asarray(sd[f"{prefix}.fn.g"]),
        "fn": {
            "to_qkv": {"kernel": dense_from_conv1x1(sd[f"{prefix}.fn.fn.to_qkv.weight"])},
            "to_out": {
                "kernel": dense_from_conv1x1(sd[f"{prefix}.fn.fn.to_out.weight"]),
                "bias": np.asarray(sd[f"{prefix}.fn.fn.to_out.bias"]),
            },
        },
    }


def convert_decoder(sd: Dict[str, np.ndarray], dim: int = 128,
                    dim_mults=(1, 2, 4, 8)) -> Dict:
    """UnitSpeech decoder checkpoint ('model' sub-dict of pretrained_decoder.pt)
    -> flax params for models.diffusion.UnitSpeech."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    p: Dict[str, Any] = {
        "text_uncon": np.asarray(sd["text_uncon"]).reshape(-1),
        "spk_uncon": np.asarray(sd["spk_uncon"]).reshape(-1),
    }
    est: Dict[str, Any] = {
        "mlp_0": {
            "kernel": linear_kernel(sd["estimator.mlp.0.weight"]),
            "bias": np.asarray(sd["estimator.mlp.0.bias"]),
        },
        "mlp_1": {
            "kernel": linear_kernel(sd["estimator.mlp.2.weight"]),
            "bias": np.asarray(sd["estimator.mlp.2.bias"]),
        },
    }
    dims = [2] + [dim * m for m in dim_mults]
    num_res = len(dim_mults)
    for i in range(num_res):
        dim_in, dim_out = dims[i], dims[i + 1]
        est[f"down_{i}_res1"] = _convert_resnet_block(
            sd, f"estimator.downs.{i}.0", dim_in != dim_out
        )
        est[f"down_{i}_res2"] = _convert_resnet_block(sd, f"estimator.downs.{i}.1", False)
        est[f"down_{i}_attn"] = _convert_attn(sd, f"estimator.downs.{i}.2")
        if i < num_res - 1:
            est[f"down_{i}_down"] = {
                "conv": {
                    "kernel": conv2d_kernel_tf(sd[f"estimator.downs.{i}.3.conv.weight"]),
                    "bias": np.asarray(sd[f"estimator.downs.{i}.3.conv.bias"]),
                }
            }
    est["mid_res1"] = _convert_resnet_block(sd, "estimator.mid_block1", False)
    est["mid_attn"] = _convert_attn(sd, "estimator.mid_attn")
    est["mid_res2"] = _convert_resnet_block(sd, "estimator.mid_block2", False)
    for j in range(num_res - 1):
        ind = num_res - 2 - j  # reference ups[j] == our up_{ind}
        est[f"up_{ind}_res1"] = _convert_resnet_block(sd, f"estimator.ups.{j}.0", True)
        est[f"up_{ind}_res2"] = _convert_resnet_block(sd, f"estimator.ups.{j}.1", False)
        est[f"up_{ind}_attn"] = _convert_attn(sd, f"estimator.ups.{j}.2")
        est[f"up_{ind}_up"] = {
            "conv": {
                "kernel": convtranspose2d_kernel_tf(sd[f"estimator.ups.{j}.3.conv.weight"]),
                "bias": np.asarray(sd[f"estimator.ups.{j}.3.conv.bias"]),
            }
        }
    est["final_block"] = {
        "conv": {
            "kernel": conv2d_kernel_tf(sd["estimator.final_block.block.0.weight"]),
            "bias": np.asarray(sd["estimator.final_block.block.0.bias"]),
        },
        "norm": {
            "scale": np.asarray(sd["estimator.final_block.block.1.weight"]),
            "bias": np.asarray(sd["estimator.final_block.block.1.bias"]),
        },
    }
    est["final_conv"] = {
        "kernel": conv2d_kernel_tf(sd["estimator.final_conv.weight"]),
        "bias": np.asarray(sd["estimator.final_conv.bias"]),
    }
    p["estimator"] = est
    return {"params": p}


def convert_bigvgan(sd: Dict[str, np.ndarray], num_upsamples: int = 4,
                    num_kernels: int = 3, convs_per_block: int = 3) -> Dict:
    """BigVGAN 'generator' state dict -> flax params (weight norm folded)."""
    p: Dict[str, Any] = {
        "conv_pre": {
            "kernel": conv1d_kernel(_weight_normed(sd, "conv_pre")),
            "bias": np.asarray(sd["conv_pre.bias"]),
        },
        "conv_post": {
            "kernel": conv1d_kernel(_weight_normed(sd, "conv_post")),
            "bias": np.asarray(sd["conv_post.bias"]),
        },
    }
    for i in range(num_upsamples):
        p[f"up_{i}"] = {
            "kernel": convtranspose1d_kernel(_weight_normed(sd, f"ups.{i}.0")),
            "bias": np.asarray(sd[f"ups.{i}.0.bias"]),
        }
        for j in range(num_kernels):
            r = i * num_kernels + j
            blk: Dict[str, Any] = {}
            for n in range(convs_per_block):
                blk[f"conv1_{n}"] = {
                    "kernel": conv1d_kernel(_weight_normed(sd, f"resblocks.{r}.convs1.{n}")),
                    "bias": np.asarray(sd[f"resblocks.{r}.convs1.{n}.bias"]),
                }
                blk[f"conv2_{n}"] = {
                    "kernel": conv1d_kernel(_weight_normed(sd, f"resblocks.{r}.convs2.{n}")),
                    "bias": np.asarray(sd[f"resblocks.{r}.convs2.{n}.bias"]),
                }
                for act_name, idx in ((f"act1_{n}", 2 * n), (f"act2_{n}", 2 * n + 1)):
                    act = {
                        "alpha": np.asarray(
                            sd[f"resblocks.{r}.activations.{idx}.act.alpha"]
                        )
                    }
                    beta_key = f"resblocks.{r}.activations.{idx}.act.beta"
                    if beta_key in sd:
                        act["beta"] = np.asarray(sd[beta_key])
                    blk[act_name] = {"act": act}
            p[f"resblock_{i}_{j}"] = blk
    act_post = {"alpha": np.asarray(sd["activation_post.act.alpha"])}
    if "activation_post.act.beta" in sd:
        act_post["beta"] = np.asarray(sd["activation_post.act.beta"])
    p["act_post"] = act_post
    return {"params": p}


def assert_tree_match(converted, target, path=""):
    """Structural check: every leaf in `target` exists in `converted` with the
    same shape (catches silent mapping gaps)."""
    if isinstance(target, dict):
        missing = set(target) - set(converted)
        extra = set(converted) - set(target)
        assert not missing, f"{path}: missing {sorted(missing)}"
        assert not extra, f"{path}: extra {sorted(extra)}"
        for k in target:
            assert_tree_match(converted[k], target[k], f"{path}/{k}")
    else:
        assert np.shape(converted) == np.shape(target), (
            f"{path}: {np.shape(converted)} != {np.shape(target)}"
        )
