"""Parameter bridge between the JAX package and the port, and random
full-width parameters.

The port keeps flax's tensor layout (Dense (in, out), conv (*k, in, out),
unflipped ConvTranspose) and names each parameter by its flax path joined
with '.', so a JAX parameter tree maps to a state dict with no transposes.
Reference `.pt` checkpoints go through unitspeech_tpu/utils/torch_convert
first, then params_from_jax.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from unitspeech_tpu_torch.config import MainConfig, config_from_dict  # noqa: F401


def params_from_jax(tree) -> dict:
    """flax parameter tree ({"params": {...}} or the inner dict) of numpy
    (or array-like) leaves -> state dict of f32/int torch tensors."""
    if isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v, copy=True))

    walk(tree, "")
    return out


def params_to_jax(state_dict) -> dict:
    """Inverse of params_from_jax: {"params": nested dict of numpy arrays}."""
    root: dict = {}
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return {"params": root}


def build_modules(cfg: MainConfig, device="cuda", dtype=torch.float32, use_kernels=True,
                  use_int8_deep=False, use_deep=False, use_resample=False,
                  use_i8pre_deep=False, with_vocoder=True) -> dict:
    """The slice's modules at `cfg`'s widths on `device` (the card unless the
    caller asks for the CPU), parameters uninitialized. use_kernels routes
    the estimator and the vocoder through the kernels; use_int8_deep runs
    the estimator's deep-stage convs in int8; use_deep, use_resample and
    use_i8pre_deep switch on the fused deep-stage configuration
    (models/unet.py)."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.models.vocoder import BigVGAN

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # never a quiet fall back to the CPU, where every kernel wrapper
        # takes its plain version
        raise RuntimeError(f"device {device} requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    with device:
        mods = {
            "text_encoder": Encoder.from_config(cfg.text_encoder),
            "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
            "decoder": UnitSpeech.from_config(
                cfg.decoder, dtype=dtype, use_kernels=use_kernels, use_int8_deep=use_int8_deep,
                use_deep=use_deep, use_resample=use_resample, use_i8pre_deep=use_i8pre_deep),
        }
        if with_vocoder:
            mods["vocoder"] = BigVGAN.from_config(cfg.vocoder, dtype=dtype,
                                                  use_kernels=use_kernels)
    return mods


def _random_leaf(rng, name: str, shape) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        # the linear attention's output grows with the square of its input:
        # smaller q/k/v projections keep the random U-Net's activations bounded
        gain = 0.2 if name.endswith("to_qkv.kernel") else 1.0
        return gain * rng.standard_normal(shape) / np.sqrt(fan_in)
    if leaf == "embedding":
        return rng.standard_normal(shape) / np.sqrt(shape[-1])
    if leaf in ("emb_rel_k", "emb_rel_v"):
        return rng.standard_normal(shape) / np.sqrt(shape[-1])
    if leaf in ("scale", "gamma"):
        return 1.0 + 0.05 * rng.standard_normal(shape)
    if leaf == "g":
        # rezero gate: non-zero so attention contributes, but small: the
        # linear attention's output grows with the square of its input, and
        # with random weights the sampler state grows ~136x over 50 DDPM
        # steps (the product of the schedule's c_x), where a trained score
        # would hold it near the data; eight attention layers would then
        # compound into inf
        return rng.uniform(0.0005, 0.0015, shape)
    if leaf == "text_uncon":
        return 0.5 * rng.standard_normal(shape)
    if leaf == "spk_uncon":
        return rng.standard_normal(shape)
    return 0.05 * rng.standard_normal(shape)  # biases, shifts, snake alpha/beta


def random_params(cfg: MainConfig, seed: int) -> dict:
    """A checkpoint dict at `cfg`'s full widths drawn from
    numpy.random.default_rng(seed): one state dict per module, a unit-norm
    speaker embedding, the mel min/max and the config. The learned
    unconditional embeddings are non-zero so dual CFG does real work."""
    rng = np.random.default_rng(seed)
    ckpt = {}
    for name, mod in build_modules(cfg, device="meta").items():
        ckpt[name] = {
            k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape)).astype(np.float32))
            for k, v in mod.state_dict().items()
        }
    spk = rng.standard_normal((1, cfg.decoder.spk_emb_dim))
    ckpt["spk_emb"] = torch.from_numpy((spk / np.linalg.norm(spk)).astype(np.float32))
    ckpt["mel_min"] = torch.full((cfg.data.n_feats,), -12.0)
    ckpt["mel_max"] = torch.full((cfg.data.n_feats,), 3.0)
    ckpt["config"] = dataclasses.asdict(cfg)
    return ckpt
