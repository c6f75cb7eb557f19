"""Parameter bridge between flax-layout trees and the port, and random
full-width parameters.

The port keeps flax's tensor layout (Dense (in, out), conv (*k, in, out),
unflipped ConvTranspose) and names each parameter by its flax path joined
with '.', so a JAX parameter tree maps to a state dict with no transposes.
Reference `.pt` checkpoints go through the port's own converter
(utils/torch_convert, numpy only) into such a tree first, then
params_from_jax; utils/artifacts does both when it loads one.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from unitspeech_tpu_torch.config import MainConfig, config_from_dict  # noqa: F401


# flax's variable collections that the port's state dicts hold: the
# parameters, and the BatchNorm running statistics (leaves `mean` / `var`,
# buffers in the port) of the speaker embedder
COLLECTIONS = ("params", "batch_stats")
STAT_LEAVES = ("mean", "var")


def params_from_jax(tree) -> dict:
    """flax variable tree ({"params": {...}}, {"params", "batch_stats"} or
    the inner dict) of numpy (or array-like) leaves -> state dict of
    f32/int torch tensors, one key per leaf: its flax path joined with '.'
    (the collections merged)."""
    if isinstance(tree, Mapping) and tree and set(tree) <= set(COLLECTIONS) and "params" in tree:
        trees = [tree[c] for c in COLLECTIONS if c in tree]
    else:
        trees = [tree]
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            elif key in out:
                raise ValueError(f"{key}: in more than one collection")
            else:
                out[key] = torch.from_numpy(np.array(v, copy=True))

    for t in trees:
        walk(t, "")
    return out


def params_to_jax(state_dict) -> dict:
    """Inverse of params_from_jax: {"params": nested dict of numpy arrays},
    plus "batch_stats" with the BatchNorm statistics when there are any."""
    roots: dict = {}
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        node = roots.setdefault("batch_stats" if leaf in STAT_LEAVES else "params", {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return {"params": roots.get("params", {}), **{k: v for k, v in roots.items() if k != "params"}}


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


def _random_state_dict(rng, mod) -> dict:
    return {k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape)).astype(np.float32))
            for k, v in mod.state_dict().items()}


# flax's truncated normal (lecun_normal) divides the standard deviation by
# the std of a standard normal truncated to [-2, 2], so the draws keep it
_TRUNC_STD = 0.87962566103423978


def _flax_init_(t: torch.Tensor, name: str, generator: torch.Generator,
                snake_logscale: bool = True) -> torch.Tensor:
    """Fill t in place from the distribution of the flax initializer that
    the JAX modules name for parameter `name` (its state-dict key):
    lecun_normal kernels (a normal truncated to 2 std, std sqrt(1 / fan_in),
    fan_in the product of all but the last dimension; convs, transposed
    convs and Dense alike), xavier_uniform for the encoder's conv_q /
    conv_k / conv_v, zeros for the prenet's residual projection,
    normal(C ** -0.5) for the token embedding and a contentvec encoder's
    input map, normal(d ** -0.5) for the relative-position tables, ones for
    the norm scales, zeros for the biases, the LayerNorm shifts, the rezero
    gates and the unconditional embeddings; a BigVGAN snake's alpha and
    beta (under `act` / `act_post`) zeros when snake_logscale, else ones
    (JAX models/vocoder.py Snake, SnakeBeta). Unknown names raise."""
    leaf = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if "." in name else ""
    if leaf in ("alpha", "beta") and parent in ("act", "act_post"):
        return t.zero_() if snake_logscale else t.fill_(1.0)
    if name.endswith("prenet.proj.kernel"):
        return t.zero_()
    if leaf == "kernel" and parent in ("conv_q", "conv_k", "conv_v"):
        limit = float(np.sqrt(3.0 / ((t.shape[0] + t.shape[1]) / 2)))
        return torch.nn.init.uniform_(t, -limit, limit, generator=generator)
    if name == "emb.kernel" or leaf in ("embedding", "emb_rel_k", "emb_rel_v"):
        return torch.nn.init.normal_(t, 0.0, t.shape[-1] ** -0.5, generator=generator)
    if leaf == "kernel":
        std = float(np.sqrt(1.0 / np.prod(t.shape[:-1]))) / _TRUNC_STD
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    if leaf in ("scale", "gamma"):
        return t.fill_(1.0)
    if leaf in ("bias", "beta", "g", "text_uncon", "spk_uncon"):
        return t.zero_()
    raise ValueError(f"no flax initializer known for {name}")


def init_module(module: torch.nn.Module, generator: torch.Generator,
                snake_logscale: bool = True) -> dict:
    """A state dict for `module` (on any device, "meta" included), every
    parameter drawn on the CPU from `generator` in state-dict order from
    its flax initializer (_flax_init_)."""
    return {k: _flax_init_(torch.empty(v.shape), k, generator, snake_logscale)
            for k, v in module.state_dict().items()}


STEP1_MODULES = ("text_encoder", "duration_predictor", "decoder")


def init_params(cfg: MainConfig, generator: torch.Generator,
                names=STEP1_MODULES) -> dict:
    """Training's starting point, as the JAX package's `init` makes it: a
    state dict for each module of `names` (STEP1's three, the default;
    ("unit_encoder",) for STEP2) at `cfg`'s widths, every parameter drawn
    (on the CPU, from `generator`, module by module in that order) from
    its flax initializer's distribution (init_module): the same
    distributions as JAX's trees, not the same draws. Unlike
    random_params, whose test weights are drawn alike and keep non-zero
    gates and unconditional embeddings, this is what training starts
    from. (The GAN's modules go through init_module where they are built.)"""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder

    build = {"text_encoder": lambda: Encoder.from_config(cfg.text_encoder),
             "duration_predictor": lambda: DurationPredictor.from_config(cfg.duration_predictor),
             "decoder": lambda: UnitSpeech.from_config(cfg.decoder),
             "unit_encoder": lambda: Encoder.from_config(cfg.unit_encoder)}
    with torch.device("meta"):
        mods = {name: build[name]() for name in names}
    return {name: init_module(m, generator) for name, m in mods.items()}


def random_params(cfg: MainConfig, seed: int) -> dict:
    """A checkpoint dict at `cfg`'s full widths drawn from
    numpy.random.default_rng(seed): one state dict per module (the unit
    encoder, which only the fine-tune reads, drawn last so that the other
    modules' weights do not depend on it), a unit-norm speaker embedding,
    the mel min/max and the config. The learned unconditional embeddings
    are non-zero so dual CFG does real work."""
    from unitspeech_tpu_torch.models.encoder import Encoder

    rng = np.random.default_rng(seed)
    ckpt = {}
    for name, mod in build_modules(cfg, device="meta").items():
        ckpt[name] = _random_state_dict(rng, mod)
    spk = rng.standard_normal((1, cfg.decoder.spk_emb_dim))
    ckpt["spk_emb"] = torch.from_numpy((spk / np.linalg.norm(spk)).astype(np.float32))
    with torch.device("meta"):
        ckpt["unit_encoder"] = _random_state_dict(rng, Encoder.from_config(cfg.unit_encoder))
    ckpt["mel_min"] = torch.full((cfg.data.n_feats,), -12.0)
    ckpt["mel_max"] = torch.full((cfg.data.n_feats,), 3.0)
    ckpt["config"] = dataclasses.asdict(cfg)
    return ckpt
