"""Model-artifact loading (counterpart of unitspeech_tpu/utils/artifacts.py):
one API over the reference's torch `.pt` checkpoints, converted on the fly
(utils/torch_convert), and the port's own files. Every loader returns a
state dict in the port's layout.

The port's files are `torch.save`d dicts keyed by module name, with the
config beside them:

  * the combined checkpoint (utils/params.random_params):
    {"text_encoder", "unit_encoder", "duration_predictor", "decoder",
    "vocoder": state dicts, "spk_emb", "mel_min", "mel_max", "config"};
  * a decoder bundle (save_decoder_bundle, what `cli finetune` writes):
    {"decoder", "spk_emb", "mel_min", "mel_max", "step", "config"};
  * a module file (save_module, what `cli convert` writes for the other
    families, the SSL models included): {<module name>: state dict,
    "config"}; k-means centroids are a `.npz` ({"centroids": (K, D)}).

A reference file holds its state dict under "model" (the decoder, and
often the encoders and the duration predictor), under "generator"
(BigVGAN), or at the top level. The orbax format of the JAX package is not
read here.
"""

from __future__ import annotations

import dataclasses
import pickle
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional

import torch

from unitspeech_tpu_torch.utils import torch_convert, torch_convert_ssl
from unitspeech_tpu_torch.utils.params import params_from_jax


@dataclass
class DecoderBundle:
    state_dict: dict  # models.diffusion.UnitSpeech, the port's layout
    spk_emb: Optional[torch.Tensor]  # (1, S) or None
    mel_min: Optional[torch.Tensor]  # (n_feats,)
    mel_max: Optional[torch.Tensor]
    step: int = 0


def read(src, weights_only: bool = True):
    """A checkpoint dict: `src` itself when it is one, else the file at that
    path (loaded to the CPU, tensors only unless weights_only is False)."""
    if isinstance(src, Mapping):
        return src
    return torch.load(src, map_location="cpu", weights_only=weights_only)


def _numpy(sd) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _port_entry(obj, name: str, src):
    """The port's state dict of module `name` in checkpoint dict obj, or None
    for a reference file. A port file (one with a config) that lacks the
    module raises."""
    if name in obj:
        return obj[name]
    if "config" in obj and not {"model", "generator"} & set(obj):
        raise ValueError(f"{src if isinstance(src, str) else 'checkpoint'}: "
                         f"a port checkpoint without a {name!r} entry")
    return None


def _flat(v) -> Optional[torch.Tensor]:
    return None if v is None else torch.as_tensor(v, dtype=torch.float32).reshape(-1)


def load_decoder_bundle(src, cfg) -> DecoderBundle:
    """A diffusion-decoder checkpoint (cfg: the DecoderConfig). Reference
    format: {'model': state_dict, 'spk_emb': (1, 1, S) or (1, S),
    'mel_min': (80, 1) or (80,), 'mel_max', 'iteration'}; the port's: a
    bundle or a combined checkpoint."""
    obj = read(src)
    sd = _port_entry(obj, "decoder", src)
    if sd is None:
        sd = params_from_jax(torch_convert.convert_decoder(
            _numpy(obj["model"]), dim=cfg.dim, dim_mults=tuple(cfg.dim_mults)))
        step = int(obj.get("iteration", 0))
    else:
        step = int(obj.get("step", 0))
    spk = obj.get("spk_emb")
    return DecoderBundle(
        state_dict=sd,
        spk_emb=None if spk is None else torch.as_tensor(spk, dtype=torch.float32).reshape(1, -1),
        mel_min=_flat(obj.get("mel_min")), mel_max=_flat(obj.get("mel_max")), step=step)


def save_decoder_bundle(path: str, bundle: DecoderBundle, cfg) -> str:
    """Write a decoder bundle in the port's format (cfg: the MainConfig)."""
    cpu = lambda v: None if v is None else v.detach().cpu()  # noqa: E731
    torch.save({"decoder": {k: v.detach().to("cpu", torch.float32)
                            for k, v in bundle.state_dict.items()},
                "spk_emb": cpu(bundle.spk_emb), "mel_min": cpu(bundle.mel_min),
                "mel_max": cpu(bundle.mel_max), "step": int(bundle.step),
                "config": dataclasses.asdict(cfg)}, path)
    return path


def save_module(path: str, name: str, state_dict: dict, cfg) -> str:
    """Write one module's state dict in the port's format (cfg: the
    MainConfig)."""
    torch.save({name: {k: v.detach().cpu() for k, v in state_dict.items()},
                "config": dataclasses.asdict(cfg)}, path)
    return path


def load_encoder_params(src, cfg, name: str = "text_encoder") -> dict:
    """A text, unit or contentvec encoder (cfg: its EncoderConfig, whose
    n_contentvec > 0 reads the reference's contentvec layout, `emb.weight`
    a (C, n_contentvec) linear map; name: "text_encoder", "unit_encoder" or
    "contentvec_encoder", the entry of a port checkpoint)."""
    obj = read(src)
    sd = _port_entry(obj, name, src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert.convert_encoder(
        _numpy(obj.get("model", obj)), n_layers=cfg.n_layers,
        prenet_layers=cfg.prenet_layers, contentvec=cfg.n_contentvec > 0))


def load_duration_predictor_params(src) -> dict:
    obj = read(src)
    sd = _port_entry(obj, "duration_predictor", src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert.convert_duration_predictor(
        _numpy(obj.get("model", obj))))


def load_vocoder_params(src, cfg) -> dict:
    """A BigVGAN generator (cfg: the VocoderConfig); the reference's weight
    norm is folded."""
    obj = read(src)
    sd = _port_entry(obj, "vocoder", src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert.convert_bigvgan(
        _numpy(obj.get("generator", obj)), num_upsamples=len(cfg.upsample_rates),
        num_kernels=len(cfg.resblock_kernel_sizes),
        convs_per_block=len(cfg.resblock_dilation_sizes[0])))


def _ssl_numpy(obj) -> dict:
    """The tensors of a reference SSL checkpoint's state dict (under "model"
    or at the top level) as numpy arrays; other entries are skipped."""
    sd = obj.get("model", obj)
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _read_ssl(src):
    """An SSL checkpoint dict, read tensors-only first. Only a file that the
    safe load refuses, such as a fairseq or s3prl checkpoint whose "cfg" /
    "args" entries are Python objects, is unpickled in full, as the
    reference and the JAX package read it; the port's module files never
    are."""
    try:
        return read(src)
    except pickle.UnpicklingError:
        return read(src, weights_only=False)


def load_hubert_params(src, cfg) -> dict:
    """The unit extractor's HuBERT (cfg: its HubertConfig). Reference
    format: a fairseq checkpoint (read by _read_ssl); the port's: a module
    file."""
    obj = _read_ssl(src)
    sd = _port_entry(obj, "hubert", src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert_ssl.convert_hubert(
        _ssl_numpy(obj), cfg.num_layers, len(cfg.conv_layers)))


def load_wavlm_params(src, cfg) -> dict:
    """A WavLM alone (cfg: its WavLMConfig), as s3prl's WavLM checkpoints
    hold it (read by _read_ssl)."""
    obj = _read_ssl(src)
    sd = _port_entry(obj, "wavlm", src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert_ssl.convert_wavlm(
        _ssl_numpy(obj), cfg.num_layers, len(cfg.conv_layers)))


def load_speaker_embedder_params(src, cfg) -> dict:
    """WavLM + ECAPA (cfg: the WavLMConfig of its backbone). Reference
    format: speaker_encoder.pt, its state dict under "model" with the
    WavLM under feature_extract.model.*; the port's: a module file."""
    obj = read(src)
    sd = _port_entry(obj, "speaker_embedder", src)
    if sd is not None:
        return sd
    return params_from_jax(torch_convert_ssl.convert_speaker_embedder(
        _ssl_numpy(obj), cfg.num_layers, len(cfg.conv_layers)))


def load_kmeans(src):
    """A KMeansQuantizer from a centroids `.npz`, or from a sklearn joblib
    checkpoint (needs joblib and sklearn)."""
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer

    if str(src).endswith(".npz"):
        return KMeansQuantizer.load(src)
    return KMeansQuantizer(torch_convert_ssl.convert_sklearn_kmeans(src))
