"""CPC speech encoder, the CPC dense-model family of the unit extractor
(counterpart of unitspeech_tpu/models/ssl/cpc.py; textlesslib
cpc_feature_reader.py:11-190): a 5-layer strided conv encoder with
ChannelNorm (160x downsampling, 100 Hz at 16 kHz) feeding a multi-layer
LSTM. The features are the LSTM's output (or the encoder's, with
use_encoder_layer), optionally mean / variance normalized over time.

Parameters keep the JAX tree's layout and names (`gEncoder.conv<i>.kernel`
(K, Cin, Cout) and `.bias`, `gEncoder.norm<i>.weight` / `.bias` (1, C),
`gAR.weight_ih_l<k>` ... in torch's LSTM layout), so
utils/params.params_from_jax carries a JAX tree across; `gAR` is an
nn.LSTM(batch_first=True), which names its parameters so.

The JAX reader pads each chunk to a multiple of max_chunk and masks by the
true length, for static shapes; here each chunk runs unpadded, which keeps
the same frames (every conv sees the reference's zero padding at the true
boundary either way, and the LSTM is causal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d


@dataclass(frozen=True)
class CpcConfig:
    hidden_encoder: int = 512   # config["hiddenEncoder"]
    hidden_gar: int = 256       # config["hiddenGar"]
    n_levels_lstm: int = 2      # config["nLevelsGRU"] (an LSTM despite the name)


def cpc_base_config() -> CpcConfig:
    """The 6k-hour LibriLight CPC checkpoint (cpc-big-ll6k)."""
    return CpcConfig()


def cpc_test_config() -> CpcConfig:
    return CpcConfig(hidden_encoder=8, hidden_gar=6, n_levels_lstm=2)


# (kernel, stride, padding) of the encoder's five convs
ENCODER_CONVS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))


class ChannelNorm(nn.Module):
    """Per-position normalization over channels with a (1, C) affine
    (cpc_feature_reader.py:89-114): torch.var's default, the unbiased
    variance (divided by C - 1)."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(1, num_features))
        self.bias = nn.Parameter(torch.zeros(1, num_features))

    def forward(self, x):  # (B, C, T)
        c = x.shape[1]
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().sum(dim=1, keepdim=True) / max(c - 1, 1)
        x = (x - mean) * torch.rsqrt(var + self.epsilon)
        return x * self.weight[..., None] + self.bias[..., None]


class CpcEncoder(nn.Module):
    """conv(10,5,p3) -> conv(8,4,p2) -> 3x conv(4,2,p1), each followed by
    ChannelNorm and ReLU (cpc_feature_reader.py:117-141)."""

    def __init__(self, config: CpcConfig):
        super().__init__()
        h = config.hidden_encoder
        for i, (k, _, _) in enumerate(ENCODER_CONVS):
            self.add_module(f"conv{i}", Conv1d(1 if i == 0 else h, h, k))
            self.add_module(f"norm{i}", ChannelNorm(h))

    def forward(self, wav):  # (B, samples) -> (B, frames, C)
        x = wav[:, None, :]
        for i, (_, s, p) in enumerate(ENCODER_CONVS):
            conv = getattr(self, f"conv{i}")
            x = F.conv1d(x, conv.kernel.permute(2, 1, 0), conv.bias, stride=s, padding=p)
            x = torch.relu(getattr(self, f"norm{i}")(x))
        return x.transpose(1, 2)


class CpcModel(nn.Module):
    """encoder -> LSTM (cpc_feature_reader.py:144-190)."""

    def __init__(self, config: CpcConfig = CpcConfig()):
        super().__init__()
        self.config = config
        self.gEncoder = CpcEncoder(config)
        self.gAR = nn.LSTM(config.hidden_encoder, config.hidden_gar,
                           num_layers=config.n_levels_lstm, batch_first=True)

    def forward(self, wav, get_encoded: bool = False, norm_output: bool = False):
        """wav (B, samples) -> (B, frames, D) f32."""
        encoded = self.gEncoder(wav)
        feat = encoded if get_encoded else self.gAR(encoded)[0]
        if norm_output:
            # torch.var over time (unbiased), eps 1e-8 (:186-189)
            t = feat.shape[1]
            mean = feat.mean(dim=1, keepdim=True)
            var = (feat - mean).square().sum(dim=1, keepdim=True) / max(t - 1, 1)
            feat = (feat - mean) / torch.sqrt(var + 1e-8)
        return feat


def convert_cpc(sd: Dict[str, np.ndarray], config: CpcConfig) -> Dict:
    """torch CPCModel state dict ('weights' of the published checkpoint) ->
    the JAX param tree: Conv1d weights (Cout, Cin, K) -> (K, Cin, Cout),
    ChannelNorm affine (1, C, 1) -> (1, C), the LSTM's copied as they are."""
    a = lambda k: np.asarray(sd[k])  # noqa: E731
    params: Dict = {"gEncoder": {}, "gAR": {}}
    for i in range(5):
        w = a(f"gEncoder.conv{i}.weight")
        params["gEncoder"][f"conv{i}"] = {"kernel": np.transpose(w, (2, 1, 0)),
                                          "bias": a(f"gEncoder.conv{i}.bias")}
        params["gEncoder"][f"norm{i}"] = {
            "weight": a(f"gEncoder.batchNorm{i}.weight").reshape(1, -1),
            "bias": a(f"gEncoder.batchNorm{i}.bias").reshape(1, -1),
        }
    for k in range(config.n_levels_lstm):
        for name in (f"weight_ih_l{k}", f"weight_hh_l{k}", f"bias_ih_l{k}", f"bias_hh_l{k}"):
            params["gAR"][name] = a(f"gAR.baseNet.{name}")
    return {"params": params}


class CpcFeatureReader:
    """The reference's chunking (cpc_feature_reader.py:31-59): full
    max_chunk windows, then a tail pass for the last (size - start) // hop
    frames. The reference's tail slice `x[:, -max_chunk:]` cuts a (1, 1, T)
    tensor's size-1 channel axis, so the tail pass runs the WHOLE waveform
    and keeps its last `delta` frames, their LSTM state carried from sample
    0; kept here as in JAX."""

    def __init__(self, model: CpcModel, max_chunk: int = 64_000, use_encoder_layer: bool = False,
                 norm_features: bool = False):
        self.model = model
        self.max_chunk = max_chunk
        self.use_encoder_layer = use_encoder_layer
        self.norm_features = norm_features

    @property
    def code_hop_size(self) -> int:
        return 160

    @property
    def hop(self) -> int:
        """SpeechEncoder's name for the hop."""
        return self.code_hop_size

    @property
    def expected_sample_rate(self) -> int:
        return 16_000

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _run(self, chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))[None].to(self.device)
        return self.model(x, get_encoded=self.use_encoder_layer,
                          norm_output=self.norm_features)[0]

    @torch.no_grad()
    def features(self, wav) -> torch.Tensor:
        """wav (samples,) at 16 kHz -> (frames, D) f32 on the model's device."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        size = len(wav)
        feat = []
        start = 0
        while start + self.max_chunk <= size:
            feat.append(self._run(wav[start:start + self.max_chunk]))
            start += self.max_chunk
        delta = (size - start) // self.code_hop_size
        if delta > 0:
            # the tail pass runs the full sequence (class docstring)
            full = self._run(wav)[: size // self.code_hop_size]
            feat.append(full[len(full) - delta:])
        if not feat:
            d = (self.model.config.hidden_encoder if self.use_encoder_layer
                 else self.model.config.hidden_gar)
            return torch.zeros((0, d), device=self.device)
        return torch.cat(feat)

    def __call__(self, wav) -> np.ndarray:
        """wav (samples,) -> (frames, D) float32 numpy."""
        return self.features(wav).cpu().numpy()

    @classmethod
    def from_torch(cls, ckpt_path: str, layer: int = 2, use_encoder_layer: bool = False,
                   norm_features: bool = False, max_chunk: int = 64_000,
                   device="cuda") -> "CpcFeatureReader":
        """The published CPC checkpoint ({'weights', 'config'},
        cpc_feature_reader.py:69-86) on `device`. `layer` sets the LSTM's
        depth, as the reference's nLevelsGRU override does; it may not
        exceed the checkpoint's nLevelsGRU (ValueError: the checkpoint has
        no weights for the deeper levels)."""
        from unitspeech_tpu_torch.utils.params import params_from_jax

        state = torch.load(ckpt_path, map_location="cpu")
        cfg_d = state["config"]
        have = int(cfg_d["nLevelsGRU"])
        depth = have if layer is None else int(layer)
        if depth > have:
            raise ValueError(f"{ckpt_path}: layer {depth} asks for a {depth}-level LSTM, but the "
                             f"checkpoint has nLevelsGRU = {have} levels")
        config = CpcConfig(hidden_encoder=int(cfg_d["hiddenEncoder"]),
                           hidden_gar=int(cfg_d["hiddenGar"]), n_levels_lstm=depth)
        sd = {k: v.numpy() for k, v in state["weights"].items()}
        model = CpcModel(config)
        model.load_state_dict(params_from_jax(convert_cpc(sd, config)))
        model = model.to(device).eval().requires_grad_(False)
        return cls(model, max_chunk=max_chunk, use_encoder_layer=use_encoder_layer,
                   norm_features=norm_features)
