"""Tacotron2 unit-vocoder acoustic model (counterpart of
unitspeech_tpu/models/tacotron2.py; textlesslib vocoders/tacotron2/
model.py:43-702, NVIDIA's Tacotron2 with obs / lat conditioning): unit-code
embedding -> conv + BiLSTM encoder -> location-sensitive-attention
autoregressive decoder -> postnet residual.

Parameters keep the JAX tree's layout and names, so
utils/params.params_from_jax carries a tree across: linears and LSTM cells
in torch's (out, in) layout under `weight` (an LSTM cell's two biases
folded into one `bias`), convs (K, Cin, Cout) under `kernel`, BatchNorm
as its four leaves (eval mode only).

Batches are padded token buckets: rows at or after each length are
re-masked after every encoder layer, the backward LSTM reverses only the
valid prefix, and attention energies at padded keys are -inf, which gives
each row the numbers of its unpadded run. The decoder is a loop of
max_decoder_steps steps that checks on the host whether every row has
stopped once every `stop_every` steps (not every step: 2 000 syncs at the
default length); rows that have stopped write zeros and count no steps,
so the extra steps leave every output as a check every step would.

The prenet's dropout is always on at inference (model.py:130-133: a
deliberate sampling trick), drawn from an explicit torch.Generator, or
taken from injected masks (the tests inject JAX's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d


@dataclass(frozen=True)
class Tacotron2Config:
    """Field names follow the reference hparams (vocoder.py:117-127)."""

    n_symbols: int = 104
    symbols_embedding_dim: int = 512
    encoder_embedding_dim: int = 512
    encoder_n_convolutions: int = 3
    encoder_kernel_size: int = 5
    n_mel_channels: int = 80
    n_frames_per_step: int = 1
    attention_rnn_dim: int = 1024
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    gate_threshold: float = 0.5
    max_decoder_steps: int = 2000
    obs_dim: int = 0
    obs_n_class: int = 1
    lat_dim: int = 0


def tacotron2_test_config(**kw) -> Tacotron2Config:
    base = dict(
        n_symbols=12, symbols_embedding_dim=16, encoder_embedding_dim=16,
        n_mel_channels=8, attention_rnn_dim=20, decoder_rnn_dim=24,
        prenet_dim=10, attention_dim=12, attention_location_n_filters=4,
        attention_location_kernel_size=7, postnet_embedding_dim=12,
        max_decoder_steps=40,
    )
    base.update(kw)
    return Tacotron2Config(**base)


# ---------------------------------------------------------------------------
# leaves, named as the JAX tree names them


class _Linear(nn.Module):
    """torch layout: weight (out, in), optional bias."""

    def __init__(self, out: int, inp: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out, inp))
        self.bias = nn.Parameter(torch.zeros(out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _BatchNorm(nn.Module):
    """Eval-mode BatchNorm1d over channels (B, C, T): the four leaves and
    nothing else (no num_batches_tracked)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean[:, None]) * inv[:, None] * self.weight[:, None]
                + self.bias[:, None])


class _LSTMCell(nn.Module):
    """torch LSTMCell with its biases folded: gates [i, f, g, o]."""

    def __init__(self, hidden: int, inp: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, inp))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x, h, c, x_proj=None):
        """One step; x_proj: x @ weight_ih.T precomputed."""
        gates = (F.linear(x, self.weight_ih) if x_proj is None else x_proj) \
            + F.linear(h, self.weight_hh) + self.bias
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        return torch.sigmoid(go) * torch.tanh(c_new), c_new

    def scan(self, x):
        """Zero-state LSTM over (B, T, C) -> (B, T, H)."""
        b, t, _ = x.shape
        hdim = self.weight_hh.shape[1]
        h = c = x.new_zeros(b, hdim)
        xp = F.linear(x, self.weight_ih)
        ys = []
        for i in range(t):
            h, c = self(None, h, c, x_proj=xp[:, i])
            ys.append(h)
        return torch.stack(ys, dim=1) if ys else x.new_zeros(b, 0, hdim)


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        m.add_module(k, v)
    return m


class Tacotron2(nn.Module):
    """The parameter tree of convert_tacotron2 / random_tacotron2_params as
    a module; inference is tacotron2_infer. The obs / lat conditioning
    (obs_dim + lat_dim wide) widens only the decoder RNN's input and the
    projections'."""

    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embedding_dim
        mem = e + cfg.obs_dim + cfg.lat_dim
        n_out = cfg.n_mel_channels * cfg.n_frames_per_step
        self.embedding = _module()
        self.embedding.weight = nn.Parameter(torch.zeros(cfg.n_symbols, cfg.symbols_embedding_dim))
        self.encoder = _module(lstm_fwd=_LSTMCell(e // 2, e), lstm_bwd=_LSTMCell(e // 2, e))
        for i in range(cfg.encoder_n_convolutions):
            cin = cfg.symbols_embedding_dim if i == 0 else e
            self.encoder.add_module(f"conv{i}", _module(
                conv=Conv1d(cin, e, cfg.encoder_kernel_size), bn=_BatchNorm(e)))
        if cfg.obs_dim > 0:
            self.obs_embedding = _module()
            self.obs_embedding.weight = nn.Parameter(torch.zeros(cfg.obs_n_class, cfg.obs_dim))
        a, f = cfg.attention_dim, cfg.attention_location_n_filters
        self.decoder = _module(
            prenet=_module(layer0=_Linear(cfg.prenet_dim, n_out, bias=False),
                           layer1=_Linear(cfg.prenet_dim, cfg.prenet_dim, bias=False)),
            attention_rnn=_LSTMCell(cfg.attention_rnn_dim, cfg.prenet_dim + e),
            attention=_module(
                query=_Linear(a, cfg.attention_rnn_dim, bias=False),
                memory=_Linear(a, e, bias=False),
                v=_Linear(1, a, bias=False),
                location_conv=Conv1d(2, f, cfg.attention_location_kernel_size, bias=False),
                location_dense=_Linear(a, f, bias=False)),
            decoder_rnn=_LSTMCell(cfg.decoder_rnn_dim, cfg.attention_rnn_dim + mem),
            linear_projection=_Linear(n_out, cfg.decoder_rnn_dim + mem),
            gate=_Linear(1, cfg.decoder_rnn_dim + mem))
        self.postnet = _module()
        for i in range(cfg.postnet_n_convolutions):
            cin = cfg.n_mel_channels if i == 0 else cfg.postnet_embedding_dim
            cout = (cfg.n_mel_channels if i == cfg.postnet_n_convolutions - 1
                    else cfg.postnet_embedding_dim)
            self.postnet.add_module(f"conv{i}", _module(
                conv=Conv1d(cin, cout, cfg.postnet_kernel_size), bn=_BatchNorm(cout)))


# ---------------------------------------------------------------------------


def _mask_rows(x, lengths):
    """(B, T, C) -> rows at / after each sequence's length zeroed."""
    idx = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(idx < lengths[:, None, None], x, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


def _reverse_valid(x, lengths):
    """Reverse each sequence's first `length` rows in place, the padding
    kept at the tail."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)
    return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))


def encoder_infer(model: Tacotron2, tokens, lengths):
    """tokens (B, T) int, lengths (B,) -> memory (B, T, E) (model.py:182-234,
    eval mode)."""
    cfg = model.cfg
    x = _mask_rows(model.embedding.weight[tokens], lengths)
    pad = (cfg.encoder_kernel_size - 1) // 2
    for i in range(cfg.encoder_n_convolutions):
        c = getattr(model.encoder, f"conv{i}")
        x = torch.relu(c.bn(c.conv.ncw(x.transpose(1, 2), pad))).transpose(1, 2)
        x = _mask_rows(x, lengths)
    fwd = model.encoder.lstm_fwd.scan(x)
    bwd = _reverse_valid(model.encoder.lstm_bwd.scan(_reverse_valid(x, lengths)), lengths)
    return _mask_rows(torch.cat([fwd, bwd], dim=-1), lengths)


def _prenet(prenet, x, masks):
    """model.py:122-133: dropout always on; masks: two (B, prenet_dim) keep
    masks, or None for no dropout."""
    for i in range(2):
        x = torch.relu(getattr(prenet, f"layer{i}")(x))
        if masks is not None:
            x = torch.where(masks[i], x / 0.5, torch.zeros((), dtype=x.dtype, device=x.device))
    return x


def decoder_infer(model: Tacotron2, memory, lengths, obs_and_lat=None, generator=None,
                  prenet_dropout: bool = True, prenet_masks=None, cfg=None,
                  stop_every: int = 32):
    """The autoregressive decode (model.py:527-569). prenet_masks: (steps,
    2, B, prenet_dim) bool, injected keep masks (else drawn from
    `generator` when prenet_dropout). cfg: model.cfg unless given (its
    gate_threshold and max_decoder_steps). Returns (mels (B, S_max, n_mel),
    gates (B, S_max), alignments (B, S_max, T), n_steps (B,), has_eos
    (B,)): buffers of max_decoder_steps rows, zero at rows >= n_steps."""
    cfg = cfg or model.cfg
    d = model.decoder
    b, t, _ = memory.shape
    dev = memory.device
    n_mel = cfg.n_mel_channels * cfg.n_frames_per_step
    s_max = cfg.max_decoder_steps
    key_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    processed_memory = d.attention.memory(memory)
    loc_pad = (cfg.attention_location_kernel_size - 1) // 2
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    has_eos = torch.zeros(b, dtype=torch.bool, device=dev)
    n_steps = torch.zeros(b, dtype=torch.int32, device=dev)
    mel_prev = z(b, n_mel)
    att_h, att_c = z(b, cfg.attention_rnn_dim), z(b, cfg.attention_rnn_dim)
    dec_h, dec_c = z(b, cfg.decoder_rnn_dim), z(b, cfg.decoder_rnn_dim)
    att_w, att_w_cum = z(b, t), z(b, t)
    att_ctx = z(b, memory.shape[2])
    mels, gates, aligns = z(s_max, b, n_mel), z(s_max, b), z(s_max, b, t)
    neg_inf = torch.tensor(-torch.inf, device=dev)

    for step in range(s_max):
        if prenet_masks is not None:
            masks = prenet_masks[step]
        elif prenet_dropout:
            masks = [torch.rand((b, cfg.prenet_dim), generator=generator, device=dev) < 0.5
                     for _ in range(2)]
        else:
            masks = None
        pre = _prenet(d.prenet, mel_prev, masks)
        att_h, att_c = d.attention_rnn(torch.cat([pre, att_ctx], dim=-1), att_h, att_c)
        # location-sensitive attention, one step (model.py:62-119)
        q = d.attention.query(att_h)[:, None, :]
        loc = d.attention.location_conv.ncw(torch.stack([att_w, att_w_cum], dim=1), loc_pad)
        loc = d.attention.location_dense(loc.transpose(1, 2))
        energies = d.attention.v(torch.tanh(q + loc + processed_memory))[..., 0]
        w = torch.softmax(torch.where(key_mask, energies, neg_inf), dim=-1)
        ctx = torch.bmm(w[:, None, :], memory)[:, 0]
        att_w, att_w_cum, att_ctx = w, att_w_cum + w, ctx
        dec_in = torch.cat([att_h, ctx] + ([obs_and_lat] if obs_and_lat is not None else []),
                           dim=-1)
        dec_h, dec_c = d.decoder_rnn(dec_in, dec_h, dec_c)
        proj_in = torch.cat([dec_h, ctx] + ([obs_and_lat] if obs_and_lat is not None else []),
                            dim=-1)
        mel = d.linear_projection(proj_in)
        gate = d.gate(proj_in)[..., 0]

        active = ~done
        write = active.to(torch.float32)
        mels[step] = mel * write[:, None]
        gates[step] = gate * write
        aligns[step] = w * write[:, None]
        stop = torch.sigmoid(gate) > cfg.gate_threshold
        done = done | stop
        has_eos = has_eos | (stop & active)
        mel_prev = torch.where(active[:, None], mel, mel_prev)
        n_steps = n_steps + active.to(torch.int32)
        if (step + 1) % stop_every == 0 and bool(done.all()):
            break
    return (mels.transpose(0, 1), gates.transpose(0, 1), aligns.transpose(0, 1), n_steps,
            has_eos)


def postnet(model: Tacotron2, mels, n_steps):
    """5-conv residual refiner (model.py:136-179, eval mode); rows >=
    n_steps are masked around every conv."""
    cfg = model.cfg
    x = _mask_rows(mels, n_steps)
    pad = (cfg.postnet_kernel_size - 1) // 2
    n = cfg.postnet_n_convolutions
    for i in range(n):
        c = getattr(model.postnet, f"conv{i}")
        x = c.bn(c.conv.ncw(x.transpose(1, 2), pad)).transpose(1, 2)
        if i < n - 1:
            x = torch.tanh(x)
        x = _mask_rows(x, n_steps)
    return mels + x


@torch.no_grad()
def tacotron2_infer(model: Tacotron2, tokens, lengths, obs_labels=None, lat=None,
                    generator=None, prenet_dropout: bool = True, prenet_masks=None, cfg=None,
                    stop_every: int = 32):
    """Full inference (model.py:666-701) on a padded token bucket: tokens
    (B, T), lengths (B,) -> (mel, mel_postnet, gates, alignments, n_steps,
    has_eos) (decoder_infer)."""
    memory = encoder_infer(model, tokens, lengths)
    mcfg = model.cfg
    parts = []
    if mcfg.obs_dim > 0:
        if obs_labels is None:
            obs_labels = torch.zeros(tokens.shape[0], dtype=torch.long, device=tokens.device)
        parts.append(model.obs_embedding.weight[obs_labels])
    if mcfg.lat_dim > 0:
        if lat is None:
            lat = torch.zeros(tokens.shape[0], mcfg.lat_dim, device=tokens.device)
        parts.append(lat)
    obs_and_lat = torch.cat(parts, dim=-1) if parts else None
    mels, gates, aligns, n_steps, has_eos = decoder_infer(
        model, memory, lengths, obs_and_lat, generator, prenet_dropout, prenet_masks, cfg,
        stop_every)
    mel_post = _mask_rows(postnet(model, mels, n_steps), n_steps)
    return mels, mel_post, gates, aligns, n_steps, has_eos


# ---------------------------------------------------------------------------
# parameter trees (numpy, as the JAX package makes them)


def random_tacotron2_params(cfg: Tacotron2Config, seed: int = 0, scale: float = 0.1) -> Dict:
    """Random tree with convert_tacotron2's structure and shapes, the JAX
    package's draws from numpy.random.default_rng(seed) in its order (equal
    arrays). With obs_dim or lat_dim set, the attention RNN and the memory
    layer take the encoder's width, which is what the decoder feeds them
    (the reference's shapes); JAX's draws add obs_dim + lat_dim there and
    do not fit its own decoder."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(out, inp, bias=True):
        d = {"weight": w(out, inp)}
        if bias:
            d["bias"] = w(out)
        return d

    def conv(k, cin, cout, bias=True):
        d = {"kernel": w(k, cin, cout)}
        if bias:
            d["bias"] = w(cout)
        return d

    def bn(c):
        return {"weight": 1.0 + w(c), "bias": w(c), "running_mean": w(c),
                "running_var": (1.0 + w(c) ** 2).astype(np.float32)}

    def lstmcell(hidden, inp):
        return {"weight_ih": w(4 * hidden, inp), "weight_hh": w(4 * hidden, hidden),
                "bias": w(4 * hidden)}

    e = cfg.encoder_embedding_dim
    mem = e + cfg.obs_dim + cfg.lat_dim
    half = e // 2
    p: Dict[str, Any] = {
        "embedding": {"weight": w(cfg.n_symbols, cfg.symbols_embedding_dim)},
        "encoder": {"lstm_fwd": lstmcell(half, e), "lstm_bwd": lstmcell(half, e)},
    }
    for i in range(cfg.encoder_n_convolutions):
        cin = cfg.symbols_embedding_dim if i == 0 else e
        p["encoder"][f"conv{i}"] = {"conv": conv(cfg.encoder_kernel_size, cin, e), "bn": bn(e)}
    if cfg.obs_dim > 0:
        p["obs_embedding"] = {"weight": w(cfg.obs_n_class, cfg.obs_dim)}
    n_out = cfg.n_mel_channels * cfg.n_frames_per_step
    p["decoder"] = {
        "prenet": {"layer0": lin(cfg.prenet_dim, n_out, bias=False),
                   "layer1": lin(cfg.prenet_dim, cfg.prenet_dim, bias=False)},
        "attention_rnn": lstmcell(cfg.attention_rnn_dim, cfg.prenet_dim + e),
        "attention": {
            "query": lin(cfg.attention_dim, cfg.attention_rnn_dim, bias=False),
            "memory": lin(cfg.attention_dim, e, bias=False),
            "v": lin(1, cfg.attention_dim, bias=False),
            "location_conv": conv(cfg.attention_location_kernel_size, 2,
                                  cfg.attention_location_n_filters, bias=False),
            "location_dense": lin(cfg.attention_dim, cfg.attention_location_n_filters,
                                  bias=False),
        },
        "decoder_rnn": lstmcell(cfg.decoder_rnn_dim, cfg.attention_rnn_dim + mem),
        "linear_projection": lin(n_out, cfg.decoder_rnn_dim + mem),
        "gate": lin(1, cfg.decoder_rnn_dim + mem),
    }
    pn: Dict[str, Any] = {}
    for i in range(cfg.postnet_n_convolutions):
        cin = cfg.n_mel_channels if i == 0 else cfg.postnet_embedding_dim
        cout = (cfg.n_mel_channels if i == cfg.postnet_n_convolutions - 1
                else cfg.postnet_embedding_dim)
        pn[f"conv{i}"] = {"conv": conv(cfg.postnet_kernel_size, cin, cout), "bn": bn(cout)}
    p["postnet"] = pn
    return p


def _t(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _conv_p(sd, prefix, bias=True) -> Dict:
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _lin_p(sd, prefix) -> Dict:
    out = {"weight": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _bn_p(sd, prefix) -> Dict:
    return {k: _t(sd[f"{prefix}.{k}"]) for k in ("weight", "bias", "running_mean", "running_var")}


def _lstmcell_p(sd, prefix) -> Dict:
    return {"weight_ih": _t(sd[f"{prefix}.weight_ih"]), "weight_hh": _t(sd[f"{prefix}.weight_hh"]),
            "bias": _t(sd[f"{prefix}.bias_ih"]) + _t(sd[f"{prefix}.bias_hh"])}


def _lstm_dir_p(sd, prefix, suffix="") -> Dict:
    return {"weight_ih": _t(sd[f"{prefix}.weight_ih_l0{suffix}"]),
            "weight_hh": _t(sd[f"{prefix}.weight_hh_l0{suffix}"]),
            "bias": _t(sd[f"{prefix}.bias_ih_l0{suffix}"]) + _t(sd[f"{prefix}.bias_hh_l0{suffix}"])}


def convert_tacotron2(sd: Dict[str, np.ndarray], cfg: Tacotron2Config) -> Dict:
    """torch Tacotron2 state dict ('model_dict', vocoder.py:118-124) -> the
    JAX tree: conv weights to (K, Cin, Cout), LSTM biases folded, the
    BiLSTM split into fwd / bwd cells."""
    p: Dict[str, Any] = {
        "embedding": {"weight": _t(sd["embedding.weight"])},
        "encoder": {"lstm_fwd": _lstm_dir_p(sd, "encoder.lstm"),
                    "lstm_bwd": _lstm_dir_p(sd, "encoder.lstm", "_reverse")},
    }
    for i in range(cfg.encoder_n_convolutions):
        p["encoder"][f"conv{i}"] = {"conv": _conv_p(sd, f"encoder.convolutions.{i}.0.conv"),
                                    "bn": _bn_p(sd, f"encoder.convolutions.{i}.1")}
    if cfg.obs_dim > 0:
        p["obs_embedding"] = {"weight": _t(sd["obs_embedding.weight"])}
    att = "decoder.attention_layer"
    p["decoder"] = {
        "prenet": {"layer0": _lin_p(sd, "decoder.prenet.layers.0.linear_layer"),
                   "layer1": _lin_p(sd, "decoder.prenet.layers.1.linear_layer")},
        "attention_rnn": _lstmcell_p(sd, "decoder.attention_rnn"),
        "attention": {
            "query": _lin_p(sd, f"{att}.query_layer.linear_layer"),
            "memory": _lin_p(sd, f"{att}.memory_layer.linear_layer"),
            "v": _lin_p(sd, f"{att}.v.linear_layer"),
            "location_conv": _conv_p(sd, f"{att}.location_layer.location_conv.conv"),
            "location_dense": _lin_p(sd, f"{att}.location_layer.location_dense.linear_layer"),
        },
        "decoder_rnn": _lstmcell_p(sd, "decoder.decoder_rnn"),
        "linear_projection": _lin_p(sd, "decoder.linear_projection.linear_layer"),
        "gate": _lin_p(sd, "decoder.gate_layer.linear_layer"),
    }
    p["postnet"] = {f"conv{i}": {"conv": _conv_p(sd, f"postnet.convolutions.{i}.0.conv"),
                                 "bn": _bn_p(sd, f"postnet.convolutions.{i}.1")}
                    for i in range(cfg.postnet_n_convolutions)}
    return p
