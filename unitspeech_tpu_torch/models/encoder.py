"""Text / unit encoder (counterpart of unitspeech_tpu/models/encoder.py;
reference encoder.py:253-309): embedding -> conv prenet with residual ->
post-LN transformer with window-limited relative-position attention ->
projection to mel channels. Layout (B, T, C); runs in f32.

Numerics: channel LayerNorm eps 1e-4 (reference encoder.py:13); masked
attention logits filled with -1e4 (encoder.py:134).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Conv1d, Dense
from unitspeech_tpu_torch.ops.masking import sequence_mask


def channel_layer_norm(x, norm: Affine, eps: float = 1e-4):
    gamma, beta = norm.params()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


class ConvReluNorm(nn.Module):
    """Prenet: (conv5 -> LN -> ReLU) x n_layers, residual projection
    (reference encoder.py:33-65). Dropout is off at inference."""

    def __init__(self, c: int, k: int = 5, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(c, c, k))
            self.add_module(f"norm_{i}", Affine(c, ("gamma", "beta")))
        self.proj = Dense(c, c)

    def forward(self, x, x_mask):
        x_org = x
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x * x_mask)
            x = F.relu(channel_layer_norm(x, getattr(self, f"norm_{i}")))
        return (x_org + self.proj(x)) * x_mask


class RelPositionMultiHeadAttention(nn.Module):
    """Self-attention with window-limited relative position bias, heads
    sharing the relative embeddings (reference encoder.py:68-187)."""

    def __init__(self, c: int, n_heads: int, window_size):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        d = c // n_heads
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            self.add_module(name, Dense(c, c))
        if window_size is not None:
            self.emb_rel_k = nn.Parameter(torch.empty(2 * window_size + 1, d))
            self.emb_rel_v = nn.Parameter(torch.empty(2 * window_size + 1, d))

    def forward(self, x, attn_mask):
        b, t, c = x.shape
        h = self.n_heads
        d = c // h

        def heads(z):
            return z.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(d)
        dev = x.device
        if self.window_size is not None:
            w = self.window_size
            r = 2 * w + 1
            qe = torch.einsum("bhid,rd->bhir", q, self.emb_rel_k) / math.sqrt(d)
            rel = (torch.arange(t, device=dev)[None, :] - torch.arange(t, device=dev)[:, None]
                   + w)
            valid = (rel >= 0) & (rel < r)
            gathered = torch.gather(qe, -1, rel.clamp(0, r - 1).expand(b, h, t, t))
            scores = scores + torch.where(valid, gathered, torch.zeros_like(gathered))
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = torch.softmax(scores, dim=-1)
        out = p_attn @ v
        if self.window_size is not None:
            src = (torch.arange(t, device=dev)[:, None] + torch.arange(r, device=dev)[None, :]
                   - w)
            valid = (src >= 0) & (src < t)
            wrel = torch.gather(p_attn, -1, src.clamp(0, t - 1).expand(b, h, t, r))
            wrel = torch.where(valid, wrel, torch.zeros_like(wrel))
            out = out + torch.einsum("bhir,rd->bhid", wrel, self.emb_rel_v)
        return self.conv_o(out.transpose(1, 2).reshape(b, t, c))


class FFN(nn.Module):
    """Conv feed-forward (reference encoder.py:190-211)."""

    def __init__(self, c: int, filter_channels: int, k: int):
        super().__init__()
        self.conv_1 = Conv1d(c, filter_channels, k)
        self.conv_2 = Conv1d(filter_channels, c, k)

    def forward(self, x, x_mask):
        x = F.relu(self.conv_1(x * x_mask))
        return self.conv_2(x * x_mask) * x_mask


class TransformerEncoder(nn.Module):
    """Post-LN transformer stack (reference encoder.py:214-250)."""

    def __init__(self, c, filter_channels, n_heads, n_layers, k, window_size):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RelPositionMultiHeadAttention(c, n_heads, window_size))
            self.add_module(f"norm1_{i}", Affine(c, ("gamma", "beta")))
            self.add_module(f"ffn_{i}", FFN(c, filter_channels, k))
            self.add_module(f"norm2_{i}", Affine(c, ("gamma", "beta")))

    def forward(self, x, x_mask):
        m = x_mask[:, :, 0]
        attn_mask = (m[:, None, :, None] * m[:, None, None, :])
        for i in range(self.n_layers):
            x = x * x_mask
            y = getattr(self, f"attn_{i}")(x, attn_mask)
            x = channel_layer_norm(x + y, getattr(self, f"norm1_{i}"))
            y = getattr(self, f"ffn_{i}")(x, x_mask)
            x = channel_layer_norm(x + y, getattr(self, f"norm2_{i}"))
        return x * x_mask


class Encoder(nn.Module):
    """(tokens (B, T) int, lengths (B,)) -> (mu_x (B, T, n_feats),
    hidden (B, T, C), mask (B, T, 1)). The contentvec input variant belongs
    to the voice-conversion slice."""

    def __init__(self, n_vocab, n_feats, n_channels, filter_channels, n_heads, n_layers,
                 kernel_size, window_size=4):
        super().__init__()
        self.n_channels = n_channels
        self.emb = nn.Module()
        self.emb.embedding = nn.Parameter(torch.empty(n_vocab, n_channels))
        self.prenet = ConvReluNorm(n_channels)
        self.encoder = TransformerEncoder(n_channels, filter_channels, n_heads, n_layers,
                                          kernel_size, window_size)
        self.proj_m = Dense(n_channels, n_feats)

    def forward(self, x, x_lengths):
        hidden = self.emb.embedding[x] * math.sqrt(self.n_channels)
        x_mask = sequence_mask(x_lengths, hidden.shape[1], dtype=hidden.dtype)[:, :, None]
        hidden = self.prenet(hidden, x_mask)
        hidden = self.encoder(hidden, x_mask)
        mu_x = self.proj_m(hidden) * x_mask
        return mu_x, hidden, x_mask

    @classmethod
    def from_config(cls, cfg):
        if cfg.n_contentvec:
            raise NotImplementedError("contentvec encoder input is not ported yet")
        return cls(cfg.n_vocab, cfg.n_feats, cfg.n_channels, cfg.filter_channels,
                   cfg.n_heads, cfg.n_layers, cfg.kernel_size, cfg.window_size)
