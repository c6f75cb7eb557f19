"""Transformer encoder of the SSL speech models (counterpart of
unitspeech_tpu/models/ssl/transformer.py; fairseq/unilm
TransformerEncoder):

  * the convolutional positional embedding (k = 128, 16 groups, padding
    k // 2, the trailing frame dropped for an even k; weight norm folded at
    conversion);
  * post-LN (HuBERT) and pre-LN (WavLM-Large) layers;
  * WavLM's gated relative position bias: bucketed relative positions ->
    a per-head bias made in layer 0 and passed on to every layer, gated by
    each query (gru_rel_pos);
  * every layer's hidden state, so that callers take a layer (mHuBERT layer
    6 for units) or a weighted sum of them (ECAPA over WavLM).

Parameters keep flax's names and layouts (models/layers.py). Softmax runs
on f32 scores; the GELUs are exact.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Dense, _param


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 320,
                             max_distance: int = 800) -> torch.Tensor:
    """Bidirectional T5-style buckets (WavLM compute_bias), int32, with the
    JAX package's f32 arithmetic so that the buckets are equal to its."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).to(torch.int32) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.to(torch.float32) / max_exact + 1e-9)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), large)


def _layer_norm(x, norm: Affine):
    return F.layer_norm(x, (x.shape[-1],), *norm.params(), eps=1e-5)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv positional embedding (fairseq pos_conv) and its GELU."""

    def __init__(self, embed_dim: int, kernel_size: int = 128, groups: int = 16):
        super().__init__()
        self.groups = groups
        self.kernel = _param(kernel_size, embed_dim // groups, embed_dim)
        self.bias = _param(embed_dim)

    def forward(self, x):
        k = self.kernel.shape[0]
        y = F.conv1d(x.transpose(1, 2), self.kernel.permute(2, 1, 0), self.bias,
                     padding=k // 2, groups=self.groups).transpose(1, 2)
        if k % 2 == 0:
            y = y[:, :-1]
        return F.gelu(y)


class SSLSelfAttention(nn.Module):
    """Multi-head self-attention, with WavLM's gated relative position bias
    when `gru_rel_pos`. Layer 0 (has_relative_attention_bias) makes the
    (H, T, T) bias from its bucket embedding; forward returns it so that
    the later layers reuse it."""

    def __init__(self, embed_dim: int, num_heads: int, has_relative_attention_bias: bool = False,
                 num_buckets: int = 320, max_distance: int = 800, gru_rel_pos: bool = False):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.gru_rel_pos = gru_rel_pos
        if has_relative_attention_bias:
            self.rel_attn_embed = _param(num_buckets, num_heads)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim))
        if gru_rel_pos:
            self.grep_linear = Dense(embed_dim // num_heads, 8)
            self.grep_a = _param(1, num_heads, 1, 1)

    def forward(self, x, position_bias: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        h = self.num_heads
        d = self.embed_dim // h
        if position_bias is None and hasattr(self, "rel_attn_embed"):
            pos = torch.arange(t, device=x.device)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                               self.max_distance)
            position_bias = self.rel_attn_embed[buckets.long()].permute(2, 0, 1)  # (H, T, T)

        def heads(proj):
            return proj(x).reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if position_bias is not None:
            bias = position_bias[None]
            if self.gru_rel_pos:
                gates = torch.sigmoid(self.grep_linear(q).reshape(b, h, t, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0], gates[..., 1]
                gate = gate_a * (gate_b * self.grep_a[:, :, :, 0] - 1.0) + 2.0
                bias = gate[..., None] * bias
            scores = scores + bias
        attn = torch.softmax(scores.to(torch.float32), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, t, self.embed_dim)
        return self.out_proj(out), position_bias


class SSLEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 layer_norm_first: bool = False, has_relative_attention_bias: bool = False,
                 gru_rel_pos: bool = False, num_buckets: int = 320, max_distance: int = 800):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.self_attn = SSLSelfAttention(embed_dim, num_heads, has_relative_attention_bias,
                                          num_buckets, max_distance, gru_rel_pos)
        self.self_attn_layer_norm = Affine(embed_dim)
        self.final_layer_norm = Affine(embed_dim)
        self.fc1 = Dense(embed_dim, ffn_dim)
        self.fc2 = Dense(ffn_dim, embed_dim)

    def forward(self, x, position_bias=None):
        if self.layer_norm_first:
            y, position_bias = self.self_attn(_layer_norm(x, self.self_attn_layer_norm),
                                              position_bias)
            x = x + y
            x = x + self.fc2(F.gelu(self.fc1(_layer_norm(x, self.final_layer_norm))))
        else:
            y, position_bias = self.self_attn(x, position_bias)
            x = _layer_norm(x + y, self.self_attn_layer_norm)
            x = _layer_norm(x + self.fc2(F.gelu(self.fc1(x))), self.final_layer_norm)
        return x, position_bias


class SSLTransformerEncoder(nn.Module):
    """pos-conv + N layers. forward returns the final output and the hidden
    states: the input to layer 0 (after the positional embedding), then
    each layer's output; `output_layer` stops after that many layers. The
    pre-LN model's final LayerNorm applies only when every layer ran."""

    def __init__(self, embed_dim: int, num_layers: int, num_heads: int, ffn_dim: int,
                 layer_norm_first: bool = False, relative_position_embedding: bool = False,
                 gru_rel_pos: bool = False, num_buckets: int = 320, max_distance: int = 800,
                 conv_pos: int = 128, conv_pos_groups: int = 16):
        super().__init__()
        self.num_layers, self.layer_norm_first = num_layers, layer_norm_first
        self.pos_conv = ConvPositionalEmbedding(embed_dim, conv_pos, conv_pos_groups)
        self.layer_norm = Affine(embed_dim)
        for i in range(num_layers):
            relpos = relative_position_embedding and i == 0
            self.add_module(f"layer_{i}", SSLEncoderLayer(
                embed_dim, num_heads, ffn_dim, layer_norm_first, relpos,
                gru_rel_pos and relative_position_embedding, num_buckets, max_distance))

    def forward(self, x, output_layer: Optional[int] = None):
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = _layer_norm(x, self.layer_norm)
        hidden_states: List[torch.Tensor] = [x]
        position_bias = None
        n = self.num_layers if output_layer is None else output_layer
        for i in range(min(n, self.num_layers)):
            x, position_bias = getattr(self, f"layer_{i}")(x, position_bias)
            hidden_states.append(x)
        if self.layer_norm_first and n == self.num_layers:
            x = _layer_norm(x, self.layer_norm)
        return x, hidden_states
