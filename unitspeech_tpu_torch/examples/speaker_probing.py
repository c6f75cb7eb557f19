"""Speaker probing over discrete units: how much speaker identity survives
quantization? (counterpart of the root examples/speaker_probing.py; the
textlesslib speaker-probing example, probes.py / train.py): small
transformer probes learn the speaker from (a) the discrete unit stream and
(b) the dense SSL features of the same utterances, against a
constant-prediction baseline. The published finding: units carry much less
speaker information than the features they quantize.

The demo corpus is synthetic, two "speakers" at two F0 ranges encoded by a
tiny random HuBERT + k-means; --hubert / --kmeans take real files.

    python -m unitspeech_tpu_torch.examples.speaker_probing [--device cpu]

`Probe` keeps flax's parameter names and layouts (Embed_0.embedding,
Dense_<i>.kernel (in, out), bos, LayerNorm_<i>, SelfAttention_<i>'s
query / key / value / out with a heads axis), so utils/params.params_from_jax
carries a JAX probe's parameters across; its attention is plain PyTorch.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
from torch import nn

from unitspeech_tpu_torch.examples.flax_layers import Dense, LayerNorm, SelfAttention


class Probe(nn.Module):
    """Transformer probe with a BOS readout (reference probes.py
    Classifier): the discrete form (vocab_size > 0) embeds unit IDs, the
    continuous one projects in_features-wide dense features; a learned BOS
    column is prepended and its final state classifies. Submodules are
    named as flax names them, in call order."""

    def __init__(self, n_classes: int, vocab_size: int = 0, in_features: int = 0,
                 d_model: int = 32, n_heads: int = 2, n_layers: int = 1, ffn: int = 64):
        super().__init__()
        self.d_model, self.vocab_size = d_model, vocab_size
        n_dense = 0

        def dense(din, dout) -> str:
            nonlocal n_dense
            name = f"Dense_{n_dense}"
            self.add_module(name, Dense((din,), (dout,)))
            n_dense += 1
            return name

        if vocab_size:
            self.Embed_0 = nn.Module()
            self.Embed_0.embedding = nn.Parameter(torch.zeros(vocab_size, d_model))
        else:
            self.proj = dense(in_features, d_model)
        self.bos = nn.Parameter(torch.zeros(d_model))
        # each layer's submodules by name: (LayerNorm, SelfAttention,
        # LayerNorm, Dense up, Dense down)
        self.layer_names = []
        for i in range(n_layers):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(d_model))
            self.add_module(f"SelfAttention_{i}", SelfAttention(d_model, n_heads))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(d_model))
            self.layer_names.append((f"LayerNorm_{2 * i}", f"SelfAttention_{i}",
                                     f"LayerNorm_{2 * i + 1}", dense(d_model, ffn),
                                     dense(ffn, d_model)))
        self.head = dense(d_model, n_classes)

    def reset_parameters(self, generator: torch.Generator):
        """flax's initializers: lecun_normal kernels, zero biases, unit
        LayerNorm scales, the embedding normal(1 / sqrt(d_model)), the BOS
        column normal(0.02)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Dense, LayerNorm, SelfAttention)):
                    m.reset(generator)
            if self.vocab_size:
                e = self.Embed_0.embedding
                e.copy_(torch.randn(e.shape, generator=generator) / math.sqrt(self.d_model))
            self.bos.copy_(0.02 * torch.randn(self.bos.shape, generator=generator))
        return self

    def forward(self, units, dense, lengths):
        """units (B, T) ids, dense (B, T, D), lengths (B,) -> (B, n_classes)
        log-probabilities."""
        b, t = units.shape
        d = self.d_model
        if self.vocab_size:
            x = self.Embed_0.embedding[units] * math.sqrt(d)
        else:
            x = self.get_submodule(self.proj)(dense)
        pos = np.zeros((t + 1, d), np.float32)
        i = np.arange(t + 1)[:, None]
        div = np.exp(np.arange(0, d, 2) / d * -np.log(10000.0))
        pos[:, 0::2] = np.sin(i * div)
        pos[:, 1::2] = np.cos(i * div)
        x = torch.cat([self.bos.expand(b, 1, d), x], dim=1) + torch.from_numpy(pos).to(x.device)
        valid = torch.arange(t + 1, device=x.device)[None, :] <= lengths[:, None]  # BOS + seq
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        for names in self.layer_names:
            ln1, att, ln2, up, down = map(self.get_submodule, names)
            x = x + att(ln1(x), mask)
            x = x + down(torch.relu(up(ln2(x))))
        return torch.log_softmax(self.get_submodule(self.head)(x[:, 0]), dim=-1)


def make_corpus(encoder, n_per_speaker=12, seconds=0.75, seed=0):
    """Two synthetic 'speakers' distinguished by F0 range, through the
    unit encoder: (units (N, T), dense (N, T, D), lengths (N,), labels)."""
    rng = np.random.default_rng(seed)
    sr = encoder.expected_sample_rate
    t = np.arange(int(seconds * sr)) / sr
    rows = []
    for spk, f0_base in enumerate((110.0, 260.0)):
        for _ in range(n_per_speaker):
            f0 = f0_base * (1 + 0.1 * rng.standard_normal())
            vib = 1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
            wav = (0.4 * np.sin(2 * np.pi * f0 * vib * t)
                   + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
            s = encoder(wav)
            rows.append((np.asarray(s["units"]), np.asarray(s["dense"]), spk))
    rng.shuffle(rows)
    t_max = max(r[0].size for r in rows)
    d = rows[0][1].shape[-1]
    units = np.zeros((len(rows), t_max), np.int32)
    dense = np.zeros((len(rows), t_max, d), np.float32)
    lengths = np.zeros((len(rows),), np.int32)
    labels = np.array([r[2] for r in rows], np.int32)
    for i, (u, f, _) in enumerate(rows):
        n = min(u.size, f.shape[0])
        units[i, :n] = u[:n]
        dense[i, :n] = f[:n]
        lengths[i] = n
    return units, dense, lengths, labels


def train_probe(probe: Probe, batch, labels, steps: int = 60, lr: float = 3e-3, seed: int = 0,
                init: bool = True):
    """Full-batch training of `probe` (on its batch's device), in place:
    the negative log-likelihood under Adam with optax.adam's update
    (m_hat / (sqrt(v_hat) + 1e-8)). init: draw the parameters from `seed`
    first (False keeps the loaded ones). Returns (accuracy after the last
    step, the last step's loss)."""
    if init:
        probe.reset_parameters(torch.Generator().manual_seed(seed))
    probe.to(batch[0].device).train()
    opt = torch.optim.Adam(probe.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rows = torch.arange(labels.shape[0], device=labels.device)
    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = -probe(*batch)[rows, labels].mean()
        loss.backward()
        opt.step()
    with torch.no_grad():
        acc = (probe(*batch).argmax(-1) == labels).float().mean().item()
    return acc, loss.item()


def _random_encoder(device):
    """The tiny random HuBERT (hubert_test_config, layer 2) + 16 centroids,
    without deduplication."""
    from unitspeech_tpu_torch.models.ssl.hubert import (
        HubertFeatureReader,
        HubertModel,
        hubert_test_config,
    )
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.tools.ssl_reference import Draw, ssl_encoder_sd
    from unitspeech_tpu_torch.utils.artifacts import load_hubert_params

    hcfg = hubert_test_config()
    draw = Draw(0)
    ssl_encoder_sd(draw, hcfg)
    model = HubertModel(hcfg)
    model.load_state_dict(load_hubert_params({"model": draw.sd}, hcfg))
    centers = np.random.default_rng(0).standard_normal((16, hcfg.embed_dim)).astype(np.float32)
    return SpeechEncoder(HubertFeatureReader(model.to(device).eval().requires_grad_(False),
                                             layer=2), KMeansQuantizer(centers),
                         deduplicate=False)


def main(argv=None):
    ap = argparse.ArgumentParser("speaker_probing")
    ap.add_argument("--hubert", default=None)
    ap.add_argument("--kmeans", default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n-per-speaker", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch.cli import _device, build_unit_extractor
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.utils.precision import strict_f32

    dev = _device(args.device)
    with strict_f32():
        if args.hubert:
            encoder = build_unit_extractor(args.hubert, args.kmeans, MainConfig(), dev)
        else:
            encoder = _random_encoder(dev)
        units, dense, lengths, labels = make_corpus(encoder, n_per_speaker=args.n_per_speaker)
        batch = (torch.from_numpy(units).long().to(dev), torch.from_numpy(dense).to(dev),
                 torch.from_numpy(lengths).long().to(dev))
        y = torch.from_numpy(labels).long().to(dev)
        n_classes = int(labels.max()) + 1
        baseline = float(np.bincount(labels).max() / labels.size)
        disc_acc, _ = train_probe(Probe(n_classes, vocab_size=encoder.vocab_size), batch, y,
                                  steps=args.steps)
        cont_acc, _ = train_probe(Probe(n_classes, in_features=dense.shape[-1]), batch, y,
                                  steps=args.steps)
    print(f"constant baseline: {baseline:.3f}")
    print(f"discrete-units probe: {disc_acc:.3f}")
    print(f"continuous-features probe: {cont_acc:.3f}")
    return baseline, disc_acc, cont_acc


if __name__ == "__main__":
    main()
