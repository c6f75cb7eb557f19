"""GSLM-style spoken generation: speech prompt -> units -> unit language
model continuation -> unit vocoder -> speech (counterpart of the root
examples/gslm.py; the textlesslib GSLM example, sample.py / sampler.py,
which samples a pretrained fairseq unit LM and vocodes with Tacotron2 +
WaveGlow). Here the unit LM is a small causal transformer trained for a
few steps on synthetic unit streams from the random tiny stack of
examples/resynthesis.py, then it continues a held-out prompt and the
TacotronVocoder speaks the result. For real files, build the encoder and
vocoder with resynthesis.build_checkpoint_stack and fit `train_ulm` on
units from a corpus: the sampling and vocoding calls are the same.

    python -m unitspeech_tpu_torch.examples.gslm [--device cpu]

`UnitLM` keeps flax's parameter names and layouts (Embed_0.embedding,
pos (1, 2048, d), LayerNorm_<i>, SelfAttention_<i>, Dense_<i>: flax names
each layer's down projection before its up projection), so
utils/params.params_from_jax carries the JAX example's parameters across.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
from torch import nn

from unitspeech_tpu_torch.examples.flax_layers import Dense, LayerNorm, SelfAttention


class UnitLM(nn.Module):
    """Causal transformer LM over discrete units (BOS = vocab_size)."""

    def __init__(self, vocab_size: int, d_model: int = 64, n_heads: int = 2, n_layers: int = 2,
                 ffn: int = 128):
        super().__init__()
        self.vocab_size, self.d_model, self.n_layers = vocab_size, d_model, n_layers
        self.Embed_0 = nn.Module()
        self.Embed_0.embedding = nn.Parameter(torch.zeros(vocab_size + 1, d_model))
        self.pos = nn.Parameter(torch.zeros(1, 2048, d_model))
        for i in range(n_layers):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(d_model))
            self.add_module(f"SelfAttention_{i}", SelfAttention(d_model, n_heads))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(d_model))
            self.add_module(f"Dense_{2 * i}", Dense((ffn,), (d_model,)))
            self.add_module(f"Dense_{2 * i + 1}", Dense((d_model,), (ffn,)))
        self.add_module(f"Dense_{2 * n_layers}", Dense((d_model,), (vocab_size,)))
        self.add_module(f"LayerNorm_{2 * n_layers}", LayerNorm(d_model))

    def reset_parameters(self, generator: torch.Generator):
        """flax's initializers: lecun_normal kernels, zero biases, unit
        LayerNorm scales; the embedding normal(1 / sqrt(d_model)) and the
        positions normal(0.02)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Dense, LayerNorm, SelfAttention)):
                    m.reset(generator)
            e = self.Embed_0.embedding
            e.copy_(torch.randn(e.shape, generator=generator) / math.sqrt(self.d_model))
            self.pos.copy_(0.02 * torch.randn(self.pos.shape, generator=generator))
        return self

    def forward(self, tokens):  # (B, T) -> (B, T, V) logits
        t = tokens.shape[1]
        x = self.Embed_0.embedding[tokens] + self.pos[:, :t]
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))[None, None]
        sub = self.get_submodule
        for i in range(self.n_layers):
            x = x + sub(f"SelfAttention_{i}")(sub(f"LayerNorm_{2 * i}")(x), causal)
            h = sub(f"LayerNorm_{2 * i + 1}")(x)
            x = x + sub(f"Dense_{2 * i}")(torch.relu(sub(f"Dense_{2 * i + 1}")(h)))
        return sub(f"Dense_{2 * self.n_layers}")(sub(f"LayerNorm_{2 * self.n_layers}")(x))


def train_ulm(streams, vocab_size, steps=120, seq_len=64, batch=16, lr=3e-3, seed=0,
              d_model=64, params=None, device="cpu"):
    """Fit the unit LM on 1-D unit arrays with next-token cross-entropy
    under Adam with optax.adam's update, on `device`. The batches are the
    JAX example's: each step's starts drawn by
    numpy.random.default_rng(seed).integers. params: a starting state dict
    (else flax's initializers from `seed`). Returns (lm, final loss)."""
    lm = UnitLM(vocab_size=vocab_size, d_model=d_model)
    if params is None:
        lm.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        lm.load_state_dict(params)
    lm.to(device).train()
    flat = np.concatenate([np.asarray(s, np.int64) for s in streams])
    opt = torch.optim.Adam(lm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(steps):
        starts = rng.integers(0, max(len(flat) - seq_len, 1), batch)
        toks = torch.from_numpy(np.stack([flat[s:s + seq_len] for s in starts])).to(device)
        # input: BOS + tokens[:-1]; target: tokens
        inp = torch.cat([torch.full_like(toks[:, :1], vocab_size), toks[:, :-1]], dim=1)
        opt.zero_grad(set_to_none=True)
        logp = torch.log_softmax(lm(inp), dim=-1)
        loss = -torch.gather(logp, 2, toks[..., None]).mean()
        loss.backward()
        opt.step()
    return lm.eval(), loss.item()


@torch.no_grad()
def sample_continuation(lm: UnitLM, prefix, n_new: int, temperature: float = 0.8,
                        seed: int = 0) -> np.ndarray:
    """Temperature-sample `n_new` units after `prefix` (the temperature
    floored at 1e-4, as in JAX), each step over the whole fixed-length
    buffer as the JAX example's scan runs it; torch.multinomial on a
    generator seeded with `seed` on the LM's device."""
    dev = lm.pos.device
    prefix = np.asarray(prefix, np.int64)
    total = len(prefix) + n_new
    buf = torch.zeros(total + 1, dtype=torch.long, device=dev)
    buf[0] = lm.vocab_size
    buf[1:1 + len(prefix)] = torch.from_numpy(prefix).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(1 + len(prefix), total + 1):
        logits = lm(buf[None, :-1])[0, i - 1] / max(temperature, 1e-4)
        buf[i] = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=gen)[0]
    return buf[1 + len(prefix):].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser("gslm")
    ap.add_argument("--prompt", default=None, help="prompt wav")
    ap.add_argument("--output", default="gslm_continuation.wav")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="speech to generate after the prompt")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--train-steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch.cli import _device
    from unitspeech_tpu_torch.examples.resynthesis import build_tiny_stack
    from unitspeech_tpu_torch.utils.audio import load_wav, write_wav
    from unitspeech_tpu_torch.utils.precision import strict_f32

    dev = _device(args.device)
    with strict_f32():
        encoder, voc, _name, vocab = build_tiny_stack(device=dev)
        # a synthetic corpus: harmonic utterances through the encoder
        rng = np.random.default_rng(0)
        t = np.arange(16000) / 16000.0
        streams = []
        for i in range(8):
            f0 = 100 + 20 * i
            wav = (0.4 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * np.sin(6 * t)))
                   + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
            streams.append(encoder(wav)["units"])
        lm, loss = train_ulm(streams, vocab, steps=args.train_steps, device=dev)
        print(f"ULM trained: final next-unit CE {loss:.3f} "
              f"(uniform would be {np.log(vocab):.3f})")
        if args.prompt:
            wav, sr = load_wav(args.prompt)
            wav = encoder.maybe_resample(wav, sr)
        else:
            wav = (0.4 * np.sin(2 * np.pi * 130 * t[:8000])).astype(np.float32)
        prompt_units = np.asarray(encoder(wav)["units"])
        # deduplicated units at about half the 50 Hz frame rate
        n_new = max(int(args.seconds * 16000 / encoder.code_hop_size / 2), 8)
        cont = sample_continuation(lm, prompt_units, n_new, temperature=args.temperature)
        full = np.concatenate([prompt_units, cont])
        print(f"prompt {prompt_units.size} units -> +{cont.size} sampled: "
              f"{' '.join(map(str, cont[:24]))}{' ...' if cont.size > 24 else ''}")
        out = voc(" ".join(str(u) for u in full))
    write_wav(args.output, out, 22050)
    print(f"continuation -> {args.output} ({out.shape[0] / 22050:.2f}s)")
    return loss, prompt_units, cont


if __name__ == "__main__":
    main()
