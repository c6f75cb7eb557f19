"""One f32 STEP1 train step on the card against the same step on the CPU,
with the same weights and the same injected draws (the replaced rows, the
dropout masks, the crop's u, the diffusion t and z, all drawn once on the
CPU): the three losses and the three pre-clip gradient norms must agree
within REL. Both run under utils/precision.strict_f32 (no TF32) with
cuDNN's deterministic algorithms, as its weight gradients are not
deterministic otherwise.

    python -m unitspeech_tpu_torch.tools.step_check [--device cuda]

`chip_smoke.py` runs it; `--device cpu` compares the CPU with itself (a
smoke run).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from unitspeech_tpu_torch.config import (
    DecoderConfig,
    DurationPredictorConfig,
    EncoderConfig,
    MainConfig,
)

REL = 1e-4
# a small STEP1 configuration: the reference's mel and segment, narrow modules
SMALL = MainConfig(
    text_encoder=EncoderConfig(n_channels=32, filter_channels=64, n_layers=2),
    duration_predictor=DurationPredictorConfig(in_channels=32, filter_channels=32,
                                               spk_emb_dim=16),
    decoder=DecoderConfig(dim=16, dim_mults=(1, 2), groups=4, spk_emb_dim=16))
B, TX, TY = 4, 32, 256


def _modules(cfg, params, device):
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder

    with torch.device(device):
        mods = {"text_encoder": Encoder.from_config(cfg.text_encoder),
                "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
                "decoder": UnitSpeech.from_config(cfg.decoder)}
    for k, m in mods.items():
        m.load_state_dict(params[k])
    return mods


def inputs(cfg=SMALL, seed: int = 0):
    """(weights, batch, spk_uncond, draws) on the CPU from a seed: flax's
    initializers with the rezero gates and unconditional embeddings made
    non-zero; a batch of B rows of TX tokens and TY mel frames, ragged; one
    step's draws (the dropout masks of a forward with a generator)."""
    from unitspeech_tpu_torch.models.layers import Dropout
    from unitspeech_tpu_torch.utils.params import init_params

    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen)
    for name in ("text_uncon", "spk_uncon"):
        params["decoder"][name].normal_(generator=gen)
    for k in params["decoder"]:
        if k.endswith(".g"):
            params["decoder"][k].fill_(0.1)
    s = cfg.decoder.spk_emb_dim
    spk = torch.randn((B, s), generator=gen)
    batch = {"tokens": torch.randint(1, cfg.text_encoder.n_vocab, (B, TX), generator=gen),
             "token_lengths": torch.tensor([TX, TX - 5, TX - 2, TX - 9]),
             "mel": torch.rand((B, TY, cfg.data.n_feats), generator=gen) * 2 - 1,
             "mel_lengths": torch.tensor([TY, TY - 40, TY - 13, TY - 70]),
             "spk_emb": spk / spk.norm(dim=1, keepdim=True)}
    mods = _modules(cfg, params, "cpu")
    te, dp = Dropout(gen), Dropout(gen)
    with torch.no_grad():
        _, hidden, x_mask = mods["text_encoder"](batch["tokens"], batch["token_lengths"],
                                                 dropout=te)
        mods["duration_predictor"](hidden, x_mask, batch["spk_emb"], dropout=dp)
    draws = {"perm": torch.randperm(B, generator=gen), "te": te.drawn, "dp": dp.drawn,
             "u": torch.rand((B,), generator=gen), "t": torch.rand((B,), generator=gen),
             "z": torch.randn((B, cfg.out_size, cfg.data.n_feats), generator=gen)}
    return params, batch, torch.randn((s,), generator=gen), draws


def step(cfg, params, batch, spk_uncond, draws, device) -> dict:
    """One f32 train step (make_step1_train_step, Adam 1e-4, clipping
    5 / 5 / 2) on `device`; its metrics as floats."""
    from unitspeech_tpu_torch.train.steps import make_step1_train_step
    from unitspeech_tpu_torch.utils.precision import strict_f32

    def to(x):
        return [to(v) for v in x] if isinstance(x, list) else x.to(device)

    mods = _modules(cfg, params, device)
    opt = torch.optim.Adam([p for m in mods.values() for p in m.parameters()], lr=1e-4,
                           betas=(0.9, 0.999), eps=1e-8)
    train = make_step1_train_step(*mods.values(), opt, cfg.out_size, to(spk_uncond))
    det = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    try:
        with strict_f32():
            metrics = train({k: to(v) for k, v in batch.items()},
                            draws={k: to(v) for k, v in draws.items()})
        return {k: float(v) for k, v in metrics.items()}
    finally:
        torch.use_deterministic_algorithms(det[0])
        torch.backends.cudnn.benchmark = det[1]


def card_vs_cpu(device, cfg=SMALL, seed: int = 0) -> dict:
    """The step on `device` and on the CPU; raises if a loss or a norm
    differs by more than REL relative."""
    args = inputs(cfg, seed)
    got, want = step(cfg, *args, device), step(cfg, *args, "cpu")
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    out = {"device": got, "cpu": want, "rel": rel, "max_rel": max(rel.values()), "bound": REL}
    if not all(np.isfinite(v) for v in got.values()) or out["max_rel"] > REL:
        raise AssertionError(f"STEP1 step on {device} vs the CPU: {out}")
    return out


def main(argv=None) -> dict:
    from unitspeech_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser("step_check")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = card_vs_cpu(resolve_device(args.device), seed=args.seed)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
