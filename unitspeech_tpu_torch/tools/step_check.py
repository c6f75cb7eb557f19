"""One f32 train step on the card against the same step on the CPU, with
the same weights and the same injected draws (all drawn once on the CPU):

  * STEP1 (the replaced rows, the dropout masks, the crop's u, the
    diffusion t and z): the three losses and the three pre-clip gradient
    norms within REL;
  * STEP2 (the unit encoder's dropout masks, u, t, z; the decoder frozen):
    the two losses, the total and the pre-clip norm within REL2;
  * one GAN step of BigVGAN (a narrow generator, the full MPD and MRD,
    AdamW at 1e-4): the seven losses, the generator's read after the
    discriminators' update, and the discriminator's gradient norm within
    REL2, the generator's gradient norm within REL. That norm sums the
    gradients of its biases and snake parameters over every sample, where
    they mostly cancel: the same step on the CPU at 1 and at 8 threads
    gives norms 1.1e-4 apart (relative; the losses 8e-6), so REL2 is
    below that norm's own rounding.

Each runs under utils/precision.strict_f32 (no TF32) with cuDNN's
deterministic algorithms, as its weight gradients are not deterministic
otherwise.

    python -m unitspeech_tpu_torch.tools.step_check [--device cuda]

runs the three; `chip_smoke.py` runs each in its training phase;
`--device cpu` compares the CPU with itself (a smoke run).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from unitspeech_tpu_torch.config import (
    DecoderConfig,
    DurationPredictorConfig,
    EncoderConfig,
    MainConfig,
    VocoderConfig,
)

REL = 1e-4
REL2 = 1e-5  # the STEP2 and GAN steps
# a small STEP1 configuration: the reference's mel and segment, narrow modules
SMALL = MainConfig(
    text_encoder=EncoderConfig(n_channels=32, filter_channels=64, n_layers=2),
    duration_predictor=DurationPredictorConfig(in_channels=32, filter_channels=32,
                                               spk_emb_dim=16),
    decoder=DecoderConfig(dim=16, dim_mults=(1, 2), groups=4, spk_emb_dim=16),
    unit_encoder=EncoderConfig(n_vocab=1000, n_channels=32, filter_channels=64, n_layers=2),
    vocoder=VocoderConfig(upsample_initial_channel=64))
B, TX, TY = 4, 32, 256
GAN_BATCH, GAN_SEGMENT = 2, 4096


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


@contextlib.contextmanager
def _exact():
    """strict f32 and deterministic algorithms (cuDNN's included) inside;
    the caller's settings after."""
    from unitspeech_tpu_torch.utils.precision import strict_f32

    det = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    try:
        with strict_f32():
            yield
    finally:
        torch.use_deterministic_algorithms(det[0])
        torch.backends.cudnn.benchmark = det[1]


def _to(x, device):
    return [_to(v, device) for v in x] if isinstance(x, list) else x.to(device)


def step(cfg, params, batch, spk_uncond, draws, device) -> dict:
    """One f32 train step (make_step1_train_step, Adam 1e-4, clipping
    5 / 5 / 2) on `device`; its metrics as floats."""
    from unitspeech_tpu_torch.train.steps import make_step1_train_step

    mods = _modules(cfg, params, device)
    opt = torch.optim.Adam([p for m in mods.values() for p in m.parameters()], lr=1e-4,
                           betas=(0.9, 0.999), eps=1e-8)
    train = make_step1_train_step(*mods.values(), opt, cfg.out_size, _to(spk_uncond, device))
    with _exact():
        metrics = train({k: _to(v, device) for k, v in batch.items()},
                        draws={k: _to(v, device) for k, v in draws.items()})
    return {k: float(v) for k, v in metrics.items()}


def step2_inputs(cfg, seed: int):
    """(weights, batch, draws) of a STEP2 step on the CPU from a seed: the
    unit encoder and the decoder from flax's initializers (rezero gates
    0.1), B rows of TX units with durations filling at most TY frames, one
    step's draws."""
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.models.layers import Dropout
    from unitspeech_tpu_torch.utils.params import init_params

    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, ("unit_encoder", "decoder"))
    for k in params["decoder"]:
        if k.endswith(".g"):
            params["decoder"][k].fill_(0.1)
    lengths = torch.tensor([TX, TX - 5, TX - 2, TX - 9])
    durations = torch.randint(1, 2 * TY // TX, (B, TX), generator=gen).float()
    durations[torch.arange(TX)[None] >= lengths[:, None]] = 0
    spk = torch.randn((B, cfg.decoder.spk_emb_dim), generator=gen)
    batch = {"units": torch.randint(0, cfg.unit_encoder.n_vocab, (B, TX), generator=gen),
             "unit_lengths": lengths, "durations": durations,
             "mel": torch.rand((B, TY, cfg.data.n_feats), generator=gen) * 2 - 1,
             "mel_lengths": durations.sum(1).clamp(max=TY).long(),
             "spk_emb": spk / spk.norm(dim=1, keepdim=True)}
    ue = Encoder.from_config(cfg.unit_encoder)
    ue.load_state_dict(params["unit_encoder"])
    drop = Dropout(gen)
    with torch.no_grad():
        ue(batch["units"], batch["unit_lengths"], dropout=drop)
    draws = {"ue": drop.drawn, "u": torch.rand((B,), generator=gen),
             "t": torch.rand((B,), generator=gen),
             "z": torch.randn((B, cfg.out_size, cfg.data.n_feats), generator=gen)}
    return params, batch, draws


def step2(cfg, params, batch, draws, device) -> dict:
    """One f32 STEP2 step (make_step2_train_step, Adam 1e-4, the clip of 5)
    on `device`; its metrics as floats."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.train.steps import make_step2_train_step

    with torch.device(device):
        ue, dec = Encoder.from_config(cfg.unit_encoder), UnitSpeech.from_config(cfg.decoder)
    ue.load_state_dict(params["unit_encoder"])
    dec.load_state_dict(params["decoder"])
    opt = torch.optim.Adam(ue.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    train = make_step2_train_step(ue, dec, opt, cfg.out_size)
    with _exact():
        metrics = train({k: _to(v, device) for k, v in batch.items()},
                        draws={k: _to(v, device) for k, v in draws.items()})
    return {k: float(v) for k, v in metrics.items()}


def gan_inputs(cfg, seed: int):
    """(the generator's, MPD's and MRD's weights from flax's initializers,
    drawn as GanTrainer draws them, GAN_BATCH segments of GAN_SEGMENT
    samples) on the CPU from a seed."""
    from unitspeech_tpu_torch.models.discriminators import (
        MultiPeriodDiscriminator,
        MultiResolutionDiscriminator,
    )
    from unitspeech_tpu_torch.models.vocoder import BigVGAN
    from unitspeech_tpu_torch.utils.params import init_module

    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        mods = {"vocoder": BigVGAN.from_config(cfg.vocoder), "mpd": MultiPeriodDiscriminator(),
                "mrd": MultiResolutionDiscriminator()}
    params = {name: init_module(m, gen, cfg.vocoder.snake_logscale) for name, m in mods.items()}
    t = torch.arange(GAN_SEGMENT, dtype=torch.float32)
    f = torch.rand((GAN_BATCH, 1), generator=gen) * 0.2 + 0.02
    wav = 0.5 * torch.sin(f * t) + 0.05 * torch.randn((GAN_BATCH, GAN_SEGMENT), generator=gen)
    return params, wav


def gan_step(cfg, params, wav, device) -> dict:
    """One fused f32 GAN step (AdamW at 1e-4, betas (0.8, 0.99), weight
    decay 1e-4, the clip of 1000 on each side) on `device`; its metrics as
    floats."""
    from unitspeech_tpu_torch.models.discriminators import (
        MultiPeriodDiscriminator,
        MultiResolutionDiscriminator,
    )
    from unitspeech_tpu_torch.models.vocoder import BigVGAN
    from unitspeech_tpu_torch.train.vocoder_gan import make_fused_vocoder_gan_step
    from unitspeech_tpu_torch.train.vocoder_loop import ADAM_BETAS, WEIGHT_DECAY

    with torch.device(device):
        mods = {"vocoder": BigVGAN.from_config(cfg.vocoder), "mpd": MultiPeriodDiscriminator(),
                "mrd": MultiResolutionDiscriminator()}
    for k, m in mods.items():
        m.load_state_dict(params[k])

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=1e-4, betas=ADAM_BETAS, eps=1e-8,
                                 weight_decay=WEIGHT_DECAY)

    fused = make_fused_vocoder_gan_step(
        mods["vocoder"], mods["mpd"], mods["mrd"], adamw(mods["vocoder"].parameters()),
        adamw([p for k in ("mpd", "mrd") for p in mods[k].parameters()]), cfg.data)
    with _exact():
        metrics = fused(wav.to(device))
    return {k: float(v) for k, v in metrics.items()}


def _compare(what, got, want, bound, bounds=None) -> dict:
    """Each metric's relative difference; raises past `bound` (or its entry
    in `bounds`). max_rel is over the metrics held to `bound`."""
    bounds = bounds or {}
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    out = {"device": got, "cpu": want, "rel": rel, "bound": bound, "bounds": bounds,
           "max_rel": max(v for k, v in rel.items() if k not in bounds)}
    if not all(np.isfinite(v) for v in got.values()) or any(
            v > bounds.get(k, bound) for k, v in rel.items()):
        raise AssertionError(f"{what} vs the CPU: {out}")
    return out


def card_vs_cpu(device, cfg=SMALL, seed: int = 0) -> dict:
    """The STEP1 step on `device` and on the CPU; raises if a loss or a norm
    differs by more than REL relative."""
    args = inputs(cfg, seed)
    return _compare(f"STEP1 step on {device}", step(cfg, *args, device), step(cfg, *args, "cpu"),
                    REL)


def card_vs_cpu_step2(device, seed: int = 0) -> dict:
    """The STEP2 step (SMALL) on `device` and on the CPU; raises beyond REL2."""
    args = step2_inputs(SMALL, seed)
    return _compare(f"STEP2 step on {device}", step2(SMALL, *args, device),
                    step2(SMALL, *args, "cpu"), REL2)


def card_vs_cpu_gan(device, seed: int = 0) -> dict:
    """The GAN step (SMALL) on `device` and on the CPU; raises beyond REL2
    (the generator's gradient norm beyond REL)."""
    args = gan_inputs(SMALL, seed)
    return _compare(f"GAN step on {device}", gan_step(SMALL, *args, device),
                    gan_step(SMALL, *args, "cpu"), REL2, {"gen_grad_norm": REL})


def main(argv=None) -> dict:
    from unitspeech_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser("step_check")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {name: check(dev, seed=args.seed) for name, check in (
        ("step1", card_vs_cpu), ("step2", card_vs_cpu_step2), ("gan", card_vs_cpu_gan))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
