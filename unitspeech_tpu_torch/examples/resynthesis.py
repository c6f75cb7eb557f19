"""Discrete resynthesis: wav -> units -> Tacotron2 -> WaveGlow -> wav
(counterpart of the root examples/resynthesis.py; the textlesslib
resynthesis example, resynth.py): encode speech into units with an SSL
dense model and k-means, report the discrete stream's bitrate, then
resynthesize a waveform from the units alone through the unit vocoder
(infer/unit_vocoder.TacotronVocoder: Tacotron2 decode -> WaveGlow at sigma
0.666 -> the spectral denoiser).

Two modes:
  * default: a random-weight stack at test sizes (no files needed);
  * --hubert / --kmeans / --tacotron / --waveglow / --code-dict: checkpoints
    in the reference's formats ('hubert-base-ls960',
    'hubert-base-ls960-kmeans-100', '...-kmeans-100-tacotron',
    '...-tacotron-codes', 'waveglow'); --dense-model cpc-big-ll6k reads a CPC
    checkpoint through --hubert.

    python -m unitspeech_tpu_torch.examples.resynthesis [--input in.wav]
        [--output out.wav] [--device cpu]

The card unless --device cpu.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# Unigram token entropies (bits) on the LibriLight-6k train split, as
# published with the reference example (resynth.py:60-71): data constants,
# so that the bitrates are comparable
UNIGRAM_ENTROPY = {
    "hubert-base-ls960": {50: 5.4585, 100: 6.4451, 200: 7.4771},
    "cpc-big-ll6k": {50: 5.4283, 100: 6.4131, 200: 7.4425},
}


def bitrates(dense_model: str, n_units: int, vocab_size: int, seconds: float):
    """(uniform bps, unigram bps or None) of the deduplicated unit stream
    (reference get_compression_rate, resynth.py:50-76)."""
    uniform = float(np.log2(vocab_size)) * n_units / seconds
    unigram_h = UNIGRAM_ENTROPY.get(dense_model, {}).get(vocab_size)
    unigram = unigram_h * n_units / seconds if unigram_h else None
    return uniform, unigram


def build_tiny_stack(seed: int = 0, device="cpu"):
    """The random-weight stack at test sizes, as the JAX example builds it:
    a tiny HuBERT (hubert_test_config, layer 2; its weights drawn by
    tools/ssl_reference, JAX's from flax's init) with 8 centroids from
    numpy.random.default_rng(seed), deduplicated; Tacotron2 and WaveGlow at
    the JAX example's test sizes with its numpy draws (seeds seed + 1 and
    seed + 2). Returns (encoder, vocoder, name, vocab)."""
    from unitspeech_tpu_torch.infer.unit_vocoder import TacotronInput, TacotronVocoder
    from unitspeech_tpu_torch.models.ssl.hubert import (
        HubertFeatureReader,
        HubertModel,
        hubert_test_config,
    )
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.models.tacotron2 import (
        Tacotron2,
        random_tacotron2_params,
        tacotron2_test_config,
    )
    from unitspeech_tpu_torch.models.waveglow import (
        WaveGlow,
        random_waveglow_params,
        waveglow_test_config,
    )
    from unitspeech_tpu_torch.tools.ssl_reference import Draw, ssl_encoder_sd
    from unitspeech_tpu_torch.utils.artifacts import load_hubert_params
    from unitspeech_tpu_torch.utils.params import params_from_jax

    vocab = 8
    hcfg = hubert_test_config()
    draw = Draw(seed)
    ssl_encoder_sd(draw, hcfg)
    hmodel = HubertModel(hcfg)
    hmodel.load_state_dict(load_hubert_params({"model": draw.sd}, hcfg))
    centers = np.random.default_rng(seed).standard_normal((vocab, hcfg.embed_dim))
    encoder = SpeechEncoder(HubertFeatureReader(hmodel.to(device).eval().requires_grad_(False),
                                                layer=2),
                            KMeansQuantizer(centers.astype(np.float32)), deduplicate=True)

    taco_cfg = tacotron2_test_config(n_symbols=vocab + 4, gate_threshold=1.1,
                                     max_decoder_steps=32)
    tacotron = Tacotron2(taco_cfg)
    tacotron.load_state_dict(params_from_jax(random_tacotron2_params(taco_cfg, seed=seed + 1)))
    wg_cfg = waveglow_test_config(n_mel_channels=taco_cfg.n_mel_channels, n_flows=3,
                                  n_channels=8)
    waveglow = WaveGlow(wg_cfg)
    waveglow.load_state_dict(params_from_jax(random_waveglow_params(wg_cfg, seed=seed + 2)))
    code_dict = {"_": 0, **{str(c): c + 1 for c in range(vocab)}}
    voc = TacotronVocoder(tacotron.to(device).eval(), waveglow.to(device).eval(),
                          TacotronInput(code_dict), max_decoder_steps=32, denoiser_n_fft=32)
    return encoder, voc, "tiny-random", vocab


def build_checkpoint_stack(args, device):
    """The reference's files: the dense model through cli
    build_unit_extractor (mHuBERT, or CPC for cpc* names at the default
    config's layer), the vocoder through TacotronVocoder.from_torch."""
    import dataclasses

    from unitspeech_tpu_torch.cli import build_unit_extractor
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.infer.unit_vocoder import TacotronVocoder

    cfg = MainConfig()
    cfg = dataclasses.replace(cfg, unit_extractor=dataclasses.replace(
        cfg.unit_extractor, dense_model_name=args.dense_model))
    encoder = build_unit_extractor(args.hubert, args.kmeans, cfg, device)
    voc = TacotronVocoder.from_torch(args.tacotron, args.code_dict, args.waveglow, device=device)
    return encoder, voc, args.dense_model, encoder.vocab_size


def default_wav(seconds: float = 1.0) -> np.ndarray:
    """A synthetic harmonic 16 kHz utterance (the JAX example's)."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.4 * np.sin(2 * np.pi * (120 + 30 * np.sin(4 * t)) * t)
            * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("resynthesis")
    ap.add_argument("--input", default=None,
                    help="input wav (default: a synthetic harmonic 16 kHz utterance)")
    ap.add_argument("--output", default="resynth.wav")
    ap.add_argument("--dense-model", default="hubert-base-ls960", choices=list(UNIGRAM_ENTROPY))
    ap.add_argument("--hubert", default=None)
    ap.add_argument("--kmeans", default=None)
    ap.add_argument("--tacotron", default=None)
    ap.add_argument("--waveglow", default=None)
    ap.add_argument("--code-dict", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch.cli import _device
    from unitspeech_tpu_torch.utils.audio import load_wav, write_wav
    from unitspeech_tpu_torch.utils.precision import strict_f32

    dev = _device(args.device)
    with strict_f32():
        if args.hubert:
            encoder, voc, model_name, vocab = build_checkpoint_stack(args, dev)
        else:
            encoder, voc, model_name, vocab = build_tiny_stack(device=dev)
        if args.input:
            wav, sr = load_wav(args.input)
            wav = encoder.maybe_resample(wav, sr)
        else:
            wav = default_wav()
        t0 = time.perf_counter()
        units = np.asarray(encoder(wav)["units"])
        seconds = len(wav) / encoder.expected_sample_rate
        uniform_bps, unigram_bps = bitrates(model_name, units.size, vocab, seconds)
        print(f"units ({units.size} @ {vocab}-vocab): "
              f"{' '.join(map(str, units[:24]))}{' ...' if units.size > 24 else ''}")
        print(f"bitrate: uniform {uniform_bps:.1f} bps"
              + (f", unigram {unigram_bps:.1f} bps" if unigram_bps else ""))
        out = voc(" ".join(str(u) for u in units))
        wall = time.perf_counter() - t0
    write_wav(args.output, out, 22050)
    print(f"resynthesized {out.shape[0] / 22050:.2f}s -> {args.output}")
    return {"units": units, "uniform_bps": uniform_bps, "unigram_bps": unigram_bps,
            "samples": int(out.shape[0]), "input_s": seconds, "wall_s": wall}


if __name__ == "__main__":
    main()
