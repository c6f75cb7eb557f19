"""End-to-end API walkthrough (counterpart of the root examples/demo.py, the
reference's DEMO notebook) on random weights at a small size, so it needs
no checkpoint:

  1. text -> phoneme IDs (pre-phonemized IPA)
  2. guided synthesis (dual CFG) -> wav
  3. batched synthesis
  4. a speaker fine-tune on a "reference" utterance (30 iterations)
  5. unit extraction (HuBERT + k-means) from the synthesized wav
  6. sv56 loudness normalization and wav writing

    python -m unitspeech_tpu_torch.examples.demo [--device cpu] [--output demo_output.wav]

The synthesis runs the CLI's serving routes (the kernels in bf16 with int8
deep convs; on CPU tensors their plain versions); the card unless
--device cpu.
"""

from __future__ import annotations

import argparse

import numpy as np


def demo_config():
    from unitspeech_tpu_torch.config import (
        DataConfig,
        DecoderConfig,
        DurationPredictorConfig,
        EncoderConfig,
        MainConfig,
        VocoderConfig,
    )

    return MainConfig(
        data=DataConfig(n_feats=16),
        text_encoder=EncoderConfig(n_vocab=180, n_feats=16, n_channels=16, filter_channels=32,
                                   n_layers=2, n_heads=2),
        unit_encoder=EncoderConfig(n_vocab=50, n_feats=16, n_channels=16, filter_channels=32,
                                   n_layers=1, n_heads=2),
        duration_predictor=DurationPredictorConfig(in_channels=16, filter_channels=16,
                                                   spk_emb_dim=8),
        decoder=DecoderConfig(n_feats=16, dim=16, dim_mults=(1, 2), groups=4, spk_emb_dim=8),
        vocoder=VocoderConfig(num_mels=16, upsample_rates=(8, 8, 2, 2),
                              upsample_kernel_sizes=(16, 16, 4, 4),
                              upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("demo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default="demo_output.wav")
    args = ap.parse_args(argv)

    import torch

    from unitspeech_tpu_torch.cli import _device
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.models.ssl.hubert import (
        HubertConfig,
        HubertFeatureReader,
        HubertModel,
    )
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.ops import sv56
    from unitspeech_tpu_torch.text import phonemes_to_sequence
    from unitspeech_tpu_torch.tools.ssl_reference import Draw, ssl_encoder_sd
    from unitspeech_tpu_torch.train.finetune import finetune_decoder, prepare_finetune_inputs
    from unitspeech_tpu_torch.utils.artifacts import load_hubert_params
    from unitspeech_tpu_torch.utils.audio import write_wav
    from unitspeech_tpu_torch.utils.params import random_params

    dev = _device(args.device)
    cfg = demo_config()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    print("1) building models (random weights, small config)...")
    ckpt = random_params(cfg, 0)
    synth = Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, use_int8_deep=True))

    print("2) text -> IDs -> guided synthesis...")
    token_ids = phonemes_to_sequence("həloʊ wɜːld, ðɪs ɪz juːnɪtspiːtʃ ɒn eɪtʃ wʌn hʌndɹəd")
    wav, sr, _ = synth(token_ids, gen(1), diffusion_steps=8)
    print(f"   synthesized {len(wav) / sr:.2f}s @ {sr} Hz")

    print("3) batched synthesis...")
    outs = synth.synthesize_batch([token_ids, token_ids[: len(token_ids) // 2]], gen(2),
                                  diffusion_steps=4)
    print(f"   batch of {len(outs)}: {[round(len(w) / s, 2) for w, s in outs]}s")

    print("4) speaker fine-tune...")
    with dev:
        unit_encoder = Encoder.from_config(cfg.unit_encoder)
    unit_encoder.load_state_dict(ckpt["unit_encoder"])
    rng = np.random.default_rng(0)
    mel = rng.uniform(-1, 1, (80, 16)).astype(np.float32)
    units = rng.integers(0, 50, 20)
    durations = rng.integers(2, 6, 20)
    cond_x, y, y_lengths, attn = prepare_finetune_inputs(
        unit_encoder, units, durations, mel, num_downsamplings=cfg.decoder.num_downsamplings)
    _, losses = finetune_decoder(cfg.decoder, ckpt["decoder"], cond_x, y, y_lengths, attn,
                                 synth.models.spk_emb, segment_size=32, n_iters=30,
                                 learning_rate=1e-4, generator=gen(4))
    print(f"   30 iters: loss {losses[:5].mean():.4f} -> {losses[-5:].mean():.4f}")

    print("5) unit extraction (tiny HuBERT + k-means)...")
    hcfg = HubertConfig(conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)), embed_dim=16,
                        num_layers=2, num_heads=2, ffn_dim=32, conv_pos=8, conv_pos_groups=2)
    draw = Draw(5)
    ssl_encoder_sd(draw, hcfg)
    hmodel = HubertModel(hcfg)
    hmodel.load_state_dict(load_hubert_params({"model": draw.sd}, hcfg))
    enc = SpeechEncoder(
        HubertFeatureReader(hmodel.to(dev).eval().requires_grad_(False), layer=2,
                            max_chunk=32000, hop=20),
        KMeansQuantizer(rng.standard_normal((50, 16)).astype(np.float32)))
    out = enc(wav[: min(len(wav), 16000)].astype(np.float32))
    print(f"   {len(out['units'])} units, durations sum {int(out['durations'].sum())}")

    print("6) sv56 normalize + write...")
    wav_n = sv56.normalize(wav, sr)
    write_wav(args.output, wav_n, sr)
    print(f"   wrote {args.output}")
    return {"seconds": len(wav) / sr, "batch_seconds": [len(w) / s for w, s in outs],
            "losses": losses, "units": len(out["units"]), "output": args.output}


if __name__ == "__main__":
    main()
