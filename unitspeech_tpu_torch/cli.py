"""Command-line entry points of the port (counterpart of
unitspeech_tpu/cli.py for the adaptive-TTS slice).

    python -m unitspeech_tpu_torch.cli make-random-checkpoint --seed 0 --output ckpt.pt
    python -m unitspeech_tpu_torch.cli inference --ipa --text "..." \\
        --checkpoint ckpt.pt --output out.wav --device cuda

A checkpoint is a `torch.save`d dict: one state dict per module in the
port's layout, the speaker embedding, the mel min/max and the config.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import wave

import numpy as np


def write_wav(path: str, data: np.ndarray, sr: int):
    """float [-1, 1] -> 16-bit PCM mono."""
    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def main_make_random_checkpoint(argv=None):
    ap = argparse.ArgumentParser("unitspeech-tpu-torch make-random-checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=None, help="JSON config overlay")
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    import torch

    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.utils.params import random_params

    cfg = load_json(args.config) if args.config else MainConfig()
    torch.save(random_params(cfg, args.seed), args.output)
    print(f"wrote {args.output} (random parameters, seed {args.seed})")
    return 0


def main_inference(argv=None) -> dict:
    """Synthesize one utterance; returns and prints its statistics."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch inference")
    ap.add_argument("--text", required=True, help="pre-phonemized IPA text (with --ipa)")
    ap.add_argument("--ipa", action="store_true",
                    help="text is IPA (required: grapheme input comes in a later slice)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output", default="generated.wav")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--diffusion-steps", type=int, default=None)
    ap.add_argument("--length-scale", type=float, default=None)
    ap.add_argument("--text-gradient-scale", type=float, default=None)
    ap.add_argument("--spk-gradient-scale", type=float, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="force the durations to sum to this many mel frames")
    ap.add_argument("--no-sv56", action="store_true")
    ap.add_argument("--fp32", dest="bf16", action="store_false",
                    help="decoder and vocoder in f32, on the plain path (the kernels take bf16)")
    ap.add_argument("--no-fast-kernels", dest="fast_kernels", action="store_false",
                    help="run the plain PyTorch path instead of the estimator and vocoder "
                         "kernels (default: kernels on in bf16)")
    ap.add_argument("--no-int8", dest="int8", action="store_false",
                    help="keep the estimator's deep-stage convs in bf16 (default: int8 "
                         "whenever the kernels are on, as the JAX serving default)")
    # the JAX package's fused deep-stage configuration (bench.py --deep --i8pre
    # --resample); off by default, as there, and only with the kernels on
    ap.add_argument("--deep", action="store_true",
                    help="whole-layer deep-stage ResnetBlocks (K8, bf16 even with int8 on)")
    ap.add_argument("--i8pre", action="store_true",
                    help="deep blocks with Cout <= 512 as int8 convs on pre-quantized "
                         "activations (K9); routes only with int8 on")
    ap.add_argument("--resample", action="store_true",
                    help="fused stride-2 Downsample/Upsample convs (K11) where they apply")
    args = ap.parse_args(argv)
    if not args.ipa:
        raise SystemExit("grapheme input is not ported yet: pass IPA text with --ipa")

    import torch

    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.ops import sv56
    from unitspeech_tpu_torch.text import phonemes_to_sequence

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda given but no CUDA device is available")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # the JAX serving defaults (unitspeech_tpu/cli.py _load_tts_models):
    # kernels in bf16, and int8 deep convs whenever the kernels are on
    fast = args.bf16 and args.fast_kernels
    routes = dict(use_kernels=fast, use_int8_deep=fast and args.int8,
                  use_deep=fast and args.deep, use_resample=fast and args.resample,
                  use_i8pre_deep=fast and args.int8 and args.i8pre)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    models = TTSModels.from_checkpoint(ckpt, device=device, dtype=dtype, **routes)
    synth = Synthesizer(models)
    token_ids = phonemes_to_sequence(args.text)
    if not token_ids:
        raise SystemExit("text produced no tokens")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    wav, sr = synth(token_ids, gen, forced_total_frames=args.frames,
                    diffusion_steps=args.diffusion_steps, length_scale=args.length_scale,
                    text_gradient_scale=args.text_gradient_scale,
                    spk_gradient_scale=args.spk_gradient_scale)
    wall = time.perf_counter() - t0  # synth returns host data: the device is done
    if wav.size == 0 or not np.isfinite(wav).all():
        raise RuntimeError("synthesis produced an empty or non-finite waveform")
    if not args.no_sv56 and models.cfg.inference.with_sv56_normalization:
        wav = sv56.normalize(wav, sr)
    write_wav(args.output, wav, sr)
    hop = models.cfg.data.hop_length
    seconds = len(wav) / sr
    stats = {"output": args.output, "tokens": len(token_ids), "frames": len(wav) // hop,
             "seconds": seconds, "wall_s": wall, "rtf": wall / seconds if seconds else None,
             "device": str(device), "kernels": fast, "int8": routes["use_int8_deep"],
             "deep": routes["use_deep"], "i8pre": routes["use_i8pre_deep"],
             "resample": routes["use_resample"]}
    print(json.dumps(stats))
    return stats


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"inference": main_inference,
                "make-random-checkpoint": main_make_random_checkpoint}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m unitspeech_tpu_torch.cli {{{','.join(commands)}}} ...",
              file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
