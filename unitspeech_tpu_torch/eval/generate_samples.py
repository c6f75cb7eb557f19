"""Evaluation sample generation with RTF accounting (counterpart of the
root evaluation/generate_samples.py; the reference's
evaluation/evaluation_generate_samples.py, including its per-speaker
orchestration, :150-353): for each speaker of a reference filelist,
`cli finetune` adapts the base decoder to that speaker's reference wav,
then the adapted decoder synthesizes the speaker's eval sentences, each
request timed until its waveform is on the host (processing_time.npy /
speech_duration.npy, as the reference saves them).

  # flat: one decoder synthesizes a sentence list
  python -m unitspeech_tpu_torch.eval.generate_samples --sentences synthesis.txt \\
      --decoder dec.pt --text-encoder te.pt --duration-predictor dp.pt --vocoder voc.pt \\
      --out-dir eval_out

  # per-speaker: fine-tune, then synthesize, speaker by speaker
  python -m unitspeech_tpu_torch.eval.generate_samples \\
      --reference-filelist refs.txt --eval-filelist eval.txt \\
      --decoder base.pt --unit-encoder ue.pt --text-encoder te.pt \\
      --duration-predictor dp.pt --vocoder voc.pt --speaker-embedder spk.pt \\
      --hubert hubert.pt --kmeans kmeans.npz --out-dir eval_out

Each module flag takes a reference `.pt`, a port file or the port's
combined checkpoint (`cli make-random-checkpoint`). Filelists are
`path|text|speaker_id` lines. The samples are synthesized on the card with
the CLI's serving routes (the kernels in bf16, int8 deep convs; the route
flags of `cli inference` switch them) unless `--device cpu`; `--device` is
passed on to `cli finetune`. `cli evaluate` scores the directory.
"""

from __future__ import annotations

import argparse
import json
import os
import types


def _token_sequences(sentences, args):
    """IPA (--ipa) or graphemes through espeak, else the rule G2P of the
    language, as `cli inference` phonemizes."""
    from unitspeech_tpu_torch import text as text_frontend

    if args.ipa:
        return [text_frontend.phonemes_to_sequence(s) for s in sentences]
    ph = text_frontend.get_phonemizer(args.language, fallback=True)
    if ph is None:
        raise SystemExit(f"espeak-ng not installed and no G2P fallback for {args.language!r}: "
                         "use --ipa")
    return [text_frontend.text_to_sequence(s, ph) for s in sentences]


def _synthesize_set(args, decoder_path, sentences, out_dir, seed):
    """A Synthesizer for `decoder_path` and the other module flags; generate
    `sentences` into out_dir."""
    import torch

    from unitspeech_tpu_torch.cli import _device, _load_tts_models, route_switches
    from unitspeech_tpu_torch.eval.harness import generate_eval_samples
    from unitspeech_tpu_torch.infer.tts import Synthesizer

    margs = types.SimpleNamespace(**vars(args))
    margs.decoder, margs.checkpoint = decoder_path, None
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    models = _load_tts_models(margs, _device(args.device), dtype, route_switches(args))
    return generate_eval_samples(
        Synthesizer(models), _token_sequences(sentences, args), out_dir, seed,
        diffusion_steps=args.diffusion_steps, text_gradient_scale=args.text_gradient_scale,
        spk_gradient_scale=args.spk_gradient_scale)


def _per_speaker(args) -> dict:
    """Per speaker: `cli finetune` on the reference wav, then that speaker's
    eval utterances with the adapted decoder (reference
    evaluation_generate_samples.py:150-353)."""
    import numpy as np

    from unitspeech_tpu_torch.cli import main_finetune
    from unitspeech_tpu_torch.data.dataset import parse_filelist
    from unitspeech_tpu_torch.eval.harness import EvalTimings, rtf_summary

    by_spk = {}
    for entry in parse_filelist(args.eval_filelist):
        path, text, spk = (entry + ["0"])[:3]
        by_spk.setdefault(spk, []).append((path, text))

    all_proc, all_speech = [], []
    per_speaker = {}
    for entry in parse_filelist(args.reference_filelist):
        ref_path, _text, spk = (entry + ["0"])[:3]
        rows = by_spk.get(spk, [])
        if not rows:
            print(f"speaker {spk}: no eval utterances, skipping")
            continue
        ft_args = ["--reference", ref_path, "--decoder", args.decoder, "--unit-encoder",
                   args.unit_encoder, "--output-dir", os.path.join(args.out_dir, f"finetune_{spk}"),
                   "--n-iters", str(args.finetune_iters), "--seed", str(args.seed),
                   "--device", args.device]
        if args.config:
            ft_args += ["--config", args.config]
        if not args.bf16:
            ft_args += ["--fp32"]
        for flag, val in (("--speaker-embedder", args.speaker_embedder),
                          ("--hubert", args.hubert), ("--kmeans", args.kmeans),
                          ("--spk-emb", args.spk_emb), ("--units", args.units)):
            if val:
                ft_args += [flag, val]
        print(f"speaker {spk}: fine-tuning on {ref_path}")
        adapted = main_finetune(ft_args)["output"]
        timings = _synthesize_set(args, adapted, [t for _p, t in rows],
                                  os.path.join(args.out_dir, f"speaker_{spk}"), args.seed)
        per_speaker[spk] = rtf_summary(timings)
        all_proc.append(timings.processing_time)
        all_speech.append(timings.speech_duration)

    if not all_proc:
        raise SystemExit("no speakers evaluated")
    total = EvalTimings(np.concatenate(all_proc), np.concatenate(all_speech))
    # the reference saves these arrays as .npy (:352-353)
    np.save(os.path.join(args.out_dir, "processing_time.npy"), total.processing_time)
    np.save(os.path.join(args.out_dir, "speech_duration.npy"), total.speech_duration)
    summary = rtf_summary(total)
    summary["per_speaker"] = per_speaker
    return summary


def main(argv=None) -> dict:
    from unitspeech_tpu_torch.cli import add_route_flags

    ap = argparse.ArgumentParser("unitspeech-tpu-torch generate-samples")
    ap.add_argument("--sentences", default=None, help="flat mode: one utterance per line")
    ap.add_argument("--eval-filelist", default=None,
                    help="per-speaker mode: path|text|spk eval utterances")
    ap.add_argument("--reference-filelist", default=None,
                    help="per-speaker mode: path|text|spk reference wavs")
    ap.add_argument("--ipa", action="store_true", help="the sentences are pre-phonemized IPA")
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--decoder", required=True,
                    help="decoder (the base decoder in per-speaker mode)")
    ap.add_argument("--text-encoder", required=True)
    ap.add_argument("--duration-predictor", required=True)
    ap.add_argument("--vocoder", required=True)
    ap.add_argument("--unit-encoder", default=None, help="required in per-speaker mode")
    ap.add_argument("--speaker-embedder", default=None)
    ap.add_argument("--hubert", default=None)
    ap.add_argument("--kmeans", default=None)
    ap.add_argument("--units", default=None)
    ap.add_argument("--spk-emb", default=None)
    ap.add_argument("--finetune-iters", type=int, default=500)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--diffusion-steps", type=int, default=50)
    ap.add_argument("--text-gradient-scale", type=float, default=1.0)
    ap.add_argument("--spk-gradient-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    add_route_flags(ap, "the fine-tune's decoder activations too; the text encoder and "
                        "duration predictor always run f32")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch.cli import _device
    from unitspeech_tpu_torch.eval.harness import rtf_summary
    from unitspeech_tpu_torch.utils.precision import strict_f32

    _device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with strict_f32():
        if args.reference_filelist:
            if not (args.eval_filelist and args.unit_encoder):
                raise SystemExit("per-speaker mode needs --eval-filelist and --unit-encoder")
            summary = _per_speaker(args)
        else:
            if not args.sentences:
                raise SystemExit("need --sentences or --reference-filelist")
            with open(args.sentences, encoding="utf-8") as f:
                sentences = [line.strip() for line in f if line.strip()]
            summary = rtf_summary(_synthesize_set(args, args.decoder, sentences, args.out_dir,
                                                  args.seed))

    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
