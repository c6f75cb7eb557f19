"""Command-line entry points of the port (counterpart of
unitspeech_tpu/cli.py for the adaptive-TTS, speaker-adaptation,
voice-conversion, serving, training and evaluation slices and the SSL
frontends; JAX's `warmup-adapt` is not ported).

    python -m unitspeech_tpu_torch.cli make-random-checkpoint --seed 0 --output ckpt.pt
    python -m unitspeech_tpu_torch.cli inference --text "Hello." [--language en-us] \\
        --checkpoint ckpt.pt [--decoder adapted/decoder.pt] --output out.wav
    python -m unitspeech_tpu_torch.cli finetune --reference ref.wav \\
        --decoder ckpt.pt --unit-encoder ckpt.pt --speaker-embedder spk.pt \\
        --hubert hubert.pt --kmeans kmeans.npz --output-dir adapted
    python -m unitspeech_tpu_torch.cli voice-conversion --source src.wav \
        --decoder adapted/decoder.pt --content-encoder ce.pt --contentvec cv.pt \
        --vocoder voc.pt [--sampler dpm2:cs2] --output converted.wav
    python -m unitspeech_tpu_torch.cli serve --checkpoint ckpt.pt \
        --calibration-file corpus.txt [--voices voices/] [--port 8777]
    python -m unitspeech_tpu_torch.cli convert decoder pretrained_decoder.pt decoder.pt
    python -m unitspeech_tpu_torch.cli preprocess-mel-stats --filelist train.txt --out mel_stats.npz
    python -m unitspeech_tpu_torch.cli preprocess-uncond --filelist train.txt \
        --mel-stats mel_stats.npz --spk-embs spk_embs.npz --out uncond_stats.npz
    python -m unitspeech_tpu_torch.cli train-step1 --filelist train.txt --spk-embs spk_embs.npz \
        --mel-stats mel_stats.npz --uncond-stats uncond_stats.npz --checkpoint-dir ckpts [--resume]
    python -m unitspeech_tpu_torch.cli make-filelist --corpus generic --root corpus/ --out-dir lists
    python -m unitspeech_tpu_torch.cli preprocess-spk-embs --filelist train.txt \
        --speaker-embedder spk.pt --out spk_embs.npz
    python -m unitspeech_tpu_torch.cli preprocess-units --filelist train.txt --hubert hubert.pt \
        --kmeans kmeans.npz
    python -m unitspeech_tpu_torch.cli train-step2 --filelist train.txt --spk-embs spk_embs.npz \
        --mel-stats mel_stats.npz --decoder ckpts/step_100 --checkpoint-dir ckpts2 [--resume]
    python -m unitspeech_tpu_torch.cli train-vocoder --filelist train.txt --checkpoint-dir voc \
        [--steps 1000] [--resume]
    python -m unitspeech_tpu_torch.cli evaluate --samples-dir samples --filelist eval.txt \
        --hubert hubert.pt --kmeans kmeans.npz [--asr-hook m:f --mos-hook m:f --spk-hook m:f]

A checkpoint is a `torch.save`d dict: one state dict per module in the
port's layout, the speaker embedding, the mel min/max and the config
(utils/artifacts lists the port's formats). Every command runs on the card
unless `--device cpu` is given; with no CUDA device `--device cuda` exits
non-zero (`make-filelist` runs on the host). The commands that take the
JAX CLI's launch flags also take `--cpu` (as `--device cpu`) and
`--distributed` (join a process group, one rank a card:
parallel.maybe_initialize_distributed); `train-step1` and `train-step2`
then split each batch over the ranks:

    torchrun --nproc_per_node 4 -m unitspeech_tpu_torch.cli train-step1 --distributed ... f32 means f32: `inference`,
`serve`, `finetune`, `voice-conversion`, `evaluate`, the SSL
preprocessors and the three training commands run with TF32 off for f32 matmuls and cuDNN convs
(utils/precision.strict_f32), and give the caller's settings back when
they return.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from unitspeech_tpu_torch.utils.audio import load_wav, resample_to, write_wav
from unitspeech_tpu_torch.utils.precision import strict_f32

# Mel-frame bucket ladder of the fine-tune's reference (4/8/12/16/24 s of
# 22.05 kHz audio at hop 256), as the JAX CLI pads it
DEFAULT_ADAPT_BUCKETS = "344,688,1032,1376,2064"
# Sample-bucket ladder of the speaker embedder's input (6 s / 12 s at
# 16 kHz), as the JAX CLI pads it: the wav is reflect-extended to the first
# bucket that holds it (the same speaker's audio, so the pooled embedding
# stays on-speaker); longer wavs and --exact-ssl keep their exact length
DEFAULT_SPK_SAMPLE_BUCKETS = (96000, 192000)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name} given but no CUDA device is available")
    return device


def add_launch_flags(ap):
    """--cpu and --distributed, the JAX CLI's launch flags (its `_common`)."""
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed process group (torchrun's variables, or "
                         "UNITSPEECH_COORDINATOR / UNITSPEECH_NUM_PROCESSES / "
                         "UNITSPEECH_PROCESS_ID), one rank a card over nccl, or over gloo "
                         "with --cpu; train-step1 and train-step2 split each batch over the "
                         "ranks, the other commands run whole on every rank, as in JAX")


def _launch_device(args):
    """The device of a command with the launch flags: --device, or the CPU
    with --cpu; with --distributed this process joins the process group
    first (parallel.maybe_initialize_distributed: nccl on the card, which
    must exist, gloo with --cpu) and runs on its rank's card."""
    import torch

    cpu = args.cpu or torch.device(args.device).type == "cpu"
    if args.distributed:
        from unitspeech_tpu_torch.parallel import local_device, maybe_initialize_distributed

        maybe_initialize_distributed(cpu=cpu)
        return local_device(cpu)
    return _device("cpu" if cpu else args.device)


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


def add_route_flags(ap, f32_note: str):
    """The decoder's and the vocoder's precision and kernel routes, as
    `inference` and `voice-conversion` take them."""
    ap.add_argument("--fp32", dest="bf16", action="store_false",
                    help="decoder and vocoder in f32, on the plain path (the kernels take "
                         "bf16). f32 is full f32 on the card: TF32 is off for every f32 "
                         f"matmul and cuDNN conv of the command ({f32_note})")
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


def route_switches(args) -> dict:
    """The estimator's and vocoder's switches from add_route_flags' flags,
    the JAX serving defaults (unitspeech_tpu/cli.py _load_tts_models):
    kernels in bf16, and int8 deep convs whenever the kernels are on."""
    fast = args.bf16 and args.fast_kernels
    return dict(use_kernels=fast, use_int8_deep=fast and args.int8,
                use_deep=fast and args.deep, use_resample=fast and args.resample,
                use_i8pre_deep=fast and args.int8 and args.i8pre)


def route_stats(routes: dict) -> dict:
    """The routes as a command's statistics line reports them."""
    return {"kernels": routes["use_kernels"], "int8": routes["use_int8_deep"],
            "deep": routes["use_deep"], "i8pre": routes["use_i8pre_deep"],
            "resample": routes["use_resample"]}


def _load_tts_models(args, device, dtype, routes):
    """TTSModels from --checkpoint and the per-module flags (each overrides
    that module of the checkpoint; without a checkpoint all four are
    required), as the JAX CLI's _load_tts_models reads them."""
    import torch

    from unitspeech_tpu_torch.config import MainConfig, config_from_dict, load_json
    from unitspeech_tpu_torch.infer.tts import TTSModels
    from unitspeech_tpu_torch.utils import artifacts

    flags = {"decoder": args.decoder, "text_encoder": args.text_encoder,
             "duration_predictor": args.duration_predictor, "vocoder": args.vocoder}
    if args.checkpoint is None and not all(flags.values()):
        missing = [f"--{k.replace('_', '-')}" for k, v in flags.items() if not v]
        raise SystemExit(f"without --checkpoint pass {', '.join(missing)}")
    ckpt = artifacts.read(args.checkpoint) if args.checkpoint else {}
    if args.config:
        cfg = load_json(args.config)
    else:
        cfg = config_from_dict(ckpt["config"]) if ckpt else MainConfig()
    state = {k: ckpt.get(k) for k in flags}
    spk, mel_min, mel_max = ckpt.get("spk_emb"), ckpt.get("mel_min"), ckpt.get("mel_max")
    if args.decoder:
        bundle = artifacts.load_decoder_bundle(args.decoder, cfg.decoder)
        state["decoder"] = bundle.state_dict
        spk = spk if bundle.spk_emb is None else bundle.spk_emb
        mel_min = mel_min if bundle.mel_min is None else bundle.mel_min
        mel_max = mel_max if bundle.mel_max is None else bundle.mel_max
    if args.text_encoder:
        state["text_encoder"] = artifacts.load_encoder_params(args.text_encoder,
                                                              cfg.text_encoder)
    if args.duration_predictor:
        state["duration_predictor"] = artifacts.load_duration_predictor_params(
            args.duration_predictor)
    if args.vocoder:
        state["vocoder"] = artifacts.load_vocoder_params(args.vocoder, cfg.vocoder)
    if args.spk_emb:
        spk = torch.from_numpy(np.load(args.spk_emb).astype(np.float32))
    missing = [k for k, v in state.items() if v is None]
    if missing:  # a STEP1 checkpoint holds no vocoder
        raise SystemExit(f"{args.checkpoint} has no {', '.join(missing)}: pass "
                         + ", ".join(f"--{k.replace('_', '-')}" for k in missing))
    if spk is None:  # a STEP1 checkpoint holds no voice
        raise SystemExit(f"no speaker embedding: {args.checkpoint or args.decoder} has no "
                         "spk_emb; pass --spk-emb")
    if mel_min is None or mel_max is None:
        raise SystemExit("no mel_min / mel_max in the checkpoint or the decoder")
    return TTSModels.from_state_dicts(cfg, state, spk, mel_min, mel_max, device=device,
                                      dtype=dtype, **routes)


def token_lists(args, cfg):
    """The request's token-ID lists: the IPA text, or the graphemes through
    espeak (the rule G2P without it) in one chunk or, with
    --split-sentences, one per sentence chunk; empty chunks are dropped."""
    from unitspeech_tpu_torch import text as text_frontend

    if args.ipa:
        lists = [text_frontend.phonemes_to_sequence(args.text)]
    else:
        lang = args.language or cfg.inference.language
        ph = text_frontend.get_phonemizer(lang, fallback=True)
        if ph is None:
            raise SystemExit(f"espeak-ng not installed and no G2P fallback for {lang!r}: "
                             "pass pre-phonemized IPA via --ipa")
        chunks = text_frontend.split_sentences(args.text) if args.split_sentences else [args.text]
        lists = [ids for c in chunks if (ids := text_frontend.text_to_sequence(c, ph))]
    if not lists or not lists[0]:
        raise SystemExit("text produced no tokens")
    return lists


def save_mel_plot(mel: np.ndarray, path: str):
    """The mel spectrogram (T, F) as a PNG (reference save_plot,
    util.py:110-121)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(mel.T, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def chunk_seed(seed: int, i: int) -> int:
    """The generator seed of sentence chunk i of a --split-sentences request
    with more than one chunk: drawn from numpy's SeedSequence((seed, i))."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0] >> 1)


@strict_f32()
def main_inference(argv=None) -> dict:
    """Synthesize one request; returns and prints its statistics."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch inference")
    ap.add_argument("--text", required=True, help="input text (IPA with --ipa)")
    ap.add_argument("--ipa", action="store_true", help="the text is pre-phonemized IPA")
    ap.add_argument("--language", default=None,
                    help="espeak language, en-us or ro (default: the config's "
                         "inference.language); without espeak-ng the built-in rule G2P "
                         "of the language phonemizes")
    ap.add_argument("--split-sentences", action="store_true",
                    help="long-text mode: one synthesis per sentence chunk, concatenated, "
                         "then sv56. With more than one chunk, chunk i draws from a "
                         "generator seeded from (--seed, i) (numpy SeedSequence); the JAX "
                         "CLI's fold_in stream is not reproduced")
    ap.add_argument("--save-plot", default=None,
                    help="write the generated mel spectrogram (all chunks) as a PNG; needs "
                         "matplotlib")
    ap.add_argument("--checkpoint", default=None,
                    help="the port's combined checkpoint (make-random-checkpoint)")
    ap.add_argument("--decoder", default=None,
                    help="decoder: a reference .pt, a port bundle (cli finetune / convert) "
                         "or checkpoint; its spk_emb and mel min/max come with it")
    ap.add_argument("--text-encoder", default=None, help="text encoder (reference or port)")
    ap.add_argument("--duration-predictor", default=None,
                    help="duration predictor (reference or port)")
    ap.add_argument("--vocoder", default=None, help="BigVGAN generator (reference or port)")
    ap.add_argument("--spk-emb", default=None,
                    help=".npy speaker embedding override (unit-normalized at load)")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay (default: the checkpoint's config, else "
                         "the reference's)")
    ap.add_argument("--output", default="generated.wav")
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--diffusion-steps", type=int, default=None)
    ap.add_argument("--length-scale", type=float, default=None)
    ap.add_argument("--text-gradient-scale", type=float, default=None)
    ap.add_argument("--spk-gradient-scale", type=float, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="force each chunk's durations to sum to this many mel frames")
    ap.add_argument("--no-sv56", action="store_true")
    add_route_flags(ap, "the text encoder and duration predictor always run f32")
    args = ap.parse_args(argv)
    if args.save_plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise SystemExit(f"--save-plot needs matplotlib ({e})") from e

    import torch

    from unitspeech_tpu_torch.infer.tts import Synthesizer
    from unitspeech_tpu_torch.ops import sv56

    device = _launch_device(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    routes = route_switches(args)
    models = _load_tts_models(args, device, dtype, routes)
    cfg = models.cfg
    lists = token_lists(args, cfg)
    synth = Synthesizer(models)
    hop = cfg.data.hop_length

    t0 = time.perf_counter()
    wavs, mels = [], []
    for i, ids in enumerate(lists):
        seed = args.seed if len(lists) == 1 else chunk_seed(args.seed, i)
        gen = torch.Generator(device=device).manual_seed(seed)
        wav, sr, mel = synth(ids, gen, forced_total_frames=args.frames,
                             diffusion_steps=args.diffusion_steps,
                             length_scale=args.length_scale,
                             text_gradient_scale=args.text_gradient_scale,
                             spk_gradient_scale=args.spk_gradient_scale)
        if wav.size == 0 or not np.isfinite(wav).all():
            raise RuntimeError(f"chunk {i}: synthesis produced an empty or non-finite waveform")
        wavs.append(wav)
        if args.save_plot:
            mels.append(mel.float().cpu().numpy())
    wall = time.perf_counter() - t0  # the waveforms are on the host: the device is done
    wav = np.concatenate(wavs)
    if not args.no_sv56 and cfg.inference.with_sv56_normalization:
        wav = sv56.normalize(wav, sr)
    write_wav(args.output, wav, sr)
    if args.save_plot:
        save_mel_plot(np.concatenate(mels), args.save_plot)
    seconds = len(wav) / sr
    stats = {"output": args.output, "tokens": sum(len(ids) for ids in lists),
             "chunks": len(lists), "frames": len(wav) // hop, "seconds": seconds,
             "wall_s": wall, "rtf": wall / seconds if seconds else None,
             "device": str(device), **route_stats(routes)}
    print(json.dumps(stats))
    return stats


def reference_mel(wav: np.ndarray, cfg, frame_buckets: str, device):
    """Log-mel (T_true, n_feats) f32 of a reference wav on `device`, and the
    frame bucket it pads to (None with frame_buckets ''), as the JAX CLI's
    _reference_mel: the wav is reflect-extended to bucket * hop samples,
    and the first T_true frames equal the exact-length mel bit for bit."""
    import torch

    from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
    from unitspeech_tpu_torch.ops.mel import mel_spectrogram, mel_true_frames, reflect_extend

    d = cfg.data
    t_true = mel_true_frames(len(wav), d.n_fft, d.hop_length)
    pad_to = None
    if frame_buckets:
        ladder = tuple(int(x) for x in str(frame_buckets).split(",") if x)
        pad_to = choose_bucket(fix_len_compatibility(t_true, cfg.decoder.num_downsamplings),
                               ladder)
        # above the ladder choose_bucket rounds to multiples of 8: re-round
        # for this config so that prepare_finetune_inputs takes pad_to
        pad_to = fix_len_compatibility(pad_to, cfg.decoder.num_downsamplings)
        wav = reflect_extend(wav, pad_to * d.hop_length)
    y = torch.from_numpy(np.asarray(wav, np.float32)).to(device)[None]
    mel = mel_spectrogram(y, n_fft=d.n_fft, num_mels=d.n_feats, sampling_rate=d.sampling_rate,
                          hop_size=d.hop_length, win_size=d.win_length, fmin=d.mel_fmin,
                          fmax=d.mel_fmax)
    return mel[0, :t_true], pad_to


def finetune_inputs(cfg, wav: np.ndarray, units, durations, unit_encoder_sd: dict, mel_min,
                    mel_max, frame_buckets: str, device):
    """The fine-tune's inputs from a reference wav (at cfg.data.sampling_rate)
    and its 50 Hz units and durations, as the JAX CLI prepares them: the
    reference's mel normalized with the decoder's mel_min / mel_max, the
    units at the mel frame rate (process_unit, counted at
    cfg.spk_embedder.sr), the frozen unit encoder's output and the
    alignment (train/finetune.prepare_finetune_inputs), on `device`."""
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.ops.mel import normalize_mel
    from unitspeech_tpu_torch.ops.units import process_unit
    from unitspeech_tpu_torch.train.finetune import prepare_finetune_inputs

    mel, pad_to = reference_mel(wav, cfg, frame_buckets, device)
    mel = normalize_mel(mel, mel_min.to(device), mel_max.to(device))
    units, durations = process_unit(units, durations, cfg.spk_embedder.sr, cfg.data.hop_length)
    with device:
        unit_encoder = Encoder.from_config(cfg.unit_encoder)
    unit_encoder.load_state_dict(unit_encoder_sd)
    return prepare_finetune_inputs(unit_encoder, units, durations, mel,
                                   num_downsamplings=cfg.decoder.num_downsamplings,
                                   pad_to=pad_to)


def load_speaker_embedder(path: str, cfg, device):
    """The WavLM + ECAPA speaker embedder (cfg: the MainConfig) from a
    reference speaker_encoder.pt or a port file, on `device` in eval mode.
    Load it once and reuse it: WavLM-Large is about 1.26 GB in f32."""
    import torch

    from unitspeech_tpu_torch.models.speaker import SpeakerEmbedder
    from unitspeech_tpu_torch.utils import artifacts

    with torch.device("meta"):
        model = SpeakerEmbedder.from_config(cfg.spk_embedder)
    sd = artifacts.load_speaker_embedder_params(path, model.wavlm.config)
    model.load_state_dict(sd, assign=True)
    return model.to(device).eval().requires_grad_(False)


@strict_f32()
def embed_speaker(model, wav: np.ndarray, sr: int, cfg,
                  sample_buckets=DEFAULT_SPK_SAMPLE_BUCKETS) -> np.ndarray:
    """wav -> (1, emb) speaker embedding, not normalized: resampled to
    cfg.spk_embedder.sr on the host and reflect-extended to the first
    sample bucket that holds it (sample_buckets None or empty: the exact
    length, the reference's behavior); f32 on the model's device."""
    import torch

    from unitspeech_tpu_torch.ops.mel import reflect_extend

    wav = resample_to(wav, sr, cfg.spk_embedder.sr)
    for b in sample_buckets or ():
        if b >= len(wav):
            wav = reflect_extend(wav, b)
            break
    device = next(model.parameters()).device
    with torch.no_grad():
        emb = model(torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None].to(device))
    return emb.cpu().numpy()


def extract_speaker_embedding(path: str, wav, sr: int, cfg, device,
                              sample_buckets=DEFAULT_SPK_SAMPLE_BUCKETS) -> np.ndarray:
    """load_speaker_embedder, then embed_speaker."""
    return embed_speaker(load_speaker_embedder(path, cfg, device), wav, sr, cfg, sample_buckets)


def build_unit_extractor(hubert_path: str, kmeans_path: str, cfg, device):
    """The dense model + k-means SpeechEncoder (wav at 16 kHz -> units,
    durations), its models on `device`; load it once and reuse it. The
    dense model is mHuBERT, or for names starting with "cpc" the CPC
    checkpoint at `hubert_path` ({'weights', 'config'}) read to
    cfg.unit_extractor.hubert_layer LSTM levels (JAX cli.py:516-529)."""
    import torch

    from unitspeech_tpu_torch.models.ssl.hubert import (
        HubertFeatureReader,
        HubertModel,
        hubert_config_by_name,
    )
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.utils import artifacts

    ucfg = cfg.unit_extractor
    if ucfg.dense_model_name.startswith("cpc"):
        # the CPC family (reference textless/__init__.py DENSE_MODELS:
        # "cpc-big-ll6k" -> CpcFeatureReader)
        from unitspeech_tpu_torch.models.ssl.cpc import CpcFeatureReader

        reader = CpcFeatureReader.from_torch(hubert_path, layer=ucfg.hubert_layer, device=device)
        return SpeechEncoder(reader, artifacts.load_kmeans(kmeans_path),
                             deduplicate=ucfg.deduplicate)
    with torch.device("meta"):
        model = HubertModel(hubert_config_by_name(ucfg.dense_model_name))
    model.load_state_dict(artifacts.load_hubert_params(hubert_path, model.config), assign=True)
    model = model.to(device).eval().requires_grad_(False)
    return SpeechEncoder(HubertFeatureReader(model, layer=ucfg.hubert_layer),
                         artifacts.load_kmeans(kmeans_path), deduplicate=ucfg.deduplicate)


@strict_f32()
def extract_units(encoder, wav, sr: int, cfg):
    """wav -> (units, durations) at 50 Hz through a build_unit_extractor
    SpeechEncoder, the wav resampled to cfg.unit_extractor.sr on the host."""
    out = encoder(resample_to(wav, sr, cfg.unit_extractor.sr))
    return out["units"], out["durations"]


@strict_f32()
def main_finetune(argv=None) -> dict:
    """Adapt the decoder to the voice of one reference wav (reference
    finetune.py; JAX cli.py main_finetune); returns and prints its
    statistics. The speaker embedding comes from --spk-emb, else the
    WavLM + ECAPA embedder (--speaker-embedder), else the decoder file; the
    units from --units, else mHuBERT + k-means (--hubert, --kmeans)."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch finetune")
    ap.add_argument("--reference", required=True, help="reference wav (22.05 kHz)")
    ap.add_argument("--decoder", required=True,
                    help="pretrained decoder: a reference .pt, a port bundle or checkpoint")
    ap.add_argument("--unit-encoder", required=True,
                    help="unit encoder: a reference .pt or a port file / checkpoint")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--n-iters", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--spk-emb", default=None,
                    help=".npy speaker embedding (skips the WavLM + ECAPA pass)")
    ap.add_argument("--units", default=None,
                    help=".npz with units and their 50 Hz durations (skips the mHuBERT pass)")
    ap.add_argument("--speaker-embedder", default=None,
                    help="WavLM + ECAPA: the reference's speaker_encoder.pt or a port file "
                         "(cli convert speaker-embedder)")
    ap.add_argument("--hubert", default=None,
                    help="mHuBERT: a fairseq checkpoint or a port file (cli convert hubert)")
    ap.add_argument("--kmeans", default=None,
                    help="k-means centroids: .npz, or sklearn's joblib file (needs sklearn)")
    ap.add_argument("--exact-ssl", action="store_true",
                    help="give the speaker embedder the exact-length wav (the reference's "
                         "behavior) instead of the sample-bucket ladder "
                         f"{DEFAULT_SPK_SAMPLE_BUCKETS}")
    ap.add_argument("--fp32", dest="bf16", action="store_false",
                    help="decoder activations in f32 (default bf16; parameters stay f32). "
                         "f32 is full f32 on the card: TF32 is off for every f32 matmul and "
                         "cuDNN conv of the command, the SSL frontends included")
    ap.add_argument("--frame-buckets", default=DEFAULT_ADAPT_BUCKETS,
                    help="comma-separated mel-frame bucket ladder the reference pads to; "
                         "'' for its exact length")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay (default: the decoder file's config, else "
                         "the reference's)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    args = ap.parse_args(argv)

    import torch

    from unitspeech_tpu_torch.config import MainConfig, config_from_dict, load_json
    from unitspeech_tpu_torch.train.finetune import finetune_decoder
    from unitspeech_tpu_torch.utils import artifacts

    device = _launch_device(args)
    dec_obj = artifacts.read(args.decoder)
    if args.config:
        cfg = load_json(args.config)
    else:
        cfg = config_from_dict(dec_obj["config"]) if "config" in dec_obj else MainConfig()
    bundle = artifacts.load_decoder_bundle(dec_obj, cfg.decoder)
    if bundle.mel_min is None or bundle.mel_max is None:
        raise SystemExit(f"{args.decoder}: no mel_min / mel_max")
    if not args.units and not (args.hubert and args.kmeans):
        raise SystemExit("need --units or (--hubert and --kmeans)")
    wav, sr = load_wav(args.reference)
    if sr != cfg.data.sampling_rate:
        raise SystemExit(f"{args.reference}: expected {cfg.data.sampling_rate} Hz, got {sr}")

    frontends = {}
    t0 = time.perf_counter()
    if args.spk_emb:
        spk = np.load(args.spk_emb).astype(np.float32).reshape(1, -1)
    elif args.speaker_embedder:
        spk = extract_speaker_embedding(
            args.speaker_embedder, wav, sr, cfg, device,
            sample_buckets=None if args.exact_ssl else DEFAULT_SPK_SAMPLE_BUCKETS)
        frontends["speaker_embedder_s"] = time.perf_counter() - t0
    elif bundle.spk_emb is not None:
        spk = bundle.spk_emb.numpy()
    else:
        raise SystemExit("need --spk-emb, --speaker-embedder or a decoder file with spk_emb")
    spk = torch.from_numpy(spk / np.linalg.norm(spk)).to(device)

    t0 = time.perf_counter()
    if args.units:
        with np.load(args.units) as z:
            units, durations = z["units"], z["durations"]
    else:
        units, durations = extract_units(build_unit_extractor(args.hubert, args.kmeans, cfg,
                                                              device), wav, sr, cfg)
        frontends["unit_extractor_s"] = time.perf_counter() - t0
    cond_x, y, y_lengths, attn = finetune_inputs(
        cfg, wav, units, durations, artifacts.load_encoder_params(
            args.unit_encoder, cfg.unit_encoder, "unit_encoder"),
        bundle.mel_min, bundle.mel_max, args.frame_buckets, device)

    n_iters = args.n_iters or cfg.finetune.n_iters
    lr = args.learning_rate or cfg.finetune.learning_rate
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    state, losses = finetune_decoder(
        cfg.decoder, bundle.state_dict, cond_x, y, y_lengths, attn, spk,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, segment_size=cfg.out_size,
        n_iters=n_iters, learning_rate=lr, grad_clip=cfg.finetune.grad_clip, generator=gen)
    seconds = time.perf_counter() - t0  # the losses came back to the host: the device is done
    os.makedirs(args.output_dir, exist_ok=True)
    out = artifacts.save_decoder_bundle(
        os.path.join(args.output_dir, "decoder.pt"),
        artifacts.DecoderBundle(state_dict=state, spk_emb=spk, mel_min=bundle.mel_min,
                                mel_max=bundle.mel_max, step=n_iters), cfg)
    stats = {"iterations": n_iters, "seconds": seconds, "ms_per_step": 1e3 * seconds / n_iters,
             "loss_first10": float(losses[:10].mean()),
             "loss_last10": float(losses[-10:].mean()), "output": out,
             "device": str(device), "bf16": args.bf16, "segment": cfg.out_size,
             "frames": int(y_lengths[0]), "bucket": int(y.shape[1]), "units": len(units),
             **frontends}
    print(json.dumps(stats))
    return {**stats, "losses": losses}


@strict_f32()
def extract_contentvec(ckpt_path: str, wav, sr: int, cfg, device) -> np.ndarray:
    """Speaker-invariant content features (T, 768) of a wav through the
    contentvec HuBERT (reference scripts/voice_conversion.py:46-68; an
    HF-named checkpoint, models/ssl/contentvec.py) at the width the
    contentvec encoder reads, the wav resampled to cfg.unit_extractor.sr
    (16 kHz) on the host, f32 on `device`."""
    from unitspeech_tpu_torch.models.ssl.contentvec import (
        ContentvecExtractor,
        contentvec_config_for,
    )

    extractor = ContentvecExtractor.from_torch(
        ckpt_path, device, contentvec_config_for(cfg.contentvec_encoder.n_contentvec))
    return extractor(resample_to(wav, sr, cfg.unit_extractor.sr))


def load_vc_modules(cfg, decoder_state: dict, content_encoder, vocoder, device, dtype, routes):
    """(contentvec encoder, decoder, vocoder) of voice conversion on `device`
    in eval mode: the encoder f32 (reference .pt or port file), the decoder
    (a state dict in the port's layout) and the vocoder (reference or port)
    in `dtype` on `routes` (route_switches), whose load hooks pack the
    kernels' weights."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.models.vocoder import BigVGAN
    from unitspeech_tpu_torch.utils import artifacts

    with device:
        mods = (Encoder.from_config(cfg.contentvec_encoder),
                UnitSpeech.from_config(cfg.decoder, dtype=dtype, **routes),
                BigVGAN.from_config(cfg.vocoder, dtype=dtype, use_kernels=routes["use_kernels"]))
    sds = (artifacts.load_encoder_params(content_encoder, cfg.contentvec_encoder,
                                         "contentvec_encoder"),
           decoder_state, artifacts.load_vocoder_params(vocoder, cfg.vocoder))
    for mod, sd in zip(mods, sds):
        mod.load_state_dict(sd)
        mod.eval().requires_grad_(False)
    return mods


@strict_f32()
def main_voice_conversion(argv=None) -> dict:
    """Convert a source wav to the voice of an adapted decoder (reference
    scripts/voice_conversion.py; JAX cli.py main_voice_conversion); prints
    its statistics and returns them with the denormalized mel (frames, F)
    the waveform was vocoded from. The content comes from
    --content-features, else the contentvec HuBERT (--contentvec)."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch voice-conversion")
    ap.add_argument("--source", required=True, help="source wav (22.05 kHz)")
    ap.add_argument("--decoder", required=True,
                    help="fine-tuned decoder: a reference .pt, a port bundle or checkpoint; "
                         "its spk_emb and mel min/max come with it")
    ap.add_argument("--content-encoder", required=True,
                    help="contentvec encoder: a reference .pt or a port file "
                         "(cli convert contentvec-encoder)")
    ap.add_argument("--content-features", default=None,
                    help=".npy (T, 768) contentvec features (skips the extraction)")
    ap.add_argument("--contentvec", default=None,
                    help="contentvec HuBERT checkpoint in HF transformers names "
                         "(lengyue233/content-vec-best)")
    ap.add_argument("--vocoder", required=True, help="BigVGAN generator (reference or port)")
    ap.add_argument("--spk-emb", default=None,
                    help=".npy speaker embedding override (unit-normalized at load)")
    ap.add_argument("--output", default="converted.wav")
    ap.add_argument("--diffusion-steps", type=int, default=50)
    ap.add_argument("--sampler", default="ddpm",
                    help="sampler spec: 'ddpm' / 'dpm2', optionally ':cs<k>', the guidance "
                         "stride (e.g. 'dpm2:cs2': the unconditional rows every 2nd step, "
                         "their delta cached between)")
    ap.add_argument("--text-gradient-scale", type=float, default=1.0)
    ap.add_argument("--spk-gradient-scale", type=float, default=1.0)
    ap.add_argument("--no-sv56", action="store_true")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay (default: the decoder file's config, else "
                         "the reference's)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    add_route_flags(ap, "the contentvec HuBERT and encoder always run f32")
    args = ap.parse_args(argv)
    if not args.content_features and not args.contentvec:
        raise SystemExit("need --content-features or --contentvec")

    import torch

    from unitspeech_tpu_torch.config import MainConfig, config_from_dict, load_json
    from unitspeech_tpu_torch.infer import vc
    from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec
    from unitspeech_tpu_torch.ops import sv56
    from unitspeech_tpu_torch.utils import artifacts

    try:
        parse_sampler_spec(args.sampler)
    except ValueError as e:
        raise SystemExit(f"--sampler: {e}") from e
    device = _launch_device(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    routes = route_switches(args)
    dec_obj = artifacts.read(args.decoder)
    if args.config:
        cfg = load_json(args.config)
    else:
        cfg = config_from_dict(dec_obj["config"]) if "config" in dec_obj else MainConfig()
    bundle = artifacts.load_decoder_bundle(dec_obj, cfg.decoder)
    if bundle.mel_min is None or bundle.mel_max is None:
        raise SystemExit(f"{args.decoder}: no mel_min / mel_max")
    if args.spk_emb:
        spk = np.load(args.spk_emb).astype(np.float32).reshape(1, -1)
    elif bundle.spk_emb is not None:
        spk = bundle.spk_emb.numpy()
    else:
        raise SystemExit("no speaker embedding: pass --spk-emb or a decoder with spk_emb")
    spk = torch.from_numpy(spk / np.linalg.norm(spk)).to(device)

    wav, sr = load_wav(args.source)
    mel_len = len(wav) // cfg.data.hop_length
    stats = {}
    t0 = time.perf_counter()
    if args.content_features:
        content = np.load(args.content_features).astype(np.float32)
    else:
        content = extract_contentvec(args.contentvec, wav, sr, cfg, device)
        stats["contentvec_s"] = time.perf_counter() - t0

    encoder, decoder, vocoder = load_vc_modules(cfg, bundle.state_dict, args.content_encoder,
                                                args.vocoder, device, dtype, routes)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    mel = vc.voice_conversion(
        encoder, decoder, torch.from_numpy(content)[None].to(device), mel_len, spk,
        bundle.mel_min.to(device), bundle.mel_max.to(device), n_timesteps=args.diffusion_steps,
        text_gradient_scale=args.text_gradient_scale,
        spk_gradient_scale=args.spk_gradient_scale,
        num_downsamplings=cfg.decoder.num_downsamplings, sampler=args.sampler, generator=gen)
    with torch.no_grad():
        out = vocoder(mel)[0, : mel_len * cfg.data.hop_length].float().cpu().numpy()
    wall = time.perf_counter() - t0  # the waveform is on the host: the device is done
    if out.size == 0 or not np.isfinite(out).all():
        raise RuntimeError("voice conversion produced an empty or non-finite waveform")
    if not args.no_sv56:
        out = sv56.normalize(out, cfg.data.sampling_rate)
    write_wav(args.output, out, cfg.data.sampling_rate)
    seconds = len(out) / cfg.data.sampling_rate
    stats = {"output": args.output, "content_frames": len(content), "frames": mel_len,
             "bucket": vc.vc_frames(mel_len, cfg.decoder.num_downsamplings),
             "seconds": seconds, "wall_s": wall, "rtf": wall / seconds if seconds else None,
             "sampler": args.sampler, "steps": args.diffusion_steps, "device": str(device),
             "bf16": args.bf16, **route_stats(routes), **stats}
    print(json.dumps(stats))
    return {**stats, "mel": mel[0, :mel_len].float().cpu().numpy()}


@strict_f32()
def main_serve(argv=None) -> dict:
    """The TTS serving daemon (JAX cli.py main_serve; unitspeech_tpu_torch/
    serve.py): dynamic batching over the bucket-switch Synthesizer and an
    HTTP front end, on the card unless --device cpu. Startup calibrates the
    window (or takes --switch-buckets) and runs the whole (batch ladder x
    token bucket) grid once before the port opens, so a kernel that fails
    to build or launch fails startup. f32 means f32 for the server's whole
    lifetime (strict_f32). Returns the serving configuration (--dry-run
    returns after the warm-up; otherwise when the server stops)."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch serve")
    ap.add_argument("--checkpoint", default=None,
                    help="the port's combined checkpoint (make-random-checkpoint)")
    ap.add_argument("--decoder", default=None,
                    help="decoder: a reference .pt, a port bundle or checkpoint")
    ap.add_argument("--text-encoder", default=None, help="text encoder (reference or port)")
    ap.add_argument("--duration-predictor", default=None,
                    help="duration predictor (reference or port)")
    ap.add_argument("--vocoder", default=None, help="BigVGAN generator (reference or port)")
    ap.add_argument("--spk-emb", default=None, help=".npy speaker embedding override")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay (default: the checkpoint's config, else "
                         "the reference's)")
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="dynamic-batching wait window (latency traded for throughput)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="pending-request cap: submissions beyond it get 503 "
                         "(backpressure) instead of unbounded queueing; 0 = unbounded")
    ap.add_argument("--strict-grid", action="store_true",
                    help="refuse requests outside the warmed grid (non-default "
                         "steps/sampler, over-long tokens, frame-window overflows) "
                         "instead of serving them cold on the dispatcher thread")
    ap.add_argument("--diffusion-steps", type=int, default=None)
    ap.add_argument("--sampler", default="ddpm",
                    help="default sampler spec: 'ddpm' or 'dpm2', optionally with a "
                         "':cs<k>' guidance stride, e.g. 'dpm2:cs2'")
    ap.add_argument("--length-scale", type=float, default=None)
    ap.add_argument("--text-gradient-scale", type=float, default=None)
    ap.add_argument("--spk-gradient-scale", type=float, default=None)
    ap.add_argument("--language", default=None,
                    help="espeak language for text payloads (the rule G2P without "
                         "espeak-ng; token_ids payloads always work)")
    ap.add_argument("--calibration-file", default=None,
                    help="one utterance per line; phonemized (or read as IPA with "
                         "--ipa-calibration) at startup to derive the bucket-switch "
                         "window from the corpus' length distribution")
    ap.add_argument("--ipa-calibration", action="store_true",
                    help="calibration file lines are pre-phonemized IPA")
    ap.add_argument("--switch-buckets", default=None,
                    help="comma-separated frame buckets (skips calibration; e.g. "
                         "344,384,432)")
    ap.add_argument("--bucket-policy", default="cost", choices=("cost", "quantile"),
                    help="frame-window derivation from the calibrated lengths: 'cost' "
                         "(minimize expected per-request cost under the card's measured "
                         "cost model, infer/cost_anchors_h100.json) or the 'quantile' "
                         "P5..max heuristic")
    ap.add_argument("--warmup-token-lengths", default="64",
                    help="comma-separated token lengths whose buckets are warmed across "
                         "the batch ladder")
    ap.add_argument("--voices", default=None,
                    help="voice bank for multi-voice serving: a directory of <name>.npy "
                         "speaker embeddings or one .npz keyed by name; requests select "
                         "with {\"speaker\": \"<name>\"}")
    ap.add_argument("--dry-run", action="store_true",
                    help="build + calibrate + warm up, print the serving config JSON, and "
                         "exit without opening the port")
    add_route_flags(ap, "the text encoder and duration predictor always run f32")
    args = ap.parse_args(argv)

    import dataclasses as dc

    import torch

    from unitspeech_tpu_torch import text as text_frontend
    from unitspeech_tpu_torch.infer.tts import Synthesizer
    from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec
    from unitspeech_tpu_torch.serve import build_batcher, make_http_server

    try:
        parse_sampler_spec(args.sampler)  # fail a typo'd spec at startup
    except ValueError as e:
        raise SystemExit(f"--sampler: {e}") from e
    device = _launch_device(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    routes = route_switches(args)
    models = _load_tts_models(args, device, dtype, routes)
    cfg = models.cfg
    synth = Synthesizer(models)
    if args.switch_buckets:
        window = tuple(sorted(int(b) for b in args.switch_buckets.split(",")))
        synth = dc.replace(synth, switch_buckets=window)
        calibration_texts = None
    elif args.calibration_file:
        lang = args.language or cfg.inference.language
        ph = None if args.ipa_calibration else text_frontend.get_phonemizer(lang, fallback=True)
        if ph is None and not args.ipa_calibration:
            raise SystemExit(f"espeak-ng not installed and no G2P fallback for {lang!r}: use "
                             "--ipa-calibration or --switch-buckets")
        with open(args.calibration_file, encoding="utf-8") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        calibration_texts = [text_frontend.phonemes_to_sequence(ln) if args.ipa_calibration
                             else text_frontend.text_to_sequence(ln, ph) for ln in lines]
    else:
        raise SystemExit("pass --calibration-file or --switch-buckets")

    kw = {}
    if args.diffusion_steps is not None:
        kw["default_steps"] = args.diffusion_steps
    if args.length_scale is not None:
        kw["length_scale"] = args.length_scale
    if args.text_gradient_scale is not None:
        kw["text_gradient_scale"] = args.text_gradient_scale
    if args.spk_gradient_scale is not None:
        kw["spk_gradient_scale"] = args.spk_gradient_scale
    if args.voices:
        from unitspeech_tpu_torch.utils.artifacts import load_speaker_embs

        kw["voices"] = load_speaker_embs(args.voices, int_keys=False)
    t0 = time.perf_counter()
    batcher = build_batcher(
        synth, calibration_texts=calibration_texts, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        warmup_token_lengths=tuple(int(t) for t in args.warmup_token_lengths.split(",")),
        default_sampler=args.sampler, strict_grid=args.strict_grid,
        max_queue=args.max_queue or None, bucket_policy=args.bucket_policy, **kw)
    serving_cfg = {
        "switch_buckets": list(batcher.synth.switch_buckets),
        "batch_ladder": batcher.batch_ladder,
        "default_steps": batcher.default_steps,
        "default_sampler": batcher.default_sampler,
        "length_scale": batcher.length_scale,
        "cfg_scales": [batcher.tg, batcher.sg],
        "max_wait_ms": args.max_wait_ms,
        "voices": sorted(batcher.voices),
        "warmup_s": time.perf_counter() - t0,
        "device": str(device), **route_stats(routes),
    }
    if args.dry_run:
        batcher.shutdown()
        print(json.dumps({"serving_config": serving_cfg, "warmed": True}))
        return serving_cfg

    lang = args.language or cfg.inference.language
    ph = text_frontend.get_phonemizer(lang, fallback=True)
    text_to_ids = None if ph is None else (lambda s: text_frontend.text_to_sequence(s, ph))
    srv = make_http_server(batcher, host=args.host, port=args.port, text_to_ids=text_to_ids)
    print(json.dumps({"serving_config": serving_cfg,
                      "listening": f"http://{args.host}:{srv.server_address[1]}"}), flush=True)
    import signal

    def _sigterm(*_a):
        # raise into serve_forever so the finally below drains the batcher
        # (resolving queued futures) before the process exits
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        batcher.shutdown()
    return serving_cfg


def _filelist_flags(ap):
    ap.add_argument("--filelist", action="append", required=True,
                    help="path|text|spk filelist (repeatable, e.g. train+test)")
    ap.add_argument("--max-files", type=int, default=None)
    ap.add_argument("--config", default=None, help="JSON config overlay")
    ap.add_argument("--device", default="cuda",
                    help="where the mels or the SSL models run (the card unless cpu)")
    add_launch_flags(ap)


def main_preprocess_mel_stats(argv=None) -> dict:
    """Global per-channel log-mel min / max over filelists (JAX cli.py
    main_preprocess_mel_stats; reference process_mel_normalization.py)."""
    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.preprocess.stats import compute_mel_stats

    ap = argparse.ArgumentParser("unitspeech-tpu-torch preprocess-mel-stats")
    _filelist_flags(ap)
    ap.add_argument("--out", required=True, help="output mel_stats.npz")
    args = ap.parse_args(argv)
    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    stats = compute_mel_stats(args.filelist, cfg.data, args.out, device, args.max_files)
    print(f"mel stats over {len(args.filelist)} filelist(s) -> {args.out} "
          f"(min {stats['mel_min'].min():.3f}, max {stats['mel_max'].max():.3f})")
    return stats


def main_preprocess_uncond(argv=None) -> dict:
    """The unconditional CFG embeddings: the mean normalized mel frame
    (text_uncond) and the mean of the speaker means (spk_uncond) (JAX
    cli.py main_preprocess_uncond; reference process_uncond_mel.py,
    process_uncond_spk.py)."""
    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.preprocess.stats import compute_uncond_mel, compute_uncond_spk

    ap = argparse.ArgumentParser("unitspeech-tpu-torch preprocess-uncond")
    _filelist_flags(ap)
    ap.add_argument("--mel-stats", required=True, help="mel_stats.npz")
    ap.add_argument("--spk-embs", required=True, help="spk_embs.npz")
    ap.add_argument("--out", required=True, help="output uncond_stats.npz")
    args = ap.parse_args(argv)
    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    stats = np.load(args.mel_stats)
    text_uncond = compute_uncond_mel(args.filelist, cfg.data, stats["mel_min"].reshape(-1),
                                     stats["mel_max"].reshape(-1), device=device,
                                     max_files=args.max_files)
    with np.load(args.spk_embs) as embs:
        spk_uncond = compute_uncond_spk({k: embs[k] for k in embs.files})
    np.savez(args.out, text_uncond=text_uncond, spk_uncond=spk_uncond)
    print(f"uncond stats ({text_uncond.shape[0]}-d mel, {spk_uncond.shape[-1]}-d spk) "
          f"-> {args.out}")
    return {"text_uncond": text_uncond, "spk_uncond": spk_uncond}


def _train_parser(name: str, extra) -> argparse.ArgumentParser:
    """A training command's flags: the JAX CLI's (`extra` adds the step's
    own), with --config and --device."""
    ap = argparse.ArgumentParser(f"unitspeech-tpu-torch {name}")
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--spk-embs", required=True, help=".npz of per-speaker embeddings")
    ap.add_argument("--mel-stats", required=True, help=".npz with mel_min/mel_max")
    extra(ap)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--n-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--config", default=None, help="JSON config overlay")
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    return ap


def step1_parser() -> argparse.ArgumentParser:
    """`train-step1`'s flags: the JAX CLI's, with --device and --config."""

    def extra(ap):
        ap.add_argument("--uncond-stats", default=None,
                        help=".npz with text_uncond/spk_uncond (CFG training)")
        ap.add_argument("--language", default="en-us",
                        help="espeak language of the filelist's text; without espeak-ng the "
                             "text must be pre-phonemized IPA, as in the JAX CLI")

    return _train_parser("train-step1", extra)


def step2_parser() -> argparse.ArgumentParser:
    """`train-step2`'s flags: the JAX CLI's, with --device and --config."""

    def extra(ap):
        ap.add_argument("--decoder", required=True,
                        help="the frozen pretrained decoder: a STEP1 checkpoint, a decoder "
                             "bundle or a reference .pt")

    return _train_parser("train-step2", extra)


def _train_inputs(args):
    """(device, config, speaker embeddings, mel_min, mel_max) of a training
    command: the config overlay with --batch-size applied, the mel
    statistics on the device."""
    import dataclasses

    import torch

    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.utils.artifacts import load_speaker_embs

    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    if args.batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 batch_size=args.batch_size))
    stats = np.load(args.mel_stats)
    mel_min = torch.from_numpy(stats["mel_min"].reshape(-1)).to(device)
    mel_max = torch.from_numpy(stats["mel_max"].reshape(-1)).to(device)
    return device, cfg, load_speaker_embs(args.spk_embs), mel_min, mel_max


def _train_loop(args, cfg, device, train_step, modules, optimizer, dataset, spk_embs, mel_min,
                mel_max, shard):
    from unitspeech_tpu_torch.data.dataset import BucketCollator
    from unitspeech_tpu_torch.train.loop import TrainLoop

    tcfg = cfg.train
    return TrainLoop(cfg=cfg, train_step=train_step, modules=modules, optimizer=optimizer,
                     dataset=dataset,
                     collator=BucketCollator(hop_length=cfg.data.hop_length,
                                             num_downsamplings=cfg.decoder.num_downsamplings),
                     mel_min=mel_min, mel_max=mel_max, spk_embs=spk_embs,
                     log_dir=args.log_dir or tcfg.log_dir,
                     checkpoint_dir=args.checkpoint_dir or tcfg.checkpoint_dir,
                     save_every=tcfg.save_every, seed=tcfg.seed, device=device, shard=shard)


def build_step1(args):
    """(config, TrainLoop) of `train-step1` from its parsed flags: the text
    encoder, duration predictor and decoder from flax's initializers
    (utils/params.init_params, seeded by the config's train.seed; the
    decoder's unconditional embeddings from --uncond-stats), Adam at
    train.learning_rate with per-module clipping, the decoder's activations
    in bf16 when train.use_bf16 (parameters f32), on --device."""
    import torch

    from unitspeech_tpu_torch import text as text_frontend
    from unitspeech_tpu_torch.data.dataset import TextMelSpeakerDataset, parse_filelist
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.parallel import train_shard
    from unitspeech_tpu_torch.train.steps import make_step1_train_step
    from unitspeech_tpu_torch.utils.params import init_params

    device, cfg, spk_embs, mel_min, mel_max = _train_inputs(args)
    tcfg = cfg.train
    ph = text_frontend.get_phonemizer(args.language)

    def text_to_ids(t):
        if ph is None:  # pre-phonemized filelists
            return text_frontend.phonemes_to_sequence(t, add_blank=cfg.data.add_blank)
        return text_frontend.text_to_sequence(t, ph, add_blank=cfg.data.add_blank)

    dataset = TextMelSpeakerDataset(parse_filelist(args.filelist), text_to_ids,
                                    hop_length=cfg.data.hop_length,
                                    sampling_rate=cfg.data.sampling_rate)
    params = init_params(cfg, torch.Generator().manual_seed(tcfg.seed))
    spk_uncond = None
    if args.uncond_stats:
        uz = np.load(args.uncond_stats)
        spk_uncond = torch.from_numpy(uz["spk_uncond"].reshape(-1)).to(device)
        params["decoder"]["text_uncon"] = torch.from_numpy(uz["text_uncond"].reshape(-1))
        params["decoder"]["spk_uncon"] = torch.from_numpy(uz["spk_uncond"].reshape(-1))
    with device:
        modules = {"text_encoder": Encoder.from_config(cfg.text_encoder),
                   "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
                   "decoder": UnitSpeech.from_config(
                       cfg.decoder, dtype=torch.bfloat16 if tcfg.use_bf16 else torch.float32)}
    for name, mod in modules.items():
        mod.load_state_dict(params[name])
        mod.train().requires_grad_(True)
    optimizer = torch.optim.Adam([p for m in modules.values() for p in m.parameters()],
                                 lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    shard = train_shard(tcfg.batch_size)
    train_step = make_step1_train_step(
        *modules.values(), optimizer, out_size=cfg.out_size, spk_uncond=spk_uncond,
        spk_dropout=tcfg.spk_dropout,
        clip_norms=(tcfg.grad_clip_encoder, tcfg.grad_clip_duration, tcfg.grad_clip_decoder),
        beta_min=cfg.decoder.beta_min, beta_max=cfg.decoder.beta_max,
        shard=None if shard.group is None else shard)
    return cfg, _train_loop(args, cfg, device, train_step, modules, optimizer, dataset, spk_embs,
                            mel_min, mel_max, shard)


def build_step2(args):
    """(config, TrainLoop) of `train-step2` from its parsed flags: the unit
    encoder from flax's initializers (seeded by train.seed), the only
    trained module, with Adam at train.learning_rate and one clip of 5;
    the decoder of --decoder frozen in the step (its activations in bf16
    when train.use_bf16, parameters f32, no kernel: the plain estimator,
    as JAX builds it), on --device. A checkpoint holds the unit encoder
    and its Adam state."""
    import torch

    from unitspeech_tpu_torch.data.dataset import UnitMelSpeakerDataset, parse_filelist
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.parallel import train_shard
    from unitspeech_tpu_torch.train.steps import make_step2_train_step
    from unitspeech_tpu_torch.utils.artifacts import load_decoder_bundle
    from unitspeech_tpu_torch.utils.params import init_params

    device, cfg, spk_embs, mel_min, mel_max = _train_inputs(args)
    tcfg = cfg.train
    dataset = UnitMelSpeakerDataset(parse_filelist(args.filelist),
                                    hop_length=cfg.data.hop_length,
                                    sampling_rate=cfg.data.sampling_rate)
    params = init_params(cfg, torch.Generator().manual_seed(tcfg.seed), ("unit_encoder",))
    with device:
        unit_encoder = Encoder.from_config(cfg.unit_encoder)
        decoder = UnitSpeech.from_config(
            cfg.decoder, dtype=torch.bfloat16 if tcfg.use_bf16 else torch.float32)
    unit_encoder.load_state_dict(params["unit_encoder"])
    unit_encoder.train()
    decoder.load_state_dict(load_decoder_bundle(args.decoder, cfg.decoder).state_dict)
    optimizer = torch.optim.Adam(unit_encoder.parameters(), lr=tcfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    shard = train_shard(tcfg.batch_size)
    train_step = make_step2_train_step(unit_encoder, decoder, optimizer, out_size=cfg.out_size,
                                       beta_min=cfg.decoder.beta_min,
                                       beta_max=cfg.decoder.beta_max,
                                       shard=None if shard.group is None else shard)
    loop = _train_loop(args, cfg, device, train_step, {"unit_encoder": unit_encoder}, optimizer,
                       dataset, spk_embs, mel_min, mel_max, shard)
    return cfg, loop, decoder


def _run_training(args, cfg, loop) -> dict:
    """Run a TrainLoop (resumed with --resume) for --n-epochs (else the
    config's); returns and prints its statistics: the newest checkpoint,
    the epoch and step it started from, the steps, each step's metrics and
    seconds, and the median ms a step after the first."""
    from unitspeech_tpu_torch.utils.checkpoint import latest_checkpoint

    metrics = []
    loop.step_hook = lambda step, m: metrics.append(m)
    start = loop.resume() if args.resume else 0
    first_step = loop.step
    t0 = time.perf_counter()
    loop.run(args.n_epochs or cfg.train.n_epochs, start)
    wall = time.perf_counter() - t0
    secs = loop.step_seconds
    res = {"checkpoint": latest_checkpoint(loop.checkpoint_dir), "start_epoch": start,
           "first_step": first_step, "steps": loop.step, "seconds": wall,
           "ms_per_step": float(np.median(secs[1:]) * 1e3) if len(secs) > 1 else None,
           "step_seconds": secs, "metrics": metrics, "device": str(loop.device)}
    print(json.dumps({k: v for k, v in res.items() if k not in ("metrics", "step_seconds")}))
    return res


@strict_f32()
def main_train_step1(argv=None) -> dict:
    """STEP1 training (JAX cli.py main_train_step1; reference
    train_STEP1.py; see build_step1), MAS on the card (M1), resumable.
    Returns its statistics (_run_training)."""
    args = step1_parser().parse_args(argv)
    cfg, loop = build_step1(args)
    return _run_training(args, cfg, loop)


@strict_f32()
def main_train_step2(argv=None) -> dict:
    """STEP2 training (JAX cli.py main_train_step2; reference
    train_STEP2.py; see build_step2): the unit encoder against the frozen
    decoder, resumable. Its checkpoints serve `cli finetune
    --unit-encoder`. Returns its statistics (_run_training)."""
    args = step2_parser().parse_args(argv)
    cfg, loop, _ = build_step2(args)
    return _run_training(args, cfg, loop)


def main_make_filelist(argv=None) -> dict:
    """`path|text|speaker` train / valid / test filelists from a corpus tree,
    on the host (JAX cli.py main_make_filelist; the reference ships fixed
    filelists, resources/filelists): a split seeded by --seed, the files
    byte-identical to the JAX CLI's.

    Layouts:
      ljspeech: ROOT/metadata.csv (`id|raw|normalized`), wavs at
                ROOT/wavs/<id>.wav, one speaker, 0.
      libritts: ROOT/**/<utt>.wav with <utt>.normalized.txt (or .txt);
                the speaker is the first path component under ROOT.
      generic:  ROOT/**/<utt>.wav with <utt>.txt or .lab; the speaker is
                the parent directory's name.
    Returns {split: rows}."""
    import random

    ap = argparse.ArgumentParser("unitspeech-tpu-torch make-filelist")
    ap.add_argument("--corpus", choices=("ljspeech", "libritts", "generic"), required=True)
    ap.add_argument("--root", required=True, help="corpus root directory")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--valid", type=int, default=100,
                    help="held-out validation utterances (the reference's ljspeech valid.txt "
                         "has 94)")
    ap.add_argument("--test", type=int, default=500,
                    help="held-out test utterances (the reference's test.txt: 487)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speaker-ids", action="store_true",
                    help="map speaker names to dense integer ids (multi-speaker training "
                         "wants int ids; by default generic corpora keep the names)")
    args = ap.parse_args(argv)

    entries = []  # (path, text, speaker)
    if args.corpus == "ljspeech":
        with open(os.path.join(args.root, "metadata.csv"), encoding="utf-8") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("|")
                if len(parts) < 2:
                    continue
                entries.append((os.path.join(args.root, "wavs", parts[0] + ".wav"), parts[-1],
                                "0"))
    else:
        for dirpath, _dirnames, filenames in sorted(os.walk(args.root)):
            for fn in sorted(filenames):
                if not fn.endswith(".wav"):
                    continue
                stem = os.path.join(dirpath, fn[:-4])
                text = None
                for ext in (".normalized.txt", ".txt", ".lab"):
                    if os.path.exists(stem + ext):
                        with open(stem + ext, encoding="utf-8") as fh:
                            text = fh.read().strip().replace("|", " ")
                        break
                if text is None:
                    continue
                if args.corpus == "libritts":
                    spk = os.path.relpath(dirpath, args.root).split(os.sep)[0]
                else:
                    spk = os.path.basename(dirpath)
                entries.append((stem + ".wav", text, spk))
    if not entries:
        raise SystemExit("no utterances found")
    if args.speaker_ids:
        ids = {s: i for i, s in enumerate(sorted({e[2] for e in entries}))}
        entries = [(p, t, str(ids[s])) for p, t, s in entries]

    order = list(range(len(entries)))
    random.Random(args.seed).shuffle(order)
    n_valid = min(args.valid, max(0, len(entries) - 1))
    n_test = min(args.test, max(0, len(entries) - n_valid - 1))
    splits = {"valid": [entries[i] for i in order[:n_valid]],
              "test": [entries[i] for i in order[n_valid:n_valid + n_test]],
              "train": [entries[i] for i in order[n_valid + n_test:]]}
    os.makedirs(args.out_dir, exist_ok=True)
    for name, rows in splits.items():
        out = os.path.join(args.out_dir, f"{name}.txt")
        with open(out, "w", encoding="utf-8") as fh:
            for p, t, spk in sorted(rows):
                fh.write(f"{p}|{t}|{spk}\n")
        print(f"{out}: {len(rows)} utterances")
    return splits


def main_preprocess_spk_embs(argv=None) -> dict:
    """Each speaker's mean WavLM + ECAPA embedding over filelists (JAX
    cli.py main_preprocess_spk_embs; reference process_spkr_embs.py), the
    checkpoint loaded once. Each wav is embedded at its exact length (the
    reference's behavior, so that the corpus artifact matches it) unless
    --bucket-ssl. Returns {speaker id: (S,)}."""
    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.preprocess.stats import compute_speaker_embs

    ap = argparse.ArgumentParser("unitspeech-tpu-torch preprocess-spk-embs")
    _filelist_flags(ap)
    ap.add_argument("--speaker-embedder", required=True,
                    help="WavLM + ECAPA: the reference's speaker_encoder.pt or a port file")
    ap.add_argument("--out", required=True, help="output spk_embs.npz")
    ap.add_argument("--bucket-ssl", action="store_true",
                    help="reflect-extend the wavs to the sample-bucket ladder "
                         f"{DEFAULT_SPK_SAMPLE_BUCKETS} (the fine-tune's); by default each "
                         "wav is embedded at its exact length, as the reference does")
    args = ap.parse_args(argv)
    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    model = load_speaker_embedder(args.speaker_embedder, cfg, device)
    buckets = DEFAULT_SPK_SAMPLE_BUCKETS if args.bucket_ssl else None
    means = compute_speaker_embs(
        args.filelist, lambda wav, sr: embed_speaker(model, wav, sr, cfg, buckets), args.out,
        args.max_files)
    print(f"{len(means)} speaker embedding(s) -> {args.out}")
    return means


def main_preprocess_units(argv=None) -> int:
    """`<stem>.units.npz` {units, durations} beside every wav of filelists
    through mHuBERT + k-means, each wav resampled to
    cfg.unit_extractor.sr (JAX cli.py main_preprocess_units; reference
    process_units.py), the models loaded once. Returns the wav count."""
    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.preprocess.stats import extract_units as extract_all

    ap = argparse.ArgumentParser("unitspeech-tpu-torch preprocess-units")
    _filelist_flags(ap)
    ap.add_argument("--hubert", required=True,
                    help="mHuBERT: a fairseq checkpoint or a port file")
    ap.add_argument("--kmeans", required=True,
                    help="k-means centroids: .npz, or sklearn's joblib file (needs sklearn)")
    args = ap.parse_args(argv)
    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    encoder = build_unit_extractor(args.hubert, args.kmeans, cfg, device)
    count = extract_all(args.filelist, lambda wav, sr: extract_units(encoder, wav, sr, cfg),
                        args.max_files)
    print(f"unit sidecars for {count} wav(s)")
    return count


@strict_f32()
def main_train_vocoder(argv=None) -> dict:
    """BigVGAN's GAN training against the full MPD and MRD (JAX cli.py
    main_train_vocoder; train/vocoder_loop.py), the generator on its plain
    path; its checkpoints serve `cli inference --vocoder` on K5 / K6.
    Filelists longer than --preload-limit load each wav per draw. Prints
    {"final_metrics"}; returns it with the steps run, their wall, each
    step's seconds (train_vocoder) and their median in ms."""
    from functools import partial

    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.data.dataset import parse_filelist
    from unitspeech_tpu_torch.train.vocoder_loop import VocoderTrainConfig, train_vocoder

    ap = argparse.ArgumentParser("unitspeech-tpu-torch train-vocoder")
    ap.add_argument("--filelist", required=True, help="wav filelist (path or path|text|spk lines)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--segment-size", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preload-limit", type=int, default=256,
                    help="filelists longer than this load each wav per draw instead of "
                         "holding the corpus in host memory")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--config", default=None, help="JSON config overlay")
    ap.add_argument("--device", default="cuda")
    add_launch_flags(ap)
    args = ap.parse_args(argv)
    device = _launch_device(args)
    cfg = load_json(args.config) if args.config else MainConfig()
    rows = parse_filelist(args.filelist)

    def checked_load(path):
        wav, sr = load_wav(path)
        if sr != cfg.data.sampling_rate:
            raise ValueError(f"{path}: {sr} != {cfg.data.sampling_rate}")
        return wav

    try:
        if len(rows) > args.preload_limit:
            # per draw; each file's rate is checked when it is first read
            wavs = [partial(checked_load, row[0]) for row in rows]
            checked_load(rows[0][0])  # fail fast on a corpus at the wrong rate
        else:
            wavs = [checked_load(row[0]) for row in rows]
    except ValueError as e:
        raise SystemExit(str(e))
    tcfg = VocoderTrainConfig(segment_size=args.segment_size, batch_size=args.batch_size,
                              learning_rate=args.lr, steps=args.steps, seed=args.seed,
                              save_every=args.save_every)
    t0 = time.perf_counter()
    trainer, metrics, secs = train_vocoder(cfg, wavs, tcfg, log_dir=args.log_dir,
                                           checkpoint_dir=args.checkpoint_dir,
                                           resume=args.resume, device=device)
    print(json.dumps({"final_metrics": metrics}))
    return {"final_metrics": metrics, "steps": trainer.step, "seconds": time.perf_counter() - t0,
            "step_seconds": secs, "ms_per_step": float(np.median(secs) * 1e3) if secs else None,
            "device": str(device)}


@strict_f32()
def main_evaluate(argv=None) -> dict:
    """The metric summary of a generated-samples directory as one CSV row
    (JAX cli.py main_evaluate; the reference's evaluation-metrics
    notebook): the RTF statistics of timings.npz, WER / CER through an ASR
    hook, predicted MOS through a MOS hook, speaker cosine through an
    embedding hook, and the unit round trip (uer_*) through a unit hook or
    the port's mHuBERT + k-means on --device. External models are
    'module:function' hooks:
        --asr-hook  m:f   f(wav, sr) -> str
        --mos-hook  m:f   f(wav, sr) -> float
        --spk-hook  m:f   f(wav, sr) -> np.ndarray embedding
        --unit-hook m:f   f(wav, sr) -> unit-id array
    Writes the row to --out (default <samples-dir>/summary.csv), prints it
    as JSON and returns it."""
    ap = argparse.ArgumentParser("unitspeech-tpu-torch evaluate")
    ap.add_argument("--samples-dir", required=True,
                    help="directory from eval/generate_samples.py (sample_*.wav + timings.npz)")
    ap.add_argument("--filelist", default=None,
                    help="path|text|spk filelist giving the reference text for sample i on "
                         "line i (enables WER/CER)")
    ap.add_argument("--reference-wav", default=None,
                    help="target-speaker reference wav (enables speaker cosine with "
                         "--spk-hook)")
    ap.add_argument("--asr-hook", default=None)
    ap.add_argument("--mos-hook", default=None)
    ap.add_argument("--spk-hook", default=None)
    ap.add_argument("--unit-hook", default=None,
                    help="'module:function' f(wav, sr) -> unit-id array for the unit round "
                         "trip (uer_*); alternatively --hubert and --kmeans")
    ap.add_argument("--hubert", default=None,
                    help="mHuBERT for the unit extractor: a fairseq checkpoint or a port file")
    ap.add_argument("--kmeans", default=None,
                    help="k-means centroids for the unit extractor (.npz, or sklearn's joblib)")
    ap.add_argument("--uer-ref-dir", default=None,
                    help="directory of ground-truth wavs for sample i (sorted); default: the "
                         "wav paths in --filelist")
    ap.add_argument("--out", default=None,
                    help="summary CSV path (default <samples-dir>/summary.csv)")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay: the unit extractor's dense model and layer "
                         "(default: the reference's)")
    ap.add_argument("--device", default="cuda", help="the unit extractor's device")
    args = ap.parse_args(argv)

    import glob

    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.data.dataset import parse_filelist
    from unitspeech_tpu_torch.eval import harness

    device = _device(args.device)
    wav_paths = sorted(glob.glob(os.path.join(args.samples_dir, "sample_*.wav")))
    if not wav_paths:
        raise SystemExit(f"no sample_*.wav under {args.samples_dir}")
    wavs = [load_wav(p) for p in wav_paths]

    timings = None
    tpath = os.path.join(args.samples_dir, "timings.npz")
    if os.path.exists(tpath):
        timings = harness.EvalTimings.load(tpath)

    transcription_pairs = transcribe = None
    if args.asr_hook and args.filelist:
        texts = [e[1] for e in parse_filelist(args.filelist)]
        transcription_pairs = [(w, sr, t) for (w, sr), t in zip(wavs, texts)]
        transcribe = harness.load_hook(args.asr_hook)

    predict_mos = harness.load_hook(args.mos_hook) if args.mos_hook else None

    embedding_pairs = None
    if args.spk_hook and args.reference_wav:
        embed = harness.load_hook(args.spk_hook)
        ref_emb = np.asarray(embed(*load_wav(args.reference_wav)))
        embedding_pairs = [(ref_emb, np.asarray(embed(w, sr))) for w, sr in wavs]

    # the unit round trip: units of each sample and of its ground-truth wav
    # (--uer-ref-dir, sorted, else the --filelist paths)
    unit_pairs = extract = None
    if args.unit_hook or (args.hubert and args.kmeans):
        if args.unit_hook:
            extract = harness.load_hook(args.unit_hook)
        else:
            cfg = load_json(args.config) if args.config else MainConfig()
            extract = harness.speech_encoder_unit_hook(
                build_unit_extractor(args.hubert, args.kmeans, cfg, device))
        if args.uer_ref_dir:
            ref_paths = sorted(glob.glob(os.path.join(args.uer_ref_dir, "*.wav")))
        elif args.filelist:
            ref_paths = [e[0] for e in parse_filelist(args.filelist)]
        else:
            ref_paths = []
        if not ref_paths:
            print("uer: no ground-truth wavs (--uer-ref-dir / --filelist); skipping",
                  file=sys.stderr)
            extract = None
        else:
            unit_pairs = [(w, sr, *load_wav(p)) for (w, sr), p in zip(wavs, ref_paths)]

    row = harness.evaluation_summary(
        timings=timings, transcription_pairs=transcription_pairs, transcribe=transcribe,
        mos_wavs=wavs if predict_mos else None, predict_mos=predict_mos,
        embedding_pairs=embedding_pairs, unit_pairs=unit_pairs, extract_units=extract)
    row["n_samples"] = len(wavs)
    out = args.out or os.path.join(args.samples_dir, "summary.csv")
    harness.write_summary_csv(out, row)
    print(json.dumps(row))
    print(f"summary -> {out}")
    return row


def main_convert(argv=None) -> int:
    from unitspeech_tpu_torch.utils import convert_cli

    return convert_cli.main(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"inference": main_inference, "serve": main_serve, "finetune": main_finetune,
                "voice-conversion": main_voice_conversion, "convert": main_convert,
                "make-random-checkpoint": main_make_random_checkpoint,
                "preprocess-mel-stats": main_preprocess_mel_stats,
                "preprocess-uncond": main_preprocess_uncond, "train-step1": main_train_step1,
                "train-step2": main_train_step2, "make-filelist": main_make_filelist,
                "preprocess-spk-embs": main_preprocess_spk_embs,
                "preprocess-units": main_preprocess_units, "train-vocoder": main_train_vocoder,
                "evaluate": main_evaluate}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m unitspeech_tpu_torch.cli {{{','.join(commands)}}} ...",
              file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
