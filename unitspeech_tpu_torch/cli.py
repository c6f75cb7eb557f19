"""Command-line entry points of the port (counterpart of
unitspeech_tpu/cli.py for the adaptive-TTS, speaker-adaptation and
voice-conversion slices and the SSL frontends).

    python -m unitspeech_tpu_torch.cli make-random-checkpoint --seed 0 --output ckpt.pt
    python -m unitspeech_tpu_torch.cli inference --text "Hello." [--language en-us] \\
        --checkpoint ckpt.pt [--decoder adapted/decoder.pt] --output out.wav
    python -m unitspeech_tpu_torch.cli finetune --reference ref.wav \\
        --decoder ckpt.pt --unit-encoder ckpt.pt --speaker-embedder spk.pt \\
        --hubert hubert.pt --kmeans kmeans.npz --output-dir adapted
    python -m unitspeech_tpu_torch.cli voice-conversion --source src.wav \
        --decoder adapted/decoder.pt --content-encoder ce.pt --contentvec cv.pt \
        --vocoder voc.pt [--sampler dpm2:cs2] --output converted.wav
    python -m unitspeech_tpu_torch.cli convert decoder pretrained_decoder.pt decoder.pt

A checkpoint is a `torch.save`d dict: one state dict per module in the
port's layout, the speaker embedding, the mel min/max and the config
(utils/artifacts lists the port's formats). Every command runs on the card
unless `--device cpu` is given; with no CUDA device `--device cuda` exits
non-zero. f32 means f32: `inference`, `finetune` and `voice-conversion`
run with TF32 off for f32 matmuls and cuDNN convs
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

from unitspeech_tpu_torch.utils.audio import load_wav, write_wav
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
    if spk is None:
        raise SystemExit("no speaker embedding: pass --spk-emb or a decoder with spk_emb")
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

    device = _device(args.device)
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


def resample_to(wav: np.ndarray, sr: int, target: int) -> np.ndarray:
    """wav at sr -> f32 at target (scipy resample_poly on the host, in
    float64, as the JAX CLI)."""
    if sr == target:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    return resample_poly(np.asarray(wav, np.float64), target, sr).astype(np.float32)


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
    """The mHuBERT + k-means SpeechEncoder (wav at 16 kHz -> units,
    durations), its models on `device`; load it once and reuse it."""
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
        raise SystemExit(f"{ucfg.dense_model_name}: the CPC dense models are not ported yet "
                         "(ROADMAP Queue 1 item 12)")
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
    args = ap.parse_args(argv)

    import torch

    from unitspeech_tpu_torch.config import MainConfig, config_from_dict, load_json
    from unitspeech_tpu_torch.train.finetune import finetune_decoder
    from unitspeech_tpu_torch.utils import artifacts

    device = _device(args.device)
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
    device = _device(args.device)
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


def main_convert(argv=None) -> int:
    from unitspeech_tpu_torch.utils import convert_cli

    return convert_cli.main(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"inference": main_inference, "finetune": main_finetune,
                "voice-conversion": main_voice_conversion, "convert": main_convert,
                "make-random-checkpoint": main_make_random_checkpoint}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m unitspeech_tpu_torch.cli {{{','.join(commands)}}} ...",
              file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
