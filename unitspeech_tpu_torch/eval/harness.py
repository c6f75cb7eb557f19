"""Evaluation harness: sample generation with RTF accounting and the
objective metrics (counterpart of unitspeech_tpu/eval/harness.py; the
reference's evaluation_generate_samples.py records processing_time /
speech_duration, its metrics notebook computes RTF, Whisper WER/CER,
predicted MOS and speaker cosine similarity):

  * generate_eval_samples: synthesize a sentence list on the models'
    device, timing each request until its waveform is on the host, and
    write the wavs and timings.npz;
  * rtf_summary: the headline RTF statistics;
  * mel_l1 / mel_cepstral_distortion / speaker_cosine_similarity: parity
    metrics;
  * wer / cer / unit_error_rate: edit distances over words, characters or
    discrete units; evaluate_unit_roundtrip scores synthesized audio
    against ground truth through a unit extractor (the port's mHuBERT +
    k-means through speech_encoder_unit_hook);
  * the external models (ASR, MOS, a speaker embedder) plug in as
    'module:function' hooks (load_hook).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from unitspeech_tpu_torch.utils.audio import write_wav


@dataclass
class EvalTimings:
    processing_time: np.ndarray  # (N,) seconds
    speech_duration: np.ndarray  # (N,) seconds

    @property
    def rtf(self) -> float:
        return float(self.processing_time.sum() / self.speech_duration.sum())

    @property
    def rtf_mean_of_ratios(self) -> float:
        """The reference notebook's statistic: mean(proc) / mean(speech)
        (evaluation-metrics.ipynb cell 6)."""
        return float(self.processing_time.mean() / self.speech_duration.mean())

    def save(self, path: str):
        np.savez(path, processing_time=self.processing_time,
                 speech_duration=self.speech_duration)

    @classmethod
    def load(cls, path: str) -> "EvalTimings":
        z = np.load(path)
        return cls(z["processing_time"], z["speech_duration"])


def generate_eval_samples(synthesizer, token_sequences: Sequence[Sequence[int]], out_dir: str,
                          seed: int, diffusion_steps: Optional[int] = None, warmup: int = 1,
                          **synth_kwargs) -> EvalTimings:
    """Synthesize every token sequence with `synthesizer` (infer/tts.py
    Synthesizer), timing each request from its token IDs to its waveform
    on the host, and write sample_<i>.wav and timings.npz to out_dir.
    Sample i draws its noise from a generator on the models' device seeded
    with cli.chunk_seed(seed, i) (JAX folds i into its key); the first
    `warmup` sequences run once before, untimed, from `seed`."""
    import torch

    from unitspeech_tpu_torch.cli import chunk_seed

    device = synthesizer.models.device
    os.makedirs(out_dir, exist_ok=True)

    def run(seq, s):
        gen = torch.Generator(device=device).manual_seed(s)
        return synthesizer(list(seq), gen, diffusion_steps=diffusion_steps, **synth_kwargs)

    for seq in token_sequences[:warmup]:
        run(seq, seed)
    proc, speech = [], []
    for i, seq in enumerate(token_sequences):
        t0 = time.perf_counter()
        wav, sr, _ = run(seq, chunk_seed(seed, i))
        if device.type == "cuda":  # the waveform is on the host; nothing may be left queued
            torch.cuda.synchronize(device)
        proc.append(time.perf_counter() - t0)
        speech.append(len(wav) / sr)
        write_wav(os.path.join(out_dir, f"sample_{i:04d}.wav"), wav, sr)
    timings = EvalTimings(np.asarray(proc), np.asarray(speech))
    timings.save(os.path.join(out_dir, "timings.npz"))
    return timings


def rtf_summary(timings: EvalTimings) -> Dict[str, float]:
    return {
        "rtf": timings.rtf,
        "rtf_mean_of_ratios": timings.rtf_mean_of_ratios,
        "mean_processing_s": float(timings.processing_time.mean()),
        "mean_speech_s": float(timings.speech_duration.mean()),
        "n": int(len(timings.processing_time)),
    }


# --- objective parity metrics ----------------------------------------------


def mel_l1(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mean absolute log-mel difference over the overlapping frames."""
    t = min(mel_a.shape[0], mel_b.shape[0])
    return float(np.abs(mel_a[:t] - mel_b[:t]).mean())


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray, k: int = 13) -> float:
    """MCD-style distance on DCT-II cepstra of log-mels (dB)."""
    from scipy.fft import dct

    t = min(mel_a.shape[0], mel_b.shape[0])
    ca = dct(mel_a[:t], type=2, axis=1, norm="ortho")[:, 1:k]
    cb = dct(mel_b[:t], type=2, axis=1, norm="ortho")[:, 1:k]
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0)
                 * np.sqrt(((ca - cb) ** 2).sum(axis=1)).mean())


def speaker_cosine_similarity(emb_a: np.ndarray, emb_b: np.ndarray) -> float:
    a = emb_a.reshape(-1)
    b = emb_b.reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def edit_distance(ref: np.ndarray, hyp: np.ndarray) -> int:
    """Levenshtein distance between two 1-D integer arrays, one numpy row
    per reference element. Within a row, cur[j] = min(best[j-1], cur[j-1]
    + 1) with cur[0] = i unrolls to cur[j] = j + min over k <= j of v[k],
    v = [i, best[0] - 1, best[1] - 2, ...]: a running minimum, with no
    Python loop over the hypothesis."""
    cols = np.arange(hyp.size + 1)
    row = cols
    for i in range(1, ref.size + 1):
        best = np.minimum(row[:-1] + (ref[i - 1] != hyp), row[1:] + 1)
        row = cols + np.minimum.accumulate(np.concatenate(([i], best)) - cols)
    return int(row[-1])


def _word_ids(*sentences: Sequence[str]):
    ids: Dict[str, int] = {}
    return [np.array([ids.setdefault(w, len(ids)) for w in s], np.int64) for s in sentences]


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate: the word-level edit distance over the reference's
    word count (the reference scores jiwer on Whisper transcripts)."""
    r, h = _word_ids(reference.split(), hypothesis.split())
    return float(edit_distance(r, h) / max(r.size, 1))


def cer(reference: str, hypothesis: str) -> float:
    return wer(" ".join(reference.replace(" ", "")), " ".join(hypothesis.replace(" ", "")))


def unit_error_rate(ref_units, hyp_units, dedup: bool = True) -> float:
    """ASR-free intelligibility proxy: the edit distance between discrete
    unit transcripts over the reference's length, WER over unit IDs. With
    dedup both sequences are run-length collapsed first, so that pace
    differences between two renditions of one text are not errors. An
    empty reference scores 1.0 against a non-empty hypothesis, else 0.0."""
    ref = np.asarray(ref_units).reshape(-1)
    hyp = np.asarray(hyp_units).reshape(-1)
    if dedup:
        if ref.size:
            ref = ref[np.insert(np.diff(ref) != 0, 0, True)]
        if hyp.size:
            hyp = hyp[np.insert(np.diff(hyp) != 0, 0, True)]
    if ref.size == 0:
        return float(hyp.size > 0)
    return float(edit_distance(ref, hyp) / ref.size)


def evaluate_unit_roundtrip(pairs: List, extract_units: Callable[[np.ndarray, int], np.ndarray]
                            ) -> Dict[str, float]:
    """pairs: [(syn_wav, syn_sr, ref_wav, ref_sr)], synthesized vs
    ground-truth audio of the same text; extract_units: (wav, sr) -> unit
    IDs. Returns the set's UER statistics."""
    uers = []
    for syn_wav, syn_sr, ref_wav, ref_sr in pairs:
        hyp = extract_units(np.asarray(syn_wav), syn_sr)
        ref = extract_units(np.asarray(ref_wav), ref_sr)
        uers.append(unit_error_rate(ref, hyp))
    arr = np.asarray(uers, np.float64)
    return {"uer_mean": float(arr.mean()), "uer_median": float(np.median(arr)),
            "uer_max": float(arr.max())}


def speech_encoder_unit_hook(encoder) -> Callable[[np.ndarray, int], np.ndarray]:
    """A models/ssl/speech_encoder.SpeechEncoder as the (wav, sr) -> units
    hook of evaluate_unit_roundtrip, the wav resampled to the encoder's
    16 kHz on the host."""

    def hook(wav: np.ndarray, sr: int) -> np.ndarray:
        return encoder(encoder.maybe_resample(np.asarray(wav), sr))["units"]

    return hook


def evaluate_transcriptions(pairs: List, transcribe: Callable[[np.ndarray, int], str]
                            ) -> Dict[str, float]:
    """pairs: [(wav, sr, reference_text)]; transcribe: an ASR hook."""
    wers, cers = [], []
    for wav, sr, ref_text in pairs:
        hyp = transcribe(wav, sr)
        wers.append(wer(ref_text.lower(), hyp.lower()))
        cers.append(cer(ref_text.lower(), hyp.lower()))
    return {"wer": float(np.mean(wers)), "cer": float(np.mean(cers))}


# --- predicted MOS and the summary table (notebook cells 12-18) ------------


def evaluate_mos(wavs: Sequence, predict_mos: Callable[[np.ndarray, int], float]
                 ) -> Dict[str, float]:
    """wavs: [(wav, sr)]; predict_mos: a hook (wav, sr) -> float (the
    reference uses s3prl's mos_wav2vec2). The set's statistics."""
    scores = np.asarray([float(predict_mos(w, sr)) for w, sr in wavs], np.float64)
    return {"mos_mean": float(scores.mean()), "mos_min": float(scores.min()),
            "mos_max": float(scores.max())}


def load_hook(spec: str):
    """An external model's hook given as 'module.path:function'."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"hook spec {spec!r} must be 'module:function'")
    import importlib

    return getattr(importlib.import_module(mod_name), fn_name)


def evaluation_summary(timings: Optional[EvalTimings] = None,
                       transcription_pairs: Optional[List] = None,
                       transcribe: Optional[Callable] = None,
                       mos_wavs: Optional[Sequence] = None,
                       predict_mos: Optional[Callable] = None,
                       embedding_pairs: Optional[List] = None,
                       unit_pairs: Optional[List] = None,
                       extract_units: Optional[Callable] = None) -> Dict[str, float]:
    """One summary row: the RTF statistics, WER / CER, predicted MOS, the
    unit round trip (uer_*) and speaker cosine, each section skipped when
    its inputs or hook are absent."""
    row: Dict[str, float] = {}
    if timings is not None:
        row.update(rtf_summary(timings))
    if transcription_pairs and transcribe is not None:
        row.update(evaluate_transcriptions(transcription_pairs, transcribe))
    if mos_wavs and predict_mos is not None:
        row.update(evaluate_mos(mos_wavs, predict_mos))
    if unit_pairs and extract_units is not None:
        row.update(evaluate_unit_roundtrip(unit_pairs, extract_units))
    if embedding_pairs:
        sims = [speaker_cosine_similarity(a, b) for a, b in embedding_pairs]
        row["spk_cosine_mean"] = float(np.mean(sims))
        row["spk_cosine_min"] = float(np.min(sims))
    return row


def write_summary_csv(path: str, row: Dict[str, float]):
    """The notebook's final table as a one-header, one-row CSV."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(row.keys()))
        w.writerow([f"{v:.6g}" if isinstance(v, float) else v for v in row.values()])
