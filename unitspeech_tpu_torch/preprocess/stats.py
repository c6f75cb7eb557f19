"""Dataset-level preprocessing for STEP1 and STEP2 (counterpart of
unitspeech_tpu/preprocess/stats.py; reference preprocessing/*.py), .npz
artifacts:

  compute_mel_stats    -> mel_stats.npz {mel_min, mel_max}   (process_mel_normalization.py)
  compute_uncond_mel   -> text_uncond, the mean normalized mel frame (process_uncond_mel.py)
  compute_uncond_spk   -> spk_uncond, the mean of the speaker means (process_uncond_spk.py)
  compute_speaker_embs -> spk_embs.npz {<id>: (S,)}, each speaker's mean (process_spkr_embs.py)
  extract_units        -> <stem>.units.npz {units, durations} (process_units.py)

Each wav's log-mel is computed on `device` (ops/mel.py) and reduced on the
host in the JAX package's order and precision. The speaker embeddings and
the units come from the caller's embed / encode function (the CLI's SSL
frontends, on their device).

`max_files` follows the JAX entry points: the mel statistics stop after
max_files wavs in all; the speaker embeddings and the units stop the
filelist they are in once the running count reaches max_files, and each
later filelist then adds one more wav before it stops too (JAX's `break`
leaves only the inner loop).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from unitspeech_tpu_torch.data.dataset import parse_filelist
from unitspeech_tpu_torch.ops.mel import mel_spectrogram, normalize_mel
from unitspeech_tpu_torch.utils.audio import load_wav


def _iter_mels(filelists: Iterable[str], data_cfg, device="cpu",
               max_files: Optional[int] = None):
    """(path, spk_id, log-mel (T, F) f32 numpy) for every wav of the
    filelists, at most max_files of them."""
    count = 0
    for fl in filelists:
        for entry in parse_filelist(fl):
            path, _text, spk = (entry + ["0"])[:3]
            wav, sr = load_wav(path)
            if sr != data_cfg.sampling_rate:
                raise ValueError(f"{path}: {sr} != {data_cfg.sampling_rate}")
            mel = mel_spectrogram(
                torch.from_numpy(wav)[None].to(device), n_fft=data_cfg.n_fft,
                num_mels=data_cfg.n_feats, sampling_rate=data_cfg.sampling_rate,
                hop_size=data_cfg.hop_length, win_size=data_cfg.win_length,
                fmin=data_cfg.mel_fmin, fmax=data_cfg.mel_fmax)
            yield path, int(spk), mel[0].cpu().numpy()
            count += 1
            if max_files and count >= max_files:
                return


def compute_mel_stats(filelists: List[str], data_cfg, out_path: str, device="cpu",
                      max_files: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Global per-channel log-mel min / max over the dataset, written to
    out_path (reference process_mel_normalization.py:15-58)."""
    mel_min = np.full((data_cfg.n_feats,), np.inf, np.float32)
    mel_max = np.full((data_cfg.n_feats,), -np.inf, np.float32)
    for _path, _spk, mel in _iter_mels(filelists, data_cfg, device, max_files):
        mel_min = np.minimum(mel_min, mel.min(axis=0))
        mel_max = np.maximum(mel_max, mel.max(axis=0))
    np.savez(out_path, mel_min=mel_min, mel_max=mel_max)
    return {"mel_min": mel_min, "mel_max": mel_max}


def compute_uncond_mel(filelists: List[str], data_cfg, mel_min, mel_max, device="cpu",
                       max_files: Optional[int] = None) -> np.ndarray:
    """The global mean normalized mel frame, the text_uncond CFG embedding
    (reference process_uncond_mel.py:22-48): each wav's frames normalized
    and summed in f32, the sums accumulated in float64."""
    total = np.zeros((data_cfg.n_feats,), np.float64)
    n = 0
    for _path, _spk, mel in _iter_mels(filelists, data_cfg, device, max_files):
        normed = normalize_mel(mel, mel_min, mel_max)
        total += np.asarray(normed).sum(axis=0)
        n += normed.shape[0]
    return (total / max(n, 1)).astype(np.float32)


def compute_uncond_spk(spk_embs: Dict[int, np.ndarray]) -> np.ndarray:
    """The mean of the speaker means, the spk_uncond CFG embedding
    (reference process_uncond_spk.py:34-44)."""
    return np.mean(np.stack(list(spk_embs.values())), axis=0).astype(np.float32)


def compute_speaker_embs(filelists: List[str], embed_fn: Callable[[np.ndarray, int], np.ndarray],
                         out_path: str, max_files: Optional[int] = None) -> Dict[int, np.ndarray]:
    """Each speaker's mean embedding over its wavs, written to out_path
    keyed by speaker id (reference process_spkr_embs.py:63-100, which
    assumed speaker-contiguous filelists; this does not): embed_fn(wav, sr)
    -> the embedding, summed in float64, the means f32."""
    sums: Dict[int, np.ndarray] = {}
    counts: Dict[int, int] = {}
    for fl in filelists:
        for entry in parse_filelist(fl):
            path, _text, spk = (entry + ["0"])[:3]
            wav, sr = load_wav(path)
            emb = np.asarray(embed_fn(wav, sr)).reshape(-1)
            spk_id = int(spk)
            if spk_id not in sums:
                sums[spk_id] = np.zeros_like(emb, np.float64)
                counts[spk_id] = 0
            sums[spk_id] += emb
            counts[spk_id] += 1
            if max_files and sum(counts.values()) >= max_files:
                break
    means = {k: (sums[k] / counts[k]).astype(np.float32) for k in sums}
    np.savez(out_path, **{str(k): v for k, v in means.items()})
    return means


def extract_units(filelists: List[str],
                  encode_fn: Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]],
                  max_files: Optional[int] = None) -> int:
    """Write `<stem>.units.npz` {units, durations} beside every wav of the
    filelists (reference process_units.py:31-51 writes _unit.pt /
    _duration.pt): encode_fn(wav, sr) -> (units, durations), resampling
    the wav to its model's rate itself (cli.extract_units). Returns the
    number of wavs written."""
    count = 0
    for fl in filelists:
        for entry in parse_filelist(fl):
            path = entry[0]
            wav, sr = load_wav(path)
            units, durations = encode_fn(wav, sr)
            np.savez(path.rsplit(".", 1)[0] + ".units.npz", units=units, durations=durations)
            count += 1
            if max_files and count >= max_files:
                break
    return count
