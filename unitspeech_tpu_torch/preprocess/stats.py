"""Dataset-level preprocessing for STEP1 (counterpart of
unitspeech_tpu/preprocess/stats.py; reference preprocessing/*.py), .npz
artifacts:

  compute_mel_stats   -> mel_stats.npz {mel_min, mel_max}   (process_mel_normalization.py)
  compute_uncond_mel  -> text_uncond, the mean normalized mel frame (process_uncond_mel.py)
  compute_uncond_spk  -> spk_uncond, the mean of the speaker means (process_uncond_spk.py)

Each wav's log-mel is computed on `device` (ops/mel.py) and reduced on the
host in the JAX package's order and precision. The per-speaker embeddings
(`preprocess-spk-embs`) and the units wait for a later slice.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

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
