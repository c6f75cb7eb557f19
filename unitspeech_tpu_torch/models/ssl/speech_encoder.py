"""SpeechEncoder: waveform -> {units, durations, dense[, f0]} (counterpart
of unitspeech_tpu/models/ssl/speech_encoder.py; textlesslib SpeechEncoder):
a dense model (mHuBERT or CPC) -> k-means -> optional run-length
deduplication, bos/eos wrapping and an F0 stream aligned to the units
(need_f0), on a 16 kHz wav (maybe_resample, or the CLI, resamples on the
host). The dense model, the k-means product and the F0 candidates run on
the dense model's device; deduplication, the F0 track's DP and its pooling
to units are on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer, dedup_consecutive
from unitspeech_tpu_torch.ops.f0 import F0_FRAME_SPACE, align_f0_to_durations, extract_f0
from unitspeech_tpu_torch.utils.audio import resample_to


@dataclass
class SpeechEncoder:
    dense_model: Any  # HubertFeatureReader or CpcFeatureReader
    quantizer: KMeansQuantizer
    deduplicate: bool = True
    add_bos_eos: bool = False
    need_f0: bool = False
    f0_normalizer: Optional[Callable] = None
    f0_quantizer: Optional[Callable] = None

    @property
    def vocab_size(self) -> int:
        return self.quantizer.vocab_size

    @property
    def bos(self) -> int:
        return self.vocab_size

    @property
    def eos(self) -> int:
        return self.vocab_size + 1

    @property
    def code_hop_size(self) -> int:
        return self.dense_model.hop

    @property
    def expected_sample_rate(self) -> int:
        return 16000

    @property
    def f0_code_ratio(self) -> float:
        """F0 frames per unit frame (speech_encoder.py:171-177)."""
        return self.code_hop_size / self.expected_sample_rate / F0_FRAME_SPACE

    def maybe_resample(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """wav at sr -> the dense model's rate: unchanged at that rate, else
        resample_poly in float64 to f32 (JAX speech_encoder.py
        maybe_resample)."""
        if sr == self.expected_sample_rate:
            return wav
        return resample_to(wav, sr, self.expected_sample_rate)

    def _f0_stream(self, wav: np.ndarray, durations: np.ndarray, speaker, device) -> np.ndarray:
        """The wav's F0 track (candidates on `device`), normalized, pooled to
        one value a unit (ValueError where the track misses the units'
        length by more than 5 units' frames, speech_encoder.py:51), then
        quantized."""
        import torch

        f0 = extract_f0(torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(device))
        if self.f0_normalizer is not None:
            f0 = self.f0_normalizer(f0, speaker)
        f0 = align_f0_to_durations(f0, durations, self.f0_code_ratio, tol=5 * self.f0_code_ratio)
        if self.f0_quantizer is not None:
            f0 = self.f0_quantizer(f0)
        return f0

    def __call__(self, wav: np.ndarray, speaker=None) -> Dict[str, np.ndarray]:
        """wav (samples,) at 16 kHz -> {"units", "durations", "dense"[, "f0"]};
        without deduplication every duration is 1. `speaker` is the F0
        normalizer's key."""
        wav = np.asarray(wav)
        if wav.ndim > 1:  # multi-channel -> mono
            wav = wav.mean(axis=0)
        dense = self.dense_model.features(wav)  # (T, D) on the model's device
        units = self.quantizer(dense)
        device = dense.device
        dense = dense.cpu().numpy()
        if self.deduplicate:
            units, durations = dedup_consecutive(units)
        else:
            durations = np.ones_like(units, dtype=np.int64)
        f0 = self._f0_stream(wav, durations, speaker, device) if self.need_f0 else None
        units = np.asarray(units, np.int64)
        durations = np.asarray(durations, np.int64)
        if self.add_bos_eos:
            units = np.concatenate([[self.bos], units, [self.eos]])
            durations = np.concatenate([[0], durations, [0]])
            dense = np.concatenate([np.zeros_like(dense[:1]), dense, np.zeros_like(dense[:1])])
            if f0 is not None:
                f0 = np.concatenate([np.zeros_like(f0[:1]), f0, np.zeros_like(f0[:1])])
        out = {"units": units, "durations": durations, "dense": dense}
        if f0 is not None:
            out["f0"] = f0
        return out
