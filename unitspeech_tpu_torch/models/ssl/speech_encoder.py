"""SpeechEncoder: waveform -> {units, durations, dense} (counterpart of
unitspeech_tpu/models/ssl/speech_encoder.py; textlesslib SpeechEncoder):
a dense model (mHuBERT) -> k-means -> optional run-length deduplication
and bos/eos wrapping, on a 16 kHz wav (maybe_resample, or the CLI,
resamples on the host). The dense model and the k-means product run on the dense model's device;
deduplication is on the host. The aligned F0 stream
(need_f0) needs ops/f0.py, which the port does not have yet (ROADMAP
Queue 1 item 12); no served path asks for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer, dedup_consecutive
from unitspeech_tpu_torch.utils.audio import resample_to


@dataclass
class SpeechEncoder:
    dense_model: Any  # HubertFeatureReader
    quantizer: KMeansQuantizer
    deduplicate: bool = True
    add_bos_eos: bool = False
    need_f0: bool = False

    def __post_init__(self):
        if self.need_f0:
            raise NotImplementedError("need_f0: the F0 stream (ops/f0.py) is not ported yet "
                                      "(ROADMAP Queue 1 item 12)")

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

    def maybe_resample(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """wav at sr -> the dense model's rate: unchanged at that rate, else
        resample_poly in float64 to f32 (JAX speech_encoder.py
        maybe_resample)."""
        if sr == self.expected_sample_rate:
            return wav
        return resample_to(wav, sr, self.expected_sample_rate)

    def __call__(self, wav: np.ndarray) -> Dict[str, np.ndarray]:
        """wav (samples,) at 16 kHz -> {"units", "durations", "dense"};
        without deduplication every duration is 1."""
        wav = np.asarray(wav)
        if wav.ndim > 1:  # multi-channel -> mono
            wav = wav.mean(axis=0)
        dense = self.dense_model.features(wav)  # (T, D) on the model's device
        units = self.quantizer(dense)
        dense = dense.cpu().numpy()
        if self.deduplicate:
            units, durations = dedup_consecutive(units)
        else:
            durations = np.ones_like(units, dtype=np.int64)
        units = np.asarray(units, np.int64)
        durations = np.asarray(durations, np.int64)
        if self.add_bos_eos:
            units = np.concatenate([[self.bos], units, [self.eos]])
            durations = np.concatenate([[0], durations, [0]])
            dense = np.concatenate([np.zeros_like(dense[:1]), dense, np.zeros_like(dense[:1])])
        return {"units": units, "durations": durations, "dense": dense}
