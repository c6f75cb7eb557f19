"""Mel-spectrogram frontend and mel normalization (counterpart of
unitspeech_tpu/ops/mel.py; reference vocoder/meldataset.py:51-74,
data.py:89-92, inference.py:140), with the reference's semantics:

  1. reflect-pad the waveform by (n_fft - hop)/2 on both sides
  2. frames with center=False (torch.stft's default center=True would pad
     n_fft/2 and give other frames), periodic Hann window
  3. magnitude = sqrt(re^2 + im^2 + 1e-9)
  4. Slaney-scale, Slaney-normalized mel filterbank (librosa's default),
     projected in f32
  5. log(clamp(x, min=1e-5))

The filterbank and the window are host-side numpy constants; the STFT and
the projection run on the waveform's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_branch = min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int = 22050, n_fft: int = 1024, n_mels: int = 80, fmin: float = 0.0,
                   fmax: float = 8000.0) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney-scale, Slaney-normalized triangular
    filterbank (librosa.filters.mel with htk=False, norm='slaney'), f32."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=4)
def hann_window(win_length: int = 1024) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default), f32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 22050, hop_size: int = 256, win_size: int = 1024,
                    fmin: float = 0.0, fmax: float = 8000.0) -> torch.Tensor:
    """(B, L) waveform in [-1, 1] -> (B, n_frames, num_mels) f32 log-mel on
    y's device, n_frames = mel_true_frames(L). Time-major, as the JAX
    package returns it (the reference returns (mels, frames))."""
    y = y.to(torch.float32)
    pad = (n_fft - hop_size) // 2
    y = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop_size)  # (B, T, n_fft), center=False
    win = torch.from_numpy(hann_window(win_size)).to(y.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fbank = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax))
    mel = mag @ fbank.to(y.device).t()
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_true_frames(n_samples: int, n_fft: int = 1024, hop: int = 256) -> int:
    """The frame count mel_spectrogram gives an n_samples wav."""
    pad = (n_fft - hop) // 2
    return 1 + (n_samples + 2 * pad - n_fft) // hop


def reflect_extend(wav: np.ndarray, target_len: int) -> np.ndarray:
    """Extend a 1-D wav to target_len samples by repeated reflect padding on
    the right. The first (n_fft - hop)/2 appended samples equal
    mel_spectrogram's own right reflect pad, so the first
    mel_true_frames(len(wav)) frames of the extended wav's mel equal the
    exact-length mel bit for bit; the frames past them are padding."""
    wav = np.asarray(wav)
    if wav.shape[0] < 2 and wav.shape[0] < target_len:
        # reflect is undefined on fewer than 2 samples
        raise ValueError(f"reflect_extend: wav has {wav.shape[0]} sample(s), cannot "
                         f"extend to {target_len}")
    out = wav
    while out.shape[0] < target_len:
        # np.pad's reflect needs pad < len: chunk for short signals
        chunk = min(target_len - out.shape[0], out.shape[0] - 1)
        out = np.pad(out, (0, chunk), mode="reflect")
    return out


def normalize_mel(mel, mel_min, mel_max):
    """Per-channel min-max normalization of a log-mel (..., n_mels) to
    [-1, 1] (reference data.py:89-92)."""
    return 2.0 * (mel - mel_min) / (mel_max - mel_min) - 1.0


def denormalize_mel(mel, mel_min, mel_max):
    """[-1, 1] per-channel normalized mel (..., n_mels) -> log-mel."""
    return (mel + 1.0) / 2.0 * (mel_max - mel_min) + mel_min
