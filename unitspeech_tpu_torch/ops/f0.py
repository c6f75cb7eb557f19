"""F0 (pitch) extraction, normalization and quantization (counterpart of
unitspeech_tpu/ops/f0.py; textlesslib f0_preprocess.py, which shells into
pYAAPT): NCCF (normalized cross-correlation) candidate peaks, then a
Viterbi track over the candidates plus an unvoiced state, with
octave-jump and voicing-switch penalties. Like the JAX tracker it has no
spectral (SHC) track steering the NCCF one; its accuracy envelope is the
JAX package's (tests/test_f0_oracle.py).

extract_f0 computes the frames, the rFFT cross-correlation, the energy
denominators, the candidate peaks and their parabolic refinement on the
wav's device, then brings the (frames, 5) local costs and frequencies to
the host once and runs the Viterbi forward pass and backtrack there in
numpy float32, in the JAX scan's operation order. The DP is sequential
over frames with 6 states: on the card each frame would cost about 15
launches (30 000 for 10 s), where the host does the whole pass in
microseconds a frame. This is a deliberate host step, as deduplication
is, not a fallback.

The per-speaker normalizers, the quantizers and trailing_silence_mask are
host-side numpy, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

F0_FRAME_SPACE = 0.005  # seconds per F0 frame (textlesslib default)

# DP tuning, the JAX tracker's (calibrated there on tests/test_f0_oracle.py)
_N_CANDS = 5          # NCCF candidates per frame
_UV_COST = 0.62       # local cost of the unvoiced state (vs 1 - merit)
_W_OCTAVE = 0.45      # per-octave transition cost between voiced frames
_W_SWITCH = 0.12      # voiced <-> unvoiced transition cost
_RMS_GATE = 1e-3      # absolute silence gate (frame RMS)
_LAG_WT = 0.3         # lag-proportional merit downweight (prefers the
                      # shortest lag among near-equal peaks)


@torch.no_grad()
def f0_candidates(wav, sr: int = 16000, frame_length: int = 1024, hop: Optional[int] = None,
                  fmin: float = 60.0, fmax: float = 400.0):
    """(samples,) f32 tensor -> (local_v, freq), each (frames, 5) f32 on the
    wav's device: each candidate's local cost (inf where the frame has no
    such peak or is below the silence gate) and its frequency in Hz (1.0
    where there is no peak). JAX ops/f0.py extract_f0 up to the DP."""
    hop = hop or int(sr * F0_FRAME_SPACE)
    wav = torch.as_tensor(wav, dtype=torch.float32)
    dev = wav.device
    n = wav.shape[0]
    n_frames = max(1 + (n - frame_length) // hop, 1)
    idx = (torch.arange(frame_length, device=dev)[None, :]
           + hop * torch.arange(n_frames, device=dev)[:, None])
    frames = wav[idx.clamp(0, n - 1)]
    frames = frames - frames.mean(dim=1, keepdim=True)

    lag_min = max(int(sr / fmax), 2)
    lag_max = min(int(sr / fmin), frame_length // 2 - 2)
    win = frame_length - lag_max - 1  # correlation window length

    # NCCF numerator: rFFT cross-correlation of frame[:win] with the frame
    nfft = 2 * frame_length
    head = frames * (torch.arange(frame_length, device=dev) < win)
    num = torch.fft.irfft(torch.conj(torch.fft.rfft(head, n=nfft, dim=1))
                          * torch.fft.rfft(frames, n=nfft, dim=1), n=nfft, dim=1)[:, :lag_max + 2]
    # denominators: e0 = ||x[:win]||^2, e(tau) = ||x[tau:tau+win]||^2
    cs = torch.cumsum(frames.square(), dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    taus = torch.arange(lag_max + 2, device=dev)
    e_tau = cs[:, taus + win] - cs[:, taus]
    e0 = e_tau[:, :1]
    nccf = num / torch.sqrt(torch.clamp(e0 * e_tau, min=1e-12))

    # candidate peaks: local maxima with lags in [lag_min, lag_max]
    left, mid, right = nccf[:, :-2], nccf[:, 1:-1], nccf[:, 2:]
    lag_of_mid = torch.arange(1, lag_max + 1, device=dev)
    is_peak = ((mid >= left) & (mid > right)
               & ((lag_of_mid >= lag_min) & (lag_of_mid <= lag_max))[None, :])
    scored = torch.where(is_peak, mid, torch.full_like(mid, -torch.inf))
    merit, pk = torch.topk(scored, _N_CANDS, dim=1)  # (N, K), descending
    has_cand = torch.isfinite(merit)
    merit = torch.where(has_cand, merit, torch.zeros_like(merit))
    # parabolic sub-sample lag refinement (pk indexes `mid`: nccf lag pk + 1)
    ym = torch.gather(nccf, 1, pk + 1)
    yl = torch.gather(nccf, 1, pk)
    yr = torch.gather(nccf, 1, pk + 2)
    denom = yl - 2.0 * ym + yr
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (yl - yr) / denom, torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    lag = (pk + 1).to(torch.float32) + delta
    freq = torch.where(has_cand, sr / torch.clamp(lag, min=1.0), torch.ones_like(lag))

    # energy gate: silent frames cannot be voiced
    rms = torch.sqrt(frames.square().mean(dim=1))
    merit_eff = merit * (1.0 - _LAG_WT * lag / float(lag_max))
    local_v = torch.where(has_cand & (rms[:, None] > _RMS_GATE), 1.0 - merit_eff,
                          torch.full_like(merit_eff, torch.inf))
    return local_v, freq


def viterbi(local_v: np.ndarray, freq: np.ndarray, return_costs: bool = False):
    """Host DP over 5 voiced candidates + 1 unvoiced state: (frames, 5) f32
    local costs and frequencies -> (frames,) states (5 = unvoiced). numpy
    float32 in the JAX scan's operation order: the `<=` tie toward voiced,
    first-index argmin, cost - min(cost) after every frame.
    return_costs: also the (frames, 6) normalized cost vectors (the test
    reads near-ties from them)."""
    local_v = np.asarray(local_v, np.float32)
    logf = np.log2(np.maximum(np.asarray(freq, np.float32), np.float32(1e-3)))
    n = local_v.shape[0]
    w_oct, w_sw, uv = np.float32(_W_OCTAVE), np.float32(_W_SWITCH), np.float32(_UV_COST)
    cost = np.concatenate([local_v[0], [uv]]).astype(np.float32)
    costs = [cost]
    backs = np.zeros((max(n - 1, 0), _N_CANDS + 1), np.int64)
    for t in range(1, n):
        prev_cost, prev_logf, lv, lf = cost, logf[t - 1], local_v[t], logf[t]
        jump = np.abs(prev_logf[:, None] - lf[None, :])
        from_v = prev_cost[:-1, None] + w_oct * jump
        from_uv = prev_cost[-1] + w_sw
        min_v = from_v.min(axis=0)
        best_v = np.minimum(min_v, from_uv)
        arg_v = np.where(min_v <= from_uv, from_v.argmin(axis=0), _N_CANDS)
        cost_v = best_v + lv
        into_uv = np.concatenate([prev_cost[:-1] + w_sw, prev_cost[-1:]])
        cost = np.concatenate([cost_v, [into_uv.min() + uv]]).astype(np.float32)
        cost = cost - cost.min()
        backs[t - 1, :_N_CANDS] = arg_v
        backs[t - 1, _N_CANDS] = into_uv.argmin()
        costs.append(cost)
    states = np.zeros((n,), np.int64)
    states[-1] = int(np.argmin(cost))
    for t in range(n - 2, -1, -1):
        states[t] = backs[t, states[t + 1]]
    return (states, np.stack(costs)) if return_costs else states


def extract_f0(wav, sr: int = 16000, frame_length: int = 1024, hop: Optional[int] = None,
               fmin: float = 60.0, fmax: float = 400.0) -> np.ndarray:
    """(samples,) wav (a tensor: its device computes the candidates; an
    array: the CPU) -> (frames,) float32 numpy F0 in Hz, 0 where unvoiced:
    the candidates on the device, then one host Viterbi pass (module
    docstring)."""
    local_v, freq = f0_candidates(wav, sr, frame_length, hop, fmin, fmax)
    local_v, freq = local_v.cpu().numpy(), freq.cpu().numpy()
    states = viterbi(local_v, freq)
    f0 = np.take_along_axis(freq, np.minimum(states, _N_CANDS - 1)[:, None], axis=1)[:, 0]
    return np.where(states < _N_CANDS, f0, np.float32(0.0)).astype(np.float32)


def mean_normalize_f0(f0: np.ndarray) -> np.ndarray:
    """Divide voiced frames by the speaker's voiced mean."""
    voiced = f0 > 0
    if not voiced.any():
        return f0
    mean = f0[voiced].mean()
    out = f0.copy()
    out[voiced] = f0[voiced] / max(mean, 1e-8)
    return out


def std_normalize_f0(f0: np.ndarray) -> np.ndarray:
    """Z-score voiced frames (per utterance)."""
    voiced = f0 > 0
    if not voiced.any():
        return f0
    mean, std = f0[voiced].mean(), f0[voiced].std()
    out = f0.copy()
    out[voiced] = (f0[voiced] - mean) / max(std, 1e-8)
    return out


def quantize_f0(f0: np.ndarray, n_bins: int = 32, f_lo: float = 0.0,
                f_hi: float = 2.0) -> np.ndarray:
    """Uniform bins of (normalized) F0; bin 0 is unvoiced."""
    voiced = f0 > 0
    bins = np.clip(((f0 - f_lo) / max(f_hi - f_lo, 1e-8) * (n_bins - 1)).astype(np.int64) + 1,
                   1, n_bins)
    return np.where(voiced, bins, 0)


def trailing_silence_mask(f0: np.ndarray) -> np.ndarray:
    """True for the trailing run of unvoiced frames (f0_preprocess.py:127-131)."""
    mask = np.zeros(len(f0), bool)
    for i in range(len(f0) - 1, -1, -1):
        if f0[i] > 0:
            break
        mask[i] = True
    return mask


def align_f0_to_durations(f0: np.ndarray, durations: np.ndarray, f0_code_ratio: float,
                          tol: float = 1.0) -> np.ndarray:
    """One F0 value a unit: each unit's `dur * f0_code_ratio` F0 frames
    averaged over their voiced frames (0 if none), the track first cut or
    extended (with its last value) to the units' length when it misses it
    by at most `tol` frames, else ValueError (f0_preprocess.py:35-62)."""
    f0 = np.asarray(f0, np.float32)
    durations = np.asarray(durations)
    code_len = int(durations.sum())
    targ_len = int(f0_code_ratio * code_len)
    diff = len(f0) - targ_len
    if abs(diff) > tol:
        raise ValueError(f"Cannot subsample F0: |{len(f0)} - {f0_code_ratio}*{code_len}| > {tol}")
    if diff > 0:
        f0 = f0[:targ_len]
    elif diff < 0:
        f0 = np.concatenate([f0, np.full(-diff, f0[-1] if len(f0) else 0.0, np.float32)])
    offset = 0.0
    out = np.zeros(len(durations), np.float32)
    for i, dur in enumerate(durations):
        seg_len = float(dur) * f0_code_ratio
        seg = f0[int(offset): int(offset + seg_len)]
        seg = seg[seg != 0]
        out[i] = seg.mean() if len(seg) else 0.0
        offset += seg_len
    return out


class SpeakerMeanNormalize:
    """Per-speaker (log-)F0 centering / scaling from a stats table
    {speaker: {"f0_mean", "f0_std", "logf0_mean", "logf0_std"}}
    (f0_preprocess.py:65-93)."""

    def __init__(self, stats, center: bool = True, scale: bool = False, log: bool = True):
        self.stats = stats
        self.center = center
        self.scale = scale
        self.log = log

    def __call__(self, f0: np.ndarray, speaker) -> np.ndarray:
        f0 = np.array(f0, np.float32)
        mask = f0 != 0.0
        if self.log:
            f0[mask] = np.log(f0[mask])
        key = "logf0" if self.log else "f0"
        if self.center:
            f0[mask] -= float(self.stats[speaker][f"{key}_mean"])
        if self.scale:
            f0[mask] /= float(self.stats[speaker][f"{key}_std"])
        return f0


class PromptNormalize:
    """Per-utterance (log-)F0 centering / scaling over the voiced frames
    (f0_preprocess.py:96-113)."""

    def __init__(self, center: bool = True, scale: bool = False, log: bool = True):
        self.center = center
        self.scale = scale
        self.log = log

    def __call__(self, f0: np.ndarray, _speaker=None) -> np.ndarray:
        f0 = np.array(f0, np.float32)
        mask = f0 != 0.0
        if self.log:
            f0[mask] = np.log(f0[mask])
        if mask.any():
            if self.center:
                f0[mask] -= f0[mask].mean()
            if self.scale:
                f0[mask] /= max(f0[mask].std(), 1e-8)
        return f0


class F0BinQuantizer:
    """Bin index of each F0 value from bin edges (f0_preprocess.py:116-122)."""

    def __init__(self, bins: np.ndarray):
        self.bins = np.asarray(bins, np.float32).reshape(-1)

    def __call__(self, f0: np.ndarray) -> np.ndarray:
        return (np.asarray(f0, np.float32).reshape(-1, 1)
                > self.bins.reshape(1, -1)).sum(axis=1).astype(np.int64)
