"""Textless "quantized view" datasets (counterpart of
unitspeech_tpu/data/quantize.py; textlesslib quantized_datasets.py:
117-255): wrap an index-style dataset whose items lead with a raw waveform
and give its aligned unit / duration / dense (and, with need_f0, F0)
streams through a SpeechEncoder, with a collater for padded batches.

The SpeechEncoder's models sit on one device, so there is none of the
reference's per-worker GPU placement (quantized_datasets.py:147-186). The
torchaudio corpora are wrapped when torchaudio is importable;
QuantizedFilelist covers the same role from `path|text|speaker` filelists.
As in JAX, FilelistAudioDataset drops the file's sample rate and
QuantizeDataset does not resample: the wavs must be at the encoder's rate.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from unitspeech_tpu_torch.data.dataset import parse_filelist
from unitspeech_tpu_torch.utils.audio import load_wav


def collate_arrays(stream: Sequence[np.ndarray], pad) -> np.ndarray:
    """Right-pad 1-D arrays to the batch's longest (collater_utils.py:10-28)."""
    assert len(stream) > 0
    length = max(len(v) for v in stream)
    out = np.full((len(stream), length), pad, dtype=np.asarray(stream[0]).dtype)
    for i, v in enumerate(stream):
        out[i, :len(v)] = v
    return out


def default_speaker_ls(rest) -> str:
    """LibriSpeech's item layout (quantized_datasets.py:40-41)."""
    return str(rest[2])


def no_speaker(_):
    """Datasets without speakers (quantized_datasets.py:108-114)."""
    return None


class FilelistAudioDataset:
    """`path|text|speaker` filelist -> (waveform, text, speaker) items."""

    def __init__(self, filelist_path: str):
        self.rows = parse_filelist(filelist_path)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int):
        row = self.rows[i]
        wav, _sr = load_wav(row[0])
        text = row[1] if len(row) > 1 else ""
        speaker = row[2] if len(row) > 2 else None
        return wav, text, speaker


def filelist_speaker(rest):
    return rest[1]


class QuantizeDataset:
    """Item k is speech_encoder(dataset[k][0]) with the item's other fields
    under "rest" (quantized_datasets.py:117-213)."""

    def __init__(self, dataset, speech_encoder, speaker_extractor: Optional[Callable] = None):
        self.dataset = dataset
        self.speech_encoder = speech_encoder
        self.speaker_extractor = (speaker_extractor if speaker_extractor is not None
                                  else default_speaker_ls)
        self.unit_vocab_size = speech_encoder.vocab_size
        # a pad id clear of the units and of bos / eos (quantized_datasets.py:165-169)
        self.unit_pad = 1 + max(self.unit_vocab_size - 1, int(speech_encoder.bos),
                                int(speech_encoder.eos))

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, k: int) -> Dict[str, Any]:
        item = self.dataset[k]
        waveform, rest = item[0], list(item[1:])
        speaker = self.speaker_extractor(rest)
        wav = np.asarray(waveform, np.float32)
        if wav.ndim > 1:
            wav = wav.reshape(-1) if 1 in wav.shape else wav.mean(axis=0)
        encoded = dict(self.speech_encoder(wav, speaker))
        encoded["rest"] = rest
        return encoded

    def collater(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Units padded with unit_pad, the other streams with zeros; "rest"
        passes through uncollated (quantized_datasets.py:215-255, with its
        quirk of returning f0 as a 1-tuple)."""
        units = collate_arrays([s["units"] for s in samples], self.unit_pad)
        durations = collate_arrays([s["durations"] for s in samples], 0)
        f0 = collate_arrays([s["f0"] for s in samples], 0.0) if "f0" in samples[0] else None
        dense_dim = samples[0]["dense"].shape[1]
        max_len = max(s["dense"].shape[0] for s in samples)
        dense = np.zeros((len(samples), max_len, dense_dim), np.float32)
        for i, s in enumerate(samples):
            dense[i, :s["dense"].shape[0]] = s["dense"]
        n_rest = len(samples[0]["rest"])
        rest = [[s["rest"][i] for s in samples] for i in range(n_rest)]
        result: Dict[str, Any] = {"units": units, "durations": durations, "dense": dense,
                                  "rest": rest}
        if f0 is not None:
            result["f0"] = (f0,)
        return result


def QuantizedFilelist(speech_encoder, filelist_path: str) -> QuantizeDataset:
    """Quantized view of a `path|text|speaker` filelist."""
    return QuantizeDataset(FilelistAudioDataset(filelist_path), speech_encoder,
                           speaker_extractor=filelist_speaker)


class _First:
    """torchaudio items (a tensor first) -> a numpy waveform first."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        wav, *rest = self.ds[i]
        return np.asarray(wav), *rest


def _torchaudio_wrap(cls_name: str, speaker_extractor, *args, **kwargs):
    try:
        import torchaudio.datasets as tad
    except Exception as e:  # torchaudio is optional (the card's machine has none)
        raise ImportError("torchaudio is required for the pre-wrapped datasets; use "
                          "QuantizedFilelist for filelist corpora") from e
    speech_encoder = kwargs.pop("speech_encoder")
    ds = getattr(tad, cls_name)(*args, **kwargs)
    return QuantizeDataset(_First(ds), speech_encoder, speaker_extractor=speaker_extractor)


def QuantizedLibriSpeech(speech_encoder, root, url="train-clean-100",
                         folder_in_archive="LibriSpeech", download=False):
    """quantized_datasets.py:26-37 (rest[2] is the speaker)."""
    return _torchaudio_wrap("LIBRISPEECH", default_speaker_ls, root, url, folder_in_archive,
                            download, speech_encoder=speech_encoder)


def QuantizedLjSpeech(speech_encoder, root, **kwargs):
    """quantized_datasets.py:44-53."""
    return _torchaudio_wrap("LJSPEECH", default_speaker_ls, root,
                            speech_encoder=speech_encoder, **kwargs)


def QuantizedVCTK_092(speech_encoder, root, mic_id="mic2", **kwargs):
    """quantized_datasets.py:73-91 (rest[2] is the speaker)."""
    return _torchaudio_wrap("VCTK_092", lambda rest: rest[2], root, mic_id,
                            speech_encoder=speech_encoder, **kwargs)


def QuantizedYesNo(speech_encoder, root, **kwargs):
    """quantized_datasets.py:94-105 (no speakers)."""
    return _torchaudio_wrap("YESNO", no_speaker, root, speech_encoder=speech_encoder, **kwargs)
