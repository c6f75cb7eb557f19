"""The training data pipeline (counterpart of unitspeech_tpu/data/dataset.py;
reference data.py:21-236), numpy on the host:

  * `parse_filelist`: `path|text|speaker_id` lines;
  * `TextMelSpeakerDataset` (STEP1): items {tokens, wav, spk_id}, the text
    turned into token IDs once per utterance (cached), the wav read as PCM
    (utils/audio.load_wav); the mel is computed on the device by the train
    loop (train/loop.py), not here;
  * `UnitMelSpeakerDataset` (STEP2): items {units, durations, wav, spk_id},
    the units and their durations from the `<stem>.units.npz`
    sidecar that `cli preprocess-units` writes;
  * `BucketCollator`: pads a batch of either kind to a (token bucket, frame
    bucket) shape, the frame bucket rounded for the U-Net, the wavs to
    bucket x hop samples, as the JAX collator does, so that batches take
    few shapes;
  * `iterate_batches`: one rank's epoch iterator, its strided slice of one
    shuffled order (the JAX package's per-host sharding).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu_torch.utils.audio import load_wav


def parse_filelist(filelist_path: str) -> List[List[str]]:
    """`path|text|speaker_id` lines (reference util.py:49-52); blank lines
    skipped."""
    with open(filelist_path, encoding="utf-8") as f:
        return [line.strip().split("|") for line in f if line.strip()]


@dataclass
class TextMelSpeakerDataset:
    """Filelist-backed dataset for STEP1 (reference data.py:21-112).
    `text_to_ids` maps an entry's text to token IDs (the text frontend); the
    IDs are cached, so the text is phonemized once, not once an epoch. A
    wav at another rate than `sampling_rate` raises."""

    filelist: List[List[str]]
    text_to_ids: Callable[[str], Sequence[int]]
    hop_length: int = 256
    sampling_rate: int = 22050

    def __post_init__(self):
        self._token_cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.filelist)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path, text, spk = (self.filelist[idx] + ["0"])[:3]
        if idx not in self._token_cache:
            self._token_cache[idx] = np.asarray(self.text_to_ids(text), np.int32)
        wav, sr = load_wav(path)
        if sr != self.sampling_rate:
            raise ValueError(f"{path}: {sr} != {self.sampling_rate}")
        return {"tokens": self._token_cache[idx], "wav": wav, "spk_id": np.int32(int(spk))}


@dataclass
class UnitMelSpeakerDataset:
    """Filelist-backed dataset for STEP2 (reference data.py:143-236): each
    wav's units and their durations come from its sidecar
    `<stem>.units.npz`, whose two arrays must have one length. A wav at
    another rate than `sampling_rate` raises."""

    filelist: List[List[str]]
    hop_length: int = 256
    sampling_rate: int = 22050

    def __len__(self):
        return len(self.filelist)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path, _text, spk = (self.filelist[idx] + ["0"])[:3]
        side = os.path.splitext(path)[0] + ".units.npz"
        with np.load(side) as z:
            units, durations = z["units"], z["durations"]
        if len(units) != len(durations):
            raise ValueError(f"{side}: {len(units)} units but {len(durations)} durations")
        wav, sr = load_wav(path)
        if sr != self.sampling_rate:
            raise ValueError(f"{path}: {sr} != {self.sampling_rate}")
        return {"units": units.astype(np.int32), "durations": durations.astype(np.float32),
                "wav": wav, "spk_id": np.int32(int(spk))}


@dataclass
class BucketCollator:
    """Pads a list of items to a static (token bucket, frame bucket) shape
    (the JAX collator's buckets): the longest token count to the first
    token bucket that holds it, the longest frame count (wav samples // hop)
    to the first frame bucket, rounded up by fix_len_compatibility for the
    U-Net (reference data.py:128-140); each wav zero-padded (cut to its
    whole frames) to frames x hop samples, so the mel frontend yields the
    bucket's frames. Returns {tokens, token_lengths, wav, mel_lengths,
    spk_id} for text items; for unit items (UnitMelSpeakerDataset) units
    and unit_lengths in place of the tokens, and the durations zero-padded
    to the token bucket (f32)."""

    hop_length: int = 256
    num_downsamplings: int = 3
    token_buckets: Sequence[int] = (32, 64, 96, 128, 192, 256, 384, 512)
    frame_buckets: Sequence[int] = (
        128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536, 2048,
    )

    def __call__(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        b = len(items)
        key, lengths = ("tokens", "token_lengths") if "tokens" in items[0] else (
            "units", "unit_lengths")
        tok_lens = np.array([len(it[key]) for it in items], np.int32)
        frame_lens = np.array([len(it["wav"]) // self.hop_length for it in items], np.int32)
        t_x = choose_bucket(int(tok_lens.max()), self.token_buckets)
        t_y = fix_len_compatibility(choose_bucket(int(frame_lens.max()), self.frame_buckets),
                                    self.num_downsamplings)
        tokens = np.zeros((b, t_x), np.int32)
        wavs = np.zeros((b, t_y * self.hop_length), np.float32)
        spk_ids = np.zeros((b,), np.int32)
        durations = np.zeros((b, t_x), np.float32) if "durations" in items[0] else None
        for i, it in enumerate(items):
            tokens[i, :tok_lens[i]] = it[key]
            n = frame_lens[i] * self.hop_length
            wavs[i, :n] = it["wav"][:n]
            if durations is not None:
                durations[i, :tok_lens[i]] = it["durations"]
            spk_ids[i] = it["spk_id"]
        batch = {key: tokens, lengths: tok_lens, "wav": wavs, "mel_lengths": frame_lens,
                 "spk_id": spk_ids}
        if durations is not None:
            batch["durations"] = durations
        return batch


def iterate_batches(dataset, collator: BucketCollator, batch_size: int,
                    key: Optional[np.random.Generator] = None, shuffle: bool = True,
                    drop_last: bool = True, process_index: int = 0, process_count: int = 1):
    """One epoch of collated batches of `batch_size` (this process's): the
    indices shuffled in place by `key` (a numpy Generator; default_rng(0)
    when none; every process must seed it alike), this process's strided
    slice idx[process_index::process_count] taken (the JAX iterator's
    per-host sharding: the slices are disjoint and cover the epoch), then
    batch_size at a time, a short last batch dropped when drop_last. With
    several processes and drop_last, each yields the batches of the
    smallest slice, len(dataset) // process_count, so that all step in
    lock-step."""
    idx = np.arange(len(dataset))
    if shuffle:
        (key or np.random.default_rng(0)).shuffle(idx)
    idx = idx[process_index::process_count]
    if drop_last and process_count > 1:
        end = (len(dataset) // process_count // batch_size) * batch_size
    elif drop_last:
        end = len(idx) - (len(idx) % batch_size)
    else:
        end = len(idx)
    for s in range(0, end, batch_size):
        yield collator([dataset[int(i)] for i in idx[s:s + batch_size]])
