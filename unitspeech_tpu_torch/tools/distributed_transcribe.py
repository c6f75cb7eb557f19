"""Distributed offline unit transcription (counterpart of
unitspeech_tpu/tools/distributed_transcribe.py; reference textlesslib
tools/distributed_transcribe/): a manifest of wavs split over the ranks of
a process group, each rank running the port's SpeechEncoder (the dense
model + k-means of `cli.build_unit_extractor`) on its own card.

  * the topology is the process group's when one is initialized, else the
    RANK / WORLD_SIZE variables (torchrun's), else one process;
  * each rank takes the strided share range(rank, n, world)
    (transcribe.py:109) and writes its own shard file, `<idx>\\t<units>`
    a line;
  * rank 0 merges the shards in manifest order (transcribe.py:141-160).

    torchrun --nproc_per_node 4 -m unitspeech_tpu_torch.tools.distributed_transcribe \\
        --manifest wavs.txt --output units.txt --hubert hubert.pt --kmeans kmeans.npz

In a process group every rank waits for the others (a barrier) before
rank 0 merges; without one, rank 0 merges once every shard file exists,
and says so when one is missing (`--merge-only` merges later).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import torch.distributed as dist

from unitspeech_tpu_torch.utils.audio import load_wav


def process_topology() -> Tuple[int, int]:
    """(rank, world size): the process group's if initialized, else the
    RANK / WORLD_SIZE variables, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def shard_indices(n: int, rank: int, world: int) -> List[int]:
    """The strided split of the reference's transcribe.py:109."""
    return list(range(rank, n, world))


def transcribe_shard(manifest: List[str], indices: List[int], speech_encoder,
                     out_path: str) -> int:
    """Units for this rank's share, one line an item: `<idx>\\t<units>`
    space-separated. The wavs are read at their own rate (16 kHz for the
    SpeechEncoder, as in JAX). Returns the item count."""
    with open(out_path, "w", encoding="utf-8") as f:
        for idx in indices:
            wav, _sr = load_wav(manifest[idx])
            units = " ".join(str(int(u)) for u in speech_encoder(wav)["units"])
            f.write(f"{idx}\t{units}\n")
    return len(indices)


def merge_shards(shard_paths: List[str], out_path: str, n_items: int):
    """The shards merged into manifest order (transcribe.py:141-160); a
    missing index raises RuntimeError."""
    lines: List[Optional[str]] = [None] * n_items
    for sp in shard_paths:
        with open(sp, encoding="utf-8") as f:
            for line in f:
                idx, units = line.rstrip("\n").split("\t", 1)
                lines[int(idx)] = units
    missing = [i for i, line in enumerate(lines) if line is None]
    if missing:
        raise RuntimeError(f"missing transcriptions for indices {missing[:10]}...")
    with open(out_path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("unitspeech-tpu-torch distributed-transcribe")
    ap.add_argument("--manifest", required=True, help="one wav path per line")
    ap.add_argument("--output", required=True)
    ap.add_argument("--hubert", required=True)
    ap.add_argument("--kmeans", required=True)
    ap.add_argument("--merge-only", action="store_true")
    ap.add_argument("--config", default=None,
                    help="JSON config overlay (unit_extractor: the dense model and layer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the rank's card (LOCAL_RANK under torchrun); cpu for a smoke run")
    args = ap.parse_args(argv)

    with open(args.manifest, encoding="utf-8") as f:
        manifest = [line.strip() for line in f if line.strip()]
    rank, world = process_topology()
    shard_path = f"{args.output}.shard{rank}"

    if not args.merge_only:
        import torch

        from unitspeech_tpu_torch.cli import build_unit_extractor
        from unitspeech_tpu_torch.config import MainConfig, load_json
        from unitspeech_tpu_torch.tools import resolve_device
        from unitspeech_tpu_torch.utils.precision import strict_f32

        device = resolve_device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        cfg = load_json(args.config) if args.config else MainConfig()
        with strict_f32():
            enc = build_unit_extractor(args.hubert, args.kmeans, cfg, device)
            n = transcribe_shard(manifest, shard_indices(len(manifest), rank, world), enc,
                                 shard_path)
        print(f"rank {rank}/{world}: transcribed {n} items -> {shard_path}")
    if dist.is_available() and dist.is_initialized():
        dist.barrier()

    if rank == 0:
        shards = [f"{args.output}.shard{r}" for r in range(world)]
        if all(os.path.exists(s) for s in shards):
            merge_shards(shards, args.output, len(manifest))
            print(f"merged {world} shards -> {args.output}")
        else:
            print("not all shards present; run with --merge-only once they are")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
