"""Batch sv56 loudness normalization of a directory of wavs (counterpart of
the root sv56.py; the reference's sv56.py, in dir -> out dir, and
sv56_inplace.py, recursive **/*.wav in place): each wav's active speech
level (ITU-T P.56, the port's numpy ops/sv56.py) brought to --target-dbov.
There is no native path: the port has no C++ P.56.

    python -m unitspeech_tpu_torch.tools.sv56 --input-dir wavs/ --output-dir normed/
    python -m unitspeech_tpu_torch.tools.sv56 --input-dir wavs/ --inplace
"""

from __future__ import annotations

import argparse
import glob
import os


def normalize_file(src: str, dest: str, target_dbov: float):
    from unitspeech_tpu_torch.ops import sv56
    from unitspeech_tpu_torch.utils.audio import load_wav, write_wav

    wav, sr = load_wav(src)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    write_wav(dest, sv56.normalize(wav, sr, target_dbov), sr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.sv56",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--inplace", action="store_true")
    ap.add_argument("--target-dbov", type=float, default=-26.0)
    args = ap.parse_args(argv)
    if not args.inplace and not args.output_dir:
        raise SystemExit("need --output-dir or --inplace")
    files = sorted(glob.glob(os.path.join(args.input_dir, "**", "*.wav"), recursive=True))
    for src in files:
        dest = src if args.inplace else os.path.join(args.output_dir,
                                                      os.path.relpath(src, args.input_dir))
        normalize_file(src, dest, args.target_dbov)
    print(f"normalized {len(files)} files (numpy P.56)")
    return {"files": len(files), "target_dbov": args.target_dbov}


if __name__ == "__main__":
    main()
