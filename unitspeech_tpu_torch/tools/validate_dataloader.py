"""Data-pipeline check by hand: a dataset and the collator on a filelist,
one item's and one batch's shapes printed (counterpart of the root
scripts/validate_dataloader.py; the reference's
scripts_custom/validate_dataloader.py).

    python -m unitspeech_tpu_torch.tools.validate_dataloader --filelist train.txt [--units]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.validate_dataloader",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--units", action="store_true", help="the unit-mel dataset (STEP2)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--language", default="en-us")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch import text as text_frontend
    from unitspeech_tpu_torch.data.dataset import (
        BucketCollator,
        TextMelSpeakerDataset,
        UnitMelSpeakerDataset,
        iterate_batches,
        parse_filelist,
    )

    filelist = parse_filelist(args.filelist)
    print(f"{len(filelist)} entries in {args.filelist}")
    if args.units:
        dataset = UnitMelSpeakerDataset(filelist)
    else:
        ph = text_frontend.get_phonemizer(args.language)

        def text_to_ids(t):
            if ph is None:  # pre-phonemized filelists
                return text_frontend.phonemes_to_sequence(t)
            return text_frontend.text_to_sequence(t, ph)

        dataset = TextMelSpeakerDataset(filelist, text_to_ids)

    def shapes(d):
        out = {k: (list(np.shape(v)), str(np.asarray(v).dtype)) for k, v in d.items()}
        for k, (shape, dtype) in out.items():
            print(f"  {k}: shape={tuple(shape)} dtype={dtype}")
        return out

    print("item[0]:")
    item = shapes(dataset[0])
    batch = next(iterate_batches(dataset, BucketCollator(), args.batch_size, shuffle=False))
    print(f"batch (size {args.batch_size}):")
    res = {"entries": len(filelist), "item": item, "batch": shapes(batch)}
    wav = batch["wav"]
    print(f"  wav range: [{wav.min():.3f}, {wav.max():.3f}]")
    return res


if __name__ == "__main__":
    main()
