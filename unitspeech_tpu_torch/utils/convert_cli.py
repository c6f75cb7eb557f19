"""Checkpoint conversion: a reference torch .pt -> the port's format
(counterpart of unitspeech_tpu/utils/convert_cli.py, which writes orbax).

    python -m unitspeech_tpu_torch.cli convert decoder pretrained_decoder.pt decoder.pt
    python -m unitspeech_tpu_torch.cli convert text-encoder text_encoder.pt te.pt
    python -m unitspeech_tpu_torch.cli convert unit-encoder unit_encoder.pt ue.pt
    python -m unitspeech_tpu_torch.cli convert duration-predictor duration_predictor.pt dp.pt
    python -m unitspeech_tpu_torch.cli convert vocoder bigvgan_generator.pt voc.pt
    python -m unitspeech_tpu_torch.cli convert hubert mhubert_base.pt hubert.pt
    python -m unitspeech_tpu_torch.cli convert wavlm WavLM-Large.pt wavlm.pt
    python -m unitspeech_tpu_torch.cli convert speaker-embedder speaker_encoder.pt spk.pt
    python -m unitspeech_tpu_torch.cli convert kmeans kmeans.bin kmeans.npz

A decoder becomes a decoder bundle (utils/artifacts.save_decoder_bundle),
k-means centroids a `.npz` (sklearn's joblib file needs joblib and sklearn
installed), every other family a module file (save_module); `cli
inference` and `cli finetune` read both, and the reference files directly
too. --config gives the widths (default: the reference's; the HuBERT's
from unit_extractor.dense_model_name, the WavLM's from
spk_embedder.feat_type); it is stored in the output.
"""

from __future__ import annotations

import argparse
import sys

KINDS = ("decoder", "text-encoder", "unit-encoder", "duration-predictor", "vocoder", "hubert",
         "wavlm", "speaker-embedder", "kmeans")
# the JAX CLI's other kinds, whose modules the port does not have yet
NOT_PORTED = {
    "contentvec-encoder": "the contentvec encoder (voice conversion) is not ported yet "
                          "(ROADMAP Queue 1 item 7)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("unitspeech-tpu-torch convert")
    ap.add_argument("kind", choices=KINDS + tuple(NOT_PORTED))
    ap.add_argument("src", help="reference torch .pt checkpoint")
    ap.add_argument("dest", help="output file (the port's format)")
    ap.add_argument("--config", default=None, help="JSON config overlay")
    args = ap.parse_args(argv)
    if args.kind in NOT_PORTED:
        raise SystemExit(f"convert {args.kind}: {NOT_PORTED[args.kind]}")

    from unitspeech_tpu_torch.config import MainConfig, load_json
    from unitspeech_tpu_torch.models.speaker import WAVLM_CONFIGS
    from unitspeech_tpu_torch.models.ssl.hubert import hubert_config_by_name
    from unitspeech_tpu_torch.utils import artifacts

    cfg = load_json(args.config) if args.config else MainConfig()
    if args.kind == "kmeans":
        artifacts.load_kmeans(args.src).save(args.dest)
        out = args.dest
    elif args.kind == "hubert":
        out = artifacts.save_module(args.dest, "hubert", artifacts.load_hubert_params(
            args.src, hubert_config_by_name(cfg.unit_extractor.dense_model_name)), cfg)
    elif args.kind in ("wavlm", "speaker-embedder"):
        wcfg = WAVLM_CONFIGS[cfg.spk_embedder.feat_type]()
        load = (artifacts.load_wavlm_params if args.kind == "wavlm"
                else artifacts.load_speaker_embedder_params)
        out = artifacts.save_module(args.dest, args.kind.replace("-", "_"),
                                    load(args.src, wcfg), cfg)
    elif args.kind == "decoder":
        out = artifacts.save_decoder_bundle(
            args.dest, artifacts.load_decoder_bundle(args.src, cfg.decoder), cfg)
    elif args.kind in ("text-encoder", "unit-encoder"):
        name = args.kind.replace("-", "_")
        out = artifacts.save_module(
            args.dest, name,
            artifacts.load_encoder_params(args.src, getattr(cfg, name), name), cfg)
    elif args.kind == "duration-predictor":
        out = artifacts.save_module(args.dest, "duration_predictor",
                                    artifacts.load_duration_predictor_params(args.src), cfg)
    else:
        out = artifacts.save_module(args.dest, "vocoder",
                                    artifacts.load_vocoder_params(args.src, cfg.vocoder), cfg)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
