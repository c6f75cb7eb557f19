"""The unit-round-trip intelligibility score (UER) measured against
degradation on a synthetic corpus (counterpart of the root
tools/uer_synth_study.py, whose record is UER_SYNTH.json): harmonic
"utterances" with random F0 contours, degraded at controlled SNRs, go
through the port's unit stack, HuBERT (hubert_test_config) through
HubertFeatureReader and k-means, the pipeline `cli evaluate --hubert
--kmeans` scores with; the centroids are two Lloyd iterations on the
corpus's own features. A usable metric is 0 on identical audio and rises
with degradation (`monotone`).

    python -m unitspeech_tpu_torch.tools.uer_synth_study [--out uer.json] [--device cpu]

HuBERT's weights are drawn from --seed (tools/ssl_reference's
distributions); study() also takes given ones. The study runs on the card
unless --device cpu; the k-means fit runs on the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CONDITIONS = [("identical", None), ("snr20db", 0.1), ("snr6db", 0.5), ("snr0db", 1.0),
              ("noise_only", None)]


def study(out_json=None, n_utts: int = 8, seconds: float = 2.0, k: int = 100, seed: int = 0,
          device="cuda", hubert=None) -> dict:
    """The UER of each condition over the corpus; written to out_json when
    given. hubert: a checkpoint path or dict for load_hubert_params, else
    random weights from `seed`."""
    from unitspeech_tpu_torch.cli import _device
    from unitspeech_tpu_torch.eval.harness import evaluate_unit_roundtrip, speech_encoder_unit_hook
    from unitspeech_tpu_torch.models.ssl.hubert import (
        HubertFeatureReader,
        HubertModel,
        hubert_test_config,
    )
    from unitspeech_tpu_torch.models.ssl.kmeans import KMeansQuantizer
    from unitspeech_tpu_torch.models.ssl.speech_encoder import SpeechEncoder
    from unitspeech_tpu_torch.tools.ssl_reference import Draw, ssl_encoder_sd
    from unitspeech_tpu_torch.utils.artifacts import load_hubert_params
    from unitspeech_tpu_torch.utils.precision import strict_f32

    device = _device(str(device))
    sr = 16000
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)

    def utterance(i):
        # a harmonic source with a random F0 contour and formant-like AM
        # noise: enough spectro-temporal structure for utterance-specific
        # features
        t = np.arange(n) / sr
        f0 = 110 + 40 * np.sin(2 * np.pi * (0.7 + 0.2 * i) * t + i)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        src = sum(np.sin(h * phase) / h for h in range(1, 6))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (2.3 + 0.3 * i) * t + 2 * i)
        return (src * env + 0.05 * rng.standard_normal(n)).astype(np.float32)

    corpus = [utterance(i) for i in range(n_utts)]

    hcfg = hubert_test_config()
    if hubert is None:
        draw = Draw(seed + 1)
        ssl_encoder_sd(draw, hcfg)
        hubert = {"model": draw.sd}
    model = HubertModel(hcfg)
    model.load_state_dict(load_hubert_params(hubert, hcfg))
    reader = HubertFeatureReader(model.to(device).eval().requires_grad_(False), layer=2)
    with strict_f32():
        feats = np.concatenate([reader(w) for w in corpus[:4]])
        # k-means centroids fitted on the corpus features: two Lloyd
        # iterations from a random subset (a real run loads published ones)
        idx = rng.choice(len(feats), size=min(k, len(feats)), replace=False)
        centers = feats[idx].copy()
        for _ in range(2):
            d = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(len(centers)):
                m = assign == j
                if m.any():
                    centers[j] = feats[m].mean(0)
        hook = speech_encoder_unit_hook(
            SpeechEncoder(reader, KMeansQuantizer(centers), deduplicate=True))

        report = {"n_utts": n_utts, "seconds": seconds, "k": int(len(centers)),
                  "stack": "HubertModel(hubert_test_config) + k-means (the port's)",
                  "device": str(device), "uer_by_condition": {}}
        for name, noise in CONDITIONS:
            pairs = []
            for w in corpus:
                if name == "identical":
                    syn = w
                elif name == "noise_only":
                    syn = (np.std(w) * rng.standard_normal(n)).astype(np.float32)
                else:
                    syn = (w + noise * np.std(w) * rng.standard_normal(n)).astype(np.float32)
                pairs.append((syn, sr, w, sr))
            r = evaluate_unit_roundtrip(pairs, hook)
            report["uer_by_condition"][name] = round(r["uer_mean"], 4)
            print(f"{name}: uer_mean={r['uer_mean']:.4f}", flush=True)

    u = report["uer_by_condition"]
    report["monotone"] = bool(u["identical"] == 0.0 and u["identical"] <= u["snr20db"]
                              <= u["snr6db"] <= u["snr0db"] <= u["noise_only"])
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("uer_synth_study")
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    ap.add_argument("--n-utts", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return study(args.out, args.n_utts, args.seconds, args.k, args.seed, args.device)


if __name__ == "__main__":
    main()
