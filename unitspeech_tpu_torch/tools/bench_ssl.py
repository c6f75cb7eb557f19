"""The SSL frontends at their published sizes and the wall of adapting a
voice from a wav, end to end (counterpart of the root tools/bench_ssl.py).

On a --seconds wav made from a seed (160 + 320 Hz and a little noise, at
the mel rate), each in strict f32 as `cli finetune` runs them:
  1. WavLM-Large + ECAPA: the speaker embedding (`cli.embed_speaker`, the
     96 000 / 192 000-sample ladder);
  2. mHuBERT-base + k-means (1 000 centroids): the units
     (`cli.extract_units`);
  3. adapting a voice: the reference mel, `process_unit`, the frozen unit
     encoder and the alignment (`cli.finetune_inputs`, the
     `prepare_finetune_inputs` of the CLI), then `finetune_decoder` for
     --n-iters steps (bf16 activations on the card) twice: the first run
     and a second one on the same inputs;
  then one request served with the adapted decoder and the extracted voice
  on the serving default (every kernel, int8 deep convs, bf16): a finite
  mel of its frames.
The whole session runs twice in one process: the second is the warm
session (kernels built, cuDNN plans chosen, the allocator's blocks held),
the counterpart of JAX's `--label warm` run on its compile cache.

Each frontend's time: loading its checkpoint to the card and the first
call (init_and_first_s), then the median of 3 calls (forward_s). Random
weights (timing does not depend on them): --speaker-embedder / --hubert /
--kmeans files, or reference-format files written from a seed into a
temporary directory (tools/ssl_reference); the TTS weights from
--checkpoint or random_params(MainConfig(), 0).

    python -m unitspeech_tpu_torch.tools.bench_ssl [--n-iters 500] [--out FILE]
    python -m unitspeech_tpu_torch.tools.bench_ssl --small --device cpu   # smoke run

(--small: the test widths, and the speaker embedder on the wav's exact
length rather than the sample ladder.)

Returns (and prints) one JSON object, JAX's keys (but finetune_aot_hit: the
port has no compile cache) plus `card` and `adapted_request`; on the card it
is also written to chiprun_out/bench_ssl.json.
"""

from __future__ import annotations

import argparse
import gc
import json
import tempfile
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import _serving, device_line, resolve_device

def timed(fn, reps: int = 3):
    """(fn's result, the median seconds of `reps` calls after a first one);
    fn must end with its result on the host."""
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def session(cfg, ckpt, wav, files, n_iters, dev, sample_buckets) -> dict:
    """One adapt-a-voice session: the two frontends, the fine-tune's inputs,
    two fine-tunes. Returns the report and the adapted decoder and voice.
    sample_buckets: the speaker embedder's input ladder (cli.embed_speaker)."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.train.finetune import finetune_decoder

    sr = cfg.data.sampling_rate
    rep = {}
    total_t0 = time.perf_counter()
    t0 = time.perf_counter()
    spk_model = cli.load_speaker_embedder(files["speaker-embedder"], cfg, dev)
    emb, spk_s = timed(lambda: cli.embed_speaker(spk_model, wav, sr, cfg, sample_buckets))
    rep["spk_embedder"] = {
        "params_m": round(sum(p.numel() for p in spk_model.parameters()) / 1e6, 1),
        "init_and_first_s": round(time.perf_counter() - t0, 1), "forward_s": round(spk_s, 4)}
    del spk_model
    spk = torch.from_numpy(emb / np.linalg.norm(emb)).to(dev)

    t0 = time.perf_counter()
    enc = cli.build_unit_extractor(files["hubert"], files["kmeans"], cfg, dev)
    (units, durations), unit_s = timed(lambda: cli.extract_units(enc, wav, sr, cfg))
    rep["unit_extractor"] = {
        "params_m": round(sum(p.numel() for p in enc.dense_model.model.parameters()) / 1e6, 1),
        "init_and_first_s": round(time.perf_counter() - t0, 1), "forward_s": round(unit_s, 4),
        "n_units": int(np.asarray(units).size)}
    del enc

    t0 = time.perf_counter()
    inputs = cli.finetune_inputs(cfg, wav, units, durations, ckpt["unit_encoder"],
                                 ckpt["mel_min"], ckpt["mel_max"], cli.DEFAULT_ADAPT_BUCKETS, dev)
    prep_s = time.perf_counter() - t0
    ft = []
    for seed in (4, 5):
        t0 = time.perf_counter()
        state, losses = finetune_decoder(
            cfg.decoder, ckpt["decoder"], *inputs, spk,
            dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
            segment_size=cfg.out_size, n_iters=n_iters, learning_rate=cfg.finetune.learning_rate,
            grad_clip=cfg.finetune.grad_clip,
            generator=torch.Generator(device=dev).manual_seed(seed))
        ft.append(time.perf_counter() - t0)  # the losses came to the host: the steps ran
    rep["adapt_voice"] = {
        "prep_s": round(prep_s, 2), "finetune_first_s": round(ft[0], 2),
        "finetune_s": round(ft[1], 2),
        # warm: the SSL forwards, the conditioning prep and one fine-tune
        "total_warm_s": round(spk_s + unit_s + prep_s + ft[1], 2),
        "total_session_s": round(time.perf_counter() - total_t0, 1),
        "loss_last": float(losses[-1])}
    return rep, state, spk


def adapted_request(ckpt, state, spk, n_tok, steps, dev) -> dict:
    """One request (n_tok random tokens, seed 0) with the adapted decoder and
    voice on the serving default: its frames, wall and whether its mel is
    finite."""
    synth = _serving.build({**ckpt, "decoder": state, "spk_emb": spk.reshape(1, -1).cpu()}, dev)
    n_vocab = synth.models.cfg.text_encoder.n_vocab
    toks = [int(t) for t in np.random.default_rng(0).integers(1, n_vocab - 1, n_tok)]
    t0 = time.perf_counter()
    wav, sr, mel = synth(toks, torch.Generator(device=dev).manual_seed(0), diffusion_steps=steps,
                         text_gradient_scale=1.0, spk_gradient_scale=1.0)
    return {"frames": int(mel.shape[0]), "samples": int(len(wav)),
            "wall_s": round(time.perf_counter() - t0, 3),
            "finite": bool(torch.isfinite(mel).all()) and bool(np.isfinite(wav).all())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.bench_ssl",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "bench_ssl")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--n-iters", type=int, default=500)
    ap.add_argument("--speaker-embedder", default=None,
                    help="WavLM + ECAPA file (reference or port format)")
    ap.add_argument("--hubert", default=None, help="mHuBERT file (reference or port format)")
    ap.add_argument("--kmeans", default=None, help="k-means centroids (.npz)")
    args = ap.parse_args(argv)

    from unitspeech_tpu_torch.config import MainConfig, config_from_dict
    from unitspeech_tpu_torch.tools.ssl_reference import random_ssl_reference
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.params import random_params

    dev = resolve_device(args.device)
    if args.checkpoint:
        ckpt = artifacts.read(args.checkpoint)
        cfg = config_from_dict(ckpt["config"])
    else:
        cfg = _serving.small_config() if args.small else MainConfig()
        ckpt = random_params(cfg, 0)
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * args.seconds)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 160 * t) + 0.1 * np.sin(2 * np.pi * 320 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    report = {"seconds": args.seconds, "variant": cfg.spk_embedder.feat_type,
              "device": dev.type, "n_iters": args.n_iters, "card": device_line(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        files = {"speaker-embedder": args.speaker_embedder, "hubert": args.hubert,
                 "kmeans": args.kmeans}
        if not all(files.values()):
            files = {**random_ssl_reference(tmp, cfg, seed=0),
                     **{k: v for k, v in files.items() if v}}
        # at the test widths' 1.6 kHz the ladder's 96 000 samples are a minute
        from unitspeech_tpu_torch.cli import DEFAULT_SPK_SAMPLE_BUCKETS

        buckets = None if args.small else DEFAULT_SPK_SAMPLE_BUCKETS
        cold, state, spk = session(cfg, ckpt, wav, files, args.n_iters, dev, buckets)
        print(json.dumps(cold), flush=True)
        del state, spk
        gc.collect()
        warm, state, spk = session(cfg, ckpt, wav, files, args.n_iters, dev, buckets)
    report.update(cold)
    report["adapt_voice"].update(warm_session_s=warm["adapt_voice"]["total_session_s"],
                                 warm_prep_s=warm["adapt_voice"]["prep_s"],
                                 warm_finetune_first_s=warm["adapt_voice"]["finetune_first_s"])
    report["warm"] = warm
    report["adapted_request"] = adapted_request(ckpt, state, spk, 12 if args.small else 140,
                                                2 if args.small else 50, dev)
    _serving.write_result(report, args, "bench_ssl", dev)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
