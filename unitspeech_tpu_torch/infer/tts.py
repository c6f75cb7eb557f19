"""Adaptive text-to-speech pipeline (counterpart of
unitspeech_tpu/infer/tts.py `TTSModels` and `Synthesizer`; reference
unitspeech.py:413-450 driven by inference.py:34-160):

  phoneme IDs -> text encoder -> duration predictor -> generate_path ->
  aligned conditioning -> 50-step reverse DDPM with dual CFG (or the
  sampler a spec names: ddpm / dpm2, optionally :cs<k>) -> denormalize ->
  BigVGAN -> waveform

The mel-frame axis is padded to a bucket of the same ladder as the JAX
Synthesizer (tts.py:516-518). PyTorch needs no static shapes, but the
padding is part of the function: GroupNorm statistics and the attention
keys pool over the padded frames, so a batch's mel depends on the bucket
of its longest row.

`Synthesizer.__call__` dispatches in the JAX order: forced durations, the
bucket switch (`switch_buckets`), the calibrated guess (`calibrator`), the
constant-ratio guess (`speculative_frames_per_token`), then the exact
path. Every mode pads the token axis to `token_buckets` as JAX does; the
forced and exact paths (`synthesize_mel`, the CLI's) are the batched path
at B = 1. Where JAX picks the switch bucket on
the device inside one executable, the port brings the predicted lengths to
the host and runs one align -> sample -> vocode at JAX's bucket; the
guessed modes run without that sync and check `fits` after. Every overflow
falls back at the exact bucket, reusing the encoder outputs.
`synthesize_batch` runs B requests as one 3B-row sampler at the bucket of
the longest. With JAX's `mesh` and a `sample_spec` that puts 'data' on the
batch axis, synthesize_mel_batch and synthesize_batch split the B
requests over the ranks of the mesh's data axis (rows rank, rank + size,
...): each rank runs its rows through the padded batched encode, the
aligner, the sampler (the global batch's noise, its rows kept) and the
vocoder, at the bucket of the longest row of all, and the outputs are
gathered in request order on every rank. The single-request paths
(`__call__`, `synthesize_mel`) and the serving dispatches run whole on
each rank of the data axis. A spec that puts 'seq' on the frame axis
(JAX's P(None, "seq", None), or P("data", "seq", None) with the data
axis) splits every sampler call's frames over the mesh's seq axis, in
every mode (parallel/mesh.py SeqShard; models/diffusion.py seq_sharded):
the encoder, the duration predictor and the vocoder run whole on every
rank, as JAX constrains only the sampler's state. The decoder may be
sharded over the mesh's model axis (parallel.shard_params_tp(models.decoder,
mesh), as JAX's sampler paths shard the decoder's parameters alone): every
sampler call then runs the tensor-parallel estimator, with or without a
spec; the encoder, the duration predictor and the vocoder stay whole. A
spec naming 'model' raises ValueError (the axis shards parameters, not the
sample). Every mode runs on these meshes, the fused deep-stage
configuration (--deep --i8pre --resample) too: its kernels take their
sharded forms (models/unet.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from unitspeech_tpu_torch.config import MainConfig
from unitspeech_tpu_torch.infer.graphs import graphs_for
from unitspeech_tpu_torch.models.diffusion import UnitSpeech, parse_sampler_spec, sample
from unitspeech_tpu_torch.models.duration import DurationPredictor
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.models.vocoder import BigVGAN
from unitspeech_tpu_torch.ops.masking import (
    choose_bucket,
    default_frame_buckets,
    fix_len_compatibility,
    generate_path,
    sequence_mask,
)
from unitspeech_tpu_torch.ops.mel import denormalize_mel
from unitspeech_tpu_torch.parallel.mesh import SINGLE, sample_shard
from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict


@dataclass
class TTSModels:
    """The synthesis path's modules (eval mode, on one device)."""

    cfg: MainConfig
    text_encoder: Encoder
    duration_predictor: DurationPredictor
    decoder: UnitSpeech
    vocoder: Optional[BigVGAN]
    spk_emb: torch.Tensor  # (1, spk_emb_dim), unit-normalized
    mel_min: torch.Tensor  # (n_feats,)
    mel_max: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.spk_emb.device

    @classmethod
    def from_state_dicts(cls, cfg: MainConfig, state_dicts: dict, spk_emb, mel_min, mel_max,
                         device="cuda", dtype=torch.bfloat16, use_kernels: bool = True,
                         use_int8_deep: bool = False, use_deep: bool = False,
                         use_resample: bool = False, use_i8pre_deep: bool = False,
                         with_vocoder: bool = True):
        """The modules at `cfg`'s widths with weights from `state_dicts`
        ({"text_encoder", "duration_predictor", "decoder"[, "vocoder"]}: state
        dicts in the port's layout, from a checkpoint, utils/artifacts or a
        fine-tune), on `device`, the card unless the caller asks for the CPU
        (no CUDA device raises). Each loads with load_state_dict, whose hooks
        pack the weights for the kernel routes. The encoder and duration
        predictor run in f32; the decoder and vocoder in `dtype`, with the
        estimator and vocoder kernels when `use_kernels`, and int8 deep-stage
        convs when `use_int8_deep`. use_deep, use_resample and use_i8pre_deep
        are the JAX package's use_pallas_deep, use_pallas_resample and
        use_i8pre_deep: the fused deep-stage configuration (models/unet.py).
        spk_emb is unit-normalized here."""
        mods = build_modules(cfg, device=device, dtype=dtype, use_kernels=use_kernels,
                             use_int8_deep=use_int8_deep, use_deep=use_deep,
                             use_resample=use_resample, use_i8pre_deep=use_i8pre_deep,
                             with_vocoder=with_vocoder)
        for name, mod in mods.items():
            mod.load_state_dict(state_dicts[name])
            mod.eval().requires_grad_(False)
        spk = torch.as_tensor(spk_emb).to(device, torch.float32).reshape(1, -1)
        return cls(cfg=cfg, text_encoder=mods["text_encoder"],
                   duration_predictor=mods["duration_predictor"], decoder=mods["decoder"],
                   vocoder=mods.get("vocoder"), spk_emb=spk / torch.linalg.vector_norm(spk),
                   mel_min=torch.as_tensor(mel_min).to(device, torch.float32).reshape(-1),
                   mel_max=torch.as_tensor(mel_max).to(device, torch.float32).reshape(-1))

    @classmethod
    def from_checkpoint(cls, ckpt: dict, device="cuda", dtype=torch.bfloat16, **kwargs):
        """ckpt: the dict utils.params.random_params returns (or one loaded
        from a file that `cli make-random-checkpoint` wrote); its
        "unit_encoder" entry, which only the fine-tune reads, is not loaded.
        kwargs: the routes of from_state_dicts. A checkpoint without a
        speaker embedding (a STEP1 checkpoint) raises: pass its modules to
        from_state_dicts with a voice, as `cli inference --spk-emb` does."""
        if ckpt.get("spk_emb") is None:
            raise ValueError("the checkpoint has no spk_emb (a STEP1 checkpoint holds no "
                             "voice): give one, as cli inference --spk-emb does")
        return cls.from_state_dicts(config_from_dict(ckpt["config"]), ckpt, ckpt["spk_emb"],
                                    ckpt["mel_min"], ckpt["mel_max"], device=device,
                                    dtype=dtype, **kwargs)




def forced_durations(n_tok: int, frames: int) -> np.ndarray:
    """(1, n_tok) durations summing to `frames`, the remainder on the first
    token (the JAX Synthesizer's _forced_total_frames rule)."""
    w = np.full((1, n_tok), frames // n_tok, np.float32)
    w[0, 0] += frames - (frames // n_tok) * n_tok
    return w


def switch_choice(y_max: int, buckets: Sequence[int]):
    """The bucket-switch choice for a batch whose longest predicted length
    is y_max frames: (bucket, fits), JAX's `_synthesize_bucket_switch`
    (tts.py:372-376): the first bucket of the ascending window that holds
    y_max, the largest when none does; fits is False then (an overflow).
    No fix_len_compatibility: the window's buckets already are multiples."""
    idx = min(sum(int(y_max) > int(b) for b in buckets), len(buckets) - 1)
    return int(buckets[idx]), int(y_max) <= int(buckets[-1])


@dataclass
class Dispatch:
    """One batch through a serving mode: wav (B, bucket * hop) and mel
    (B, bucket, F) on the device (None when a switch overflowed: nothing
    was sampled), the synthesized lengths y_lengths (B,) int on the host,
    fits, the frame bucket, and what a fallback reuses: the encoder
    outputs, the length-scaled durations and the speaker rows."""

    wav: Optional[torch.Tensor]
    mel: Optional[torch.Tensor]
    y_lengths: np.ndarray
    fits: bool
    bucket: int
    mu_x: torch.Tensor
    x_mask: torch.Tensor
    w_ceil: torch.Tensor
    spk: torch.Tensor


@dataclass
class Synthesizer:
    models: TTSModels
    frame_buckets: Sequence[int] = field(default_factory=lambda: default_frame_buckets(4096))
    # the serving modes pad the token axis to one of these (JAX tts.py:439)
    token_buckets: Sequence[int] = field(default_factory=lambda: tuple(2 ** i for i in range(4, 11)))
    # speculative serving with a constant guess: the frame bucket of
    # n_tokens * this ratio, the whole pipeline without a host sync before
    # the sampler; an overflow re-runs the exact path. None = exact.
    speculative_frames_per_token: Optional[float] = None
    # calibrated speculative serving (supersedes the constant ratio): an
    # infer/calibration.DurationCalibrator guesses each request's bucket at
    # ~P95 coverage once `ready`; before that the exact path runs and feeds
    # it. A miss falls back at the exact bucket, reusing the encoder outputs.
    calibrator: Any = None
    # bucket-switch serving (supersedes both guesses): an ascending tuple of
    # frame buckets; the predicted lengths come to the host and the batch
    # runs at the first bucket that holds its longest row (make_switch_buckets
    # picks the window from the calibrator's observed lengths)
    switch_buckets: Any = None
    # data- and sequence-sharded synthesis (JAX's fields): a
    # parallel.make_mesh mesh and a (B, T, F) spec, e.g. ("data", None,
    # None), (None, "seq", None) or ("data", "seq", None)
    mesh: Any = None
    sample_spec: Any = None
    # on the card at world 1 the sampler runs each step as one CUDA graph
    # replay (infer/graphs.py, the decoder's graphs); False runs the steps
    # eagerly (the tests' and chip_smoke.py's reference)
    graphs: bool = True

    def __post_init__(self):
        self._shard, self._seq = sample_shard(self.mesh, self.sample_spec)

    def _scales(self, diffusion_steps, length_scale, text_gradient_scale, spk_gradient_scale):
        icfg = self.models.cfg.inference
        pick = lambda v, d: d if v is None else v  # noqa: E731
        return (int(pick(diffusion_steps, icfg.diffusion_steps)),
                float(pick(length_scale, icfg.length_scale)),
                float(pick(text_gradient_scale, icfg.text_gradient_scale)),
                float(pick(spk_gradient_scale, icfg.spk_gradient_scale)))

    def _pack(self, token_sequences):
        """(tokens (B, tok_bucket) int64, lengths (B,)) on the host, the
        token axis padded with zeros to the bucket of the longest sequence."""
        tok_bucket = choose_bucket(max(len(s) for s in token_sequences), self.token_buckets)
        tokens = np.zeros((len(token_sequences), tok_bucket), np.int64)
        for i, seq in enumerate(token_sequences):
            tokens[i, :len(seq)] = seq
        return tokens, np.array([len(s) for s in token_sequences], np.int64)

    def _spk_rows(self, b: int, spk=None) -> torch.Tensor:
        """(b, spk_emb_dim) speaker rows on the models' device: `spk` (one
        row per request, the serving daemon's voices) or the model's own
        embedding broadcast. The guidance rows concatenate it with the
        unconditional embedding, so every row needs its own."""
        m = self.models
        if spk is None:
            return m.spk_emb.expand(b, m.spk_emb.shape[-1])
        return torch.as_tensor(np.asarray(spk, np.float32).reshape(b, -1), device=m.device)

    @torch.no_grad()
    def _encode_and_duration(self, tokens, lengths, spk):
        """tokens (B, T) ids, lengths (B,), spk (B, S) -> (mu_x (B, T, F),
        x_mask (B, T, 1), w_ceil (B, T)), the durations ceil(exp(logw))
        before any length scale (reference unitspeech.py:424-425)."""
        m = self.models
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=m.device)
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.long, device=m.device)
        mu_x, hidden, x_mask = m.text_encoder(tokens, lengths)
        logw = m.duration_predictor(hidden, x_mask, spk)
        return mu_x, x_mask, torch.ceil(torch.exp(logw) * x_mask[..., 0])

    def _encode_batch(self, tokens, lengths, lscale, spk=None, w_override=None):
        """The serving modes' encode of a (B, tok_bucket) batch: (mu_x,
        x_mask, w_ceil, spk rows), the durations length-scaled, or
        w_override (B, tok_bucket) in their place."""
        spk = self._spk_rows(len(tokens), spk)
        mu_x, x_mask, w_ceil = self._encode_and_duration(tokens, lengths, spk)
        if w_override is not None:
            return mu_x, x_mask, torch.as_tensor(np.asarray(w_override, np.float32),
                                                 device=w_ceil.device), spk
        return mu_x, x_mask, w_ceil * lscale, spk

    def encode(self, token_ids: Sequence[int]):
        """Token IDs -> (mu_x (1, Tx, F), x_mask (1, Tx, 1), w_ceil (1, Tx))
        on the true tokens (encoded padded to their token bucket, as every
        mode encodes), durations before any length scale."""
        tokens, lengths = self._pack([token_ids])
        n = len(token_ids)
        mu_x, x_mask, w_ceil = self._encode_and_duration(tokens, lengths, self._spk_rows(1))
        return mu_x[:, :n], x_mask[:, :n], w_ceil[:, :n]

    @torch.no_grad()
    def _align_and_sample(self, mu_x, x_mask, w_ceil, y_pad, steps, tg, sg, generator,
                          noise_z, noises, sampler, spk=None, shard=None):
        """shard: the rows are this rank's of a data-sharded batch, whose
        noise is drawn for the global batch (the rank keeps its rows); with
        a seq-sharding mesh the sampler splits the frames (sample's
        seq_shard) and returns every frame."""
        m = self.models
        spk = self._spk_rows(mu_x.shape[0]) if spk is None else spk
        y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1.0)
        y_mask = sequence_mask(torch.clamp(y_lengths, max=y_pad).to(torch.int32), y_pad)
        attn = generate_path(w_ceil, x_mask * y_mask[:, None, :])
        cond_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        z = noise_z if noise_z is not None else (shard or SINGLE).randn(
            cond_y.shape, generator, cond_y.device)
        # `sampler` is a spec ("ddpm" / "dpm2", optionally ":cs<k>"), parsed
        # here, the one sampler dispatch point, as in the JAX package
        graphs = graphs_for(m.decoder, cond_y, shard, self._seq) if self.graphs else None
        mel = sample(m.decoder, sampler, z, y_mask, cond_y, spk, steps,
                     text_gradient_scale=tg, spk_gradient_scale=sg, generator=generator,
                     noises=noises, shard=shard, seq_shard=self._seq, graphs=graphs)
        return denormalize_mel(mel, m.mel_min, m.mel_max), attn

    def _align_sample_vocode(self, mu_x, x_mask, w_ceil, y_pad, steps, tg, sg, generator,
                             sampler, spk, noise_z=None, noises=None):
        """align -> sample -> vocode at frame bucket y_pad: (wav, mel)."""
        mel, _ = self._align_and_sample(mu_x, x_mask, w_ceil, y_pad, steps, tg, sg, generator,
                                        noise_z, noises, sampler, spk)
        return self.vocode(mel), mel

    def synthesize_mel(self, token_ids: Sequence[int], generator=None, diffusion_steps=None,
                       length_scale=None, text_gradient_scale=None, spk_gradient_scale=None,
                       noise_z=None, noises=None, durations=None, sampler: str = "ddpm"):
        """Token IDs -> (denormalized log-mel (1, Ty_pad, F), y_length, attn
        (1, Tx, Ty_pad)): the exact path (and the forced one, with
        `durations`), the batched path at B = 1.

        sampler: a spec (models/diffusion.parse_sampler_spec), "ddpm" (the
        reference's), "dpm2", either with ":cs<k>"; a malformed one raises
        before any work.
        durations: optional (1, n_tok) forced per-token durations. noise_z
        (1, Ty_pad, F) / noises (steps, 1, Ty_pad, F): injected prior and
        per-step noise (shapes at the frame bucket the call resolves);
        otherwise drawn from `generator`. With predicted durations and a
        calibrator attached, the calibrator observes them (pre-scale) and
        the request's total, as JAX's exact path feeds it."""
        scales = self._scales(diffusion_steps, length_scale, text_gradient_scale,
                              spk_gradient_scale)
        forced = None if durations is None else [np.asarray(durations).reshape(-1)]
        mel, y_lengths, attn, w_host = self._mel_batch([token_ids], generator, scales, None,
                                                       noise_z, noises, forced, sampler)
        n, lscale = len(token_ids), scales[1]
        if durations is None and self.calibrator is not None:
            self.calibrator.observe_durations(token_ids, w_host[0, :n] / lscale)
            self.calibrator.observe_total(token_ids, float(w_host[0].sum()) / lscale)
        return mel, int(y_lengths[0]), attn[:, :n]

    def synthesize_mel_batch(self, token_sequences, generator=None, diffusion_steps=None,
                             length_scale=None, text_gradient_scale=None,
                             spk_gradient_scale=None, spk=None, noise_z=None, noises=None,
                             durations=None, sampler: str = "ddpm"):
        """B requests as one batch (JAX synthesize_batch): the token axis
        padded to the bucket of the longest, one host sync of the predicted
        lengths, one 3B-row sampler at the frame bucket of the longest row.
        spk: optional (B, spk_emb_dim) rows; durations: optional forced
        per-token durations, one sequence per request; noise_z (B, Ty_pad,
        F) / noises (steps, B, Ty_pad, F) injected as in synthesize_mel.
        Data-sharded with the Synthesizer's mesh (the module docstring).
        Returns (mel (B, Ty_pad, F), y_lengths (B,) int on the host)."""
        mel, y_lengths = self._rows(token_sequences, generator, diffusion_steps, length_scale,
                                    text_gradient_scale, spk_gradient_scale, spk, noise_z,
                                    noises, durations, sampler)
        if self._shard is not None:
            mel = self._shard.gather(mel, len(token_sequences))
        return mel, y_lengths

    def _rows(self, token_sequences, generator=None, diffusion_steps=None, length_scale=None,
              text_gradient_scale=None, spk_gradient_scale=None, spk=None, noise_z=None,
              noises=None, durations=None, sampler: str = "ddpm"):
        """synthesize_mel_batch's mel of this rank's rows (every row without
        a data-sharding mesh) and the y_lengths of all."""
        scales = self._scales(diffusion_steps, length_scale, text_gradient_scale,
                              spk_gradient_scale)
        mel, y_lengths, _, _ = self._mel_batch(token_sequences, generator, scales, spk, noise_z,
                                               noises, durations, sampler, self._shard)
        return mel, y_lengths

    def _mel_batch(self, token_sequences, generator, scales, spk, noise_z, noises, durations,
                   sampler, shard=None):
        """synthesize_mel_batch's work, the scales resolved: (mel, y_lengths
        (B,) int, attn (B, tok_bucket, Ty_pad), w_host (B, tok_bucket): the
        length-scaled or forced durations on the host). With `shard` the
        mel, attn and w_host are this rank's rows (the inputs are the whole
        batch's); y_lengths and the bucket are the whole batch's."""
        steps, lscale, tg, sg = scales
        parse_sampler_spec(sampler)
        tokens, lengths = self._pack(token_sequences)
        w = None
        if durations is not None:
            w = np.zeros(tokens.shape, np.float32)
            for i, d in enumerate(durations):
                w[i, :len(d)] = np.asarray(d, np.float32).reshape(-1)
        b = len(tokens)
        if shard is not None:
            if b % shard.size:
                raise ValueError(f"{b} requests do not divide over the data axis "
                                 f"({shard.size})")
            tokens, lengths = shard.take(tokens), shard.take(lengths)
            w = None if w is None else shard.take(w)
            spk = None if spk is None else shard.take(np.asarray(spk, np.float32).reshape(b, -1))
            noise_z = None if noise_z is None else shard.take(noise_z)
            noises = None if noises is None else shard.take(noises, 1)
        mu_x, x_mask, w_ceil, spk = self._encode_batch(tokens, lengths, lscale, spk, w)
        # the one host sync for the data-dependent lengths (reference
        # unitspeech.py:427-429); the whole rows cost what their sums do and
        # give the calibrator per-token observations
        w_host = w_ceil.cpu().numpy()
        y_lengths = np.maximum(w_host.sum(axis=1).astype(np.int64), 1)
        if shard is not None:  # the bucket of the longest row of all
            y_lengths = shard.gather(torch.from_numpy(y_lengths).to(w_ceil.device), b)
            y_lengths = y_lengths.cpu().numpy()
        num_down = self.models.cfg.decoder.num_downsamplings
        y_pad = choose_bucket(fix_len_compatibility(int(y_lengths.max()), num_down),
                              self.frame_buckets)
        mel, attn = self._align_and_sample(mu_x, x_mask, w_ceil, y_pad, steps, tg, sg, generator,
                                           noise_z, noises, sampler, spk, shard)
        return mel, y_lengths, attn, w_host

    def synthesize_batch(self, token_sequences, generator=None, **kwargs):
        """Batched synthesis (JAX synthesize_batch): synthesize_mel_batch,
        then one vocoder call (on each rank's rows, the waveforms gathered,
        with a data-sharding mesh). Returns a list of (wav np.ndarray, sr)."""
        mel, y_lengths = self._rows(token_sequences, generator, **kwargs)
        wavs = self.vocode(mel)
        if self._shard is not None:
            wavs = self._shard.gather(wavs, len(token_sequences))
        wavs = wavs.float().cpu().numpy()
        hop, sr = self.models.cfg.data.hop_length, self.models.cfg.data.sampling_rate
        return [(wavs[i, :int(y) * hop], sr) for i, y in enumerate(y_lengths)]

    def warmup(self, token_lengths=(64,), frame_lengths=(344,), generator=None, **synth_kwargs):
        """Run the (token length x frame length) grid once through __call__
        with forced durations before serving, so the kernel builds, the
        weight packs, the allocator's blocks and, on the card, the sampler's
        CUDA graphs for those shapes are paid before the first request."""
        for n_tok, frames in itertools.product(token_lengths, frame_lengths):
            self([1] * n_tok, generator, forced_total_frames=int(frames), **synth_kwargs)

    def reserve_steps(self, steps: int) -> None:
        """Size the sampler graphs' step tables for requests of up to `steps`
        steps (SamplerGraphs.reserve): a warm-up of fewer steps then captures
        graphs that such requests replay."""
        graphs = graphs_for(self.models.decoder, self.models.spk_emb) if self.graphs else None
        if graphs is not None:
            graphs.reserve(steps)

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        if self.models.vocoder is None:
            raise ValueError("Synthesizer built without a vocoder.")
        return self.models.vocoder(mel)

    def calibrate(self, token_sequences, length_scale: float = 1.0):
        """Feed the calibrator from a text corpus without synthesizing: each
        sequence runs only the encoder and duration predictor (padded to its
        token bucket, as a served request) and the calibrator observes its
        per-token durations and total. A serving process calls this at
        startup so the bucket-switch window and the calibrated guess are
        ready for the first request. Durations are observed pre-scale."""
        if self.calibrator is None:
            raise ValueError("Synthesizer has no calibrator attached.")
        del length_scale  # observed pre-scale by convention, as in JAX
        for token_ids in token_sequences:
            tokens, lengths = self._pack([token_ids])
            w_host = self._encode_and_duration(tokens, lengths, self._spk_rows(1))[2][0]
            w_host = w_host.cpu().numpy()
            self.calibrator.observe_durations(token_ids, w_host[:len(token_ids)])
            self.calibrator.observe_total(token_ids, float(w_host.sum()))

    def make_switch_buckets(self, length_scale: float = 1.0, lo_q: float = 0.05,
                            hi_q: float = 1.0, max_branches: int = 3, policy: str = "cost",
                            per_frame_ms=None):
        """The bucket-switch window from the calibrator's observed lengths.

        policy="cost" (the default): the ascending ladder-bucket subset of up
        to max_branches buckets (not necessarily contiguous) minimizing the
        expected per-request cost under the card's measured cost model
        (infer/bucket_cost.py), plus one insurance ladder step above the
        observed maximum. `per_frame_ms` defaults to the measured ddpm@50
        curve (bucket_cost.frame_cost_curve, from cost_anchors_h100.json,
        which must then exist); pass frame_cost_curve(sampler, steps) for
        other modes, or an explicit (c0, c1, c2) curve.

        policy="quantile": every ladder bucket between ~P(lo_q) and ~P(hi_q)
        of the lengths plus one ladder step of headroom, keeping the largest
        max_branches; needs no measured constant.

        Returns an ascending tuple for `switch_buckets`."""
        from unitspeech_tpu_torch.infer import bucket_cost

        if self.calibrator is None:
            raise ValueError("Synthesizer has no calibrator attached.")
        totals = self.calibrator.observed_totals()
        if not totals:
            raise ValueError("calibrator has no observed lengths yet")
        lengths = np.asarray(totals, np.float64) * length_scale
        num_down = self.models.cfg.decoder.num_downsamplings
        if policy == "cost":
            window, _row = bucket_cost.optimal_window(
                lengths, self.frame_buckets,
                per_frame_ms=(per_frame_ms if per_frame_ms is not None
                              else bucket_cost.frame_cost_curve("ddpm", 50)),
                max_branches=max_branches, num_down=num_down,
                headroom=1)  # one insurance branch above the observed max
            return window
        if policy != "quantile":
            raise ValueError(f"unknown bucket policy {policy!r}")
        return bucket_cost.quantile_window(lengths, self.frame_buckets, lo_q=lo_q, hi_q=hi_q,
                                           max_branches=max_branches, num_down=num_down)

    def _switch_dispatch(self, tokens, lengths, generator, steps, lscale, tg, sg,
                         sampler="ddpm", spk=None, noise_z=None, noises=None) -> Dispatch:
        """A (B, tok_bucket) batch on the bucket switch (JAX
        _synthesize_bucket_switch): encode, the length-scaled durations'
        sums to the host (the one sync), then align -> sample -> vocode at
        switch_choice's bucket; on an overflow nothing is sampled (fits
        False, wav None) and the caller falls back (_fallback). spk:
        optional (B, spk_emb_dim) rows (the daemon's voices)."""
        mu_x, x_mask, w_ceil, spk = self._encode_batch(tokens, lengths, lscale, spk)
        y_lengths = torch.clamp(w_ceil.sum(dim=1).to(torch.int32), min=1).cpu().numpy()
        bucket, fits = switch_choice(int(y_lengths.max()), self.switch_buckets)
        wav = mel = None
        if fits:
            wav, mel = self._align_sample_vocode(mu_x, x_mask, w_ceil, bucket, steps, tg, sg,
                                                 generator, sampler, spk, noise_z, noises)
        return Dispatch(wav, mel, y_lengths, fits, bucket, mu_x, x_mask, w_ceil, spk)

    def _single_dispatch(self, tokens, lengths, w_override, frame_bucket, generator, steps,
                         lscale, tg, sg, sampler="ddpm", noise_z=None, noises=None) -> Dispatch:
        """A (B, tok_bucket) batch at a frame bucket chosen up front (JAX
        _synthesize_single_dispatch): encode -> durations (w_override (B,
        tok_bucket) in their place when given) -> the frame mask on the
        device -> sample -> vocode, queued with no host sync; then the
        lengths and fits (every row within the bucket) come to the host."""
        mu_x, x_mask, w_ceil, spk = self._encode_batch(tokens, lengths, lscale,
                                                       w_override=w_override)
        y_lengths = torch.clamp(w_ceil.sum(dim=1).to(torch.int32), min=1)
        wav, mel = self._align_sample_vocode(mu_x, x_mask, w_ceil, frame_bucket, steps, tg, sg,
                                             generator, sampler, spk, noise_z, noises)
        y_host = y_lengths.cpu().numpy()
        return Dispatch(wav, mel, y_host, bool((y_host <= frame_bucket).all()), int(frame_bucket),
                        mu_x, x_mask, w_ceil, spk)

    def _fallback(self, d: Dispatch, generator, steps, tg, sg, sampler="ddpm") -> Dispatch:
        """An overflowed dispatch at the exact bucket of its longest row
        (choose_bucket over frame_buckets), reusing its encoder outputs,
        durations and speaker rows: no re-encode."""
        num_down = self.models.cfg.decoder.num_downsamplings
        y_pad = choose_bucket(fix_len_compatibility(int(d.y_lengths.max()), num_down),
                              self.frame_buckets)
        wav, mel = self._align_sample_vocode(d.mu_x, d.x_mask, d.w_ceil, y_pad, steps, tg, sg,
                                             generator, sampler, d.spk)
        return dataclasses.replace(d, wav=wav, mel=mel, fits=True, bucket=y_pad)

    def __call__(self, token_ids: Sequence[int], generator=None, forced_total_frames=None,
                 **kwargs):
        """Token IDs -> (waveform np.ndarray (n_samples,), sample_rate, mel):
        mel is the denormalized log-mel (y_length, F) the waveform was
        vocoded from, trimmed to its true frames, on the models' device.

        Dispatch, in the JAX order (tts.py:782-969):
          * forced_total_frames: durations forced to sum to this many frames;
          * switch_buckets set: the bucket switch (fallback on overflow);
          * a calibrator that is ready: one pass at its guessed bucket
            (fallback on a miss); before it is ready, the exact path;
          * speculative_frames_per_token set: one pass at the guessed
            bucket; a miss re-runs the exact path;
          * otherwise the exact path (synthesize_mel), which feeds the
            calibrator.
        Keyword arguments: diffusion_steps, length_scale, the two gradient
        scales, sampler (a spec), noise_z / noises (injected noise at the
        bucket the call resolves)."""
        m = self.models
        if m.vocoder is None:
            raise ValueError("Synthesizer built without a vocoder.")
        steps, lscale, tg, sg = self._scales(kwargs.get("diffusion_steps"),
                                             kwargs.get("length_scale"),
                                             kwargs.get("text_gradient_scale"),
                                             kwargs.get("spk_gradient_scale"))
        sampler = str(kwargs.get("sampler", "ddpm"))
        parse_sampler_spec(sampler)
        hop, sr = m.cfg.data.hop_length, m.cfg.data.sampling_rate
        noise = {k: kwargs.get(k) for k in ("noise_z", "noises")}
        num_down = m.cfg.decoder.num_downsamplings

        def out(wav, mel, y_length):
            return wav[0, :y_length * hop].cpu().numpy(), sr, mel[0, :y_length]

        if forced_total_frames is None:
            tokens, lengths = self._pack([token_ids])
            d = None
            if self.switch_buckets is not None:
                d = self._switch_dispatch(tokens, lengths, generator, steps, lscale, tg, sg,
                                          sampler, **noise)
                if self.calibrator is not None:
                    self.calibrator.observe_total(token_ids, float(d.y_lengths[0]) / lscale)
            elif self.calibrator is not None and (guess := self.calibrator.guess_frames(
                    token_ids)) is not None:
                bucket = choose_bucket(
                    fix_len_compatibility(int(np.ceil(guess * lscale)), num_down),
                    self.frame_buckets)
                d = self._single_dispatch(tokens, lengths, None, bucket, generator, steps,
                                          lscale, tg, sg, sampler, **noise)
                self.calibrator.observe_total(token_ids, float(d.y_lengths[0]) / lscale)
            elif self.speculative_frames_per_token is not None:
                guess = int(np.ceil(len(token_ids) * self.speculative_frames_per_token))
                bucket = choose_bucket(fix_len_compatibility(guess, num_down),
                                       self.frame_buckets)
                spec = self._single_dispatch(tokens, lengths, None, bucket, generator, steps,
                                             lscale, tg, sg, sampler, **noise)
                if spec.fits:  # else the predicted durations overflowed: exact re-run
                    d = spec
            if d is not None:
                if not d.fits:
                    d = self._fallback(d, generator, steps, tg, sg, sampler)
                return out(d.wav, d.mel, max(int(d.y_lengths[0]), 1))
        else:
            kwargs["durations"] = forced_durations(len(token_ids), int(forced_total_frames))
        mel, y_length, _ = self.synthesize_mel(token_ids, generator, **kwargs)
        return out(self.vocode(mel), mel, y_length)
