"""Evaluation of the port (counterpart of unitspeech_tpu/eval/): the
harness (sample generation with RTF accounting, the objective metrics and
the unit round trip) and the per-speaker sample generator.

  python -m unitspeech_tpu_torch.eval.generate_samples --sentences s.txt ... --out-dir out
  python -m unitspeech_tpu_torch.cli evaluate --samples-dir out [--hubert H --kmeans K]
"""
