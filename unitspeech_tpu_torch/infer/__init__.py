"""Inference pipelines (counterparts of unitspeech_tpu/infer)."""
