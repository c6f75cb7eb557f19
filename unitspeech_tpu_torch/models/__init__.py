"""Model modules (counterparts of unitspeech_tpu/models)."""
