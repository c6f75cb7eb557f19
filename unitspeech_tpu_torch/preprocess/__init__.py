"""Dataset-level preprocessing (counterpart of unitspeech_tpu/preprocess): the mel min/max and the unconditional CFG embeddings."""
