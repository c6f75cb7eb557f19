"""Training data (counterpart of unitspeech_tpu/data): filelists, the text-mel dataset and the
bucketed collator; the textless quantized views (quantize.py)."""
