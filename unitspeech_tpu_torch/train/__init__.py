"""Training loops (counterparts of unitspeech_tpu/train): the speaker-adaptive fine-tune."""
