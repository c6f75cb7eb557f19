"""Training loops (counterparts of unitspeech_tpu/train): STEP1 (the text encoder, duration predictor and decoder, `steps.py`, `loop.py`) and the speaker-adaptive fine-tune."""
