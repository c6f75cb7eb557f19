"""The SSL frontends of speaker adaptation (counterparts of
unitspeech_tpu/models/ssl/): the conv feature extractor and transformer
encoder shared by WavLM and HuBERT, the k-means quantizer and the unit
extractor (SpeechEncoder). Plain PyTorch, f32, channels-last like JAX."""
