"""Walkthroughs of the port's API (counterparts of the root examples/),
each runnable on random weights:

  python -m unitspeech_tpu_torch.examples.demo [--device cpu]
  python -m unitspeech_tpu_torch.examples.speaker_probing [--device cpu]
  python -m unitspeech_tpu_torch.examples.resynthesis [--device cpu]
  python -m unitspeech_tpu_torch.examples.gslm [--device cpu]

flax_layers holds the flax-layout Dense / LayerNorm / SelfAttention that
the probe and the unit LM are built from.
"""
