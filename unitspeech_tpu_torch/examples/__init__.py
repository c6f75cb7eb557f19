"""Walkthroughs of the port's API (counterparts of the root examples/ that
need only ported modules), each runnable on random weights:

  python -m unitspeech_tpu_torch.examples.demo [--device cpu]
  python -m unitspeech_tpu_torch.examples.speaker_probing [--device cpu]
"""
