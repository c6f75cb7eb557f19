"""PyTorch / CUDA port of unitspeech_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (ops/, models/, infer/, text/, utils/,
cli.py) and its public layouts: sequences (B, T, C), the U-Net
(B, T, F, C), kernel rows (B, T*F, C). The JAX package is the reference the
port is held against; this package imports torch and never jax.
"""
