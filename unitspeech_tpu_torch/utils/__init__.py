"""Parameter bridging and checkpoints."""
