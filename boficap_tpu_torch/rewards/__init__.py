"""The port's copy of the JAX package's reward scorers: n-gram counts,
BLEU and CIDEr / CIDEr-D (pure Python)."""
