"""Offline dataset building: the port's copy of the JAX package's
``prepro/`` (vocabulary, caption encoding, the phrase cutters and the
phrase-pair merges), numpy and the standard library only."""
