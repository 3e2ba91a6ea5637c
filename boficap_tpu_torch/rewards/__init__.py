"""The port's copy of the JAX package's reward scorers: n-gram counts,
BLEU and CIDEr / CIDEr-D (pure Python), and the self-critical reward
plumbing of the RL stage (with the native CIDEr-D, ``native/``)."""

from .self_critical import (array_to_str, get_scores,
                            get_self_cider_scores,
                            get_self_critical_reward, init_scorer)
