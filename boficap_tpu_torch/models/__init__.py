"""Port of the JAX package's models: transformer layers and BoFiCap, and
the ``setup`` registry (reference models.setup,
captioning/models/__init__.py:14-24)."""

from .boficap import BoFiCap, build_model

LSTM_MODELS = ("fc", "show_tell", "updown", "topdown", "att2in2", "att2in",
               "aoa")


def setup(cfg, vocab_size: int, device=None) -> BoFiCap:
    """The model a config names, parameters zeroed (fill them with a
    loader).  ``build_model`` sets the attention-core routing from
    ``use_pallas``, as the JAX package's ``setup`` sets its global."""
    cm = cfg.get("caption_model", "transformer")
    if cm in ("transformer", "bert", "m2transformer"):
        return build_model(cfg, vocab_size, device)
    if cm in LSTM_MODELS:
        raise NotImplementedError(
            f"caption_model '{cm}' (models/lstm_caption.py) is not ported "
            "yet: ROADMAP.md section 1, item 9")
    raise ValueError(f"caption_model '{cm}' is not supported")
