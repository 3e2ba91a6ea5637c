"""Port of the JAX package's models: transformer layers, BoFiCap and the
LSTM captioners, and the ``setup`` registry (reference models.setup,
captioning/models/__init__.py:14-24, which builds 'transformer' only; the
fc / updown / att2in2 / aoa workloads its config corpus names are the JAX
package's own)."""

from .boficap import DTYPES, BoFiCap, build_model
from .lstm_caption import (AoANet, Att2in2Model, FCModel, LSTMCaptioner,
                           UpDownModel)

LSTM_MODELS = ("fc", "show_tell", "updown", "topdown", "att2in2", "att2in",
               "aoa")


def setup(cfg, vocab_size: int, device=None):
    """The model a config names, parameters zeroed (fill them with a
    loader).  ``use_pallas`` sets the attention-core routing
    (``set_attention_core``), as the JAX package's ``setup`` sets its
    global."""
    cm = cfg.get("caption_model", "transformer")
    if cm in ("transformer", "bert", "m2transformer"):
        return build_model(cfg, vocab_size, device)
    if cm not in LSTM_MODELS:
        raise ValueError(f"caption_model '{cm}' is not supported")
    from ..device import resolve_device
    common = dict(tgt_vocab=vocab_size + 4,
                  d_model=cfg.get("input_encoding_size", 512),
                  rnn_size=cfg.get("rnn_size", 512),
                  max_length=cfg.get("max_length", 20) or 20,
                  drop_prob_lm=cfg.get("drop_prob_lm", 0.5),
                  att_feat_size=cfg.get("att_feat_size", 2048),
                  max_boxes=cfg.get("max_boxes", 36) or 36,
                  dtype=DTYPES[cfg.get("dtype", "bfloat16")],
                  device=resolve_device(device))
    if cm in ("fc", "show_tell"):
        model = FCModel(**common)
    elif cm in ("updown", "topdown"):
        model = UpDownModel(att_hid_size=cfg.get("att_hid_size", 512),
                            **common)
    elif cm in ("att2in2", "att2in"):
        model = Att2in2Model(att_hid_size=cfg.get("att_hid_size", 512),
                             **common)
    else:
        model = AoANet(num_heads=cfg.get("num_att_heads", 8),
                       N_enc=cfg.get("N_enc", 6) or 6, **common)
    model.set_attention_core(bool(cfg.get("use_pallas", False)))
    return model


__all__ = ["AoANet", "Att2in2Model", "BoFiCap", "FCModel", "LSTMCaptioner",
           "LSTM_MODELS", "UpDownModel", "build_model", "setup"]
