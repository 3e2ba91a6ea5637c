"""Model configuration for the port: a reader for the repo's flat
``key: value`` YAML files and the defaults that ``build_model`` reads.

PyYAML is not assumed on the GPU machine, so this reader handles only the
subset the shipped configs use: one ``key: value`` per line, ``#``
comments, scalars (int, float, bool, null, bare or quoted strings) and an
optional ``_BASE_`` parent file.  Anything else (nesting, lists, block
scalars) raises, rather than being read wrongly.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

BASE_KEY = "_BASE_"

# the defaults of the fields build_model reads (the JAX package's
# config/opts.py DEFAULTS, the transformer-dims fallbacks of its finalize()),
# compute dtype included: a file that names no dtype builds a bfloat16 model,
# as the JAX package does; set ``dtype: float32`` for float32.  ``use_pallas``
# keeps the JAX package's key; in the port it routes the eligible attention
# calls through the attention-core kernel (ops/attention.py)
DEFAULTS: Dict[str, Any] = dict(
    train_mode="AIC",
    decoder_input_mode="add",
    N_len=0,
    N_enc=None,
    N_dec=None,
    d_model=None,
    d_ff=None,
    num_layers=1,
    rnn_size=512,
    input_encoding_size=512,
    num_att_heads=8,
    att_feat_size=2048,
    use_box=0,
    max_boxes=100,
    max_length=20,
    dtype="bfloat16",
    use_pallas=False,
)


class Config(dict):
    """Attribute-accessible dict; unknown attributes raise AttributeError
    (use ``cfg.get(k, default)`` for optional keys)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")


def _scalar(text: str, where: str) -> Any:
    if text == "" or text.lower() in ("null", "~", "none"):
        return None
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text[0] in "[{|>&*!%@`'\"":
        raise ValueError(f"{where}: unsupported YAML value {text!r} (the "
                         "port's reader takes flat scalars only)")
    return text


def read_flat_yaml(path: str) -> Dict[str, Any]:
    """Parse one flat ``key: value`` YAML file (no ``_BASE_`` resolution)."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            where = f"{path}:{n}"
            line = raw.rstrip("\n")
            if "#" in line:
                # a comment starts at '#' outside quotes
                quote = None
                for i, ch in enumerate(line):
                    if ch in "'\"":
                        quote = None if quote == ch else (quote or ch)
                    elif ch == "#" and quote is None:
                        line = line[:i]
                        break
            if not line.strip() or line.strip() == "---":
                continue
            if line[0] in " \t":
                raise ValueError(f"{where}: nested YAML is not supported")
            key, sep, value = line.partition(":")
            if not sep or not key.strip() or " " in key.strip():
                raise ValueError(f"{where}: expected 'key: value', got "
                                 f"{raw.rstrip()!r}")
            out[key.strip()] = _scalar(value.strip(), where)
    return out


def load_config(path: str) -> Config:
    """DEFAULTS, then the ``_BASE_`` chain, then the file itself; with the
    derived defaults the JAX package's ``finalize`` applies."""
    cfg = Config(DEFAULTS)
    cfg.update(_load_with_base(path))
    return finalize(cfg)


def _load_with_base(path: str) -> Dict[str, Any]:
    own = read_flat_yaml(path)
    base = own.pop(BASE_KEY, None)
    if base is None:
        return own
    if not os.path.isabs(base):
        cand = os.path.join(os.path.dirname(path), base)
        base = cand if os.path.exists(cand) else base
    merged = _load_with_base(base)
    merged.update(own)
    return merged


def finalize(cfg: Config) -> Config:
    """Transformer-dims fallbacks (reference TransformerModel.py:1631-1640)
    and the box-feature widening, as the JAX package's ``finalize`` does."""
    if cfg.get("use_box") and not cfg.get("att_feat_size_box_widened"):
        cfg.att_feat_size = cfg.att_feat_size + 5
        cfg.att_feat_size_box_widened = True
    if cfg.get("N_enc") is None:
        cfg.N_enc = cfg.num_layers
    if cfg.get("N_dec") is None:
        cfg.N_dec = cfg.num_layers
    if cfg.get("d_model") is None:
        cfg.d_model = cfg.input_encoding_size
    if cfg.get("d_ff") is None:
        cfg.d_ff = cfg.rnn_size
    return cfg


def make_config(**fields) -> Config:
    """DEFAULTS overridden by ``fields``, finalized."""
    cfg = Config(DEFAULTS)
    cfg.update(fields)
    return finalize(cfg)
