"""The work of one launch of each of the port's counted kernel wrappers
(the keys of ``ops.launch_counts()``), from the sizes of the cell that
launched it: one table, keyed by wrapper.

``sizes``: B the rows a launch takes (images x beams), R regions, L words,
d, dff, H, V (the generator's classes), N_enc, N_dec.  Each entry gives
the frozen work (``counts.py``) of one launch at the shapes the decode
paths launch it with: the layer and stack kernels over every row, the
greedy head over every word row, the attention core on an AR step's
cross-attention (one query row over R keys), the window kernels on an SA
round (8 rows; the wide round L).  ``linear`` and ``refnorm`` have their
counts, but their shapes are the caller's choice, which no cell fixes: a
window that launches them has no work the table can give (None), and the
kernels' share of their roofline is then not read.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from portbench.roofline import counts

SA_WINDOW = 8


def _enc(s, dt):
    return counts.encoder_layer(s["B"], s["R"], s["d"], s["dff"], dt)


def _dec(s, dt):
    return counts.decoder_layer(s["B"], s["L"], s["R"], s["d"], s["dff"], dt)


def _win(W):
    def work(s, dt):
        return counts.window_layer(s["B"], W if W else s["L"], s["L"],
                                   s["R"], s["d"], s["dff"], dt)
    return work


def _times(n_key: str, fn):
    def work(s, dt):
        w = fn(s, dt)
        return {k: s[n_key] * v for k, v in w.items()}
    return work


WORK: Dict[str, Optional[Callable]] = {
    "encoder_layer": _enc,
    "decoder_layer": _dec,
    "greedy_head": lambda s, dt: counts.greedy_head(s["B"] * s["L"], s["d"],
                                                    s["V"], dt),
    "attention_core": lambda s, dt: counts.attention_core(
        s["B"], s["H"], 1, s["R"], s["d"] // s["H"], dt),
    "encoder_stack": _times("N_enc", _enc),
    "decoder_stack": _times("N_dec", _dec),
    "window_layer": _win(SA_WINDOW),
    "window_stack": _times("N_dec", _win(SA_WINDOW)),
    "window_wide_stack": _times("N_dec", _win(0)),
    "window_layer_parts": _win(SA_WINDOW),
    "window_layer_hb": _win(SA_WINDOW),
    "linear": None,
    "refnorm": None,
}


def sizes(cfg: dict, rows: int, regions: int) -> Dict[str, int]:
    return {"B": rows, "R": regions, "L": cfg["max_length"],
            "d": cfg["d_model"], "dff": cfg["d_ff"],
            "H": cfg["num_att_heads"], "V": cfg["vocab_size"] + 4,
            "N_enc": cfg["N_enc"], "N_dec": cfg["N_dec"]}


def least_time_s(launches: Dict[str, int], s: Dict[str, int],
                 dtype: str) -> Optional[float]:
    """The least time of every launch in ``launches`` ({wrapper: count})
    at the sizes ``s``; None where a wrapper's work is not known."""
    total = 0.0
    for name, n in launches.items():
        fn = WORK.get(name)
        if fn is None:
            return None
        total += n * counts.least_time_s(fn(s, dtype), dtype)
    return total
