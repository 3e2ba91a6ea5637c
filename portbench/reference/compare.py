"""The comparison that decides ``correct``: what the timed path served,
judged by the plain reference (``boficap_ref.Reference``).

Random weights put near-ties everywhere, so tokens are not compared for
equality: each decision the program made is teacher-forced into the
reference, and the number read is the gap by which the reference's
log-probability of the program's choice lies below the reference's best
choice at that point (0 where they agree).  A run reports the widest gap
over its sample.  The control, the reference computed in float8
(``quant='fp8'``), is read the same way at the same points: the gap of the
token it puts first.

Decision points:

* NA (UIC): every bounding step of the plan up to and including the step
  that stopped it (its length and its syntax choice), then every filled
  word before the plan's total;
* AR (AIC): every word up to and including the first EOS.

``pad_errors`` counts what must hold exactly: PAD after the caption's end,
emitted phrases of at least one word with a syntax id in VP..CP, a plan of
at most L words.

Training (``train_gaps``): the program's first steps against the
reference's first steps from the same weights, batches and dropout masks
(``uic_train.py``).
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import torch

from .boficap_ref import (LEN, PAD, SYN_LOWER, SYN_UPPER, EOS, Reference)


def _gap(ref_lp, choice):
    """ref_lp [..., C], choice [...] -> max - ref_lp[choice]."""
    return ref_lp.max(-1).values - ref_lp.gather(-1, choice[..., None])[..., 0]


def _plan_states(pl, ps, pn, L: int):
    """For k = 0..L, the plan state before bounding step k (k = L: the
    whole plan): extend_syn [n, L+2] and last [n], the program's phrases
    0..k-1 written in."""
    n = pl.shape[0]
    dev = pl.device
    pos = torch.arange(L + 2, device=dev)[None, :]
    ext = torch.full((n, L + 2), PAD, dtype=torch.long, device=dev)
    ext[:, 0] = LEN
    last = torch.ones(n, dtype=torch.long, device=dev)
    for k in range(L + 1):
        yield k, ext.clone(), last.clone()
        if k == L:
            return
        emitted = k < pn
        le = torch.where(emitted, pl[:, k], 0)
        w = (pos >= last[:, None]) & (pos < (last + le)[:, None])
        ext = torch.where(w, ps[:, k:k + 1], ext)
        last = last + le


@torch.no_grad()
def na_gaps(ref: Reference, att, am, out: Dict[str, torch.Tensor],
            control: Optional[Reference] = None) -> Dict[str, float]:
    """``out``: the program's seq, phrase_length, phrase_syn [n, L] and
    phrase_num [n] for the features att [n, R, F], am [n, R].  Returns
    plan_gap, word_gap, pad_errors, tokens (decision points read); with
    ``control``, also ctrl_plan_gap and ctrl_word_gap."""
    L = ref.L
    seq = out["seq"].long()
    pl, ps = out["phrase_length"].long(), out["phrase_syn"].long()
    pn = out["phrase_num"].long()
    total = pl.sum(1)
    errors = int((total > L).sum())
    slot = torch.arange(L, device=seq.device)[None, :]
    emitted = slot < pn[:, None]
    errors += int((emitted & ((pl < 1) | (ps < SYN_LOWER)
                              | (ps > SYN_UPPER))).sum())
    errors += int(((slot >= total[:, None]) & (seq != PAD)).sum())
    errors += int(((~emitted) & (pl != 0)).sum())
    total = total.clamp(max=L)

    mem, src = ref.encode(att, am)
    cm = control.encode(att, am) if control is not None else None
    plan = torch.zeros_like(total, dtype=torch.float32)
    cplan = torch.zeros_like(plan)
    n_plan = 0
    syn_in = (torch.arange(10, device=seq.device) >= SYN_LOWER) & (
        torch.arange(10, device=seq.device) <= SYN_UPPER)
    for k, ext, last in _plan_states(pl, ps, pn, L):
        if k == L:
            break
        emit = k < pn
        stop = (k == pn) & (total < L)
        len_lp, syn_lp = ref.bound_logprobs(mem, src, ext, last)
        lmax = len_lp.max(-1).values
        smax = syn_lp.max(-1).values
        le = pl[:, k]
        clamped = (last + le) == (L + 1)
        cls = torch.arange(len_lp.shape[-1], device=seq.device)[None, :]
        cand = torch.where(clamped[:, None], cls >= le[:, None],
                           cls == le[:, None])
        g_len = lmax - len_lp.masked_fill(~cand, -float("inf")).max(-1).values
        g_syn = _gap(syn_lp, ps[:, k].clamp(0, 9))
        g_emit = torch.maximum(g_len, g_syn)
        g_stop = torch.minimum(
            lmax - len_lp[:, 0],
            smax - syn_lp.masked_fill(syn_in[None], -float("inf")).max(
                -1).values)
        g = torch.where(emit, g_emit, torch.where(stop, g_stop, 0.0))
        plan = torch.maximum(plan, g)
        n_plan += int((emit | stop).sum())
        if control is not None:
            c_len, c_syn = control.bound_logprobs(cm[0], cm[1], ext, last)
            cg = torch.maximum(_gap(len_lp, c_len.argmax(-1)),
                               _gap(syn_lp, c_syn.argmax(-1)))
            cplan = torch.maximum(cplan, torch.where(emit | stop, cg, 0.0))

    *_, (_, ext, _) = _plan_states(pl, ps, pn, L)
    syn_seq = ext[:, 1:L + 1]
    live = slot < total[:, None]
    lp = ref.na_fill_logprobs(mem, src, syn_seq, total)
    word = torch.where(live, _gap(lp, seq), 0.0)
    res = {"plan_gap": float(plan.max()), "word_gap": float(word.max()),
           "pad_errors": errors, "tokens": n_plan + int(live.sum())}
    if control is not None:
        clp = control.na_fill_logprobs(cm[0], cm[1], syn_seq, total)
        cword = torch.where(live, _gap(lp, clp.argmax(-1)), 0.0)
        res["ctrl_plan_gap"] = float(cplan.max())
        res["ctrl_word_gap"] = float(cword.max())
    return res


@torch.no_grad()
def ar_gaps(ref: Reference, att, am, out: Dict[str, torch.Tensor],
            control: Optional[Reference] = None) -> Dict[str, float]:
    """``out``: the program's seq [n, L] for the features att, am.  Returns
    word_gap, pad_errors, tokens; with ``control``, ctrl_word_gap."""
    seq = out["seq"].long()
    n, L = seq.shape
    pos = torch.arange(L, device=seq.device)[None, :]
    is_eos = seq == EOS
    first = torch.where(is_eos.any(1), is_eos.float().argmax(1), L)
    live = pos <= first[:, None]
    errors = int(((pos > first[:, None]) & (seq != PAD)).sum())
    mem, src = ref.encode(att, am)
    lp = ref.ar_logprobs(mem, src, seq)
    word = torch.where(live, _gap(lp, seq), 0.0)
    res = {"word_gap": float(word.max()), "pad_errors": errors,
           "tokens": int(live.sum())}
    if control is not None:
        cm, cs = control.encode(att, am)
        clp = control.ar_logprobs(cm, cs, seq)
        res["ctrl_word_gap"] = float(
            torch.where(live, _gap(lp, clp.argmax(-1)), 0.0).max())
    return res



# a leaf whose first reference gradient lies under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The program's first steps against the reference's (each a dict:
    ``loss`` a list, one a step; ``grad1`` and ``change`` {leaf: norm}).

    * ``loss_gap``: the widest |loss - ref| / |ref| over the steps;
    * ``grad_gap``: over the leaves, the widest gap between the norms of
      the first step's clipped gradient, over the reference's norm of that
      leaf or of the median leaf, whichever is larger;
    * ``change_gap``: the same of each leaf's change after the last step,
      leaving out the leaves whose reference gradient is under
      ``STILL_LEAF`` of the median leaf's (``leaves_still`` counts them);
    * ``grad_diff``: over the leaves, the widest norm of the difference
      of the first clipped gradients (``g1``: the tensors), over the same
      norm of the reference's.  A gap of norms is second order in a
      rounding error that varies from element to element, and it does not
      tell float8 products from bfloat16 ones; the difference is first
      order.
    """
    def widest(p, r, names, norms=None):
        norms = r if norms is None else norms
        med = statistics.median(norms[n] for n in names)
        return max(abs(p[n] - r[n]) / max(norms[n], med) for n in names)

    names = list(ref["grad1"])
    g_med = statistics.median(ref["grad1"].values())
    moved = [n for n in names if ref["grad1"][n] >= STILL_LEAF * g_med]
    diff = {n: float((prog["g1"][n].to(ref["g1"][n].device)
                      - ref["g1"][n]).norm()) for n in names}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["loss"], ref["loss"])),
            "grad_gap": widest(prog["grad1"], ref["grad1"], names),
            "change_gap": widest(prog["change"], ref["change"], moved),
            "grad_diff": widest(diff, {n: 0.0 for n in names}, names,
                                ref["grad1"]),
            "leaves_still": len(names) - len(moved)}
