"""Bound-and-fill inference: the port of the JAX package's
``decode/bound_fill.py`` NA path (reference core_NAIC,
captioning/models/TransformerModel.py:1823-1876) and SA path (reference
core_SAIC, :1878-1986).

BOUND: the length/syntax predictor grows the phrase plan one slot per step.
The JAX package runs it as a ``lax.while_loop`` that exits once every
sample is finished; here it is a fixed ``n_steps`` loop of device ops with
per-sample ``finished`` masks and no host sync: a finished sample's step
writes nothing (its emitted length is 0), so the extra steps change no
state and the result equals the early-exit loop's.

FILL: one parallel pass of the NA decoder over the planned words, then the
greedy head.  ``fused_fill=True`` runs the encoder (``fused_encode``), the
fill's decoder stack and the greedy head through the kernel wrappers: on
CUDA tensors the hand-written kernels at every batch size, on CPU tensors
their plain twins.  The encoder and decoder stacks follow the JAX
package's routing (``use_stacked``): one whole-stack launch
(``ops/stack.py``) for bf16 models with a 128-aligned width at B <= 128,
else one launch per layer (``ops/decoder_layer.py``).

SA (``sa_decode``): one predictor step and one decoder pass per phrase.
The fused fill keeps every layer's self-attention K/V of the decoded
positions in a cache and decodes only a window of new positions per round,
through the window kernels of ``ops/stack.py`` (under the same rule: one
launch per round) or ``ops/decoder_layer.py`` (one per layer).  The JAX package decides on the device, per round, between the
narrow window and the wide (W = L) round and whether to go on; here both
decisions read one small device tensor, so a round costs one host sync.

NNAIC (``nnaic_decode``): one whole-caption length, then the same
parallel fill through the A decoder stack and the greedy head.

UIC_s / UIC_u AR (``uic_s_ar_decode``): the bounding plan, then the
KV-cached AR step of ``decode/ar.py`` with the plan's syn ids, writing
words only inside the planned length.

Known reference defect NOT replicated: core_NAIC builds the fill mask from
``last[j]`` of the final loop iteration for every row
(TransformerModel.py:1872-1874 uses ``last[j]`` inside ``for i in
range(B)``), i.e. every sample gets the LAST sample's plan length.  Each
sample's own ``last[i]`` is used here, as the training mask does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import obs
from ..constants import BOS, LEN, PAD, SYN_LOWER, SYN_UPPER
from ..models.boficap import BoFiCap
from ..ops.decoder_layer import (fused_decoder_forward, fused_encoder_forward,
                                 fused_greedy_head,
                                 fused_window_decoder_forward,
                                 project_cross_kv)
from ..ops.stack import (fused_decoder_stack_forward,
                         fused_encoder_stack_forward,
                         fused_window_decoder_stack, fused_window_wide_stack)
from .sampling import sample_next_word


# sa_decode's narrow round: window positions a round
SA_WINDOW = 8
# The greedy head kernel (#3) runs on every greedy fill.  The JAX package
# gates it at 256 rows (B * L), a threshold tuned on a v5e (its
# decode/bound_fill.py:131).  On an H100 at 700 W #3 was the faster at
# every count from 20 to 1280 rows at both dtypes, a call's host launches
# included (chip_smoke.py phase times, ``head_gate``, which fails should
# the crossover ever come out above 0; PERF.md section 6), so the port
# has no gate.


def use_stacked(model, batch: int) -> bool:
    """The JAX package's routing rule (``_use_stacked`` without its
    interpret-mode term): the whole-stack kernels for bf16 models with a
    128-aligned width at B <= 128, the per-layer kernels otherwise."""
    return (model.dtype == torch.bfloat16 and model.d_model % 128 == 0
            and batch <= 128)


@torch.no_grad()
def fused_encode(model, att_feats, att_masks,
                 stacked: Optional[bool] = None):
    """``model.encode`` with the encoder stack on the kernel wrappers
    (inference only, so under ``no_grad``); att_embed stays plain.  ``stacked``: the whole-stack
    kernel (True) or one launch per layer (False); None follows
    ``use_stacked``.  A model without an encoder stack (an LSTM
    captioner) runs its own ``encode``, whose attentions take the
    attention core under ``use_pallas``."""
    if not isinstance(model, BoFiCap):
        return model.encode(att_feats, att_masks)
    x = model.embed_att(att_feats)
    src_mask = None if att_masks is None else att_masks.bool()
    pack = model.packed_encoder()
    if stacked is None:
        stacked = use_stacked(model, att_feats.shape[0])
    if stacked:
        return fused_encoder_stack_forward(x, src_mask, pack.stack,
                                           pack.final_norm, model.num_heads)
    return fused_encoder_forward(x, src_mask, pack.layers, pack.final_norm,
                                 model.num_heads)


def _fused_parallel_fill(model, x, memory, src_mask, mask3, keep, *,
                         role: str, sample_method: str,
                         stacked: Optional[bool]):
    """The fill's decoder stack on the kernel wrappers (``stacked`` as in
    ``fused_encode``), then the greedy head (ids, token logprob, entropy;
    rows where ``keep`` is False take seq = PAD and lp[:, PAD]).  Returns
    ((seq, tok, ent), None) for greedy, else (None, h), the decoder's
    output, for the caller's generator and sampling."""
    with obs.span("bfc.na.fill"):
        pack = model.packed_decoder(role)
        if stacked is None:
            stacked = use_stacked(model, x.shape[0])
        if stacked:
            h = fused_decoder_stack_forward(x, memory, mask3, src_mask,
                                            pack.stack, pack.final_norm,
                                            model.num_heads)
        else:
            h = fused_decoder_forward(x, memory, mask3, src_mask,
                                      pack.layers, pack.final_norm,
                                      model.num_heads)
    if sample_method == "greedy":
        with obs.span("bfc.na.head"):
            ids, tok_a, ent, lp_pad = fused_greedy_head(
                h, *model.packed_head(), pad_id=PAD)
            seq = torch.where(keep, ids, PAD)
            tok = torch.where(keep, tok_a, lp_pad)
        return (seq, tok, ent), None
    return None, h


def _bound_update(s: Dict[str, torch.Tensor], len_N, syn_N, L: int,
                  slot: int, last_key: str = "last"):
    """Bounding bookkeeping (reference core_NAIC :1843-1867 / core_SAIC
    :1915-1930): stop, clamp, record the new phrase slot; ``last_key``
    names the state's next free label position ("phrase_last" for SA).
    Updates ``s`` in place (phrase tensors, phrase_num, finished); returns
    len_eff [B]."""
    last = s[last_key]
    stop = (len_N == 0) | (syn_N < SYN_LOWER) | (syn_N > SYN_UPPER)
    emit = (~s["finished"]) & (~stop)
    clamp = (len_N + last) >= (L + 1)
    len_eff = torch.where(clamp, L + 1 - last, len_N)
    len_eff = torch.where(emit, len_eff, 0)
    s["phrase_length"][:, slot] = len_eff
    s["phrase_syn"][:, slot] = torch.where(emit, syn_N, PAD)
    s["phrase_num"] = s["phrase_num"] + emit.long()
    s["finished"] = s["finished"] | stop | (emit & clamp)
    return len_eff


def bound_plan(model, memory, src_mask, n_steps: int, L: int
               ) -> Dict[str, torch.Tensor]:
    """The bounding loop alone: grow the syn plan from [LEN] with the
    syn-input predictor for ``n_steps`` steps.

    Returns extend_syn [B, L+2], last [B], phrase_length / phrase_syn
    [B, L+2], phrase_num [B], finished [B] (int64 / bool)."""
    L2 = L + 2
    B = memory.shape[0]
    dev = memory.device
    if model.N_len == 1:
        # loop invariants hoisted (BoFiCap.bound_cache)
        cache = model.bound_cache(memory)

        def step(ids, prefix):
            return model.bound_step_cached(cache, ids, prefix, src_mask)
    else:
        def step(ids, prefix):
            return model.bound_step(ids, prefix, memory, src_mask, True)

    extend_syn = torch.full((B, L2), PAD, dtype=torch.long, device=dev)
    extend_syn[:, 0] = LEN
    s = {
        "last": torch.ones(B, dtype=torch.long, device=dev),
        "finished": torch.zeros(B, dtype=torch.bool, device=dev),
        "phrase_length": torch.zeros((B, L2), dtype=torch.long, device=dev),
        "phrase_syn": torch.full((B, L2), PAD, dtype=torch.long, device=dev),
        "phrase_num": torch.zeros(B, dtype=torch.long, device=dev),
    }
    pos = torch.arange(L2, device=dev)[None, :]
    for i in range(n_steps):
        len_lp, syn_lp = step(extend_syn, s["last"])
        len_N = torch.argmax(len_lp, dim=-1)
        syn_N = torch.argmax(syn_lp, dim=-1)
        len_eff = _bound_update(s, len_N, syn_N, L, i)
        last = s["last"]
        w = (pos >= last[:, None]) & (pos < (last + len_eff)[:, None])
        extend_syn = torch.where(w, syn_N[:, None], extend_syn)
        s["last"] = last + len_eff
    s["extend_syn"] = extend_syn
    return s


@torch.no_grad()
def na_decode(model, memory, src_mask, *, sample_method: str = "greedy",
              temperature: float = 1.0, max_steps: Optional[int] = None,
              fused_fill: bool = False, stacked: Optional[bool] = None,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Bound (length/syn loop) then fill (one parallel decode).  With
    ``fused_fill``, ``stacked`` picks the fill's decoder kernels as in
    ``fused_encode``.

    Returns {'seq', 'tok_logprobs', 'entropy', 'phrase_num',
    'phrase_length', 'phrase_syn'}: [B, L] each except phrase_num [B] — the
    reference's NAIC sample contract with the dense [B, L, V] log-probs
    reduced to the per-position quantities eval uses."""
    L = model.max_length
    B = memory.shape[0]
    dev = memory.device
    n_steps = L if max_steps is None else min(max_steps, L)
    with obs.span("bfc.na.bound"):
        s = bound_plan(model, memory, src_mask, n_steps, L)

    total = s["last"] - 1                                         # [B]
    ar = torch.arange(L, device=dev)
    na_mask = (ar[None, None, :] < total[:, None, None]).expand(B, L, L)
    keep = ar[None, :] < total[:, None]
    syn_seq = s["extend_syn"][:, 1:-1]
    plan = {"phrase_num": s["phrase_num"],
            "phrase_length": s["phrase_length"][:, :L],
            "phrase_syn": s["phrase_syn"][:, :L]}

    if fused_fill:
        x = model.na_inputs(syn_seq)
        head, h = _fused_parallel_fill(
            model, x, memory, src_mask, na_mask, keep, role="NA",
            sample_method=sample_method, stacked=stacked)
        if head is not None:
            seq, tok, ent = head
            return {"seq": seq, "tok_logprobs": tok, "entropy": ent, **plan}
    else:
        with obs.span("bfc.na.fill"):
            h = model.decode_na(syn_seq, memory, src_mask, na_mask)
    with obs.span("bfc.na.head"):
        logprob = model.generate(h)
        ids, _ = sample_next_word(logprob, sample_method, temperature,
                                  generator)
        seq = torch.where(keep, ids, PAD)
        # no position mask: the reference's NAIC seqLogprobs is the raw
        # parallel fill tensor, so entropy / token logprob include the tail
        # rows
        tok, ent = _tok_entropy(logprob, seq)
    return {"seq": seq, "tok_logprobs": tok, "entropy": ent, **plan}


@torch.no_grad()
def nnaic_decode(model, memory, src_mask, *, sample_method: str = "greedy",
                 temperature: float = 1.0, fused_fill: bool = False,
                 stacked: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
    """Naive NA decode (reference core_NNAIC, TransformerModel.py:
    1806-1822): one whole-caption length (``nnaic_length``), then one
    parallel pass of the A decoder over BOS inputs, its keys masked to the
    predicted length.  A length of 0 masks every key: each row's attention
    is then the uniform softmax over all L keys.  With ``fused_fill`` the
    pass runs on the decoder kernels and the greedy head (``stacked`` as in
    ``fused_encode``).

    Returns {'seq', 'tok_logprobs', 'entropy'} [B, L] and 'length' [B]:
    seq is PAD past the length, where tok_logprobs holds lp[:, PAD] and
    entropy the row's (the dense tensor's tail rows, as the reference's
    seqLogprobs keeps them)."""
    L = model.max_length
    B = memory.shape[0]
    length = model.nnaic_length(memory)
    tgt = torch.full((B, L), BOS, dtype=torch.long, device=memory.device)
    keep = torch.arange(L, device=memory.device)[None, :] < length[:, None]
    if fused_fill:
        x = model.posenc(model.word_embed(tgt))
        head, h = _fused_parallel_fill(
            model, x, memory, src_mask, keep[:, None, :].expand(B, L, L),
            keep, role="A", sample_method=sample_method, stacked=stacked)
        if head is not None:
            seq, tok, ent = head
            return {"seq": seq, "tok_logprobs": tok, "entropy": ent,
                    "length": length}
        logprob = model.generate(h)
    else:
        logprob = model.generate(model.decode_a(tgt, memory, src_mask,
                                                keep[:, None, :]))
    ids, _ = sample_next_word(logprob, sample_method, temperature, generator)
    seq = torch.where(keep, ids, PAD)
    tok, ent = _tok_entropy(logprob, seq)
    return {"seq": seq, "tok_logprobs": tok, "entropy": ent,
            "length": length}


def _tok_entropy(logprob, seq, mask=None):
    """Dense [..., V] log-probs -> chosen-token logprob and entropy [...].
    ``mask`` (bool) zeroes positions, reproducing loops that stored zero
    logprob rows there; None keeps every row, reproducing the single-pass
    fills whose dense tensor had live tail rows."""
    tok = torch.gather(logprob, -1, seq[..., None])[..., 0]
    ent = -(torch.exp(logprob) * logprob).sum(-1)
    if mask is not None:
        tok = torch.where(mask, tok, 0.0)
        ent = torch.where(mask, ent, 0.0)
    return tok, ent


def _copy_phrase(seq, seq_last, prev, cur, phrase_last, L2: int):
    """Closed-form copy-from-previous-phrase for one new slot (reference
    core_SAIC :1934-1947).  Returns (values [B, L2], in_phrase [B, L2]):
    values holds the copied words at [phrase_last, phrase_last + cur)."""
    pos = torch.arange(L2, device=seq.device)[None, :]
    o = pos - phrase_last[:, None]
    in_ph = (o >= 0) & (o < cur[:, None])
    prev_ = prev[:, None]
    cur_ = cur[:, None]
    prev_safe = prev_.clamp_min(1)
    ct = cur_ // prev_safe
    pre_less = prev_ - cur_ % prev_safe
    src_short = seq_last[:, None] + (prev_ - cur_) + o
    ct_safe = ct.clamp_min(1)
    k_src = torch.where(o < pre_less * ct, o // ct_safe,
                        pre_less + (o - pre_less * ct) // (ct_safe + 1))
    src = torch.where(cur_ <= prev_, src_short, seq_last[:, None] + k_src)
    src = torch.where(in_ph, src, 0).clamp(0, L2 - 1)
    return torch.gather(seq, 1, src), in_ph


@torch.no_grad()
def sa_decode(model, memory, src_mask, *, sample_method: str = "greedy",
              temperature: float = 1.0, max_steps: Optional[int] = None,
              predictor_use_syn: bool = False, fused_fill: bool = False,
              stacked: Optional[bool] = None, window: int = SA_WINDOW,
              generator: Optional[torch.Generator] = None,
              stats: Optional[Dict[str, int]] = None
              ) -> Dict[str, torch.Tensor]:
    """Semi-autoregressive decode: one predictor step and one decoder pass
    per PHRASE (reference core_SAIC, TransformerModel.py:1878-1986).

    ``predictor_use_syn``: the UIC_s / UIC_u variant (core_UIC_s_SAIC
    :2203-2311) feeds the length predictor the syn plan instead of the
    decoded words.

    ``fused_fill``: the K/V-cached windowed fill on the window kernels, with
    the greedy head on its kernel.  ``stacked`` picks the whole-stack
    kernels (True) or the per-layer one (False); None follows
    ``use_stacked``.  ``window``: width of the narrow round; a round whose
    new phrase is longer runs the wide (W = L) round instead, and
    ``window >= max_length`` runs every round wide.

    ``stats``, if given, receives the round counts: 'rounds', 'narrow',
    'wide' and 'host_syncs'.

    Returns {'seq', 'tok_logprobs', 'entropy', 'phrase_num',
    'phrase_length', 'phrase_syn'}: [B, L] each except phrase_num [B]."""
    L = model.max_length
    L2 = L + 2
    B = memory.shape[0]
    dev = memory.device
    n_steps = L if max_steps is None else min(max_steps, L)
    pos_dec = torch.arange(L, device=dev)[None, :]
    if model.N_len == 1:
        # loop invariants hoisted (BoFiCap.bound_cache)
        bcache = model.bound_cache(memory, predictor_use_syn)

        def predict(ids, prefix):
            return model.bound_step_cached(bcache, ids, prefix, src_mask,
                                           use_syn=predictor_use_syn)
    else:
        def predict(ids, prefix):
            return model.bound_step(ids, prefix, memory, src_mask,
                                    predictor_use_syn)

    def frame(first=PAD):
        t = torch.full((B, L2), PAD, dtype=torch.long, device=dev)
        t[:, 0] = first
        return t

    s = {
        "seq": frame(BOS), "extend_len": frame(LEN),
        "extend_word": frame(PAD), "extend_syn": frame(LEN),
        "vis_dec": torch.zeros((B, L), dtype=torch.long, device=dev),
        "phrase_last": torch.ones(B, dtype=torch.long, device=dev),
        "seq_last": torch.zeros(B, dtype=torch.long, device=dev),
        "prev_len": torch.ones(B, dtype=torch.long, device=dev),
        "phrase_length": torch.zeros((B, L2), dtype=torch.long, device=dev),
        "phrase_syn": frame(PAD),
        "phrase_num": torch.zeros(B, dtype=torch.long, device=dev),
        "finished": torch.zeros(B, dtype=torch.bool, device=dev),
        "tok_lp": torch.zeros((B, L), dtype=torch.float32, device=dev),
        "ent": torch.zeros((B, L), dtype=torch.float32, device=dev),
    }
    s["phrase_length"][:, 0] = 1
    if fused_fill:
        # the cross-attention K/V do not change across rounds: project them
        # once; the self-attention K/V of decoded positions never change
        # either (blockwise finality), so each layer keeps them in a cache
        pack = model.packed_window("SA")
        if stacked is None:
            stacked = use_stacked(model, B)
        k2s, v2s = project_cross_kv(pack.wkv2, pack.bkv2, memory)
        src_b = (torch.ones(memory.shape[:2], dtype=torch.bool, device=dev)
                 if src_mask is None else src_mask.bool()).contiguous()
        n_layers = len(pack.layers)
        s["kc"] = torch.zeros((n_layers, B, L, memory.shape[-1]),
                              dtype=model.dtype, device=dev)
        s["vc"] = torch.zeros_like(s["kc"])
        w_small = min(window, L)
        key_pos = torch.arange(L, device=dev)[None, None, :]
    counts = {"rounds": 0, "narrow": 0, "wide": 0, "host_syncs": 0}

    for i in range(1, n_steps + 1):
        pred_ids = s["extend_syn"] if predictor_use_syn else s["extend_len"]
        len_lp, syn_lp = predict(pred_ids, s["phrase_last"])
        len_N = torch.argmax(len_lp, dim=-1)
        syn_N = torch.argmax(syn_lp, dim=-1)
        len_eff = _bound_update(s, len_N, syn_N, L, i, "phrase_last")
        emit = len_eff > 0

        # copy-init the new slot's decoder input from the previous phrase
        vals, in_ph = _copy_phrase(s["seq"], s["seq_last"], s["prev_len"],
                                   len_eff, s["phrase_last"], L2)
        extend_word = torch.where(in_ph, vals, s["extend_word"])
        extend_syn = torch.where(in_ph, syn_N[:, None], s["extend_syn"])

        # blockwise mask: rows >= the current start see keys < its end
        start_dec = s["phrase_last"] - 1
        end_dec = start_dec + len_eff
        vis_dec = torch.where(emit[:, None] & (pos_dec >= start_dec[:, None]),
                              end_dec[:, None], s["vis_dec"])
        tgt_mask = pos_dec[:, None, :] < vis_dec[:, :, None]      # [B, L, L]

        # the round's one host sync: the new phrase's longest length (picks
        # the window) and whether every sample has finished (ends the loop)
        longest, done = torch.stack([len_eff.max(),
                                     s["finished"].all().long()]).tolist()
        counts["host_syncs"] += 1
        counts["rounds"] += 1

        if fused_fill:
            W = w_small if w_small < L and longest <= w_small else L
            counts["wide" if W == L else "narrow"] += 1
            idx = None
            if W == L:
                x_win = model._mix_inputs(extend_word[:, 1:-1],
                                          extend_syn[:, 1:-1], "sa")
                if stacked:
                    h, s["kc"], s["vc"] = fused_window_wide_stack(
                        x_win, k2s, v2s, tgt_mask, src_b, pack.stack,
                        pack.final_norm, model.num_heads)
                else:
                    # every cache column masked; the window covers the frame
                    m = torch.cat([torch.zeros_like(tgt_mask), tgt_mask], -1)
                    h, s["kc"], s["vc"] = fused_window_decoder_forward(
                        x_win, torch.zeros(B, dtype=torch.int32, device=dev),
                        s["kc"], s["vc"], k2s, v2s, m, src_b, pack.layers,
                        pack.final_norm, model.num_heads)
            else:
                w_start = start_dec.clamp(0, L - W)
                idx = w_start[:, None] + torch.arange(W, device=dev)[None, :]
                x_win = model.mix_inputs_window(
                    torch.gather(extend_word[:, 1:-1], 1, idx),
                    torch.gather(extend_syn[:, 1:-1], 1, idx), idx, "sa")
                vis = torch.gather(vis_dec, 1, idx)[:, :, None]   # [B, W, 1]
                # keys = cache columns ++ window columns: the cache's copies
                # of in-window positions are stale, so they are masked and
                # the window columns carry those positions
                in_win = ((key_pos >= w_start[:, None, None])
                          & (key_pos < (w_start + W)[:, None, None]))
                m = torch.cat([(key_pos < vis) & ~in_win,
                               idx[:, None, :] < vis], -1)
                ws = w_start.to(torch.int32)
                fill = (fused_window_decoder_stack if stacked
                        else fused_window_decoder_forward)
                h, s["kc"], s["vc"] = fill(
                    x_win, ws, s["kc"], s["vc"], k2s, v2s, m, src_b,
                    pack.stack if stacked else pack.layers, pack.final_norm,
                    model.num_heads)
            if sample_method == "greedy":
                ids, tok_r, ent_r, _ = fused_greedy_head(
                    h, *model.packed_head(), pad_id=PAD)
            else:
                lp = model.generate(h)
                ids, _ = sample_next_word(lp, sample_method, temperature,
                                          generator)
                tok_r, ent_r = _tok_entropy(lp, ids)
            if idx is not None:
                # window rows back to the decoder frame (rows outside the
                # window stay 0 and are masked by in_dec below)
                ids = torch.zeros((B, L), dtype=ids.dtype,
                                  device=dev).scatter(1, idx, ids)
                tok_r = torch.zeros((B, L), device=dev).scatter(1, idx, tok_r)
                ent_r = torch.zeros((B, L), device=dev).scatter(1, idx, ent_r)
        else:
            h = model.decode_sa(extend_word[:, 1:-1], extend_syn[:, 1:-1],
                                memory, src_mask, tgt_mask)
            logprob = model.generate(h)                            # [B, L, V]
            ids, _ = sample_next_word(logprob, sample_method, temperature,
                                      generator)
            tok_r, ent_r = _tok_entropy(logprob, ids)
        ids_lab = torch.nn.functional.pad(ids, (1, 1))           # shift +1

        in_dec = (emit[:, None] & (pos_dec >= start_dec[:, None])
                  & (pos_dec < end_dec[:, None]))
        s["seq"] = torch.where(in_ph, ids_lab, s["seq"])
        s["extend_len"] = torch.where(in_ph, ids_lab, s["extend_len"])
        s["tok_lp"] = torch.where(in_dec, tok_r, s["tok_lp"])
        s["ent"] = torch.where(in_dec, ent_r, s["ent"])
        s["extend_word"], s["extend_syn"] = extend_word, extend_syn
        s["vis_dec"] = vis_dec
        s["seq_last"] = s["seq_last"] + torch.where(emit, s["prev_len"], 0)
        s["phrase_last"] = s["phrase_last"] + len_eff
        s["prev_len"] = torch.where(emit, len_eff, s["prev_len"])
        if done:
            break
    if stats is not None:
        stats.update(counts)
    return {"seq": s["seq"][:, 1:-1], "tok_logprobs": s["tok_lp"],
            "entropy": s["ent"], "phrase_num": s["phrase_num"],
            "phrase_length": s["phrase_length"][:, 1:-1],
            "phrase_syn": s["phrase_syn"][:, 1:-1]}


@torch.no_grad()
def uic_s_ar_decode(model, memory, src_mask, *, sample_method: str = "greedy",
                    temperature: float = 1.0, max_steps: Optional[int] = None,
                    ar_max_steps: Optional[int] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """UIC_s / UIC_u autoregressive branch (reference core_UIC_s_AIC,
    TransformerModel.py:2313-2391): bound the syn plan with the shared
    predictor, then decode autoregressively with word + syn embeddings,
    writing words only inside the planned length.  The plan is argmax, as
    in the JAX package; only the words follow ``sample_method`` (a sampled
    one draws from ``generator``).

    The AR phase is the KV-cached ``ar_step`` with the per-position syn id
    from the plan, for a fixed ``ar_max_steps`` (default L) with no host
    sync: a step past every row's plan writes PAD and zeros, so the result
    equals the JAX package's while-loop, which stops there.

    Returns {'seq', 'tok_logprobs', 'entropy', 'phrase_num',
    'phrase_length', 'phrase_syn'}: [B, L] each except phrase_num [B]."""
    L = model.max_length
    B = memory.shape[0]
    dev = memory.device
    n_bound = L if max_steps is None else min(max_steps, L)
    plan = bound_plan(model, memory, src_mask, n_bound, L)
    extend_syn = plan["extend_syn"]
    last = plan["last"]                                  # 1 + total words
    n_ar = L if ar_max_steps is None else min(ar_max_steps, L)
    cache = model.init_ar_cache(memory, L + 1)
    it = torch.full((B,), BOS, dtype=torch.long, device=dev)
    seq = torch.full((B, L), PAD, dtype=torch.long, device=dev)
    tok_lp = torch.zeros((B, L), dtype=torch.float32, device=dev)
    ent_lp = torch.zeros((B, L), dtype=torch.float32, device=dev)
    for pos in range(n_ar):
        # the syn id of the CURRENT input token's label slot pos + 1
        # (reference decode_A input extend_phrase_syn[:, 1:i+2], :2374)
        logprob, cache = model.ar_step(it, pos, cache, src_mask,
                                       syn_t=extend_syn[:, pos + 1])
        ids, _ = sample_next_word(logprob, sample_method, temperature,
                                  generator)
        write = (pos + 1) < last                          # reference :2385
        ids = torch.where(write, ids, PAD)
        seq[:, pos] = ids
        tok_lp[:, pos], ent_lp[:, pos] = _tok_entropy(logprob, ids, write)
        it = ids
    return {"seq": seq, "tok_logprobs": tok_lp, "entropy": ent_lp,
            "phrase_num": plan["phrase_num"],
            "phrase_length": plan["phrase_length"][:, :L],
            "phrase_syn": plan["phrase_syn"][:, :L]}


def _ss_coins(step: int, B: int, ss_prob: float, rng: torch.Generator,
              device):
    """``ss_sa_loop``'s two draws at phrase step ``step``, from ``rng`` in
    this order: each sample's coin for the model's plan over the gt plan
    (``ss_prob``), then its fair coin for the bos-only input.  Returns
    (use_model, bos_input), bool [B] each.  A module-level function so that
    a check can give the loop fixed coins (the JAX package's loop draws
    from ``jax.random``, which no torch generator reproduces)."""
    use_model = torch.rand(B, generator=rng, device=device) < ss_prob
    bos_input = torch.rand(B, generator=rng, device=device) < 0.5
    return use_model, bos_input


@torch.no_grad()
def ss_sa_loop(model, memory, src_mask, labels, phrase_length, phrase_syn,
               ss_prob: float, rng: torch.Generator,
               sample_method: str = "greedy", temperature: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    """Scheduled-sampling SA loop (reference ss_SAIC,
    TransformerModel.py:1988-2121), the no-grad sampling phase of the
    JAX package's ``ss_sa_loop``.

    Each phrase step, each sample flips a coin (``ss_prob``, from ``rng``
    by ``_ss_coins``) for the model's plan over the gt plan; a second fair
    coin picks copy-from-sampled-words or bos-only decoder input for the
    model branch; the gt branch copies the gt labels with the gt plan.  Words
    always come from the SA decoder through ``sample_next_word``.  Returns
    the assembled decoder inputs and the plan, from which the training
    step re-scores every step's log-probs in one differentiable pass.  The
    loop ends when every sample is finished (one host sync a step).
    labels / phrase_length / phrase_syn: [B, L2] framed gt rows."""
    B, L2 = labels.shape
    L = L2 - 2
    dev = labels.device
    pos_dec = torch.arange(L, device=dev)[None, :]
    bcache = model.bound_cache(memory, False) if model.N_len == 1 else None
    i32 = dict(dtype=labels.dtype, device=dev)

    def full(v, col0=None):
        t = torch.full((B, L2), v, **i32)
        if col0 is not None:
            t[:, 0] = col0
        return t

    seq, extend_len = full(PAD, BOS), full(PAD, LEN)
    extend_word, extend_syn = full(PAD), full(PAD, LEN)
    plan_len, plan_syn = full(0, 1), full(PAD)
    vis_dec = torch.zeros((B, L), **i32)
    phrase_last = torch.ones(B, **i32)
    seq_last = torch.zeros(B, **i32)
    label_last = torch.zeros(B, **i32)
    prev_len = torch.ones(B, **i32)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(1, L2 - 1):
        if bool(finished.all()):
            break
        if bcache is not None:
            len_lp, syn_lp = model.bound_step_cached(
                bcache, extend_len, phrase_last, src_mask, use_syn=False)
        else:
            len_lp, syn_lp = model.bound_step(extend_len, phrase_last, memory,
                                              src_mask, False)
        len_N = torch.argmax(len_lp, -1).to(labels.dtype)
        syn_N = torch.argmax(syn_lp, -1).to(labels.dtype)
        gt_len_i, gt_syn_i = phrase_length[:, i], phrase_syn[:, i]
        stop = ((len_N == 0) | (syn_N < SYN_LOWER) | (syn_N > SYN_UPPER)
                | (gt_len_i == 0))                         # reference :2029
        emit = ~finished & ~stop
        cap = (L2 - 1) - phrase_last
        pred_len = torch.minimum(len_N, cap)
        clamp = (len_N + phrase_last) >= (L2 - 1)
        use_model, bos_input = _ss_coins(i, B, ss_prob, rng, dev)
        # the gt branch clamps the gt length too (reference :2076)
        len_eff = torch.where(use_model, pred_len,
                              torch.minimum(gt_len_i, cap))
        len_eff = torch.where(emit, len_eff, 0)
        syn_eff = torch.where(use_model, syn_N, gt_syn_i)
        plan_len[:, i] = len_eff
        plan_syn[:, i] = torch.where(emit, syn_eff, PAD)
        # a clamped sample ends on the MODEL's length, before the coin
        # picks its input branch (reference :2033-2038)
        finished = finished | stop | (emit & clamp)

        prev_gt = phrase_length[:, max(i - 1, 0)]
        vals_model, in_ph = _copy_phrase(seq, seq_last, prev_len, len_eff,
                                         phrase_last, L2)
        vals_gt, _ = _copy_phrase(labels, label_last, prev_gt, len_eff,
                                  phrase_last, L2)
        vals = torch.where(use_model[:, None],
                           torch.where(bos_input[:, None], BOS, vals_model),
                           vals_gt)
        extend_word = torch.where(in_ph, vals, extend_word)
        extend_syn = torch.where(in_ph, syn_eff[:, None], extend_syn)
        start_dec = phrase_last - 1
        vis_dec = torch.where((len_eff > 0)[:, None]
                              & (pos_dec >= start_dec[:, None]),
                              (start_dec + len_eff)[:, None], vis_dec)
        tgt_mask = pos_dec[:, None, :] < vis_dec[:, :, None]
        logprob = model.generate(model.decode_sa(
            extend_word[:, 1:-1], extend_syn[:, 1:-1], memory, src_mask,
            tgt_mask))
        ids, _ = sample_next_word(logprob, sample_method, temperature, rng)
        ids_lab = torch.nn.functional.pad(ids.to(labels.dtype), (1, 1))
        seq = torch.where(in_ph, ids_lab, seq)
        extend_len = torch.where(in_ph, ids_lab, extend_len)
        grew = len_eff > 0
        seq_last = seq_last + torch.where(grew, prev_len, 0)
        label_last = label_last + torch.where(grew, prev_gt, 0)
        phrase_last = phrase_last + len_eff
        prev_len = torch.where(grew, len_eff, prev_len)
    return {"extend_word": extend_word, "extend_syn": extend_syn,
            "extend_len": extend_len, "plan_len": plan_len,
            "plan_syn": plan_syn, "vis_dec": vis_dec, "seq": seq}
