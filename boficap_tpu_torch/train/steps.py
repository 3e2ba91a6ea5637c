"""Training steps: the port of the JAX package's ``train/steps.py``
(parity with the reference LossWrapper, captioning/modules/loss_wrapper.py,
and the step body of tools/train.py:198-229).

XE: one step is the teacher-forced forward of the model's train_mode
(``BoFiCap.forward``; for PB_pad the length predictor and the packed
decode over the batch's host-built layouts, the ``pb_*`` arrays of the
loader's batch), its loss (``losses.py``), the gradients by autograd
and one optimizer update (``train/optim.py``), plain PyTorch: no TPU
kernel has a backward pass, and the kernel wrappers refuse tensors that
require grad.  After the update the model's packed kernel weights are
dropped (``BoFiCap.invalidate_packed``), so the next decode on the kernels
packs the new weights.  Dropout and GLAT draw from one ``torch.Generator``
on the model's device; ``rng=None`` is the deterministic pass of the eval
loss.

RL (the structure-loss stage, and classic SCST for AIC) is three phases,
the reference's own device-host dance (loss_wrapper.py:194-220 ->
rewards.py:86-117):

  1. ``make_rl_sample``: a decode under ``no_grad`` of the SA and / or NA
     branches (the AR sample and a greedy baseline for AIC) on the kernel
     wrappers: the encoder stack (#4 or #1), the NA fill (#5 or #2) and
     the SA rounds (#6, #7 or #8), with the plain generator, since a
     sampled fill needs the dense log-probs; #9 under ``use_pallas``;
  2. ``rl_host_scores``: one copy of the sampled ids to the host, then the
     CIDEr-D (+ BLEU) scores there (``rewards/``, the native scorer);
  3. ``make_rl_step`` / ``make_scst_step``: a differentiable re-score of
     the sampled captions by the teacher-forced forward (``rl_rescore``,
     plain autograd, no kernel), which gives the sampling pass's values
     because the blockwise and causal masks make each position depend only
     on already final inputs, then the loss (``rl_loss_fn``,
     ``scst_loss_fn``) and one update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import losses as Lm
from ..constants import BOS, EOS, PAD
from ..data import phrase_ops as po
from ..decode import ar as ar_mod
from ..decode import bound_fill as bf
from ..models.layers import causal_mask
from ..rewards import (get_scores, get_self_cider_scores,
                       get_self_critical_reward)
from ..rewards.self_critical import _gts_dict, _native_ids, pack_refs

PHRASE_MODES = ("NAIC", "SAIC", "UIC", "UIC_ds", "UIC_s", "UIC_u")
LABEL_KEYS = ("labels", "masks", "phrase_num", "phrase_length", "phrase_syn")
# PB_pad's packed layouts (data/pb_pack.py), one row a caption
PB_KEYS = ("pb_labels", "pb_word_mask", "pb_ids", "pb_slot", "pb_mask")


def _flat(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """[B, S, ...] -> [B*S, ...] views of the label-side tensors."""
    return {k: batch[k].reshape((-1,) + tuple(batch[k].shape[2:]))
            for k in LABEL_KEYS if batch.get(k) is not None}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader batch's arrays as tensors on ``device`` (integers int64,
    features float32, PB_pad's packed mask bool); other entries (infos,
    gts, bounds) are left out."""
    out = {}
    for k in ("att_feats", "att_masks") + LABEL_KEYS + PB_KEYS:
        v = batch.get(k)
        if v is None:
            continue
        t = torch.as_tensor(np.asarray(v))
        if t.dtype != torch.bool:
            t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


def ss_sa_forward(model, rng, att, am, labels, phrase_length, phrase_syn,
                  ss_prob: float):
    """Scheduled-sampling SA branch (reference ss path,
    TransformerModel.py:1759-1767 -> ss_SAIC :1988-2121): the mixed
    gt/model per-phrase loop without gradient (``ss_sa_loop``), then the
    assembled inputs re-scored differentiably: one ``decode_sa`` pass for
    the word log-probs and one ``bound_teacher`` pass for the per-step
    (len, syn) log-probs.  Returns (len, syn, word log-probs, memory,
    src_mask), the memory repeated to the caption rows."""
    L = model.max_length
    memory = model.encode(att, am, rng)
    src_mask = am.bool()
    if labels.shape[0] != memory.shape[0]:
        k = labels.shape[0] // memory.shape[0]
        memory = memory.repeat_interleave(k, dim=0)
        src_mask = src_mask.repeat_interleave(k, dim=0)
    loop = bf.ss_sa_loop(model, memory.detach(), src_mask, labels,
                         phrase_length, phrase_syn, ss_prob, rng)
    pos = torch.arange(L, device=labels.device)
    tgt_mask = pos[None, None, :] < loop["vis_dec"][:, :, None]
    word_lp = model.generate(model.decode_sa(
        loop["extend_word"][:, 1:-1], loop["extend_syn"][:, 1:-1], memory,
        src_mask, tgt_mask, rng))
    len_lp, syn_lp = model.bound_teacher(loop["extend_len"],
                                         loop["plan_len"], memory, src_mask,
                                         False, rng)
    return len_lp, syn_lp, word_lp, memory, src_mask


def pb_loss(model, batch, f, rng, reduction: str):
    """PB_pad's XE loss (JAX ``xe_loss_fn``'s PB branch): the memory
    repeated to the caption rows, the per-slot length log-probs, the
    packed decode over the batch's host-built layout, and
    ``losses.pb_pad_loss``.  Returns (loss, metrics)."""
    memory = model.encode(batch["att_feats"], batch["att_masks"], rng)
    src_mask = batch["att_masks"].bool()
    labels = f["labels"]
    if labels.shape[0] != memory.shape[0]:
        k = labels.shape[0] // memory.shape[0]
        memory = memory.repeat_interleave(k, dim=0)
        src_mask = src_mask.repeat_interleave(k, dim=0)
    len_lp = model.pb_length_predict(labels, f["phrase_num"],
                                     f["phrase_length"], memory, src_mask,
                                     rng)
    word_lp = model.pb_decode(batch["pb_ids"], batch["pb_slot"], labels,
                              f["phrase_length"], memory, src_mask,
                              batch["pb_mask"], rng)
    d = Lm.pb_pad_loss(batch["pb_labels"][:, 1:], word_lp,
                       batch["pb_word_mask"][:, 1:], f["phrase_num"],
                       f["phrase_length"][:, 1:], len_lp, reduction)
    return d.pop("loss"), d


def xe_loss_fn(model, batch: Dict[str, torch.Tensor],
               rng: Optional[torch.Generator], glat_p: Optional[float] = None,
               drop_worst_rate: float = 0.0, label_smoothing: float = 0.0,
               ss_prob: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy stage loss of every train_mode the model's forward
    takes (the LossWrapper XE branches).  ``batch``: tensors on the
    model's device, label-side ones [B, S, ...].  Returns (loss, metrics)."""
    mode = model.train_mode
    f = _flat(batch)
    att, am = batch["att_feats"], batch["att_masks"]
    reduction = "none" if drop_worst_rate > 0 else "mean"

    if mode in ("UIC", "UIC_ds") and ss_prob > 0:
        # scheduled sampling replaces the teacher-forced SA branch
        sa_len, sa_syn, sa_word, memory, src_mask = ss_sa_forward(
            model, rng, att, am, f["labels"], f["phrase_length"],
            f["phrase_syn"], ss_prob)
        L = model.max_length
        extend_syn = po.extend_syn_seq(f["phrase_length"], f["phrase_syn"],
                                       L)
        na_len, na_syn = model.bound_teacher(extend_syn, f["phrase_length"],
                                             memory, src_mask, True, rng)
        total = po.total_words(f["phrase_length"])
        na_mask = (torch.arange(L, device=att.device)[None, None, :]
                   < total[:, None, None]).expand(-1, L, L)
        na_word = model.generate(model.decode_na(
            extend_syn[:, 1:-1], memory, src_mask, na_mask, rng))
        d = Lm.uic_loss(sa_len, sa_syn, sa_word, na_len, na_syn, na_word,
                        f["phrase_num"], f["phrase_length"], f["phrase_syn"],
                        f["labels"], self_dis=model.self_dis,
                        reduction=reduction)
        loss = d.pop("loss")
        if drop_worst_rate > 0:
            loss = Lm.drop_worst(loss, drop_worst_rate)
        d["loss"] = loss
        return loss, d

    if mode == "PB_pad":
        loss, metrics = pb_loss(model, batch, f, rng, reduction)
        if drop_worst_rate > 0:
            loss = Lm.drop_worst(loss, drop_worst_rate)
        metrics["loss"] = loss
        return loss, metrics

    out = model(att, am, f["labels"], f.get("phrase_num"),
                f.get("phrase_length"), f.get("phrase_syn"), glat_p=glat_p,
                rng=rng)
    metrics: Dict[str, torch.Tensor] = {}
    if mode in ("AIC", "auto"):
        tgt, msk = f["labels"][:, 1:], f["masks"][:, 1:]
        if label_smoothing > 0:
            loss = Lm.label_smoothing_loss(out["logprob"], tgt, msk,
                                           label_smoothing, reduction)
        else:
            loss = Lm.lm_loss(out["logprob"], tgt, msk, reduction)
    elif mode == "NNAIC":
        tgt, msk = f["labels"][:, 1:], f["masks"][:, 1:]
        d = Lm.nnaic_loss(out["length_pred"].detach().float(),
                          out["logprob"], tgt, msk, reduction)
        loss = d.pop("loss")
        metrics.update(d)
    elif mode in ("NAIC", "SAIC"):
        p = "sa" if mode == "SAIC" else "na"
        d = Lm.naic_loss(out[f"{p}_len_logprob"], out[f"{p}_syn_logprob"],
                         out[f"{p}_logprob"], f["phrase_num"],
                         f["phrase_length"], f["phrase_syn"], f["labels"],
                         reduction)
        loss = d.pop("loss")
        metrics.update(d)
    elif mode in ("UIC", "UIC_ds"):
        d = Lm.uic_loss(out["sa_len_logprob"], out["sa_syn_logprob"],
                        out["sa_logprob"], out["na_len_logprob"],
                        out["na_syn_logprob"], out["na_logprob"],
                        f["phrase_num"], f["phrase_length"], f["phrase_syn"],
                        f["labels"], self_dis=model.self_dis,
                        reduction=reduction)
        loss = d.pop("loss")
        metrics.update(d)
    elif mode in ("UIC_s", "UIC_u"):
        d = Lm.tuic_loss(out["len_logprob"], out["syn_logprob"],
                         out["a_logprob"], out["sa_logprob"],
                         out["na_logprob"], f["phrase_num"],
                         f["phrase_length"], f["phrase_syn"], f["labels"],
                         reduction)
        loss = d.pop("loss")
        metrics.update(d)
    else:
        raise NotImplementedError(mode)
    if drop_worst_rate > 0:
        loss = Lm.drop_worst(loss, drop_worst_rate)
    if "glat_mismatch" in out:
        metrics["glat_mismatch"] = out["glat_mismatch"]
    metrics["loss"] = loss
    return loss, metrics


def make_xe_step(model, optimizer, label_smoothing: float = 0.0,
                 debug_checks: bool = False, grad_accum: int = 1):
    """``step(batch, rng, glat_p=None, drop_worst=0.0, ss_prob=0.0) ->
    metrics``: gradients of ``xe_loss_fn`` by autograd, one
    ``optimizer.step``, then the model's packed kernel weights dropped.

    ``grad_accum`` G > 1 splits the batch's images into G equal
    microbatches run in turn and updates once with the mean of their
    gradients; the metrics are the microbatches' means.  Each microbatch's
    loss is normalised by its own token count, as the JAX package does
    (ROADMAP section 3: at unequal counts this reweights the captions).
    ``debug_checks`` adds the counts of non-finite gradient values and
    losses to the metrics."""
    params = optimizer.params

    def grads_of(batch, rng, glat_p, drop_worst, ss_prob):
        loss, metrics = xe_loss_fn(model, batch, rng, glat_p, drop_worst,
                                   label_smoothing, ss_prob)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss, {k: v.detach() for k, v in metrics.items()}, grads

    def step(batch, rng, glat_p=None, drop_worst: float = 0.0,
             ss_prob: float = 0.0) -> Dict[str, torch.Tensor]:
        if grad_accum > 1:
            if drop_worst:
                # drop-worst picks the worst losses over the WHOLE batch
                raise ValueError("grad_accum > 1 is incompatible with "
                                 "drop_worst_rate > 0")
            G = grad_accum
            n = batch["att_feats"].shape[0]
            if n % G:
                raise ValueError(f"batch {n} not divisible by grad_accum "
                                 f"{G}")
            m = n // G
            # PB_pad's layouts have a row a caption: seq_per_img rows an
            # image
            S = batch["labels"].shape[1]
            acc, per = None, []
            for g in range(G):
                mb = {k: v[g * m * S:(g + 1) * m * S] if k in PB_KEYS
                      else v[g * m:(g + 1) * m] for k, v in batch.items()}
                _, metrics, grads = grads_of(mb, rng, glat_p, 0.0, ss_prob)
                acc = grads if acc is None else torch._foreach_add(acc,
                                                                   grads)
                per.append(metrics)
            grads = torch._foreach_div(acc, float(G))
            metrics = {k: torch.stack([p[k] for p in per]).mean(0)
                       for k in per[0]}
        else:
            _, metrics, grads = grads_of(batch, rng, glat_p, drop_worst,
                                         ss_prob)
        if debug_checks:
            metrics["nonfinite_grads"] = sum(
                (~torch.isfinite(g)).sum() for g in grads)
            metrics["nonfinite_loss"] = (
                ~torch.isfinite(metrics["loss"])).int()
        optimizer.step(grads)
        model.invalidate_packed()
        return metrics

    return step


def run_xe_step(step_fn, batch: Dict[str, Any], rng, glat_p=-1.0,
                drop_worst: float = 0.0, ss_prob: float = 0.0,
                device=None) -> Dict[str, torch.Tensor]:
    """A loader batch through ``step_fn``: its arrays onto ``device`` (the
    model's), glat off for a negative rate."""
    g = glat_p if (glat_p is not None and glat_p >= 0) else None
    return step_fn(to_device(batch, device), rng, g, drop_worst, ss_prob)


# ---------------------------------------------------------------------------
# RL (structure-loss) stage
# ---------------------------------------------------------------------------

def frame_plan(seq, phrase_length, phrase_syn, L: int):
    """Sampled (seq [B, L], plan [B, L]) -> framed label and plan rows
    [B, L+2] in the training collate's layout (a leading bos and a
    length-1 slot)."""
    B = seq.shape[0]

    def frame(x, first):
        return torch.cat([torch.full((B, 1), first, dtype=x.dtype,
                                     device=x.device), x,
                          torch.zeros((B, 1), dtype=x.dtype,
                                      device=x.device)], dim=1)

    return (frame(seq, BOS), frame(phrase_length, 1),
            frame(phrase_syn, BOS))


def make_rl_sample(model, sample_method: str = "sample",
                   temperature: float = 1.0, sample_n: int = 5):
    """The RL stage's sampler: ``sample(att_feats, att_masks, generator)
    -> {branch: decode outputs}``, under ``no_grad``.  SA and NA branch
    samples for the phrase modes (loss_wrapper.py:194-209), plus the
    plan-gated AR branch for UIC_s / UIC_u (:296-330); for AIC the samples
    and a greedy baseline (classic SCST) from the same encoding.

    The encoder runs through ``fused_encode`` and the fills with
    ``fused_fill=True``: on the card the kernels, on the CPU their plain
    twins.  Each image's memory is repeated ``sample_n`` times with
    ``repeat_interleave`` (image-major rows, ``jnp.repeat``'s order), so
    sample row r belongs to image r // sample_n.  The plans stay argmax;
    the words are drawn from ``generator``."""
    mode = model.train_mode

    @torch.no_grad()
    def sample(att_feats, att_masks, generator: torch.Generator):
        memory = bf.fused_encode(model, att_feats, att_masks)
        src_mask = att_masks.bool()
        mem = memory.repeat_interleave(sample_n, dim=0)
        msk = src_mask.repeat_interleave(sample_n, dim=0)
        kw = dict(sample_method=sample_method, temperature=temperature,
                  generator=generator)
        out = {}
        if mode in ("AIC", "auto"):
            out["sample"] = ar_mod.ar_sample(model, mem, msk, **kw)
            out["greedy"] = ar_mod.ar_sample(model, memory, src_mask,
                                             sample_method="greedy")
            return out
        use_syn_pred = mode in ("UIC_s", "UIC_u")
        if mode in ("SAIC", "UIC", "UIC_ds", "UIC_s", "UIC_u"):
            # UIC_s / UIC_u's SA core feeds the predictor the syn plan
            # (core_UIC_s_SAIC, TransformerModel.py:2232-2234)
            out["sa"] = bf.sa_decode(model, mem, msk, fused_fill=True,
                                     predictor_use_syn=use_syn_pred, **kw)
        if mode in ("NAIC", "UIC", "UIC_ds", "UIC_s", "UIC_u"):
            out["na"] = bf.na_decode(model, mem, msk, fused_fill=True, **kw)
        if use_syn_pred:
            out["sample"] = bf.uic_s_ar_decode(model, mem, msk, **kw)
        return out

    return sample


def rl_rescore(model, att_feats, att_masks, samples, sample_n: int,
               rng: Optional[torch.Generator] = None,
               use_logsoftmax: bool = True) -> Dict[str, torch.Tensor]:
    """Differentiable re-score of the sampled captions: the teacher-forced
    log-probs [B*n, L, V] of each branch under the current weights, plain
    autograd: every attention on the plain path (``plain_attention``)
    whatever ``use_pallas`` says, since the kernels have no backward.
    ``rng`` None (the default) is deterministic, as the sampler was, so
    the gathered values are the sampled policy's.
    ``use_logsoftmax=False`` returns the raw generator logits, which the
    margin-family structure losses take (the reference's output_logsoftmax
    flag, loss_wrapper.py:158-160)."""
    with model.plain_attention():
        L = model.max_length
        memory = model.encode(att_feats, att_masks, rng)
        src_mask = att_masks.bool()
        mem = memory.repeat_interleave(sample_n, dim=0)
        msk = src_mask.repeat_interleave(sample_n, dim=0)
        gen = model.generate if use_logsoftmax else model.generate_logits
        out = {}
        if "sa" in samples:
            s = samples["sa"]
            labels, pl, ps = frame_plan(s["seq"], s["phrase_length"],
                                        s["phrase_syn"], L)
            word_syn = po.extend_syn_seq(pl, ps, L)[:, 1:-1]
            out["sa_logprob"] = gen(model.decode_sa(
                po.copy_init(labels, pl, L), word_syn, mem, msk,
                po.blockwise_mask(pl, L), rng))
        if "na" in samples:
            s = samples["na"]
            total = s["phrase_length"].sum(-1)
            na_mask = (torch.arange(L, device=mem.device)[None, None, :]
                       < total[:, None, None]).expand(-1, L, L)
            _, pl, ps = frame_plan(s["seq"], s["phrase_length"],
                                   s["phrase_syn"], L)
            word_syn = po.extend_syn_seq(pl, ps, L)[:, 1:-1]
            out["na_logprob"] = gen(model.decode_na(word_syn, mem, msk,
                                                    na_mask, rng))
        if "sample" in samples:  # the AR branch
            s = samples["sample"]
            seq = s["seq"]
            syn_seq = None
            if model.train_mode in ("UIC_s", "UIC_u"):
                # the plan-gated AR decode adds syn embeddings: re-score with
                # the sampled plan's syn sequence
                labels, pl, ps = frame_plan(seq, s["phrase_length"],
                                            s["phrase_syn"], L)
                syn_seq = po.extend_syn_seq(pl, ps, L)[:, 1:-1]
            else:
                labels = torch.cat([torch.full_like(seq[:, :1], BOS), seq,
                                    torch.zeros_like(seq[:, :1])], dim=1)
            # the teacher-forced causal decode of the AIC forward, on the
            # repeated memory
            inp = labels[:, :-2]
            keep = (inp != EOS) & (inp != PAD)
            keep[:, 0] = True
            mask = keep[:, None, :] & causal_mask(L, inp.device)[None]
            out["a_logprob"] = gen(model.decode_a(inp, mem, msk, mask,
                                                  syn_seq=syn_seq, rng=rng))
        return out


def _rl_settings(cfg) -> Dict[str, Any]:
    loss_type = cfg.get("structure_loss_type", "new_self_critical")
    return {
        "loss_type": loss_type,
        "sample_n": int(cfg.get("train_sample_n", 5)),
        "rl_kl": bool(cfg.get("rl_kl", False)),
        "w": float(cfg.get("structure_loss_weight", 1.0)),
        "ent_w": float(cfg.get("entropy_reward_weight", 0) or 0.0),
        "sc_w": float(cfg.get("self_cider_reward_weight", 0) or 0.0),
        # the margin family takes raw logits, every other type log-softmax
        "use_ls": bool(cfg.get("struc_use_logsoftmax", False)
                       or loss_type == "softmax_margin"
                       or "margin" not in loss_type),
        "glat_p": cfg.get("glat_p", -1.0),
        "label_smoothing": float(cfg.get("label_smoothing", 0.0) or 0.0),
    }


def rl_loss_fn(model, att_feats, att_masks, samples, scores, cfg,
               gt: Optional[Dict[str, torch.Tensor]] = None,
               rng: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The structure-stage loss of fixed samples and host scores (the body
    of the JAX package's RL step).  Per sampled branch:
    ``(1-w)·lm_loss + w·structure_loss`` (loss_wrapper.py:169/220-222;
    ``lm_loss`` is the XE loss of the gt batch ``gt``, needed when
    ``structure_loss_weight`` w < 1 and entering once per branch), plus the
    optional ``rl_kl`` term KL(NA <- SA) over the SA sample's positions
    (:221-227).  ``scores``: tensors [n_img, sample_n] by branch, and
    ``<branch>_self_cider`` [n_img] with ``self_cider_reward_weight``.
    ``rng`` draws the XE term's dropout; the re-score is deterministic.
    Returns (loss, metrics)."""
    st = _rl_settings(cfg)
    w = st["w"]
    lps = rl_rescore(model, att_feats, att_masks, samples, st["sample_n"],
                     use_logsoftmax=st["use_ls"])
    metrics: Dict[str, torch.Tensor] = {}
    lm = 0.0
    if w < 1.0:
        if gt is None:
            raise ValueError(
                "structure_loss_weight < 1 needs the gt batch for the "
                "(1-w)*lm_loss term: pass gt= to the rl step")
        lm, _ = xe_loss_fn(model, dict(gt, att_feats=att_feats,
                                       att_masks=att_masks), rng,
                           glat_p=st["glat_p"],
                           label_smoothing=st["label_smoothing"])
        metrics["lm_loss"] = lm
    total = 0.0
    reward_sum = 0.0
    for key, lp_key in (("sa", "sa_logprob"), ("na", "na_logprob"),
                        ("sample", "a_logprob")):
        if key not in samples:
            continue
        d = Lm.structure_loss(
            lps[lp_key], samples[key]["seq"], scores[key], st["loss_type"],
            entropy_reward_weight=st["ent_w"],
            self_cider_scores=scores.get(f"{key}_self_cider"),
            self_cider_reward_weight=st["sc_w"])
        total = total + (1.0 - w) * lm + w * d["loss"]
        metrics[f"{key}_struc_loss"] = d["loss"]
        reward_sum = reward_sum + d["reward"].mean()
    if st["rl_kl"] and "sa" in samples and "na" in samples:
        sa_mask = (samples["sa"]["seq"] > 0).float()
        lp_sa = lps["sa_logprob"].detach()
        kl = (torch.exp(lp_sa) * (lp_sa - lps["na_logprob"])).sum(-1)
        kl = (kl * sa_mask).sum() / (sa_mask.sum() + 1e-6)
        total = total + kl
        metrics["rl_kl"] = kl
    metrics["reward"] = reward_sum
    return total, metrics


def scst_loss_fn(model, att_feats, att_masks, samples, rewards,
                 sample_n: int) -> Tuple[torch.Tensor, Dict]:
    """Classic SCST (sc_flag): -logp(sample) * (r_sample - r_greedy) by
    ``reward_criterion`` (loss_wrapper.py:66-82).  ``rewards`` [B*n, L]."""
    lps = rl_rescore(model, att_feats, att_masks,
                     {"sample": samples["sample"]}, sample_n)
    loss = Lm.reward_criterion(lps["a_logprob"], samples["sample"]["seq"],
                               rewards)
    return loss, {"reward": rewards[:, 0].mean()}


def _update(model, optimizer, loss, metrics) -> Dict[str, torch.Tensor]:
    """Gradients of ``loss`` by autograd, one update, the packs dropped."""
    params = optimizer.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    optimizer.step([torch.zeros_like(p) if g is None else g
                    for p, g in zip(params, grads)])
    model.invalidate_packed()
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return metrics


def make_rl_step(model, optimizer, cfg):
    """``step(att_feats, att_masks, samples, scores, gt=None, rng=None) ->
    metrics``: ``rl_loss_fn``'s gradients, one update, the packs dropped
    (so the next sampler packs the new weights)."""

    def step(att_feats, att_masks, samples, scores, gt=None, rng=None):
        loss, metrics = rl_loss_fn(model, att_feats, att_masks, samples,
                                   scores, cfg, gt=gt, rng=rng)
        return _update(model, optimizer, loss, metrics)

    return step


def make_scst_step(model, optimizer, cfg):
    """``step(att_feats, att_masks, samples, rewards) -> metrics``: the
    classic SCST update (``scst_loss_fn``), the packs dropped after it."""
    sample_n = int(cfg.get("train_sample_n", 5))

    def step(att_feats, att_masks, samples, rewards):
        loss, metrics = scst_loss_fn(model, att_feats, att_masks, samples,
                                     rewards, sample_n)
        return _update(model, optimizer, loss, metrics)

    return step


def samples_to_host(samples) -> Dict[str, np.ndarray]:
    """The sampled ids of every branch as numpy arrays, through ONE
    device-to-host copy (the step's one host sync for the ids, as the JAX
    package's ``device_get``)."""
    keys = list(samples)
    seqs = [samples[k]["seq"] for k in keys]
    flat = torch.cat(seqs, dim=0).cpu().numpy()
    return dict(zip(keys, np.split(
        flat, np.cumsum([s.shape[0] for s in seqs])[:-1])))


def rl_host_scores(samples, gts, cfg, classic_scst: bool = False
                   ) -> Dict[str, np.ndarray]:
    """Host phase.  Structure-loss mode: CIDEr-D (+BLEU) scores per branch,
    shaped [n_img, sample_n] for the leave-one-out baseline.  Classic SCST
    mode (sc_flag): per-token rewards = score(sample) - score(greedy)
    (rewards.py:41-84).  ``samples``' ids may be tensors on the card: they
    come to the host in one copy (``samples_to_host``)."""
    sample_n = cfg.get("train_sample_n", 5)
    seqs = samples_to_host(samples)
    out = {}
    if classic_scst and "greedy" in seqs:
        out["scst_reward"] = get_self_critical_reward(
            seqs["greedy"], gts, seqs["sample"], cfg)
        return out
    sc_w = cfg.get("self_cider_reward_weight", 0) or 0.0
    # shared across branches (same references): the packed int32 bank for
    # the native score_ids path, the id-string dict for the string path
    bleu_on = (cfg.get("bleu_reward_weight", 0) or 0) > 0
    if _native_ids() and not bleu_on:
        gts_strs, gts_pack = None, pack_refs(gts)
    else:
        gts_strs, gts_pack = _gts_dict(gts), None
    for key in ("sa", "na", "sample"):
        if key not in seqs:
            continue
        scores = get_scores(gts, seqs[key], cfg, gts_strs=gts_strs,
                            gts_pack=gts_pack)
        out[key] = scores.reshape(-1, sample_n)
        if sc_w > 0:
            # each image's eigenvalue diversity bonus (reference losses.py
            # :167-171 computes it on the host inside the criterion)
            out[f"{key}_self_cider"] = get_self_cider_scores(gts, seqs[key],
                                                             cfg)
    return out
