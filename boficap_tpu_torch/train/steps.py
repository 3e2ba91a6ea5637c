"""The XE training step: the port of the XE half of the JAX package's
``train/steps.py`` (parity with the reference LossWrapper,
captioning/modules/loss_wrapper.py, and the step body of tools/train.py:
198-229).

One step is the teacher-forced forward of the model's train_mode
(``BoFiCap.forward``), its loss (``losses.py``), the gradients by autograd
and one optimizer update (``train/optim.py``), plain PyTorch: no TPU
kernel has a backward pass, and the kernel wrappers refuse tensors that
require grad.  After the update the model's packed kernel weights are
dropped (``BoFiCap.invalidate_packed``), so the next decode on the kernels
packs the new weights.  Dropout and GLAT draw from one ``torch.Generator``
on the model's device; ``rng=None`` is the deterministic pass of the eval
loss.  The RL stage waits for ROADMAP item 5.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import losses as Lm
from ..data import phrase_ops as po
from ..decode import bound_fill as bf

PHRASE_MODES = ("NAIC", "SAIC", "UIC", "UIC_ds", "UIC_s", "UIC_u")
LABEL_KEYS = ("labels", "masks", "phrase_num", "phrase_length", "phrase_syn")


def _flat(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """[B, S, ...] -> [B*S, ...] views of the label-side tensors."""
    return {k: batch[k].reshape((-1,) + tuple(batch[k].shape[2:]))
            for k in LABEL_KEYS if batch.get(k) is not None}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader batch's arrays as tensors on ``device`` (integers int64,
    features float32); other entries (infos, gts, bounds) are left out."""
    out = {}
    for k in ("att_feats", "att_masks") + LABEL_KEYS:
        v = batch.get(k)
        if v is None:
            continue
        t = torch.as_tensor(np.asarray(v))
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
            acc, per = None, []
            for g in range(G):
                mb = {k: v[g * m:(g + 1) * m] for k, v in batch.items()}
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
