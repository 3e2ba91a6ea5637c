"""Training criteria as pure torch functions: the port of the JAX package's
``losses.py`` (reference captioning/modules/losses.py).

Conventions shared by every function:
  * ``*_logprob`` arguments are log-softmax outputs (float32),
  * ``reduction='mean'`` sums each term and divides by the WORD-mask sum
    (the reference normalises the length, syn and KL terms by the word
    mask too, losses.py:307-311, :358-368); ``'none'`` gives per-sample
    values,
  * the per-sample masking loops of the reference are the closed-form
    masks of ``data/phrase_ops.py``.

Data parallelism (``sharded``): inside ``with sharded(group)`` each rank
holds its shard of the batch, and every batch-wide normaliser (a token
mean's word count, a mean over rows, drop-worst's ranking) is taken over
the whole group: the counts are all-reduced (``global_count``) before the
shard's sums are divided by them, and ``drop_worst`` ranks the gathered
per-sample losses.  A rank's loss is then its share of the global loss;
the shares, and their gradients, sum over the group to the single-device
values on the global batch (``train/steps.py`` sums them).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .constants import PAD
from .data import phrase_ops as po


# the data-parallel group of ``sharded``, else None
_SHARD_GROUP = None


@contextlib.contextmanager
def sharded(group):
    """Batch-wide normalisers over ``group``'s shards inside the block
    (None: this rank's batch is the whole batch)."""
    global _SHARD_GROUP
    prev, _SHARD_GROUP = _SHARD_GROUP, group
    try:
        yield
    finally:
        _SHARD_GROUP = prev


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (a mask's sum, a number of rows) summed over the shards of
    ``sharded``, no gradient; ``x`` itself outside it."""
    if _SHARD_GROUP is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=_SHARD_GROUP)
    return x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the whole batch: the shard's sum over the count of
    elements in every shard."""
    if _SHARD_GROUP is None:
        return x.mean()
    return x.sum() / global_count(torch.tensor(float(x.numel()),
                                               device=x.device))


def _gather_logprob(logprob, ids):
    """logprob [..., L, V], ids [..., L] -> [..., L]."""
    return torch.gather(logprob, -1, ids[..., None].long())[..., 0]


def _reduce(per_pos, mask, reduction: str):
    mask = mask.to(per_pos.dtype)
    per_pos = per_pos * mask
    if reduction == "none":
        return per_pos.sum(-1) / mask.sum(-1).clamp_min(1e-8)
    return per_pos.sum() / global_count(mask.sum()).clamp_min(1e-8)


def _denom(mask, reduction: str):
    return (mask.sum(-1) if reduction == "none"
            else global_count(mask.sum())).clamp_min(1e-8)


# ---------------------------------------------------------------------------
# word-level criteria (AR path)
# ---------------------------------------------------------------------------

def lm_loss(logprob, target, mask, reduction: str = "mean"):
    """Masked NLL (reference LanguageModelCriterion, losses.py:181-204)."""
    L = logprob.shape[-2]
    nll = -_gather_logprob(logprob, target[..., :L])
    return _reduce(nll, mask[..., :L], reduction)


def label_smoothing_loss(logprob, target, mask, smoothing: float = 0.0,
                         reduction: str = "mean"):
    """KL(true_dist || model) with smoothing / (V - 1) on every class and
    the confidence on the target class in place of its share (reference
    LabelSmoothing, losses.py:426-464); 0 log 0 counts as 0."""
    V, L = logprob.shape[-1], logprob.shape[-2]
    target = target[..., :L]
    confidence = 1.0 - smoothing
    fill = smoothing / (V - 1)
    tlp = _gather_logprob(logprob, target)
    cross = -(fill * (logprob.sum(-1) - tlp) + confidence * tlp)
    ent = ((V - 1) * fill * math.log(fill)
           + confidence * math.log(confidence)) if smoothing > 0 else 0.0
    return _reduce(cross + ent, mask[..., :L], reduction)


# ---------------------------------------------------------------------------
# phrase-level criteria
# ---------------------------------------------------------------------------

def _phrase_terms(logprob, labels, phrase_length, L: int):
    """(per-word NLL [B, L], word mask [B, L]) of a fill decoder's output."""
    nll = -_gather_logprob(logprob, labels[..., 1:-1])
    return nll, po.word_loss_mask(phrase_length, L)


def _slot_terms(len_logprob, syn_logprob, phrase_num, phrase_length,
                phrase_syn):
    """Length / syn NLL over the predictor slots (real slots: [..., 1:])."""
    S = len_logprob.shape[-2]
    smask = po.slot_loss_mask(phrase_num, S)
    len_nll = -_gather_logprob(len_logprob, phrase_length[..., 1:][..., :S])
    syn_nll = -_gather_logprob(syn_logprob, phrase_syn[..., 1:][..., :S])
    return len_nll, syn_nll, smask


def naic_loss(len_logprob, syn_logprob, word_logprob, phrase_num,
              phrase_length, phrase_syn, labels, reduction: str = "mean"
              ) -> Dict[str, torch.Tensor]:
    """NAIC three-term loss (reference LanguageModelCriterion_NAIC,
    losses.py:273-312); every term over the word-mask sum."""
    L = word_logprob.shape[-2]
    nll, wmask = _phrase_terms(word_logprob, labels, phrase_length, L)
    len_nll, syn_nll, smask = _slot_terms(len_logprob, syn_logprob,
                                          phrase_num, phrase_length,
                                          phrase_syn)
    wm, sm = wmask.to(nll.dtype), smask.to(nll.dtype)
    if reduction == "none":
        total = ((nll * wm).sum(-1) + (len_nll * sm).sum(-1)
                 + (syn_nll * sm).sum(-1)) / _denom(wm, reduction)
        return {"loss": total}
    denom = _denom(wm, reduction)
    word = (nll * wm).sum() / denom
    length = (len_nll * sm).sum() / denom
    syn = (syn_nll * sm).sum() / denom
    return {"loss": word + length + syn, "word_loss": word,
            "length_loss": length, "syn_loss": syn}


def _kl_term(student_logprob, teacher_logprob, wmask):
    """sum_c p_t (log p_t - log p_s) per word, the teacher detached
    (reference nn.KLDivLoss(reduction='none'), losses.py:336-339)."""
    lp_t = teacher_logprob.detach()
    kl = (torch.exp(lp_t) * (lp_t - student_logprob)).sum(-1)
    return kl * wmask


def uic_loss(sa_len_logprob, sa_syn_logprob, sa_word_logprob,
             na_len_logprob, na_syn_logprob, na_word_logprob,
             phrase_num, phrase_length, phrase_syn, labels,
             self_dis: bool = False, reduction: str = "mean"
             ) -> Dict[str, torch.Tensor]:
    """UIC six-term SA + NA loss, with the optional self-distillation
    KL(NA <- SA) (reference LanguageModelCriterion_UIC, losses.py:315-369)."""
    L = sa_word_logprob.shape[-2]
    sa_nll, wmask = _phrase_terms(sa_word_logprob, labels, phrase_length, L)
    na_nll, _ = _phrase_terms(na_word_logprob, labels, phrase_length, L)
    sa_len, sa_syn, smask = _slot_terms(sa_len_logprob, sa_syn_logprob,
                                        phrase_num, phrase_length, phrase_syn)
    na_len, na_syn, _ = _slot_terms(na_len_logprob, na_syn_logprob,
                                    phrase_num, phrase_length, phrase_syn)
    wm, sm = wmask.to(sa_nll.dtype), smask.to(sa_nll.dtype)
    if reduction == "none":
        total = ((sa_nll * wm).sum(-1) + (sa_len * sm).sum(-1)
                 + (sa_syn * sm).sum(-1) + (na_nll * wm).sum(-1)
                 + (na_len * sm).sum(-1) + (na_syn * sm).sum(-1)
                 ) / _denom(wm, reduction)
        return {"loss": total}
    denom = _denom(wm, reduction)
    out = {
        "sa_word_loss": (sa_nll * wm).sum() / denom,
        "sa_length_loss": (sa_len * sm).sum() / denom,
        "sa_syn_loss": (sa_syn * sm).sum() / denom,
        "na_word_loss": (na_nll * wm).sum() / denom,
        "na_length_loss": (na_len * sm).sum() / denom,
        "na_syn_loss": (na_syn * sm).sum() / denom,
    }
    total = sum(out.values())
    if self_dis:
        kl = _kl_term(na_word_logprob, sa_word_logprob, wm).sum() / denom
        out["kl_loss"] = kl
        total = total + kl
    out["loss"] = total
    return out


def tuic_loss(len_logprob, syn_logprob, a_word_logprob, sa_word_logprob,
              na_word_logprob, phrase_num, phrase_length, phrase_syn,
              labels, reduction: str = "mean") -> Dict[str, torch.Tensor]:
    """UIC_s / UIC_u eight-term loss with the KL chain SA <- AR,
    NA <- {SA, AR} (reference LanguageModelCriterion_TUIC,
    losses.py:372-423).  ``'none'`` sums every term's row total over the
    row's word count, as the JAX package does (the reference's own 'none'
    path is broken, losses.py:408-414)."""
    L = sa_word_logprob.shape[-2]
    a_nll, wmask = _phrase_terms(a_word_logprob, labels, phrase_length, L)
    sa_nll, _ = _phrase_terms(sa_word_logprob, labels, phrase_length, L)
    na_nll, _ = _phrase_terms(na_word_logprob, labels, phrase_length, L)
    len_nll, syn_nll, smask = _slot_terms(len_logprob, syn_logprob,
                                          phrase_num, phrase_length,
                                          phrase_syn)
    wm, sm = wmask.to(sa_nll.dtype), smask.to(sa_nll.dtype)
    sa_kl_t = _kl_term(sa_word_logprob, a_word_logprob, wm)
    na_kl_t = (_kl_term(na_word_logprob, sa_word_logprob, wm)
               + _kl_term(na_word_logprob, a_word_logprob, wm))
    if reduction == "none":
        per = ((len_nll * sm).sum(-1) + (syn_nll * sm).sum(-1)
               + (a_nll * wm).sum(-1) + (sa_nll * wm).sum(-1)
               + (na_nll * wm).sum(-1) + sa_kl_t.sum(-1) + na_kl_t.sum(-1))
        return {"loss": per / _denom(wm, reduction)}
    denom = _denom(wm, reduction)
    out = {
        "length_loss": (len_nll * sm).sum() / denom,
        "syn_loss": (syn_nll * sm).sum() / denom,
        "a_word_loss": (a_nll * wm).sum() / denom,
        "sa_word_loss": (sa_nll * wm).sum() / denom,
        "na_word_loss": (na_nll * wm).sum() / denom,
        "sa_kl_loss": sa_kl_t.sum() / denom,
        "na_kl_loss": na_kl_t.sum() / denom,
    }
    out["loss"] = sum(out.values())
    return out


def nnaic_loss(length_pred, word_logprob, target, mask,
               reduction: str = "mean"):
    """NNAIC word NLL + squared length error (reference losses.py:206-233;
    the length head gets no gradient there, replicated)."""
    L = word_logprob.shape[-2]
    mask = mask[..., :L].to(word_logprob.dtype)
    word = -_gather_logprob(word_logprob, target[..., :L]) * mask
    length_loss = (mask.sum(-1) - length_pred) ** 2
    if reduction == "none":
        return {"loss": (word.sum(-1) + 0.1 * length_loss)
                / _denom(mask, reduction)}
    denom = _denom(mask, reduction)
    out = {"word_loss": word.sum() / denom,
           "length_loss": length_loss.sum() / denom}
    out["loss"] = out["word_loss"] + out["length_loss"]
    return out


# ---------------------------------------------------------------------------
# RL criteria (rewards computed on the host)
# ---------------------------------------------------------------------------

def _seq_mask(seq):
    """Positions up to and including the first eos (reference mask shift,
    losses.py:17-18, :49-50)."""
    m = seq > PAD
    return torch.cat([torch.ones_like(m[..., :1]), m[..., :-1]], dim=-1)


def reward_criterion(sample_logprob, seq, reward, reduction: str = "mean"):
    """Classic SCST policy gradient -logp * reward * mask (reference
    RewardCriterion, losses.py:7-26).  ``sample_logprob``: [B, L, V]
    (gathered here) or [B, L] per-token log-probs; ``reward``
    broadcastable to [B, L]."""
    if sample_logprob.dim() == seq.dim() + 1:
        lp = _gather_logprob(sample_logprob, seq)
    else:
        lp = sample_logprob
    mask = _seq_mask(seq).to(lp.dtype)
    reward = torch.as_tensor(reward, dtype=lp.dtype, device=lp.device)
    reward = reward.reshape(tuple(reward.shape)
                            + (1,) * (lp.dim() - reward.dim())).expand(
                                lp.shape)
    out = -lp * reward * mask
    if reduction == "none":
        return out.sum(-1) / _denom(mask, reduction)
    return out.sum() / _denom(mask, reduction)


def structure_loss(logprob, seq, scores, loss_type: str,
                   entropy_reward_weight: float = 0.0,
                   self_cider_scores: Optional[torch.Tensor] = None,
                   self_cider_reward_weight: float = 0.0,
                   reduction: str = "mean") -> Dict[str, torch.Tensor]:
    """Structure losses over ``train_sample_n`` samples per image
    (reference StructureLosses, losses.py:29-179).  logprob [B, L, V]
    (log-softmax, or logits for the margin family, as the caller passes
    them); seq [B, L] sampled ids; scores: host-computed scores laid out as
    n_img x sample_n."""
    B = seq.shape[0]
    lp_tok = _gather_logprob(logprob, seq)
    mask = _seq_mask(seq).to(lp_tok.dtype)
    # the reported reward is the raw score, before the entropy bonus
    out: Dict[str, torch.Tensor] = {"reward": scores}
    if entropy_reward_weight > 0:
        ent = -(torch.softmax(logprob, -1)
                * torch.log_softmax(logprob, -1)).sum(-1)
        ent = ((ent * mask).sum(-1) / _denom(mask, "none")).detach()
        scores = scores + entropy_reward_weight * ent.reshape(scores.shape)

    if loss_type == "new_self_critical":
        # leave-one-out baseline (losses.py:157-176)
        n = scores.shape[-1] if scores.dim() == 2 else 1
        sc = scores.reshape(-1, n)
        baseline = (sc.sum(-1, keepdim=True) - sc) / max(n - 1, 1)
        adv = sc - baseline
        if self_cider_scores is not None and self_cider_reward_weight > 0:
            adv = adv + self_cider_reward_weight * self_cider_scores.reshape(
                -1, 1)
        pg = -lp_tok * mask * adv.reshape(B, 1).detach()
        out["loss"] = (pg.sum(-1) / _denom(mask, "none")
                       if reduction == "none"
                       else pg.sum() / _denom(mask, "mean"))
        return out

    n = scores.shape[-1]
    costs = -scores.reshape(-1, n)
    if loss_type in ("risk", "softmax_margin"):
        costs = costs - costs.min(-1, keepdim=True).values
        costs = costs / costs.max(-1, keepdim=True).values.clamp_min(1e-8)
    avg = lp_tok * mask
    if loss_type == "risk":
        per_seq = avg.sum(-1).reshape(-1, n)
    else:
        per_seq = (avg.sum(-1) / _denom(mask, "none")).reshape(-1, n)

    def xent(scores_mat, target):
        lsm = torch.log_softmax(scores_mat, dim=-1)
        return -batch_mean(torch.gather(lsm, -1, target[:, None]))

    target = torch.argmin(costs, dim=-1)
    if loss_type == "seqnll":
        out["loss"] = xent(per_seq, target)
    elif loss_type == "risk":
        probs = torch.softmax(torch.exp(per_seq), dim=-1)
        out["loss"] = batch_mean((probs * costs).sum(-1))
    elif loss_type in ("max_margin", "multi_margin"):
        costs_star = costs.min(-1, keepdim=True).values
        input_star = torch.gather(per_seq, -1, target[:, None])
        viol = torch.relu(costs - costs_star - input_star + per_seq)
        out["loss"] = batch_mean(viol.max(-1).values / 2
                                 if loss_type == "max_margin" else viol)
    elif loss_type in ("softmax_margin", "real_softmax_margin"):
        out["loss"] = xent(per_seq + costs, target)
    else:
        raise ValueError(f"unknown structure loss {loss_type}")
    return out


def drop_worst(per_sample_loss, drop_rate: float):
    """Mean of the (1 - rate) lowest per-sample losses (reference
    tools/train.py:216-220, topk largest=False).  Inside ``sharded`` the
    ranking is over the whole batch (the shards' losses gathered in rank
    order) and a rank returns its kept losses' sum over the kept count."""
    if _SHARD_GROUP is None:
        B = per_sample_loss.shape[0]
        k = max(int(B * (1 - drop_rate)), 1)
        vals, _ = torch.topk(-per_sample_loss, k)
        return -vals.mean()
    from .parallel.tensor_parallel import all_gather
    b = per_sample_loss.shape[0]
    everyone = torch.cat(all_gather(per_sample_loss, _SHARD_GROUP))
    k = max(int(everyone.shape[0] * (1 - drop_rate)), 1)
    _, idx = torch.topk(-everyone, k)
    keep = torch.zeros_like(everyone, dtype=torch.bool)
    keep[idx] = True
    off = dist.get_rank(_SHARD_GROUP) * b
    return torch.where(keep[off:off + b], per_sample_loss, 0.0).sum() / k


def pb_pad_loss(packed_labels, word_logprob, packed_mask, phrase_num,
                length_targets, len_logprob, reduction: str = "mean"):
    """PB_pad two-term loss (reference PB_pad_LanguageModelCriterion,
    losses.py:235-271): packed-phrase word NLL + per-slot next-length NLL,
    both over the packed word-mask sum."""
    pm = packed_mask.to(word_logprob.dtype)
    word_nll = -_gather_logprob(word_logprob, packed_labels) * pm
    S = min(len_logprob.shape[-2], length_targets.shape[-1])
    smask = po.slot_loss_mask(phrase_num, S).to(word_logprob.dtype)
    len_nll = -_gather_logprob(len_logprob[..., :S, :],
                               length_targets[..., :S]) * smask
    if reduction == "none":
        return {"loss": (word_nll.sum(-1) + len_nll.sum(-1))
                / _denom(pm, reduction)}
    denom = _denom(pm, reduction)
    out = {"phrase_loss": word_nll.sum() / denom,
           "length_loss": len_nll.sum() / denom}
    out["loss"] = out["phrase_loss"] + out["length_loss"]
    return out
