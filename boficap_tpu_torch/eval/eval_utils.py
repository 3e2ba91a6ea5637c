"""Evaluation loop: the port of the JAX package's ``eval/eval_utils.py``
(parity with reference captioning/utils/eval_utils.py:129-651).

One ``eval_split`` covers every branch the port has a decoder for,
selected by (train_mode, inference_mode) as ``_branch_for`` does:

  * ``NAIC``        -> ``na_decode``,
  * ``SAIC``        -> ``sa_decode``,
  * ``AIC``         -> ``ar_sample``, or ``ar_beam_search`` for
    ``beam_size > 1`` (``ar_diverse_beam_search`` with ``group_size > 1``;
    the top-3 beams dumped to ``KD_file``),
  * ``NNAIC``       -> ``nnaic_decode``,
  * ``UIC_s_SAIC``  -> ``sa_decode(predictor_use_syn=True)``,
  * ``UIC_s_AIC``   -> ``uic_s_ar_decode``,
  * ``PB_pad``      -> ``decode/pb.py::pb_decode`` (``pb_packed_width``
    raises its packed-width cap; the model's ``use_pallas`` puts its
    attentions on the attention-core kernel).

``sample_n > 1`` on the AIC branch adds ``sample_n`` captions an image
(``sample_n_captions``: all beams of a beam search, a diverse beam search,
diverse sampling or repeated sampling) to ``n_predictions``, and the
multi-sample metrics (``eval/multi_metrics.py``) to ``lang_stats``; other
branches ignore it and say so, as the JAX package does.

The decoders are plain calls, with no compilation and no program cache.
``use_cuda_fill`` is the counterpart of the JAX package's
``use_pallas_fill``: 'auto' runs ``fused_encode`` and the fill on the
hand-written kernels (``fused_fill=True``, the whole-stack or per-layer
route by ``use_stacked``, as the server does) when the model is on a CUDA
device, and the plain path on the CPU; '1' on the CPU raises
``ValueError``; '0' runs the plain path anywhere.  No kernel call is
wrapped in a ``try``: a shape the kernels refuse raises.

Decode-time accounting follows the JAX package (the reference's
speed-measurement protocol, AttModel.py:303-305/:408-410): the timer wraps
encode and the decode call, after the batch is on the device; on CUDA a
``torch.cuda.synchronize()`` ends it.  The first batch is excluded (its
time is reported as ``compile_time``); a one-batch eval decodes its batch
again for the rate.  ``images_per_s`` counts the images the timed decodes
processed.

``verbose_loss`` (on by default, as in the JAX package) adds the
teacher-forced XE loss of each batch with labels (``train/steps.py``
``xe_loss_fn``, deterministic, glancing off), outside the timer; ``loss``
is its mean over the batches.  PB_pad has none, as in the JAX package
(its packed layouts are not in the eval loader's batches).

A non-greedy ``sample_method``, and
a sampled ``sample_n_method``, draw from one ``torch.Generator`` on the
model's device, seeded by ``eval_kwargs['seed']`` (0 by default), as the
JAX package seeds its key.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List

import torch

from ..decode import ar
from ..decode import bound_fill as bf
from ..decode import pb
from ..text import VOCAB_LOWER, decode_sequence
from ..train.state import safe_load
from .metrics import BAD_ENDINGS, language_eval
from .multi_metrics import multi_sample_eval

__all__ = ["decode_sequence", "eval_split", "make_decoders",
           "sample_n_captions", "use_cuda_fill", "cache_path", "save_cached",
           "load_cached"]


def not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                              f"section 1, item {item}")


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def use_cuda_fill(flag, model) -> bool:
    """``use_cuda_fill``: 'auto' = the model is on a CUDA device; '1' / True
    forces the kernels (``ValueError`` on the CPU, where they cannot run);
    '0' / False runs the plain path."""
    on_card = _model_device(model).type == "cuda"
    if isinstance(flag, str) and flag.lower() == "auto":
        return on_card
    forced = (flag.lower() in ("1", "true", "yes", "on")
              if isinstance(flag, str) else bool(flag))
    if forced and not on_card:
        raise ValueError(
            "use_cuda_fill=1 needs the model on a CUDA device (it is on "
            f"{_model_device(model)}); use use_cuda_fill=auto or 0 for the "
            "plain path")
    return forced


def make_decoders(model, eval_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Decode callables keyed by branch, each ``(memory, src_mask) ->
    outputs``, ``encode(att, am) -> memory`` and ``sample_n(memory,
    src_mask) -> ids [B, n, L]`` (``sample_n_captions``); the options are
    read from ``eval_kwargs`` as the JAX package's ``_decode_cfg`` reads
    them."""
    fused = use_cuda_fill(eval_kwargs.get("use_cuda_fill", "auto"), model)
    beam_size = int(eval_kwargs.get("beam_size", 1) or 1)
    sample_method = eval_kwargs.get("sample_method", "greedy")
    temperature = float(eval_kwargs.get("temperature", 1.0) or 1.0)
    group_size = int(eval_kwargs.get("group_size", 1) or 1)
    diversity_lambda = float(eval_kwargs.get("diversity_lambda", 0.5) or 0.5)
    decoding_constraint = bool(eval_kwargs.get("decoding_constraint", 0))
    block_trigrams = bool(eval_kwargs.get("block_trigrams", 0))
    suppress_unk_idx = eval_kwargs.get("_suppress_unk_idx")
    bad_endings_ix = eval_kwargs.get("_bad_endings_ix")
    length_penalty = eval_kwargs.get("length_penalty", "") or ""
    pb_width = int(eval_kwargs.get("pb_packed_width", 0) or 0) or None
    # a sampled method draws from one generator on the model's device,
    # seeded as the JAX package's eval_split seeds its PRNGKey
    generator = None
    if sample_method != "greedy" or int(eval_kwargs.get("sample_n", 1)) > 1:
        generator = torch.Generator(device=_model_device(model)).manual_seed(
            int(eval_kwargs.get("seed", 0) or 0))
    sampling = dict(sample_method=sample_method, temperature=temperature,
                    generator=generator)

    def encode(att, am):
        if fused:
            return bf.fused_encode(model, att, am)
        return model.encode(att, am)

    def dec_na(memory, src_mask):
        return bf.na_decode(model, memory, src_mask, fused_fill=fused,
                            **sampling)

    def dec_sa(memory, src_mask):
        return bf.sa_decode(model, memory, src_mask, fused_fill=fused,
                            **sampling)

    def dec_ar(memory, src_mask):
        return ar.ar_sample(model, memory, src_mask,
                            decoding_constraint=decoding_constraint,
                            block_trigrams=block_trigrams,
                            bad_endings_ix=bad_endings_ix, **sampling)

    def dec_beam(memory, src_mask):
        if group_size > 1:
            return ar.ar_diverse_beam_search(
                model, memory, src_mask, beam_size=beam_size,
                group_size=group_size, diversity_lambda=diversity_lambda,
                length_penalty=length_penalty,
                suppress_unk_idx=suppress_unk_idx, temperature=temperature,
                decoding_constraint=decoding_constraint,
                bad_endings_ix=bad_endings_ix)
        return ar.ar_beam_search(
            model, memory, src_mask, beam_size=beam_size,
            length_penalty=length_penalty, suppress_unk_idx=suppress_unk_idx,
            temperature=temperature, decoding_constraint=decoding_constraint,
            bad_endings_ix=bad_endings_ix)

    def dec_nnaic(memory, src_mask):
        return bf.nnaic_decode(model, memory, src_mask, fused_fill=fused,
                               **sampling)

    def dec_sa_syn(memory, src_mask):
        return bf.sa_decode(model, memory, src_mask, predictor_use_syn=True,
                            fused_fill=fused, **sampling)

    def dec_uic_s_ar(memory, src_mask):
        return bf.uic_s_ar_decode(model, memory, src_mask, **sampling)

    def dec_pb(memory, src_mask):
        return pb.pb_decode(model, memory, src_mask, packed_width=pb_width,
                            **sampling)

    def dec_sample_n(memory, src_mask):
        return sample_n_captions(model, memory, src_mask, eval_kwargs,
                                 generator)

    return {"encode": encode, "NAIC": dec_na, "SAIC": dec_sa,
            "AIC": dec_ar, "beam": dec_beam, "NNAIC": dec_nnaic,
            "UIC_s_SAIC": dec_sa_syn, "UIC_s_AIC": dec_uic_s_ar,
            "PB_pad": dec_pb, "sample_n": dec_sample_n}


def sample_n_captions(model, memory, src_mask, eval_kwargs,
                      generator=None) -> torch.Tensor:
    """``sample_n`` captions an image (reference eval_split_n,
    eval_utils.py:671-722), by ``sample_n_method``: 'bs' all beams of an
    n-wide beam search, 'dbs' a diverse beam search of n groups, 'd<m>'
    diverse sampling of n groups by method m, else n sampled captions an
    image (over the memory repeated n times), a sampled method drawing
    from ``generator``.  The decode constraints apply as in the headline
    decoders.  Returns ids [B, n, L]."""
    n = int(eval_kwargs.get("sample_n", 1))
    method = eval_kwargs.get("sample_n_method", "sample")
    temperature = eval_kwargs.get("temperature", 1.0)
    length_penalty = eval_kwargs.get("length_penalty", "")
    suppress_unk_idx = eval_kwargs.get("_suppress_unk_idx")
    bad_endings_ix = eval_kwargs.get("_bad_endings_ix")
    decoding_constraint = bool(eval_kwargs.get("decoding_constraint", 0))
    diversity_lambda = eval_kwargs.get("diversity_lambda", 0.5)
    if method == "bs":
        return ar.ar_beam_search(
            model, memory, src_mask, beam_size=n,
            length_penalty=length_penalty, suppress_unk_idx=suppress_unk_idx,
            temperature=temperature, decoding_constraint=decoding_constraint,
            bad_endings_ix=bad_endings_ix)["seq"]
    if method == "dbs":
        return ar.ar_diverse_beam_search(
            model, memory, src_mask, beam_size=n, group_size=n,
            diversity_lambda=diversity_lambda, length_penalty=length_penalty,
            suppress_unk_idx=suppress_unk_idx, temperature=temperature,
            decoding_constraint=decoding_constraint,
            bad_endings_ix=bad_endings_ix)["seq"]
    block_trigrams = bool(eval_kwargs.get("block_trigrams", 0))
    if method.startswith("d"):
        # dgreedy / dsample / dtopk / dtopp: diverse sampling, the method
        # without its 'd' (reference eval_split_n's else branch, :713-719)
        return ar.ar_diverse_sample(
            model, memory, src_mask, group_size=n, sample_method=method[1:],
            temperature=temperature, diversity_lambda=diversity_lambda,
            decoding_constraint=decoding_constraint,
            block_trigrams=block_trigrams, bad_endings_ix=bad_endings_ix,
            generator=generator)["seq"]
    B = memory.shape[0]
    out = ar.ar_sample(
        model, memory.repeat_interleave(n, 0),
        None if src_mask is None else src_mask.repeat_interleave(n, 0),
        sample_method=method, temperature=temperature,
        decoding_constraint=decoding_constraint,
        block_trigrams=block_trigrams, bad_endings_ix=bad_endings_ix,
        generator=generator)
    return out["seq"].reshape(B, n, -1)


def eval_loss(model, data, device) -> float:
    """The teacher-forced XE loss of one loader batch (JAX
    ``eval_utils.py:320-342``): ``xe_loss_fn`` with no dropout and no
    glancing, under the caller's ``no_grad``."""
    from ..train.steps import to_device, xe_loss_fn
    loss, _ = xe_loss_fn(model, to_device(data, device), None)
    return float(loss)


def _stash_decode_constraints(model, ix_to_word, eval_kwargs
                              ) -> Dict[str, Any]:
    """Resolve suppress_UNK / remove_bad_endings into the vocab-index keys
    the decoders read."""
    ix_to_word = ix_to_word or {}
    # reference CaptionModel.py:171-173: beam search knocks the top vocab id
    # down by 1000 iff suppress_UNK is on AND that id decodes to 'UNK'
    if eval_kwargs.get("suppress_UNK", 0) and hasattr(model, "tgt_vocab"):
        top = str(int(model.tgt_vocab) - 1)
        if ix_to_word.get(top) == "UNK":
            eval_kwargs = dict(eval_kwargs,
                               _suppress_unk_idx=int(model.tgt_vocab) - 1)
    # reference AttModel.py:104 + :355-360 / CaptionModel.py:169-170:
    # remove_bad_endings forbids STOPPING right after a bad-ending word
    # during AR sampling and beam search (plus the string-level strip in
    # decode_sequence)
    if eval_kwargs.get("remove_bad_endings", 0):
        bad_ix = tuple(sorted(
            int(k) for k, v in ix_to_word.items() if v in BAD_ENDINGS))
        if bad_ix:
            eval_kwargs = dict(eval_kwargs, _bad_endings_ix=bad_ix)
    return eval_kwargs


def _branch_for(train_mode: str, inference_mode: str) -> str:
    if train_mode in ("AIC", "auto"):
        return "AIC"
    if train_mode in ("NAIC", "SAIC", "NNAIC", "PB_pad"):
        return train_mode
    if train_mode in ("UIC_s", "UIC_u"):
        # predictor input is the syn plan for all three branches
        # (reference eval_utils.py:506-582, cores :2148-2391)
        m = inference_mode or "NAIC"
        return {"NAIC": "NAIC", "SAIC": "UIC_s_SAIC",
                "AIC": "UIC_s_AIC"}.get(m, "NAIC")
    # UIC / UIC_ds: inference_mode picks the branch (eval_utils.py:459)
    return inference_mode or "NAIC"


@torch.no_grad()
def eval_split(model, loader, eval_kwargs: Dict[str, Any],
               inference_mode: str = "") -> Dict[str, Any]:
    """Decode ``eval_kwargs['split']`` of ``loader`` (a ``CaptionData``) with
    ``model`` where its weights are.  Returns {'loss', 'predictions',
    'n_predictions', 'lang_stats', 'decode_time', 'compile_time',
    'n_images', 'gts_words', 'images_per_s'}, as the JAX package's."""
    verbose = eval_kwargs.get("verbose", False)
    # -1 = the whole split
    num_images = eval_kwargs.get("num_images", -1)
    if num_images is None:
        num_images = -1
    split = eval_kwargs.get("split", "val")
    lang_eval_flag = eval_kwargs.get("language_eval", 0)
    train_mode = eval_kwargs.get("train_mode", model.train_mode)
    beam_size = eval_kwargs.get("beam_size", 1)
    remove_bad = bool(eval_kwargs.get("remove_bad_endings", 0))
    KD_file = eval_kwargs.get("KD_file", "")
    branch = _branch_for(train_mode, inference_mode)
    verbose_loss = (bool(eval_kwargs.get("verbose_loss", 1))
                    and model.train_mode != "PB_pad")
    sample_n = int(eval_kwargs.get("sample_n", 1))
    multi = sample_n > 1 and branch == "AIC"
    if sample_n > 1 and not multi:
        # the reference's eval_split_n has _sample branches only for the AR
        # train modes (AttModel.py:339-467); the JAX package skips, and says
        # so
        print(f"sample_n={sample_n} is AR(AIC)-only; ignoring for branch "
              f"{branch} (the reference crashes here, AttModel.py:339-467)")

    eval_kwargs = _stash_decode_constraints(
        model, getattr(loader, "ix_to_word", {}), eval_kwargs)
    dec = make_decoders(model, eval_kwargs)
    dev = _model_device(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def decode(att, am):
        memory = dec["encode"](att, am)
        if branch == "AIC" and beam_size > 1:
            return memory, dec["beam"](memory, am.bool())
        return memory, dec[branch](memory, am.bool())

    loader.reset_iterator(split)
    ix_to_word = loader.ix_to_word

    n = 0
    loss_sum, loss_evals = 0.0, 1e-8
    predictions: List[dict] = []
    n_predictions: List[dict] = []
    gts_words: Dict[Any, List[str]] = {}
    decode_time = 0.0
    compile_time = 0.0
    first = True
    seq_kd: Dict[Any, List[str]] = {}
    decoded_imgs = 0          # images through timed decodes
    first_imgs = 0
    while True:
        data = loader.get_batch(split)
        n += len(data["infos"])
        decoded_imgs += len(data["infos"])
        att = torch.from_numpy(data["att_feats"]).to(dev)
        am = torch.from_numpy(data["att_masks"]).to(dev)
        if verbose_loss and data.get("labels") is not None:
            loss_sum += eval_loss(model, data, dev)
            loss_evals += 1

        sync()
        t0 = time.perf_counter()
        memory, out = decode(att, am)
        sync()
        dt = time.perf_counter() - t0
        if first:
            compile_time = dt
            first = False
            first_imgs = len(data["infos"])
            redo = (att, am)           # re-timed after the loop if alone
        else:
            decode_time += dt
            redo = None

        ent_arr = None
        if branch == "AIC" and beam_size > 1:
            seq_all = out["seq"].cpu().numpy()           # [B, K, L]
            seq = seq_all[:, 0]
            tok_lp = out["tok_logprobs"][:, 0].float().cpu().numpy()
            if eval_kwargs.get("verbose_beam"):
                # reference eval_utils.py:186-190: print every done beam
                for i in range(seq_all.shape[0]):
                    print("\n".join(decode_sequence(ix_to_word, seq_all[i])))
                    print("--" * 10)
        else:
            seq = out["seq"].cpu().numpy()
            tok_lp = out["tok_logprobs"].float().cpu().numpy()
            ent_arr = out["entropy"].float().cpu().numpy()

        n_tok = (seq > VOCAB_LOWER).sum(1) + 1
        ppl = -tok_lp.sum(1) / n_tok
        # the beam decoder keeps per-token logprobs but not distribution
        # entropies: entropy stays None there (absent, never faked)
        entropy = ent_arr.sum(1) / n_tok if ent_arr is not None else None

        sents = decode_sequence(ix_to_word, seq, remove_bad_endings=remove_bad)
        for kk, sent in enumerate(sents):
            img_id = data["infos"][kk]["id"]
            entry = {"image_id": img_id, "caption": sent,
                     "perplexity": float(ppl[kk]),
                     "entropy": (None if entropy is None
                                 else float(entropy[kk]))}
            if eval_kwargs.get("dump_path", 0) == 1:
                # reference eval_utils.py:198-199
                entry["file_name"] = data["infos"][kk].get("file_path", "")
            predictions.append(entry)
            if eval_kwargs.get("dump_images", 0) == 1:
                # copy the image next to the predictions (reference
                # eval_utils.py:201-204); no-op when the loader carries no
                # file paths or the file is absent
                src = os.path.join(
                    str(eval_kwargs.get("image_root", "") or ""),
                    str(data["infos"][kk].get("file_path", "") or ""))
                if data["infos"][kk].get("file_path") and os.path.isfile(src):
                    import shutil
                    os.makedirs(os.path.join("vis", "imgs"), exist_ok=True)
                    shutil.copy(src, os.path.join(
                        "vis", "imgs", f"img{len(predictions)}.jpg"))
            gts_words[img_id] = decode_sequence(ix_to_word,
                                                data["gts"][kk])
            if verbose:
                print(f"image {img_id}: {sent}")

        if multi:
            ids = dec["sample_n"](memory, am.bool()).cpu().numpy()
            for i, info in enumerate(data["infos"]):
                for cap in decode_sequence(ix_to_word, ids[i]):
                    n_predictions.append({"image_id": info["id"],
                                          "caption": cap})

        if branch == "AIC" and beam_size > 1 and KD_file:
            for i, info in enumerate(data["infos"]):
                seq_kd[info["id"]] = decode_sequence(
                    ix_to_word, seq_all[i][:3])   # top-3 beams (KD recipe)

        ix1 = data["bounds"]["it_max"]
        if num_images != -1:
            ix1 = min(ix1, num_images)
        else:
            num_images = ix1
        for _ in range(n - ix1):
            predictions.pop()
            # the popped image's sample_n captions go too
            if multi:
                del n_predictions[-sample_n:]
        n = min(n, ix1)
        if num_images >= 0 and n >= num_images:
            break
        if data["bounds"]["wrapped"]:
            # split exhausted before num_images (reference eval_utils.py
            # breaks on wrapped too)
            break

    lang_stats = None
    if lang_eval_flag:
        lang_stats = language_eval(predictions, gts_words)
        if n_predictions:
            # the multi-sample block of the reference's language_eval
            # (eval_utils.py:105-121)
            lang_stats.update(multi_sample_eval(
                n_predictions, gts_words,
                eval_oracle=bool(eval_kwargs.get("eval_oracle", 1))))

    if KD_file and seq_kd:
        os.makedirs("KD_dataset", exist_ok=True)
        with open(os.path.join("KD_dataset", KD_file), "w") as f:
            json.dump({str(k): v for k, v in seq_kd.items()}, f)

    n_imgs = len(predictions)
    timed_imgs = decoded_imgs - first_imgs
    if decode_time == 0 and redo is not None:
        # single-batch eval: decode the batch again for a rate past the
        # first call
        att, am = redo
        sync()
        t0 = time.perf_counter()
        decode(att, am)
        sync()
        decode_time = time.perf_counter() - t0
        timed_imgs = att.shape[0]
    return {
        "loss": loss_sum / loss_evals,
        "predictions": predictions,
        "n_predictions": n_predictions,
        "lang_stats": lang_stats,
        "decode_time": decode_time,
        "compile_time": compile_time,
        "n_images": n_imgs,
        "gts_words": gts_words,
        "images_per_s": timed_imgs / decode_time
        if decode_time > 0 else float("nan"),
    }


def cache_path(eval_kwargs) -> str:
    eid = eval_kwargs.get("id", "model")
    split = eval_kwargs.get("split", "val")
    os.makedirs("eval_results", exist_ok=True)
    return os.path.join("eval_results", f".saved_pred_{eid}_{split}.pkl")


def save_cached(eval_kwargs, result) -> None:
    with open(cache_path(eval_kwargs), "wb") as f:
        pickle.dump(result, f)


def load_cached(eval_kwargs):
    """The cached predictions, read as data only (``train.state.safe_load``:
    a cache that names any class raises ``pickle.UnpicklingError``)."""
    p = cache_path(eval_kwargs)
    if os.path.exists(p):
        with open(p, "rb") as f:
            return safe_load(f)
    return None
