"""Cross-entropy training of the UIC model: the program's loader
(``CaptionData``) assembles each batch on the host from a corpus and a
feature store held in host memory, and the program's XE step
(``make_xe_step``: teacher-forced forward, loss, autograd, value clip,
noam Adam) takes it, one step after another.

The mix's keys: ``images_per_step`` (each with the configuration's
``seq_per_img`` captions), ``corpus_images``, ``regions``, ``live_min``
(live regions an image, drawn from live_min..regions), ``checked_steps``
(the first steps, which the reference follows), ``reference_images`` (the
reference's rows a block), ``trace_seconds``.

Set-up builds the one model, optimizer and step and drives them through
the first ``checked_steps`` steps by the window's own call and feed; the
window then goes on with the same objects.  End-to-end:
``train_captions_per_s``, the captions of every step enqueued in the
window over the time from the window's start to the last step's end;
``train_peak_gb``, the card's peak of allocated memory over the window;
``setup_s``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import devtrace, gen, program
from portbench.cell import Outcome, RunData, Spans, memory_peak, sync
from portbench.reference import compare, uic_train
from portbench.roofline import counts


def make_inputs(cell):
    """Weights (on the card), the corpus and the feature store (features,
    masks; made on the card, kept in host memory, where the loader reads
    them), all from the seed."""
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    n = int(tr["corpus_images"])
    weights = gen.model_weights(cfg, cell.seed, dev)
    corpus = gen.make_corpus(n, cfg["vocab_size"], cfg["max_length"],
                             cfg["seq_per_img"], cell.seed)
    att, am = (t.cpu() for t in gen.make_store(
        n, tr["regions"], cfg["att_feat_size"], tr["live_min"], cell.seed,
        dev))
    host = program.HostFeatures(att.numpy(), am.sum(1).long().numpy())
    return weights, corpus, att, am, host


def to_host(weights):
    """The initial weights in host memory, once the model holds its copy:
    the card's memory in the window is the program's alone."""
    return {k: v.cpu() for k, v in weights.items()}


def dropout_seed(seed: int) -> int:
    return gen.sub_seed(seed, "dropout")


class Trainer:
    """The program's model, optimizer, step and loader, with the window's
    call (``one``)."""

    def __init__(self, cell, weights, corpus, host, spans=None):
        cfg, tr, dev = cell.cfg, cell.traffic, cell.device
        self.dev = dev
        self.loader = program.caption_data(
            cfg, corpus, host, int(tr["images_per_step"]),
            gen.sub_seed(cell.seed, "loader") % (2 ** 31))
        self.model = program.build_model(cfg, weights, dev)
        self.opt, self.step = program.xe_trainer(cfg, self.model)
        self.rng = torch.Generator(device=dev).manual_seed(
            dropout_seed(cell.seed))
        self.spans = spans or Spans(False, dev)

    def one(self):
        with self.spans("batch"):
            batch = self.loader.get_batch("train")
        with self.spans("step"):
            metrics = program.xe_step(self.step, batch, self.rng, self.dev)
        return batch, metrics

    def first_steps(self, n: int, weights) -> dict:
        """The first ``n`` steps through ``one``: each step's loss, the
        first clipped gradient by leaf (Adam's first moment after one step
        over 1 - b1: ``g1``, and its norms) and the norm of each leaf's
        change after the n-th; and the images of each batch."""
        b1 = uic_train.ADAM[0]
        losses, ids, g1 = [], [], None
        for s in range(n):
            batch, metrics = self.one()
            ids.append([int(i["ix"]) for i in batch["infos"]])
            losses.append(metrics["loss"].detach().float())
            if s == 0:
                mu = program.adam_first_moment(self.opt)
                g1 = {k: (v / (1 - b1)).cpu() for k, v in mu.items()}
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            change = {k: (named[k].detach().to(weights[k].device)
                          - weights[k]).norm() for k in weights}
        return {"loss": [float(x) for x in losses], "ids": ids, "g1": g1,
                "grad1": {k: float(v.norm()) for k, v in g1.items()},
                "change": {k: float(v) for k, v in change.items()}}

    def close(self):
        self.loader.reset_iterator("train")


def reference_readings(cell, weights, corpus, att, am, ids,
                       quant=None) -> dict:
    """The reference's first steps over the batches of images ``ids``
    (float32 with TF32 off, or ``quant``)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=cell.device).manual_seed(
            dropout_seed(cell.seed))
        return uic_train.follow(weights, cell.cfg, corpus, att, am, ids, g,
                                int(cell.traffic["reference_images"]),
                                cell.device, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def run(cell) -> Outcome:
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    weights, corpus, att, am, host = make_inputs(cell)
    spans = Spans(False, dev)
    t = Trainer(cell, weights, corpus, host, spans)
    weights = to_host(weights)
    first = t.first_steps(int(tr["checked_steps"]), weights)
    sync(dev)
    setup_peak = memory_peak(dev)
    spans = t.spans = Spans(cell.trace, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = devtrace.start(cell.trace)
    setup_s = cell.age_s()
    steps = 0
    with (torch.profiler.record_function(devtrace.WINDOW) if prof
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        while True:
            t.one()
            steps += 1
            if time.perf_counter() - t0 >= cell.window_s:
                break
        sync(dev)
        t1 = time.perf_counter()
    trace = devtrace.collect(prof, ("batch", "step")) if prof else None
    window_peak = memory_peak(dev)
    t.close()
    n_img, k = int(tr["images_per_step"]), cfg["seq_per_img"]
    elapsed = t1 - t0
    rd = RunData(kind="train", window_s=elapsed, spans=spans.device_ms(),
                 dtype=cfg["dtype"], trace=trace)
    rd.counts.update(steps=steps, flops_per_step=counts.xe_step_flops(
        cfg, n_img, k, tr["regions"]))

    del t, host
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, weights, corpus, att, am, first["ids"])
    readings = compare.train_gaps(first, ref)
    e2e = {"train_captions_per_s": steps * n_img * k / elapsed,
           "train_peak_gb": window_peak / 1e9, "setup_s": setup_s}
    return Outcome(e2e=e2e, readings=readings, attempted=steps, failed=0,
                   memory_peak=max(setup_peak, window_peak), run=rd)
