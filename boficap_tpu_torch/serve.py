"""Serving layer: request batching over the NA bound-then-fill decode, the
SA per-phrase decode and the AR decode (the port of the JAX package's
``serve.py::CaptionServer``).

Requests (precomputed region features, the reference's input contract) are
queued, coalesced into batches and padded up to a power-of-two SIZE BUCKET.
Batch padding is exact: every per-sample path (encoder rows, attention with
per-sample masks, RefLayerNorm, the kernels' row-independent sums) is
independent across the batch, so a request's caption does not depend on
its batchmates.  Padding rows keep one live region (``am[n:, 0] = 1``) so
their masks stay sane.

The weights are resident on the device once (the model is moved at
construction, never per request).  Each bucket has one decode program,
chosen at its first batch (or at construction with ``warm``) among two, as
the JAX server chooses (its ``route``):

  * the kernel program: ``fused_encode``, then ``na_decode(fused_fill=
    True)`` for mode 'NAIC' or ``sa_decode(fused_fill=True)`` for mode
    'SAIC': on the card through the hand-written kernels, routed as the
    JAX package routes them (the whole-stack kernels for a bf16 model at
    B <= 128), on the CPU through their plain twins;
  * the plain program: ``model.encode`` and the decode with
    ``fused_fill=False``.

``route='auto'`` (the default) runs each program once to warm it, then
three times, each ended by a synchronize, and keeps the plain program for
the server's lifetime only where its least time beats the kernel
program's by more than the spread of the repeats (the larger of the two
programs' max - min), else the kernel program; it prints the choice.
``'fused'`` and ``'unfused'`` force one, which is then not timed.  On the
card, ``'auto'`` and ``'fused'`` need the wrappers to take the model's
shapes (``_kernel_refusal``: the bf16 products' widths, the attention
block's heads and shared memory at R regions and L words, the
counterpart of JAX's TPU and 128-lane test): where they do not, the
server raises their ValueError at construction and never serves the
plain program in the kernels' place; ``'unfused'`` asks for it.
``routes`` holds each bucket's choice and, under 'auto', both times and
the spread in ms.  Mode
'AIC' has one program, as in the JAX server (``ar_sample`` takes no
``fused_fill``): ``fused_encode`` and the KV-cached ``ar_sample`` (the
attention core on every step when the model's ``use_pallas`` is set; on a
UIC_s model and on the LSTM captioners too, which encode with their own
``encode``).  With ``pipeline=True`` the worker thread uploads and
launches a batch while a completion thread waits for the previous batch's
result, so the next upload overlaps the decode in flight.

``mesh`` (the JAX server's data-parallel serving, its serve.py:96-124):
a sequence of devices, one replica of the model on each, with its own
kernel packs there; replicas on one device share one copy of the weights
(a mesh may name a device more than once: two replicas of one card).
Each bucket's batch splits evenly over the replicas, in order, and the
answers come back in order; the buckets are the multiples of the mesh
size, and a ``max_batch`` the mesh size does not divide raises
``ValueError``.  Every replica's launches count in ``ops.launch_counts``.
"""

from __future__ import annotations

import collections
import copy
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .decode import ar
from .decode import bound_fill as bf
from .device import resolve_device
from .models.boficap import DECODER_ROLES, DTYPES
from .ops import decoder_layer as dl
from .text import decode_sequence


# the JAX server's routes: time both programs a bucket, or force one
ROUTES = ("auto", "fused", "unfused")


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


@dataclass(eq=False)        # identity hash/eq: requests live in sets
class _Request:
    att: torch.Tensor                    # [R, feat], feature dtype, CPU
    att_mask: Optional[torch.Tensor]     # [R] float32 or None
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[BaseException] = None
    t_submit: float = 0.0


class CaptionServer:
    """In-process caption server.

    >>> srv = CaptionServer(model, ix_to_word)       # on cuda by default
    >>> fut = srv.submit(att_feats)                   # a waitable handle
    >>> print(fut.caption())
    """

    def __init__(self, model, ix_to_word: Dict[str, str], *,
                 mode: str = "NAIC", max_batch: int = 64,
                 max_wait_ms: float = 2.0, max_steps: Optional[int] = None,
                 max_regions: Optional[int] = None,
                 feature_dtype: str = "float32", pipeline: bool = True,
                 warm: bool = False, route: str = "auto", device=None,
                 mesh=None):
        if mode not in ("NAIC", "SAIC", "AIC"):
            raise ValueError(f"mode {mode!r}")
        if route not in ROUTES:
            raise ValueError(f"route {route!r}: one of {ROUTES}")
        role = {"NAIC": "NA", "SAIC": "SA", "AIC": "A"}[mode]
        roles = DECODER_ROLES.get(getattr(model, "train_mode", ""), {})
        if role not in roles:
            raise ValueError(
                f"mode={mode} needs a '{role}' decoder role; train_mode="
                f"{model.train_mode} has {sorted(roles)}")
        if feature_dtype not in DTYPES:
            raise ValueError(f"feature_dtype must be one of "
                             f"{sorted(DTYPES)}")
        if mesh is None:
            self.devices = [resolve_device(device)]
        else:
            self.devices = [resolve_device(d) for d in mesh]
            if not self.devices or max_batch % len(self.devices):
                raise ValueError(f"max_batch {max_batch} must be a multiple "
                                 f"of the mesh size {len(self.devices)}")
        self.device = self.devices[0]
        # the feature store's region width (36 for bottom-up features)
        self.R = int(max_regions or model.max_boxes)
        if mode != "AIC" and route != "unfused":
            refusal = self._kernel_refusal(model)
            if refusal is not None:
                raise ValueError(
                    f"route={route!r}: the kernels refuse this model's "
                    f"shapes ({refusal}); route='unfused' serves the plain "
                    f"program") from refusal
        # the weights move to each device once, here: one replica a device
        self.model = model.to(self.device).eval()
        on = {self.device: self.model}
        for d in self.devices[1:]:
            if d not in on:
                on[d] = copy.deepcopy(self.model).to(d).eval()
        self.replicas = [on[d] for d in self.devices]
        self.ix_to_word = ix_to_word
        self.mode = mode
        self.max_steps = max_steps
        n_rep = len(self.devices)
        self.buckets = [b for b in _buckets(max_batch) if b % n_rep == 0]
        self.max_wait_s = max_wait_ms / 1e3
        # transport dtype: 'bfloat16' halves host->device bytes at the cost
        # of quantising the features; 'float32' is exact
        self.feat_dtype = DTYPES[feature_dtype]
        self.route = route
        # bucket -> the program kept, and its choice with both times
        self._programs: Dict[int, Callable] = {}
        self.routes: Dict[int, Dict[str, Any]] = {}
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._done_q: "queue.Queue[tuple]" = queue.Queue()
        # requests handed to a worker/completer and not yet resolved: close()
        # fails these if the threads outlive its join deadline
        self._inflight: set = set()
        self._stop = threading.Event()
        self._lat_ms: "collections.deque[float]" = collections.deque(
            maxlen=8192)
        self._n_done = 0
        self._lock = threading.Lock()
        if warm:
            for b in self.buckets:
                t0 = time.perf_counter()
                self._program(b)
                print(f"serve warm: bucket {b} ready, "
                      f"{self.routes[b]['route']} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        self.pipeline = pipeline
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._completer = None
        if pipeline:
            self._completer = threading.Thread(target=self._complete,
                                               daemon=True)
            self._completer.start()

    # ---- decode programs --------------------------------------------------

    def _make(self, fused: bool) -> Callable:
        """The kernel program (``fused``) or the plain one: (att, am) ->
        the decode's outputs, launched asynchronously on the card; over a
        mesh, each replica's even share of the rows on its device, the
        ids gathered in order."""
        progs = [self._make_one(fused, m) for m in self.replicas]
        if len(progs) == 1:
            return progs[0]
        devices = self.devices

        def program(att, am):
            outs = [p(a.to(d, non_blocking=True), m.to(d, non_blocking=True))
                    for p, d, a, m in zip(progs, devices,
                                          att.chunk(len(progs)),
                                          am.chunk(len(progs)))]
            return {"seq": torch.cat([o["seq"].to(self.device)
                                      for o in outs])}

        return program

    def _make_one(self, fused: bool, model) -> Callable:
        mode, max_steps = self.mode, self.max_steps

        @torch.no_grad()
        def program(att, am):
            if fused:
                memory = bf.fused_encode(model, att, am)
            else:
                memory = model.encode(att, am)
            src = am.bool()
            if mode == "AIC":
                return ar.ar_sample(model, memory, src, max_steps=max_steps)
            decode = bf.sa_decode if mode == "SAIC" else bf.na_decode
            return decode(model, memory, src, max_steps=max_steps,
                          fused_fill=fused)

        return program

    def _kernel_refusal(self, m) -> Optional[ValueError]:
        """The wrappers' ValueError where they refuse model ``m``'s shapes
        on the card, else None (on the CPU they run their plain twins,
        which take any)."""
        if all(d.type != "cuda" for d in self.devices):
            return None
        dtype, D, H = m.dtype, m.d_model, m.num_heads
        W, L, R = bf.SA_WINDOW, m.max_length, self.R
        try:
            dl.check_product_shape(dtype, {"d_model": D, "d_ff": m.d_ff})
            dl.check_attention_shape(
                {"encoder_self": (R, R, False), "self": (L, L, False),
                 "cross": (L, R, False), "window_self": (W, L + W, True),
                 "window_cross": (W, R, False)}, D // H, dtype)
        except ValueError as e:
            return e
        return None

    def _sync(self) -> None:
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _time_program(self, fused: bool, prog: Callable, att,
                      am) -> List[float]:
        """Seconds of three calls of ``prog`` (the kernel program if
        ``fused``) once warm: one call to warm it, then three, each ended
        by a synchronize."""
        prog(att, am)
        self._sync()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            prog(att, am)
            self._sync()
            times.append(time.perf_counter() - t0)
        return times

    def _program(self, bucket: int) -> Callable:
        """The bucket's program, kept for the server's lifetime: under
        'auto' the plain one only where it wins by more than the repeats'
        spread (both timed, the choice printed), else the kernel one; the
        one asked for, or AIC's only one, untimed."""
        if bucket in self._programs:
            return self._programs[bucket]
        fused = self.mode == "AIC" or self.route != "unfused"
        choice = {"route": "fused" if fused else "unfused",
                  "fused_ms": None, "unfused_ms": None, "spread_ms": None}
        if self.mode != "AIC" and self.route == "auto":
            att = torch.zeros((bucket, self.R, self.model.att_feat_size),
                              dtype=self.feat_dtype, device=self.device)
            am = torch.ones((bucket, self.R), device=self.device)
            t = {f: self._time_program(f, self._make(f), att, am)
                 for f in (True, False)}
            spread = max(max(v) - min(v) for v in t.values())
            fused = min(t[False]) >= min(t[True]) - spread
            choice = {"route": "fused" if fused else "unfused",
                      "fused_ms": min(t[True]) * 1e3,
                      "unfused_ms": min(t[False]) * 1e3,
                      "spread_ms": spread * 1e3}
            print(f"serve route: bucket {bucket} {choice['route']} "
                  f"(kernels {choice['fused_ms']:.4f} ms, plain "
                  f"{choice['unfused_ms']:.4f} ms, spread "
                  f"{choice['spread_ms']:.4f} ms)", flush=True)
        self.routes[bucket] = choice
        self._programs[bucket] = self._make(fused)
        return self._programs[bucket]

    def _decode(self, att: torch.Tensor, am: torch.Tensor):
        """A padded batch (att [bucket, R, feat]) through its bucket's
        program."""
        return self._program(att.shape[0])(att, am)

    def _bind_thread(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ---- request path -----------------------------------------------------

    def submit(self, att, att_mask=None) -> "_Future":
        """att [R, feat] (or fewer than R regions: padded and masked).
        Shape errors raise HERE, on the submitting caller, never inside the
        batch worker where they would fail co-batched requests."""
        att = torch.as_tensor(np.asarray(att, np.float32)).to(self.feat_dtype)
        R = self.R
        feat = self.model.att_feat_size
        if att.dim() != 2 or att.shape[1] != feat or att.shape[0] > R:
            raise ValueError(
                f"features must be [<= {R} regions, {feat}], got "
                f"{tuple(att.shape)}")
        n_rows = att.shape[0]
        if att_mask is not None:
            att_mask = torch.as_tensor(
                np.asarray(att_mask, np.float32)).reshape(-1)
            if att_mask.shape[0] == n_rows and n_rows < R:
                att_mask = torch.cat([att_mask, torch.zeros(R - n_rows)])
            elif att_mask.shape[0] != R:
                raise ValueError(
                    f"att_mask must have {R} (or {n_rows}) entries, got "
                    f"{att_mask.shape[0]}")
        if n_rows < R:
            att = torch.cat([att, torch.zeros((R - n_rows, feat),
                                              dtype=att.dtype)])
            if att_mask is None:
                att_mask = torch.zeros(R)
                att_mask[:n_rows] = 1.0
        req = _Request(att=att, att_mask=att_mask,
                       t_submit=time.perf_counter())
        # closed-check and enqueue are atomic under the lock: close() drains
        # under the same lock after setting _stop
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("CaptionServer is closed")
            self._q.put(req)
        return _Future(req, self)

    def _run(self):
        """Dispatch loop: batch -> upload -> launch.  The blocking result
        fetch happens on the completion thread (pipeline=True)."""
        self._bind_thread()
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.buckets[-1]:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                self._dispatch_batch(batch)
            except BaseException as e:                # surfaced per request
                with self._lock:
                    self._inflight.difference_update(batch)
                for r in batch:
                    r.error = e
                    r.event.set()

    def _dispatch_batch(self, batch: List[_Request]):
        n = len(batch)
        with self._lock:
            self._inflight.update(batch)
        bucket = next(b for b in self.buckets if b >= n)
        R = self.R
        att = torch.zeros((bucket, R, batch[0].att.shape[-1]),
                          dtype=self.feat_dtype)
        am = torch.zeros((bucket, R))
        for i, r in enumerate(batch):
            att[i] = r.att
            am[i] = 1.0 if r.att_mask is None else r.att_mask
        am[n:, 0] = 1.0          # pad rows: one live region keeps masks sane
        if self.device.type == "cuda":
            # pinned + non_blocking: the upload queues behind the decode in
            # flight instead of waiting for it on the host
            att = att.pin_memory().to(self.device, non_blocking=True)
            am = am.pin_memory().to(self.device, non_blocking=True)
        out = self._decode(att, am)               # asynchronous on the card
        if self.pipeline:
            self._done_q.put((batch, bucket, out))
        else:
            self._finish(batch, bucket, out)

    def _complete(self):
        self._bind_thread()
        while not self._stop.is_set():
            try:
                batch, bucket, out = self._done_q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._finish(batch, bucket, out)

    def _finish(self, batch: List[_Request], bucket: int, out):
        n = len(batch)
        try:
            seq = out["seq"][:n].cpu().numpy()         # blocks: fetch
            sents = decode_sequence(self.ix_to_word, seq)
        except BaseException as e:
            with self._lock:
                self._inflight.difference_update(batch)
            for r in batch:
                r.error = e
                r.event.set()
            return
        t_done = time.perf_counter()
        with self._lock:
            self._inflight.difference_update(batch)
            for i, r in enumerate(batch):
                r.result = {"caption": sents[i], "seq": seq[i],
                            "batch": n, "bucket": bucket}
                self._lat_ms.append((t_done - r.t_submit) * 1e3)
                self._n_done += 1
                r.event.set()

    # ---- admin ------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat_ms)
            n = self._n_done
        if not lat:
            return {"n": 0}
        return {"n": n,
                "p50_ms": lat[len(lat) // 2],
                "p95_ms": lat[min(len(lat) - 1, int(len(lat) * 0.95))],
                "max_ms": lat[-1]}

    def close(self, join_timeout: float = 60.0):
        """Stop the threads and fail every request still queued (or
        dispatched but unfetched) so no future blocks forever.  The drain
        runs under the submit() lock and repeats while a slow worker is
        alive; whatever a worker still holds past ``join_timeout`` is failed
        through the in-flight set."""
        self._stop.set()
        err = RuntimeError("CaptionServer closed before request completed")

        def drain():
            for q in (self._q, self._done_q):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    reqs = [item] if isinstance(item, _Request) else item[0]
                    for r in reqs:
                        if not r.event.is_set():
                            r.error = err
                            r.event.set()

        deadline = time.monotonic() + join_timeout
        while time.monotonic() < deadline:
            self._worker.join(timeout=min(0.5, max(join_timeout, 0.05)))
            with self._lock:
                drain()
            if not self._worker.is_alive():
                break
        if self._completer is not None:
            self._completer.join(timeout=5)
        with self._lock:
            drain()
            for r in self._inflight:
                if not r.event.is_set():
                    r.error = err
                    r.event.set()
            self._inflight.clear()


class _Future:
    def __init__(self, req: _Request, srv: CaptionServer):
        self._req = req
        self._srv = srv

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._req.event.wait(timeout):
            raise TimeoutError("caption request timed out")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result

    def caption(self, timeout: Optional[float] = None) -> str:
        return self.wait(timeout)["caption"]
