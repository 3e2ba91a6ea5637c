"""Caption dataset + batch assembly (the port's copy of the JAX package's
``data/dataset.py``; parity with the reference DataLoader,
captioning/data/dataloader.py:88-647):

  * batches have STATIC shapes: region features are padded to a fixed
    ``max_att_len`` (the reference pads to the per-batch max, dataloader.py:
    329-338),
  * the phrase-tensor collate math (extend/copy/mask building, dataloader.py:
    343-428) does NOT happen here: the host ships only
    labels/phrase_length/phrase_syn/phrase_num, the model derives the rest,
  * single-process, resumable: the sampler state (permutation + cursor) is
    checkpointable exactly like the reference ``MySampler`` (dataloader.py:
    595-647) minus the torch-worker prefetch compensation.

Label file schema (produced by scripts/prepro_labels*.py, reference
scripts/prepro_labels_stanford.py:391-400): ``labels [N, L]``,
``label_start_ix/label_end_ix [n_images]`` (1-based), and for phrase modes
``phrase_num [N]``, ``phrase_length [N, L]``, ``phrase_syn [N, L]``
(stored as 'phrase_label' in the h5).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..constants import BOS, EOS
from .readers import FeatureReader, SyntheticFeatures

PHRASE_MODES = ("PB_pad", "NAIC", "SAIC", "UIC", "UIC_ds", "UIC_s", "UIC_u")


# ---------------------------------------------------------------------------
# Label store
# ---------------------------------------------------------------------------

class LabelStore:
    """In-memory caption labels + split info + vocab."""

    def __init__(self, images: List[dict], ix_to_word: Dict[str, str],
                 labels: np.ndarray, label_start_ix: np.ndarray,
                 label_end_ix: np.ndarray,
                 phrase_num: Optional[np.ndarray] = None,
                 phrase_length: Optional[np.ndarray] = None,
                 phrase_syn: Optional[np.ndarray] = None):
        self.images = images
        self.ix_to_word = ix_to_word
        self.vocab_size = len(ix_to_word)
        self.labels = labels
        self.seq_length = labels.shape[1]
        self.label_start_ix = label_start_ix
        self.label_end_ix = label_end_ix
        self.phrase_num = phrase_num
        self.phrase_length = phrase_length
        self.phrase_syn = phrase_syn

    @classmethod
    def from_files(cls, input_json: str, input_label_h5: str,
                   need_phrases: bool) -> "LabelStore":
        import h5py
        info = json.load(open(input_json))
        h5 = h5py.File(input_label_h5, "r")
        kw = {}
        if need_phrases:
            kw = dict(phrase_num=h5["phrase_num"][:],
                      phrase_length=h5["phrase_length"][:],
                      phrase_syn=h5["phrase_label"][:])
        return cls(info["images"], info["ix_to_word"], h5["labels"][:],
                   h5["label_start_ix"][:], h5["label_end_ix"][:], **kw)

    @classmethod
    def synthetic(cls, n_images: int = 30, vocab_size: int = 40, L: int = 20,
                  caps_per_img: int = 5, seed: int = 0,
                  splits=(0.6, 0.2, 0.2)) -> "LabelStore":
        """Tiny random corpus with valid phrase structure (test fixture)."""
        rng = np.random.RandomState(seed)
        n_caps = n_images * caps_per_img
        labels = np.zeros((n_caps, L), np.int32)
        pn = np.zeros(n_caps, np.int32)
        pls = np.zeros((n_caps, L), np.int32)
        syns = np.zeros((n_caps, L), np.int32)
        for i in range(n_caps):
            total = rng.randint(4, L + 1)
            labels[i, :total] = rng.randint(4, vocab_size + 4, total)
            left, lens = total, []
            while left > 0:
                li = rng.randint(1, min(left, 5) + 1)
                lens.append(li)
                left -= li
            pn[i] = len(lens)
            pls[i, :pn[i]] = lens
            syns[i, :pn[i]] = rng.randint(4, 7, pn[i])
        start = np.arange(n_images) * caps_per_img + 1          # 1-based
        end = start + caps_per_img - 1
        n_tr = int(n_images * splits[0])
        n_va = int(n_images * splits[1])
        images = []
        for ix in range(n_images):
            split = ("train" if ix < n_tr
                     else "val" if ix < n_tr + n_va else "test")
            images.append({"id": ix, "split": split,
                           "file_path": f"img{ix}.jpg"})
        ix_to_word = {str(i + 4): f"w{i}" for i in range(vocab_size)}
        return cls(images, ix_to_word, labels, start, end, pn, pls, syns)

    def save(self, dirpath: str, json_name="data.json", h5_name="label.h5"):
        """Write the json + h5 artifacts in the reference's file format."""
        import h5py
        os.makedirs(dirpath, exist_ok=True)
        with open(os.path.join(dirpath, json_name), "w") as f:
            json.dump({"images": self.images, "ix_to_word": self.ix_to_word},
                      f)
        with h5py.File(os.path.join(dirpath, h5_name), "w") as h5:
            h5.create_dataset("labels", data=self.labels)
            h5.create_dataset("label_start_ix", data=self.label_start_ix)
            h5.create_dataset("label_end_ix", data=self.label_end_ix)
            if self.phrase_num is not None:
                h5.create_dataset("phrase_num", data=self.phrase_num)
                h5.create_dataset("phrase_length", data=self.phrase_length)
                h5.create_dataset("phrase_label", data=self.phrase_syn)


# ---------------------------------------------------------------------------
# pp_mode transforms (reference dataloader.py:261-294)
#
# NOTE (reference parity): both modes transform only phrase_num /
# phrase_length; phrase_syn stays aligned to the ORIGINAL phrase slots —
# exactly as the reference's collate does (its pp_mode branches never touch
# phrase_label).  Syn supervision under pp_mode != 'phrase' is therefore
# slot-shifted there and here alike; these modes are used with syn-free
# training in practice.
# ---------------------------------------------------------------------------

def pp_mode_word(phrase_num, phrase_length):
    """All phrases become length-1 (word mode)."""
    total = np.array([phrase_length[i, :phrase_num[i]].sum()
                      for i in range(len(phrase_num))])
    out_len = np.zeros_like(phrase_length)
    for i, t in enumerate(total):
        out_len[i, :t] = 1
    return total.astype(phrase_num.dtype), out_len


def pp_mode_phrase2(phrase_num, phrase_length):
    """Merge single-word phrases into their successor (or predecessor at the
    tail) — reference 'phrase_2' (dataloader.py:273-294)."""
    pn2 = np.zeros_like(phrase_num)
    pl2 = np.zeros_like(phrase_length)
    for i in range(len(phrase_num)):
        cnt, it = 0, 0
        while it < phrase_num[i]:
            if phrase_length[i, it] > 1:
                pl2[i, cnt] = phrase_length[i, it]
                cnt += 1
                it += 1
            elif it + 1 < phrase_num[i]:
                pl2[i, cnt] = phrase_length[i, it] + phrase_length[i, it + 1]
                cnt += 1
                it += 2
            elif cnt > 0:
                pl2[i, cnt - 1] += phrase_length[i, it]
                it += 1
            else:
                pl2[i, cnt] = phrase_length[i, it]
                cnt += 1
                it += 1
        pn2[i] = cnt
    return pn2, pl2


# ---------------------------------------------------------------------------
# Sampler (reference MySampler, dataloader.py:595-647)
# ---------------------------------------------------------------------------

class SplitSampler:
    def __init__(self, index_list: np.ndarray, shuffle: bool, wrap: bool,
                 seed: int = 0):
        self.base = np.asarray(index_list)
        self.shuffle = shuffle
        self.wrap = wrap
        self.rng = np.random.RandomState(seed)
        self._reset()
        self.iter_counter = 0

    def _reset(self):
        self.index_list = self.base.copy()
        if self.shuffle:
            self.rng.shuffle(self.index_list)

    def next(self):
        wrapped = False
        if self.iter_counter >= len(self.index_list):
            self._reset()
            self.iter_counter = 0
            wrapped = True
        elem = (int(self.index_list[self.iter_counter]),
                self.iter_counter + 1, wrapped)
        self.iter_counter += 1
        return elem

    def state_dict(self):
        return {"index_list": self.index_list.copy(),
                "iter_counter": self.iter_counter}

    def load_state_dict(self, state):
        if state is None:
            return
        self.index_list = np.asarray(state["index_list"])
        self.iter_counter = int(state["iter_counter"])


# ---------------------------------------------------------------------------
# DataLoader equivalent
# ---------------------------------------------------------------------------

class _PrefetchError:
    """Sentinel carrying a worker exception across the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _BatchPrefetcher:
    """Background train-batch assembly (depth-N queue, one worker thread) —
    the device step and the host-side numpy assembly overlap instead of
    alternating (the reference gets the same overlap from 4 torch DataLoader
    worker processes, dataloader.py:536-548).

    Resume correctness: the sampler state snapshotted BEFORE each batch was
    drawn rides with it, and ``pending_state()`` reports the snapshot of the
    oldest batch the consumer has NOT yet received — i.e. checkpointed state
    behaves as if queued-but-unconsumed batches were never drawn.  The
    reference compensates for its worker prefetch the same way
    (dataloader.py:579-592)."""

    def __init__(self, assemble, snapshot, depth: int = 2):
        import collections
        import queue
        import threading
        self._assemble = assemble
        self._snapshot = snapshot
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._pending = collections.deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import queue
        while not self._stop.is_set():
            with self._lock:
                snap = self._snapshot()
                self._pending.append(snap)
            try:
                batch = self._assemble()
            except BaseException as e:  # re-raised in get(), like torch workers
                batch = _PrefetchError(e)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, _PrefetchError):
                return

    def get(self):
        import queue
        while True:
            try:
                batch = self._q.get(timeout=5)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "prefetch worker died without reporting an error")
        if isinstance(batch, _PrefetchError):
            raise batch.exc
        with self._lock:
            self._pending.popleft()
        return batch

    def pending_state(self):
        """Sampler state as-if no queued/in-flight batch had been drawn."""
        with self._lock:
            return self._pending[0] if self._pending else self._snapshot()

    def close(self):
        self._stop.set()
        # Drain-then-join until the thread actually exits: callers touch
        # sampler state right after close(), so a still-running _assemble()
        # must not race it (a blocked put() also needs the drain to unwedge).
        for _ in range(60):
            self._thread.join(timeout=1)
            if not self._thread.is_alive():
                return
            try:
                while True:
                    self._q.get_nowait()
            except Exception:
                pass
        raise RuntimeError("prefetch worker failed to exit within 60s")


class CaptionData:
    """get_batch(split) -> fixed-shape numpy batch (reference DataLoader,
    dataloader.py:524-592)."""

    def __init__(self, cfg, labels: Optional[LabelStore] = None,
                 features=None):
        self.cfg = cfg
        self.batch_size = cfg.get("batch_size", 10)
        self.seq_per_img = cfg.get("seq_per_img", 5)
        self.train_mode = cfg.get("train_mode", "AIC")
        self.pp_mode = cfg.get("preprocess_mode", "phrase")
        self.use_phrases = self.train_mode in PHRASE_MODES
        self.max_att_len = cfg.get("max_boxes", 100) or 100
        self.norm_att_feat = cfg.get("norm_att_feat", 0)
        self.use_fc = cfg.get("use_fc", True)

        if labels is None:
            if cfg.get("input_json") == "synthetic":
                labels = LabelStore.synthetic(L=cfg.get("max_length", 20))
            else:
                labels = LabelStore.from_files(
                    cfg.input_json, cfg.input_label_h5, self.use_phrases)
        self.labels = labels
        if features is None:
            att_dir = cfg.get("input_att_dir", "synthetic")
            if att_dir == "synthetic":
                features = SyntheticFeatures(
                    n_regions=min(36, self.max_att_len))
            else:
                features = FeatureReader(
                    att_dir, ".npz", in_memory=cfg.get("data_in_memory", False))
        self.features = features
        fc_dir = cfg.get("input_fc_dir", "")
        self.fc_reader = (FeatureReader(fc_dir, ".npy")
                          if fc_dir and fc_dir != "synthetic"
                          and os.path.exists(fc_dir) else None)
        # optional box geometry channel (reference dataloader.py:471-487):
        # appends [x1/w, y1/h, x2/w, y2/h, area-fraction] per region and
        # sorts regions by box size; att_feat_size is widened +5 by opts
        self.use_box = bool(cfg.get("use_box", 0))
        self.norm_box_feat = cfg.get("norm_box_feat", 0)
        box_dir = cfg.get("input_box_dir", "")
        self.box_reader = (FeatureReader(box_dir, ".npy")
                           if self.use_box and box_dir
                           and os.path.exists(box_dir) else None)
        if self.use_box and self.box_reader is None:
            raise ValueError(
                f"use_box=1 needs a readable input_box_dir "
                f"(got {box_dir!r}); att_feat_size is widened +5 for the "
                f"geometry channel")
        self.att_feat_dim = int(cfg.get("att_feat_size", 2048) or 2048)
        # fc fallback is the mean of the (possibly box-widened) att feats
        self.fc_feat_dim = (int(cfg.get("fc_feat_size", 2048) or 2048)
                            if self.fc_reader is not None
                            else self.att_feat_dim)

        self.seq_length = labels.seq_length
        self.vocab_size = labels.vocab_size
        self.ix_to_word = labels.ix_to_word

        self.split_ix: Dict[str, List[int]] = {"train": [], "val": [],
                                               "test": []}
        for ix, img in enumerate(labels.images):
            split = img.get("split", "train")
            if split in self.split_ix:
                self.split_ix[split].append(ix)
            elif cfg.get("train_only", 0) == 0:      # restval
                self.split_ix["train"].append(ix)
        self.samplers = {
            split: SplitSampler(np.array(ixs, np.int64),
                                shuffle=(split == "train"),
                                wrap=(split == "train"),
                                seed=cfg.get("seed", 0))
            for split, ixs in self.split_ix.items()
        }
        # one caption-sampling rng per split: the train prefetch thread and
        # main-thread val/test assembly must not share a stream (the
        # reference's torch workers each have their own rng state)
        self._cap_rngs = {
            split: np.random.RandomState(cfg.get("seed", 0) + 1 + k)
            for k, split in enumerate(("train", "val", "test"))
        }
        self.prefetch_depth = int(cfg.get("data_prefetch", 2) or 0)
        self._prefetcher: Optional[_BatchPrefetcher] = None

    # ------------------------------------------------------------- per-image
    def _image_feats(self, ix: int):
        img = self.labels.images[ix]
        att = self.features.get(str(img["id"]))
        att = att.reshape(-1, att.shape[-1])[: self.max_att_len]
        if self.norm_att_feat:
            att = att / np.linalg.norm(att, 2, 1, keepdims=True)
        if self.use_box and self.box_reader is not None:
            box = self.box_reader.get(str(img["id"]))
            box = box.reshape(-1, 4)[: att.shape[0]].astype(np.float32)
            w = float(img.get("width", 1) or 1)
            h = float(img.get("height", 1) or 1)
            x1, y1, x2, y2 = (box[:, k] for k in range(4))
            geom = np.stack([x1 / w, y1 / h, x2 / w, y2 / h,
                             (x2 - x1) * (y2 - y1) / (w * h)], axis=1)
            if self.norm_box_feat:
                geom = geom / np.linalg.norm(geom, 2, 1, keepdims=True)
            att = np.concatenate([att, geom.astype(np.float32)], axis=1)
            att = att[np.argsort(-att[:, -1], kind="stable")]
        if self.fc_reader is not None:
            fc = self.fc_reader.get(str(img["id"]))
        else:
            fc = att.mean(0)  # dataloader.py:492-495
        return fc.astype(np.float32), att.astype(np.float32)

    def _captions(self, ix: int, split: str = "train"):
        """Sample seq_per_img caption rows (reference get_captions_and_phrase,
        dataloader.py:203-229)."""
        st = self.labels
        rng = self._cap_rngs[split]
        # h5 pointers are uint32 (reference file format): cast before
        # arithmetic or i2 - n underflows and wraps
        i1 = int(st.label_start_ix[ix]) - 1
        i2 = int(st.label_end_ix[ix]) - 1
        ncap = i2 - i1 + 1
        n = self.seq_per_img
        if ncap < n:
            rows = np.array([rng.randint(i1, i2 + 1)
                             for _ in range(n)])
        else:
            lo = rng.randint(i1, i2 - n + 2)
            rows = np.arange(lo, lo + n)
        seq = st.labels[rows, : self.seq_length]
        if not self.use_phrases:
            return seq, None, None, None
        pn = st.phrase_num[rows].copy()
        pl = st.phrase_length[rows].copy()
        ps = st.phrase_syn[rows].copy()
        if self.pp_mode == "word":
            pn, pl = pp_mode_word(pn, pl)
        elif self.pp_mode == "phrase_2":
            pn, pl = pp_mode_phrase2(pn, pl)
        return seq, pn, pl, ps

    # ---------------------------------------------------------------- batch
    def get_batch(self, split: str) -> Dict[str, Any]:
        """Next fixed-shape batch; train batches come from the background
        prefetcher (``data_prefetch`` queue depth, 0 disables)."""
        if split == "train" and self.prefetch_depth > 0:
            if self._prefetcher is None:
                self._prefetcher = _BatchPrefetcher(
                    lambda: self._assemble_batch("train"),
                    self.samplers["train"].state_dict,
                    depth=self.prefetch_depth)
            return self._prefetcher.get()
        return self._assemble_batch(split)

    def _close_prefetcher(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def _assemble_batch(self, split: str) -> Dict[str, Any]:
        B = self.batch_size
        S = self.seq_per_img
        L = self.seq_length
        L2 = L + 2
        R = self.max_att_len
        sampler = self.samplers[split]

        fc = np.zeros((B, self.fc_feat_dim), np.float32)
        att = np.zeros((B, R, self.att_feat_dim), np.float32)
        att_masks = np.zeros((B, R), np.float32)
        labels = np.zeros((B, S, L2), np.int32)
        masks = np.zeros((B, S, L2), np.float32)
        pnum = np.zeros((B, S), np.int32)
        plen = np.zeros((B, S, L2), np.int32)
        psyn = np.zeros((B, S, L2), np.int32)
        gts, infos = [], []
        wrapped = False
        it_pos_now = 0

        for b in range(B):
            ix, it_pos_now, w = sampler.next()
            wrapped = wrapped or w
            fcb, attb = self._image_feats(ix)
            k = attb.shape[0]
            fc[b] = fcb[: self.fc_feat_dim]
            att[b, :k] = attb
            att_masks[b, :k] = 1.0
            seq, pn, pl, ps = self._captions(ix, split)
            labels[b, :, 1: L + 1] = seq
            labels[b, :, 0] = BOS
            labels[b, :, L + 1] = EOS
            nz = (seq != 0).sum(1) + 2            # dataloader.py:446-452
            for s in range(S):
                masks[b, s, : nz[s]] = 1.0
            if self.use_phrases:
                # bos/eos framing (dataloader.py:358-371)
                pnum[b] = pn + 1
                plen[b, :, 0] = 1
                psyn[b, :, 0] = BOS
                for s in range(S):
                    n = pn[s]
                    plen[b, s, 1: n + 1] = pl[s, :n]
                    psyn[b, s, 1: n + 1] = ps[s, :n]
                    psyn[b, s, n + 1] = EOS
            st = self.labels
            gts.append(st.labels[st.label_start_ix[ix] - 1:
                                 st.label_end_ix[ix]])
            img = st.images[ix]
            infos.append({"ix": ix, "id": img["id"],
                          "file_path": img.get("file_path", "")})

        data: Dict[str, Any] = {
            "fc_feats": fc, "att_feats": att, "att_masks": att_masks,
            "labels": labels, "masks": masks, "gts": gts, "infos": infos,
            "bounds": {"it_pos_now": it_pos_now,
                       "it_max": len(self.split_ix[split]),
                       "wrapped": wrapped},
        }
        if self.use_phrases:
            data.update(phrase_num=pnum, phrase_length=plen, phrase_syn=psyn)
            if self.train_mode == "PB_pad":
                from .pb_pack import pack_decoder_inputs, pack_gt
                lab2 = labels.reshape(-1, L2)
                pn2 = pnum.reshape(-1)
                pl2 = plen.reshape(-1, L2)
                packed, wmask = pack_gt(lab2, pn2, pl2)
                ids_p, slot_p, mask_p = pack_decoder_inputs(lab2, pn2, pl2)
                data.update(pb_labels=packed, pb_word_mask=wmask,
                            pb_ids=ids_p, pb_slot=slot_p, pb_mask=mask_p)
        return data

    def reset_iterator(self, split: str):
        if split == "train":
            self._close_prefetcher()
        self.samplers[split]._reset()
        self.samplers[split].iter_counter = 0

    def state_dict(self):
        out = {split: s.state_dict() for split, s in self.samplers.items()}
        if self._prefetcher is not None:
            # report the state as-if queued-but-unconsumed train batches had
            # never been drawn (see _BatchPrefetcher)
            out["train"] = self._prefetcher.pending_state()
        return out

    def load_state_dict(self, state):
        if not state:
            return
        self._close_prefetcher()
        for split, s in state.items():
            if split in self.samplers:
                self.samplers[split].load_state_dict(s)
