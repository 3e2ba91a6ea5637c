"""The system under test, as the benchmark reaches it: the port
(``boficap_tpu_torch``) built from a benchmark configuration and handed the
benchmark's weights and data.  Nothing here computes a number the
benchmark reports; it only builds and calls the program."""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

# the benchmark configuration's keys that are the program's config keys
MODEL_KEYS = ("caption_model", "train_mode", "N_enc", "N_dec", "N_len",
              "d_model", "d_ff", "num_att_heads", "dropout", "drop_prob_lm",
              "max_boxes", "att_feat_size", "max_length",
              "decoder_input_mode", "self_dis", "dtype", "use_pallas",
              "noamopt", "noamopt_warmup", "noamopt_factor", "learning_rate",
              "label_smoothing", "seq_per_img", "batch_size",
              "preprocess_mode", "scheduled_sampling_start",
              "learning_rate_decay_start", "train_sample_n", "remat",
              "grad_clip_mode", "grad_clip_value")


def program_config(cfg: dict, **override):
    from boficap_tpu_torch.config import make_config
    fields = {k: cfg[k] for k in MODEL_KEYS if k in cfg}
    fields.update(override)
    return make_config(**fields)


def entry(dotted: str):
    """The program's function at ``package.module.function``."""
    module, name = dotted.rsplit(".", 1)
    if module.split(".", 1)[0] != "boficap_tpu_torch":
        raise ValueError(f"{dotted!r} is not a function of the port")
    return getattr(importlib.import_module(module), name)


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's model of ``cfg`` with ``weights`` copied in (every
    parameter, strictly by name)."""
    from boficap_tpu_torch.models import setup
    model = setup(program_config(cfg), cfg["vocab_size"], device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


class HostFeatures:
    """Region features held in host memory, read by the program's loader
    by image id: image i's live rows."""

    def __init__(self, att: np.ndarray, live: np.ndarray):
        self.att, self.live = att, live

    def get(self, key: str) -> np.ndarray:
        i = int(key)
        return self.att[i, :self.live[i]]


def caption_data(cfg: dict, corpus: Dict[str, np.ndarray], feats,
                 images_per_step: int, seed: int):
    """The program's training loader (``data/dataset.py::CaptionData``)
    over the benchmark's corpus (every image in the train split, its
    captions in order) and features."""
    from boficap_tpu_torch.data.dataset import CaptionData, LabelStore
    n_caps = corpus["labels"].shape[0]
    k = cfg["seq_per_img"]
    n = n_caps // k
    start = np.arange(n, dtype=np.int64) * k + 1
    store = LabelStore(
        [{"id": i, "split": "train", "file_path": f"{i}.jpg"}
         for i in range(n)],
        {str(i + 4): f"w{i}" for i in range(cfg["vocab_size"])},
        corpus["labels"], start, start + k - 1, corpus["phrase_num"],
        corpus["phrase_length"], corpus["phrase_syn"])
    pcfg = program_config(cfg, batch_size=images_per_step, seed=seed)
    return CaptionData(pcfg, labels=store, features=feats)


def xe_trainer(cfg: dict, model):
    """The program's optimizer over ``model`` and its XE step, as the
    training CLI builds them; returns (optimizer, step)."""
    from boficap_tpu_torch.convert import flax_layout
    from boficap_tpu_torch.train import optim, steps
    pcfg = program_config(cfg)
    layout = flax_layout(model)
    opt = optim.Optimizer(optim.build_optimizer(pcfg, layout), model, layout)
    step = steps.make_xe_step(model, opt,
                              label_smoothing=pcfg.label_smoothing)
    return opt, step


def xe_step(step, batch, rng, device):
    """One loader batch through the program's XE step."""
    from boficap_tpu_torch.train import steps
    return steps.run_xe_step(step, batch, rng, device=device)


def adam_first_moment(opt) -> Dict[str, torch.Tensor]:
    """The optimizer's first moments by leaf name, read from its state."""
    def find(state):
        if isinstance(state, dict):
            if "mu" in state and isinstance(state["mu"], dict):
                return state["mu"]
            for v in state.values():
                got = find(v)
                if got is not None:
                    return got
        return None
    mu = find(opt.state)
    if mu is None:
        raise ValueError("the optimizer's state holds no Adam moments")
    return dict(mu)
