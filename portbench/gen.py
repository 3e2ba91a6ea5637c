"""The benchmark's input generators, frozen copies made from ``--seed``.

Every input of a run comes from here, so that a later change to the program
cannot move the yardstick:

* ``make_weights``: every parameter in the initialisers' law (Xavier-uniform
  matrices and tables, zero biases, unit norm scales), the law of the
  program's ``convert.fill_random``; drawn on the device in one call of
  ``torch.rand`` and cut into leaves.
* ``nudge_plans``: the length- and syntax-head bias nudge of
  ``chip_smoke.build`` (random weights otherwise plan empty captions for
  every image): the length head toward 1-3 word phrases with seeded noise,
  the syntax head toward the VP / NP / CP ids.
* ``make_store``: region features and masks in the law of
  ``chip_smoke.features``: standard normal features, 10 to R live regions
  an image, the rest padding.
* ``make_corpus``: caption labels with phrase plans in the arithmetic of
  the program's ``data/dataset.py::LabelStore.synthetic`` (a total length
  of 4 to L words, phrases of 1-5 words, syntax ids VP / NP / CP), drawn
  with numpy from the seed.

A seed is any whole number below 2**63; each input takes a generator of
its own, seeded from the run's seed and the input's name, so one input's
size never shifts another's values.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import boficap_ref


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the input ``what`` of the run seeded ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def make_weights(shapes: List[Tuple[str, tuple]], laws: Dict[str, str],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``shapes``, in ``laws``
    ('xavier', 'zero', 'one'): the Xavier leaves are views of one flat
    buffer drawn in a single ``torch.rand`` call."""
    xavier = [(n, s) for n, s in shapes if laws[n] == "xavier"]
    total = sum(math.prod(s) for _, s in xavier)
    flat = torch.rand(total, generator=generator(seed, "weights", device),
                      device=device)
    out, at = {}, 0
    for name, shape in xavier:
        n = math.prod(shape)
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = flat[at:at + n].view(shape).mul_(2 * bound).sub_(bound)
        at += n
    for name, shape in shapes:
        if laws[name] == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif laws[name] == "one":
            out[name] = torch.ones(shape, device=device)
    return {name: out[name] for name, _ in shapes}


def model_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration's model (``param_shapes`` of
    the reference) from the seed, nudged where the configuration's
    ``assumed`` names the plan nudge."""
    shapes = boficap_ref.param_shapes(cfg)
    laws = {n: boficap_ref.param_law(n) for n, _ in shapes}
    weights = make_weights(shapes, laws, seed, device)
    if "plan_nudge" in cfg.get("assumed", {}):
        nudge_plans(weights, seed)
    return weights


@torch.no_grad()
def nudge_plans(weights: Dict[str, torch.Tensor], seed: int) -> None:
    """``chip_smoke.build``'s nudge, in place: length-head bias
    [-1, 1.5, 1.5, 1.5, 0 ...] plus 0.3 x standard normal noise; syntax-head
    bias +2 on the VP / NP / CP ids (4-6)."""
    b = weights["len_head2.bias"]
    g = generator(seed, "nudge", b.device)
    nudge = torch.tensor([-1.0] + [1.5] * 3 + [0.0] * 16, device=b.device)
    b += nudge + 0.3 * torch.randn(20, generator=g, device=b.device)
    weights["syn_head2.bias"] += torch.tensor(
        [0.0] * 4 + [2.0] * 3 + [0.0] * 3, device=b.device)


def make_store(n: int, regions: int, feat: int, live_min: int, seed: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features [n, regions, feat] float32 and masks [n, regions] float32
    (1 on the first k regions, k drawn from live_min..regions)."""
    g = generator(seed, "store", device)
    att = torch.randn((n, regions, feat), generator=g, device=device)
    live = torch.randint(live_min, regions + 1, (n,), generator=g,
                         device=device)
    am = (torch.arange(regions, device=device)[None, :]
          < live[:, None]).float()
    return att, am


def make_corpus(n_images: int, vocab_size: int, L: int, caps_per_img: int,
                seed: int) -> Dict[str, np.ndarray]:
    """``LabelStore.synthetic``'s arithmetic over the whole vocabulary:
    labels [n_caps, L] int32 (word ids from 4), phrase_num [n_caps],
    phrase_length and phrase_syn [n_caps, L]; caption i belongs to image
    i // caps_per_img."""
    rng = np.random.RandomState(sub_seed(seed, "corpus") % (2 ** 32))
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
    return {"labels": labels, "phrase_num": pn, "phrase_length": pls,
            "phrase_syn": syns}
