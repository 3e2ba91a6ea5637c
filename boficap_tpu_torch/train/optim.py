"""Optimizers and schedules: the port of the JAX package's
``train/optim.py`` (reference utils/misc.py:114-251, tools/train.py:106-196),
as plain tensor operations in optax's order of operations.

Three regimes, chosen as the reference chooses them:
  * ``noamopt``: Adam with the Noam rate factor * d^-0.5 *
    min(s^-0.5, s * warmup^-1.5), the schedule called with the count before
    the step (misc.py:160-199),
  * ``reduce_on_plateau``: the base optimizer with its rate scaled by
    ``PlateauTracker`` (misc.py:201-243),
  * plain: the staircase decay of ``epoch_lr`` and an optional linear
    warm-up, through the injected rate (``set_lr``).

Every transform mirrors one optax transform, and its state is a nested
dict laid out as flax writes the optax state: a tuple is a dict keyed
"0", "1", ...; an empty state is ``{}``; a moment shaped like the
parameters is a ``ParamTree`` (port parameter name -> tensor).  So
``Optimizer.state_tree`` is the JAX package's ``optimizer.ckpt`` tree,
and either package resumes the other's run (``train/state.py``).  Counts
are host ints and the injected rate a host float (rounded to float32, as
optax stores it): a step reads neither back from the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..convert import named_from_tree, tree_from_named


class ParamTree(dict):
    """An optimizer state leaf shaped like the parameters (optax's ``mu``,
    ``nu``, ``trace``, ``sum_of_squares``): parameter name -> tensor."""


def _f32(x: float) -> float:
    """x rounded to float32, as optax holds a rate."""
    return float(np.float32(x))


def _zeros_like(names, params, fill: float = 0.0) -> ParamTree:
    return ParamTree((n, torch.full_like(p, fill, dtype=torch.float32))
                     for n, p in zip(names, params))


class Transform:
    """One optax gradient transformation: ``init(names, params) -> state``
    and ``update(updates, state, params) -> (updates, state)`` over lists
    of tensors in ``names``' order."""

    def init(self, names: List[str], params: List[torch.Tensor]):
        return {}

    def update(self, updates, state, params):
        raise NotImplementedError


class Identity(Transform):
    def update(self, updates, state, params):
        return updates, state


class Clip(Transform):
    """optax.clip: each value into [-v, v]."""

    def __init__(self, v: float):
        self.v = v

    def update(self, updates, state, params):
        u = torch._foreach_clamp_min(updates, -self.v)
        return torch._foreach_clamp_max(u, self.v), state


def global_norm(tensors, params=()) -> torch.Tensor:
    """The norm of all ``tensors``; where ``params`` (aligned with them)
    holds tensor-parallel slices (``tp_group`` set by
    ``parallel.shard_params``), their squares are summed over the slices'
    group first, so the norm is the whole model's."""
    groups = [getattr(p, "tp_group", None) for p in params]
    if not any(g is not None for g in groups):
        return torch.sqrt(sum((t * t).sum() for t in tensors))
    whole = sum((t * t).sum() for t, g in zip(tensors, groups) if g is None)
    sliced = sum((t * t).sum() for t, g in zip(tensors, groups)
                 if g is not None)
    torch.distributed.all_reduce(sliced, group=next(
        g for g in groups if g is not None))
    return torch.sqrt(whole + sliced)


class ClipByGlobalNorm(Transform):
    """optax.clip_by_global_norm: ``t / norm * v`` when the global norm is
    at or above v."""

    def __init__(self, v: float):
        self.v = v

    def update(self, updates, state, params):
        g_norm = global_norm(updates, params)
        keep = g_norm < self.v
        return [torch.where(keep, t, (t / g_norm) * self.v)
                for t in updates], state


class AddDecayedWeights(Transform):
    """The torch-style coupled L2: g + wd * p."""

    def __init__(self, wd: float):
        self.wd = wd

    def update(self, updates, state, params):
        return torch._foreach_add(updates, torch._foreach_mul(
            params, self.wd)), state


def _moment(updates, t, decay: float, order: int):
    """optax ``update_moment`` (order 1) / ``update_moment_per_elem_norm``
    (order 2): (1 - decay) * g^order + decay * t."""
    g = updates if order == 1 else torch._foreach_mul(updates, updates)
    return torch._foreach_add(torch._foreach_mul(g, 1.0 - decay),
                              torch._foreach_mul(t, decay))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class ScaleByAdam(Transform):
    """optax.scale_by_adam: eps outside the sqrt, bias-corrected moments."""

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, names, params):
        return {"count": 0, "mu": _zeros_like(names, params),
                "nu": _zeros_like(names, params)}

    def update(self, updates, state, params):
        names = list(state["mu"])
        mu = _moment(updates, list(state["mu"].values()), self.b1, 1)
        nu = _moment(updates, list(state["nu"].values()), self.b2, 2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(self.b2, count))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        return torch._foreach_div(mu_hat, den), {
            "count": count, "mu": ParamTree(zip(names, mu)),
            "nu": ParamTree(zip(names, nu))}


class Scale(Transform):
    """optax.scale_by_learning_rate of a constant rate: g * -lr."""

    def __init__(self, lr: float):
        self.lr = lr

    def update(self, updates, state, params):
        return torch._foreach_mul(updates, -self.lr), state


class ScaleBySchedule(Transform):
    """optax.scale_by_learning_rate of a schedule: g * -sched(count), the
    count taken before it is incremented."""

    def __init__(self, sched: Callable[[int], float]):
        self.sched = sched

    def init(self, names, params):
        return {"count": 0}

    def update(self, updates, state, params):
        step = -self.sched(state["count"])
        return torch._foreach_mul(updates, step), {
            "count": state["count"] + 1}


class Trace(Transform):
    """optax.trace: t = g + decay * t; nesterov returns g + decay * t."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, names, params):
        return {"trace": _zeros_like(names, params)}

    def update(self, updates, state, params):
        names = list(state["trace"])
        new = torch._foreach_add(updates, torch._foreach_mul(
            list(state["trace"].values()), self.decay))
        out = (torch._foreach_add(updates, torch._foreach_mul(
            new, self.decay)) if self.nesterov else new)
        return out, {"trace": ParamTree(zip(names, new))}


class ScaleByRms(Transform):
    """optax.scale_by_rms (initial scale 0, eps inside the sqrt)."""

    def __init__(self, decay: float, eps: float):
        self.decay, self.eps = decay, eps

    def init(self, names, params):
        return {"nu": _zeros_like(names, params)}

    def update(self, updates, state, params):
        names = list(state["nu"])
        nu = _moment(updates, list(state["nu"].values()), self.decay, 2)
        scaling = torch._foreach_reciprocal(torch._foreach_sqrt(
            torch._foreach_add(nu, self.eps)))
        return torch._foreach_mul(scaling, updates), {
            "nu": ParamTree(zip(names, nu))}


class ScaleByRss(Transform):
    """optax.scale_by_rss (optax.adagrad's accumulator 0.1, eps 1e-7)."""

    def __init__(self, initial: float = 0.1, eps: float = 1e-7):
        self.initial, self.eps = initial, eps

    def init(self, names, params):
        return {"sum_of_squares": _zeros_like(names, params, self.initial)}

    def update(self, updates, state, params):
        names = list(state["sum_of_squares"])
        s = torch._foreach_add(torch._foreach_mul(updates, updates),
                               list(state["sum_of_squares"].values()))
        inv = [torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0) for t in s]
        return torch._foreach_mul(inv, updates), {
            "sum_of_squares": ParamTree(zip(names, s))}


class Chain(Transform):
    """optax.chain: state {"0": ..., "1": ...}."""

    def __init__(self, *parts: Transform):
        self.parts = parts

    def init(self, names, params):
        return {str(i): t.init(names, params)
                for i, t in enumerate(self.parts)}

    def update(self, updates, state, params):
        new = {}
        for i, t in enumerate(self.parts):
            updates, new[str(i)] = t.update(updates, state[str(i)], params)
        return updates, new


class InjectLearningRate(Transform):
    """optax.inject_hyperparams over the learning rate: the state holds the
    rate (``set_lr`` changes it between steps) and the inner transform is
    rebuilt around the current rate at each update."""

    def __init__(self, make: Callable[[float], Transform], lr: float):
        self.make, self.lr = make, lr

    def init(self, names, params):
        return {"count": 0, "hyperparams": {"learning_rate": _f32(self.lr)},
                "hyperparams_states": {},
                "inner_state": self.make(self.lr).init(names, params)}

    def update(self, updates, state, params):
        lr = state["hyperparams"]["learning_rate"]
        updates, inner = self.make(lr).update(updates, state["inner_state"],
                                              params)
        return updates, {"count": state["count"] + 1,
                         "hyperparams": dict(state["hyperparams"]),
                         "hyperparams_states": {}, "inner_state": inner}


class FusedAdam(Transform):
    """The JAX package's ``fused_adam``: Adam over FLAT float32 moments [P]
    in the flax tree's flatten order (keys sorted, each leaf in C order of
    its flax shape), with the value clip and coupled decay folded in; the
    element math of ScaleByAdam, and a schedule called with the count
    before the step."""

    def __init__(self, lr, b1: float, b2: float, eps: float,
                 clip_value: float = 0.0, weight_decay: float = 0.0,
                 layout=None):
        if layout is None:
            raise ValueError("FusedAdam needs the parameters' flax layout")
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.clip_value, self.weight_decay = clip_value, weight_decay
        # (flax path, position in the layout's order, transposed), sorted:
        # the flat moments' order
        self.order = sorted((path, i, tr) for i, (path, tr)
                            in enumerate(layout.values()))

    def flatten(self, tensors) -> torch.Tensor:
        return torch.cat([(tensors[i].t() if tr else tensors[i]).reshape(-1)
                          .float() for _, i, tr in self.order])

    def unflatten(self, flat, like) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * len(like)
        off = 0
        for _, i, tr in self.order:
            t = like[i]
            n = t.numel()
            piece = flat[off:off + n]
            out[i] = (piece.reshape(t.shape[::-1]).t() if tr
                      else piece.reshape(t.shape)).to(t.dtype)
            off += n
        return out

    def init(self, names, params):
        P = sum(p.numel() for p in params)
        dev = params[0].device
        return {"count": 0,
                "mu": torch.zeros(P, dtype=torch.float32, device=dev),
                "nu": torch.zeros(P, dtype=torch.float32, device=dev)}

    def update(self, updates, state, params):
        g = self.flatten(updates)
        if self.clip_value:
            g = g.clamp(-self.clip_value, self.clip_value)
        if self.weight_decay:
            g = g + self.weight_decay * self.flatten(params)
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        count = state["count"] + 1
        mu = self.b1 * state["mu"] + (1.0 - self.b1) * g
        nu = self.b2 * state["nu"] + (1.0 - self.b2) * (g * g)
        mu_hat = mu / _bias_correction(self.b1, count)
        nu_hat = nu / _bias_correction(self.b2, count)
        upd = -lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return self.unflatten(upd, updates), {
            "count": count, "mu": mu, "nu": nu}


# ---------------------------------------------------------------------------
# the JAX package's optimizer constructors
# ---------------------------------------------------------------------------

def noam_schedule(d_model: int, factor: float, warmup: int
                  ) -> Callable[[int], float]:
    """The NoamOpt rate of the pre-increment count (step counted from 1,
    misc.py:183-189), in float32 as the JAX package computes it."""
    scale = factor * (d_model ** -0.5)
    w = warmup ** -1.5

    def sched(step: int) -> float:
        s = np.float32(max(step + 1, 1))
        return float(np.float32(scale) * np.minimum(
            s ** np.float32(-0.5), s * np.float32(w)))
    return sched


def make_base_opt(cfg, lr: float) -> Transform:
    """The reference build_optimizer (misc.py:114-130): 'sgd' is plain,
    'sgdm' / 'sgdmom' the momentum / nesterov variants (momentum
    optim_alpha), and weight_decay the coupled L2 for all but 'adamw'."""
    kind = cfg.get("optim", "adam")
    b1 = cfg.get("optim_alpha", 0.9)
    b2 = cfg.get("optim_beta", 0.999)
    eps = cfg.get("optim_epsilon", 1e-8)
    wd = cfg.get("weight_decay", 0)

    def l2(base):
        return Chain(AddDecayedWeights(wd), base) if wd else base

    if kind == "adam":
        return l2(Chain(ScaleByAdam(b1, b2, eps), Scale(lr)))
    if kind == "adamw":
        return Chain(ScaleByAdam(b1, b2, eps), AddDecayedWeights(wd),
                     Scale(lr))
    if kind == "sgd":
        return l2(Chain(Identity(), Scale(lr)))
    if kind == "sgdm":
        return l2(Chain(Trace(b1), Scale(lr)))
    if kind == "sgdmom":
        return l2(Chain(Trace(b1, nesterov=True), Scale(lr)))
    if kind == "rmsprop":
        return l2(Chain(ScaleByRms(b1, eps), Scale(lr), Identity()))
    if kind == "adagrad":
        return l2(Chain(ScaleByRss(), Scale(lr)))
    raise ValueError(f"unknown optim {kind}")


def build_optimizer(cfg, layout) -> Transform:
    """The whole transform, value clip (or global-norm clip) first, as the
    JAX package's ``build_optimizer``; ``layout`` is
    ``convert.flax_layout(model)`` (the fused moments' order)."""
    clip_value = cfg.get("grad_clip_value", 0.1)
    value_clip = cfg.get("grad_clip_mode", "value") != "norm"
    fused = (cfg.get("fused_optimizer", False)
             and cfg.get("optim", "adam") == "adam")
    clip = Clip(clip_value) if value_clip else ClipByGlobalNorm(clip_value)

    def adam_like(lr, b1, b2, eps, wd=0.0):
        if fused:
            fa = FusedAdam(lr, b1, b2, eps,
                           clip_value if value_clip else 0.0, wd, layout)
            return fa if value_clip else Chain(clip, fa)
        scale = ScaleBySchedule(lr) if callable(lr) else Scale(lr)
        base = Chain(ScaleByAdam(b1, b2, eps), scale)
        if wd:
            base = Chain(AddDecayedWeights(wd), base)
        return Chain(clip, base)

    if cfg.get("noamopt", False):
        sched = noam_schedule(cfg.d_model, cfg.get("noamopt_factor", 1.0),
                              cfg.get("noamopt_warmup", 2000))
        return adam_like(sched, 0.9, 0.98, 1e-9)

    def with_lr(lr):
        if fused:
            return adam_like(lr, cfg.get("optim_alpha", 0.9),
                             cfg.get("optim_beta", 0.999),
                             cfg.get("optim_epsilon", 1e-8),
                             cfg.get("weight_decay", 0))
        return Chain(clip, make_base_opt(cfg, lr))

    return InjectLearningRate(with_lr, cfg.get("learning_rate", 5e-4))


def set_lr(state: Dict[str, Any], lr: float) -> Dict[str, Any]:
    """Set the injected learning rate (a no-op for the noam schedule,
    whose state holds none)."""
    if "hyperparams" in state:
        state["hyperparams"]["learning_rate"] = _f32(lr)
    return state


class Optimizer:
    """A transform bound to a model's parameters: ``step(grads)`` updates
    them in place (optax.apply_updates), ``state`` is the transform's
    state, ``state_tree`` / ``load_state_tree`` its flax form."""

    def __init__(self, tx: Transform, model: torch.nn.Module, layout):
        self.tx = tx
        self.layout = layout
        named = dict(model.named_parameters())
        self.names = list(layout)
        self.params = [named[n] for n in self.names]
        with torch.no_grad():
            self.state = tx.init(self.names, self.params)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (in ``names``' order)."""
        updates, self.state = self.tx.update(list(grads), self.state,
                                             self.params)
        torch._foreach_add_(self.params, updates)

    def set_lr(self, lr: float) -> None:
        set_lr(self.state, lr)

    def state_tree(self) -> Dict[str, Any]:
        """The state as the JAX package's ``optimizer.ckpt`` tree."""
        def conv(x):
            if isinstance(x, ParamTree):
                return tree_from_named(x, self.layout)
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                return x.detach().float().cpu().numpy()
            return np.asarray(x, np.int32 if isinstance(x, int)
                              else np.float32)
        return conv(self.state)

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Restore from an ``optimizer.ckpt`` tree.  A tree of another
        structure (another optimizer or schedule) raises ``ValueError``
        and leaves the state as it was."""
        def conv(tmpl, x, path):
            if isinstance(tmpl, ParamTree):
                try:
                    arrs = named_from_tree(x, self.layout)
                except (KeyError, TypeError, AttributeError) as e:
                    raise ValueError(f"{path}: {e}") from None
                out = ParamTree()
                for n, t in tmpl.items():
                    a = arrs[n]
                    if tuple(a.shape) != tuple(t.shape):
                        raise ValueError(f"{path}/{n}: shape {a.shape} != "
                                         f"{tuple(t.shape)}")
                    out[n] = torch.from_numpy(a).to(t.device)
                return out
            if isinstance(tmpl, dict):
                if not isinstance(x, dict) or set(x) != set(tmpl):
                    got = sorted(x) if isinstance(x, dict) else type(x)
                    raise ValueError(f"{path or '/'}: keys {got} != "
                                     f"{sorted(tmpl)}")
                return {k: conv(tmpl[k], x[k], f"{path}/{k}") for k in tmpl}
            a = np.asarray(x)
            if isinstance(tmpl, int):
                return int(a)
            if isinstance(tmpl, float):
                return float(a)
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"{path}: shape {a.shape} != "
                                 f"{tuple(tmpl.shape)}")
            return torch.from_numpy(np.array(a, np.float32)).to(tmpl.device)
        self.state = conv(self.state, tree, "")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def epoch_lr(cfg, epoch: int) -> float:
    """Staircase decay (train.py:151-157)."""
    lr = cfg.get("learning_rate", 5e-4)
    start = cfg.get("learning_rate_decay_start", -1)
    if start >= 0 and epoch > start:
        frac = (epoch - start) // cfg.get("learning_rate_decay_every", 3)
        lr = lr * cfg.get("learning_rate_decay_rate", 0.8) ** frac
    return lr


def scheduled_sampling_prob(cfg, epoch: int) -> float:
    """ss_prob anneal (train.py:159-162)."""
    start = cfg.get("scheduled_sampling_start", -1)
    if start < 0 or epoch < start:
        return 0.0
    frac = (epoch - start) // cfg.get("scheduled_sampling_increase_every",
                                      5) + 1
    return min(cfg.get("scheduled_sampling_increase_prob", 0.05) * frac,
               cfg.get("scheduled_sampling_max_prob", 0.25))


def glat_rate(cfg, epoch: int) -> float:
    """Glancing unmask-rate anneal (train.py:164-171); -1 turns it off."""
    if not cfg.get("glancing_token", False):
        return -1.0
    start = cfg.get("unmasked_rate_decay_start", -1)
    r0 = cfg.get("unmasked_rate_start", 0.5)
    if start < 0 or epoch < start:
        return r0
    frac = (epoch - start) // cfg.get("unmasked_rate_decay_every", 1) + 1
    return max(r0 - frac * cfg.get("unmasked_rate_decay_rate", 0.1),
               cfg.get("unmasked_rate_end", 0.1))


class PlateauTracker:
    """Host-side ReduceLROnPlateau (misc.py:201-243): the rate times
    ``factor`` when the score has not improved for ``patience`` checks."""

    def __init__(self, factor: float = 0.5, patience: int = 3):
        self.factor = factor
        self.patience = patience
        self.best: Optional[float] = None
        self.bad = 0
        self.scale = 1.0

    def update(self, score: float) -> float:
        if self.best is None or score > self.best:
            self.best = score
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale *= self.factor
                self.bad = 0
        return self.scale

    def state_dict(self):
        return {"best": self.best, "bad": self.bad, "scale": self.scale}

    def load_state_dict(self, s):
        self.best, self.bad, self.scale = s["best"], s["bad"], s["scale"]
