"""Shared set-up of the port's parity tests: one tiny BoFiCap built by the
JAX package and the same weights loaded into the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boficap_tpu.models.boficap import build_model as jax_build_model
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import load_jax_params
from boficap_tpu_torch.models.boficap import build_model as torch_build_model
from tests.test_model import tiny_cfg

torch.set_num_threads(2)

VOCAB = 46          # + 4 control ids = 50 output classes
L = 8               # max_length
R = 5               # regions


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def make_pair(train_mode: str = "UIC", input_mode: str = "add",
              seed: int = 0, n_len: int = 1, dtype: str = "float32",
              vocab: int = VOCAB, **fields):
    """(jax_model, jax_params, torch_model) on shared weights, both built
    for the compute ``dtype`` over ``vocab`` words; ``fields`` (e.g.
    dropout, drop_prob_lm) set in both configs.  The length and syntax
    heads' biases (where the train_mode has them; AIC has none) are nudged
    (in numpy, before both models get them) so the random model plans
    non-empty captions of varied length (PB_pad has no syntax head);
    NNAIC's length head's too, so its lengths spread over 0..L-1."""
    cfg = tiny_cfg(train_mode, N_len=n_len)
    cfg.max_length = L
    cfg.decoder_input_mode = input_mode
    cfg.dtype = dtype
    cfg.update(fields)
    jm = jax_build_model(cfg, vocab)
    Lp = L + 2
    z = jnp.zeros((2, Lp), jnp.int32)
    init = jax.jit(lambda k, a, m, n: jm.init(
        {"params": k}, a, m, z, n, z, z, glat_p=-1.0, deterministic=True))
    params = init(jax.random.PRNGKey(seed), jnp.zeros((2, R, 2048)),
                  jnp.ones((2, R)), jnp.ones((2,), jnp.int32))
    tree = to_numpy_tree(jax.device_get(params))
    rs = np.random.RandomState(seed + 100)
    p = tree["params"]
    if "len_head2" in p:
        # PB_pad stops at a predicted length 0 (the others' plans stop on
        # the syntax head): away from it, toward 1-4 word phrases
        lead = ([-1.0] + [1.5] * 4 if train_mode == "PB_pad"
                else [1.0] + [1.5] * 3)
        p["len_head2"]["bias"] = (p["len_head2"]["bias"]
                                  + np.array(lead + [0.0] * (20 - len(lead)),
                                             np.float32)
                                  + rs.randn(20).astype(np.float32) * 0.5)
    if "syn_head2" in p:
        p["syn_head2"]["bias"] = (p["syn_head2"]["bias"]
                                  + np.array([0] * 4 + [2.0] * 3 + [0] * 3,
                                             np.float32))
    if "nn_len_l2" in p:
        # NNAIC's whole-caption length head: toward 0 and L - 1 and away
        # from its random favourite, so lengths spread over 0..L-1
        nudge = np.zeros(L, np.float32)
        nudge[[0, 2, -1]] = (0.15, -0.12, 0.12)
        p["nn_len_l2"]["bias"] = p["nn_len_l2"]["bias"] + nudge
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tcfg = make_config(**{k: cfg[k] for k in (
        "train_mode", "N_enc", "N_dec", "N_len", "d_model", "d_ff",
        "num_att_heads", "max_length", "decoder_input_mode",
        "att_feat_size", "max_boxes", "dtype")}, **fields)
    tm = torch_build_model(tcfg, vocab, device="cpu")
    load_jax_params(tm, tree)
    return jm, params, tm


def make_feats(B: int = 3, seed: int = 0):
    """Region features [B, R, 2048] and masks [B, R] (sample 0 padded)."""
    rs = np.random.RandomState(seed)
    att = rs.randn(B, R, 2048).astype(np.float32)
    am = np.ones((B, R), np.float32)
    am[0, -2:] = 0
    return att, am
