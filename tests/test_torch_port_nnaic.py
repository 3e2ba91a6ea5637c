"""Port parity, NNAIC (the naive NA baseline): the whole-caption length
head ``nnaic_length``, ``nnaic_decode`` on the plain path and on the
kernel wrappers' plain twins, and the teacher-forced forward, against the
JAX package on shared weights (CPU, float32).  Lengths and ``seq``
identical, log-probs within 1e-5.  The XE step: ``MODES`` of
``tests/test_torch_port_train.py``.

``make_pair`` nudges the length head's bias, so the lengths of these
features spread from 0 (every key masked: each row's attention is the
uniform softmax over the L keys) to L - 1, the longest class."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu_torch.constants import BOS, EOS, PAD
from boficap_tpu_torch.convert import load_jax_params, to_jax_tree
from boficap_tpu_torch.decode import bound_fill as tbf
from tests._torch_port_util import L, R, make_feats, make_pair, to_numpy_tree

B = 4
TOL = 1e-5


@pytest.fixture(scope="module")
def nnaic():
    jm, params, tm = make_pair("NNAIC", seed=0)
    att, am = make_feats(B=B, seed=1)
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    return dict(jm=jm, params=params, tm=tm, att=att, am=am, jmem=jmem,
                tmem=tmem)


def _same(got, want):
    for k in ("seq", "length"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("tok_logprobs", "entropy"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def _jax_decode(s, **kw):
    out = jbf.nnaic_decode(s["jm"], s["params"], jax.random.PRNGKey(0),
                           s["jmem"], jnp.asarray(s["am"]).astype(bool), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_decode(s, fused: bool):
    tm, am = s["tm"], torch.from_numpy(s["am"])
    mem = (tbf.fused_encode(tm, torch.from_numpy(s["att"]), am) if fused
           else s["tmem"])
    out = tbf.nnaic_decode(tm, mem, am.bool(), fused_fill=fused)
    return {k: v.numpy() for k, v in out.items()}


def test_nnaic_length_matches_jax(nnaic):
    """The length head's argmax, lengths 0 and L - 1 among them."""
    s = nnaic
    want = np.asarray(s["jm"].apply(s["params"], s["jmem"],
                                    method="nnaic_length"))
    got = s["tm"].nnaic_length(s["tmem"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 in got and L - 1 in got


@pytest.mark.parametrize("fused", [False, True])
def test_nnaic_decode_matches_jax(nnaic, fused):
    """The port's plain path, and its kernel route (the encoder, the A
    stack and the greedy head on their plain twins), against JAX's plain
    decode: past the length seq is PAD, tok_logprobs lp[:, PAD] and
    entropy the row's, on both routes."""
    want = _jax_decode(nnaic)
    got = _port_decode(nnaic, fused)
    _same(got, want)
    past = np.arange(L)[None, :] >= got["length"][:, None]
    assert (got["seq"][past] == PAD).all() and (got["seq"][~past] > 3).any()
    assert (got["tok_logprobs"][past] < 0).all()
    assert (got["entropy"] > 0).all()


@pytest.mark.parametrize("stacked", [False, True])
def test_jax_fused_nnaic_matches_port_plain(nnaic, stacked):
    """JAX's nnaic_decode on its Pallas kernels in interpret mode (as
    tests/test_pallas.py runs it) against the port's plain path."""
    want = _jax_decode(nnaic, fused_fill=True, fused_interpret=True,
                       stacked=stacked)
    _same(_port_decode(nnaic, False), want)


def test_nnaic_forward_matches_jax(nnaic):
    """The teacher-forced forward (BOS inputs under the keep mask, the
    length head on the memory repeated to the caption rows): logprob
    within 1e-5, length_pred identical."""
    s = nnaic
    rs = np.random.RandomState(3)
    labels = np.full((B * 2, L + 2), PAD, np.int64)
    labels[:, 0] = BOS
    for i, n in enumerate(rs.randint(0, L + 1, size=B * 2)):
        labels[i, 1:n + 1] = rs.randint(4, 50, size=n)
        labels[i, n + 1] = EOS
    want = s["jm"].apply(s["params"], jnp.asarray(s["att"]),
                         jnp.asarray(s["am"]), jnp.asarray(labels, jnp.int32),
                         glat_p=-1.0, deterministic=True)
    with torch.no_grad():
        got = s["tm"](torch.from_numpy(s["att"]), torch.from_numpy(s["am"]),
                      torch.from_numpy(labels))
    np.testing.assert_allclose(got["logprob"].numpy(),
                               np.asarray(want["logprob"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got["length_pred"].numpy(),
                                  np.asarray(want["length_pred"]))


def test_nnaic_length_rejects_region_overflow(nnaic):
    """More regions than max_boxes raise ValueError in both packages."""
    s = nnaic
    n = s["tm"].max_boxes // R + 1
    big_t = s["tmem"].repeat(1, n, 1)
    big_j = jnp.concatenate([s["jmem"]] * n, axis=1)
    with pytest.raises(ValueError, match="max_boxes"):
        s["jm"].apply(s["params"], big_j, method="nnaic_length")
    with pytest.raises(ValueError, match="max_boxes"):
        s["tm"].nnaic_length(big_t)


def test_nnaic_weights_round_trip_bitwise(nnaic):
    """convert carries nn_len_l1 and nn_len_l2 both ways, bitwise."""
    s = nnaic
    tree = to_numpy_tree(s["params"])["params"]
    back = to_jax_tree(s["tm"])["params"]
    assert sorted(back) == sorted(tree)
    for name in ("nn_len_l1", "nn_len_l2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], tree[name][leaf])
    load_jax_params(s["tm"], {"params": back})
    np.testing.assert_array_equal(
        s["tm"].nn_len_l2.weight.detach().numpy().T,
        tree["nn_len_l2"]["kernel"])
