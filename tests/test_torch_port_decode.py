"""Port parity, the slice: the port's NA bound-then-fill ``na_decode``
against the JAX package's, on shared weights (float32, CPU).

Both JAX routes (plain, and the Pallas kernels in interpret mode) are held
against both port routes (plain modules, and the kernel wrappers' plain
twins): the phrase plan and ``seq`` identical, token logprob and entropy
within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu_torch.decode import bound_fill as tbf
from tests._torch_port_util import make_feats, make_pair

KEYS_EXACT = ("seq", "phrase_num", "phrase_length", "phrase_syn")
KEYS_CLOSE = ("tok_logprobs", "entropy")


def _jax_decode(jm, params, att, am, fused):
    a, m = jnp.asarray(att), jnp.asarray(am)
    if fused:
        mem = jbf.fused_encode(jm, params, a, m, interpret=True,
                               stacked=False)
    else:
        mem = jm.apply(params, a, m, deterministic=True, method="encode")
    out = jbf.na_decode(jm, params, jax.random.PRNGKey(0), mem,
                        m.astype(bool), fused_fill=fused,
                        fused_interpret=fused, stacked=False)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_decode(tm, att, am, fused):
    a, m = torch.from_numpy(att), torch.from_numpy(am)
    with torch.no_grad():
        mem = tbf.fused_encode(tm, a, m) if fused else tm.encode(a, m)
    out = tbf.na_decode(tm, mem, m.bool(), fused_fill=fused)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want):
    for k in KEYS_EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in KEYS_CLOSE:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("train_mode,input_mode", [
    ("UIC", "add"), ("UIC", "single"), ("UIC", "gate"), ("NAIC", "add")])
def test_na_decode_matches_jax(train_mode, input_mode):
    jm, params, tm = make_pair(train_mode, input_mode, seed=4)
    att, am = make_feats(B=4, seed=5)
    want_plain = _jax_decode(jm, params, att, am, fused=False)
    want_fused = _jax_decode(jm, params, att, am, fused=True)
    got_plain = _port_decode(tm, att, am, fused=False)
    got_fused = _port_decode(tm, att, am, fused=True)
    # the random model must plan real captions for this to test anything
    assert want_plain["phrase_num"].max() > 0
    assert (want_plain["seq"] > 3).any()
    for got in (got_plain, got_fused):
        for want in (want_plain, want_fused):
            _assert_same(got, want)


@pytest.mark.parametrize("n_len", [0, 2])
def test_bound_step_general_matches_jax(n_len):
    """N_len != 1: the predictor runs ``bound_step`` (no cached tables)."""
    jm, params, tm = make_pair("UIC", "add", seed=7, n_len=n_len)
    att, am = make_feats(B=3, seed=8)
    want = _jax_decode(jm, params, att, am, fused=False)
    _assert_same(_port_decode(tm, att, am, fused=False), want)


def test_bound_plan_finished_samples_are_frozen():
    """Steps after every sample has stopped change nothing, so the
    fixed-step loop equals the JAX package's early-exit while_loop."""
    _, _, tm = make_pair("UIC", "add", seed=4)
    att, am = make_feats(B=4, seed=5)
    L = tm.max_length
    keys = ("extend_syn", "last", "phrase_length", "phrase_syn",
            "phrase_num", "finished")
    with torch.no_grad():
        mem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
        src = torch.from_numpy(am).bool()
        plans = [tbf.bound_plan(tm, mem, src, k, L) for k in range(1, L + 1)]
    done = next(i for i, s in enumerate(plans) if s["finished"].all())
    assert done < L - 1, "every sample must stop before the last step"
    for s in plans[done + 1:]:
        for k in keys:
            assert torch.equal(s[k], plans[done][k]), k


def test_sampled_branches_not_ported():
    """Greedy takes the first maximum; the sampled branches are ported now
    (tests/test_torch_port_sampling.py) and refuse to draw without an
    explicit generator."""
    from boficap_tpu_torch.decode.sampling import sample_next_word
    lp = torch.log_softmax(torch.randn(2, 5), -1)
    ids, tok = sample_next_word(lp, "greedy")
    assert torch.equal(ids, lp.argmax(-1))
    with pytest.raises(ValueError, match="Generator"):
        sample_next_word(lp, "sample")
