"""Port parity, the SA slice: the window kernels' plain twins, the port's
semi-autoregressive ``sa_decode`` and the SAIC server against the JAX
package's, on shared weights (CPU).

The JAX Pallas kernels run in interpret mode; they take block-diagonal
masks (``_block_diag_one``) and a one-hot scatter matrix, the port takes
per-sample masks and window starts.  Float32 unless a test says otherwise:
the window layers and stacks agree to 1e-5; the decodes give the identical
phrase plan and ``seq``, and token logprob / entropy within 1e-5 route for
route and within the Pallas tests' tolerance (rtol 2e-3, atol 2e-4)
across routes."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.ops import pallas_stack as jst
from boficap_tpu.ops.pallas_decoder_layer import (
    _block_diag_one, fused_window_decoder_layer as jax_window_layer,
    project_cross_kv as jax_project_cross_kv)
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.ops import decoder_layer as dl
from boficap_tpu_torch.ops import stack as st
from boficap_tpu_torch.serve import CaptionServer
from tests._torch_port_util import L, R, VOCAB, make_feats, make_pair

KEYS_EXACT = ("seq", "phrase_num", "phrase_length", "phrase_syn")
KEYS_CLOSE = ("tok_logprobs", "entropy")
IX_TO_WORD = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}
B = 4
G = 2          # the JAX kernels' batch block (block-diagonal masks)


@pytest.fixture(scope="module")
def uic():
    return make_pair("UIC", "add", seed=4)


def _window_inputs(tm, W, seed):
    """Random window operands shared by both sides (numpy, float32):
    x_win, caches, the memory's cross K/V through each package's own
    projection, window starts (one clipped at L - W), a tgt mask with a
    fully masked row and a fully masked sample, and a padded src mask."""
    rs = np.random.RandomState(seed)
    D = tm.d_model
    NL = len(tm.packed_window("SA").layers)
    x = rs.randn(B, W, D).astype(np.float32)
    kc = rs.randn(NL, B, L, D).astype(np.float32)
    vc = rs.randn(NL, B, L, D).astype(np.float32)
    memory = rs.randn(B, R, D).astype(np.float32)
    w_start = np.array([0, L - W, 2, min(L - W, 1)], np.int32)
    tgt = rs.rand(B, W, L + W) < 0.6
    tgt[1] = False                       # an empty plan: every row masked
    tgt[2, -1] = False                   # one row past the slot
    src = np.ones((B, R), bool)
    src[0, -2:] = False
    return x, kc, vc, memory, w_start, tgt, src


def _jax_cross(jm, params, memory):
    packed, fnorm = jbf._fused_ctx(jm, params, "SA")
    k2_l, v2_l = jax_project_cross_kv(packed, jnp.asarray(memory))
    return packed, fnorm, jnp.stack(k2_l), jnp.stack(v2_l)


def _port_cross(tm, memory):
    pack = tm.packed_window("SA")
    return pack, dl.project_cross_kv(pack.wkv2, pack.bkv2,
                                     torch.from_numpy(memory))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_project_cross_kv_matches_jax(uic):
    jm, params, tm = uic
    memory = np.random.RandomState(1).randn(B, R, tm.d_model).astype(
        np.float32)
    _, _, k2j, v2j = _jax_cross(jm, params, memory)
    _, (k2t, v2t) = _port_cross(tm, memory)
    _close(k2t, k2j)
    _close(v2t, v2j)


@pytest.mark.parametrize("W", [3, L])
def test_window_layer_twin_matches_jax(uic, W):
    """#8: one windowed layer -> (x, k_new, v_new)."""
    jm, params, tm = uic
    x, kc, vc, memory, _, tgt, src = _window_inputs(tm, W, seed=2)
    packed, _, k2j, v2j = _jax_cross(jm, params, memory)
    src3 = np.broadcast_to(src[:, None, :], (B, W, R))
    want = jax_window_layer(
        jnp.asarray(x), jnp.asarray(kc[0]), jnp.asarray(vc[0]), k2j[0],
        v2j[0], _block_diag_one(jnp.asarray(tgt), G),
        _block_diag_one(jnp.asarray(src3), G), packed[0],
        num_heads=tm.num_heads, block_b=G, interpret=True)
    pack, (k2t, v2t) = _port_cross(tm, memory)
    got = dl.fused_window_decoder_layer(
        torch.from_numpy(x), torch.from_numpy(kc[0]), torch.from_numpy(vc[0]),
        k2t[0], v2t[0], torch.from_numpy(tgt), torch.from_numpy(src),
        pack.layers[0], tm.num_heads)
    for g, w in zip(got, want):
        _close(g, w)


def test_window_stack_twin_matches_jax(uic):
    """#6: a narrow round through the stack, the cache update included:
    rows outside each sample's window are untouched, a window clipped at
    L - W lands at the cache's end."""
    jm, params, tm = uic
    W = 3
    x, kc, vc, memory, w_start, tgt, src = _window_inputs(tm, W, seed=3)
    packed, fnorm, k2j, v2j = _jax_cross(jm, params, memory)
    ohw = (np.arange(L)[None, None, :]
           == (w_start[:, None] + np.arange(W)[None, :])[:, :, None])
    src3 = np.broadcast_to(src[:, None, :], (B, W, R))
    want = jst.fused_window_decoder_stack(
        jnp.asarray(x), jnp.asarray(ohw.transpose(0, 2, 1), jnp.float32),
        jnp.asarray(kc), jnp.asarray(vc), k2j, v2j,
        _block_diag_one(jnp.asarray(tgt), G),
        _block_diag_one(jnp.asarray(src3), G), jst.pack_stack(packed, "win"),
        fnorm, num_heads=tm.num_heads, block_b=G, interpret=True)
    pack, (k2t, v2t) = _port_cross(tm, memory)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = st.fused_window_decoder_stack(
        torch.from_numpy(x), torch.from_numpy(w_start), kc_t, vc_t, k2t, v2t,
        torch.from_numpy(tgt), torch.from_numpy(src), pack.stack,
        pack.final_norm, tm.num_heads)
    assert got[1] is kc_t and got[2] is vc_t          # updated in place
    for g, w in zip(got, want):
        _close(g, w)
    outside = ~ohw.any(1)                                        # [B, L]
    np.testing.assert_array_equal(kc_t.numpy()[:, outside], kc[:, outside])
    np.testing.assert_array_equal(vc_t.numpy()[:, outside], vc[:, outside])


def test_window_wide_stack_twin_matches_jax(uic):
    """#7: the wide round (W == L) has no cache keys; each layer's fresh
    K/V come back as its new cache."""
    jm, params, tm = uic
    x, _, _, memory, _, tgt, src = _window_inputs(tm, L, seed=4)
    tgt = np.ascontiguousarray(tgt[:, :, L:])
    packed, fnorm, k2j, v2j = _jax_cross(jm, params, memory)
    src3 = np.broadcast_to(src[:, None, :], (B, L, R))
    want = jst.fused_window_wide_stack(
        jnp.asarray(x), k2j, v2j, _block_diag_one(jnp.asarray(tgt), G),
        _block_diag_one(jnp.asarray(src3), G), jst.pack_stack(packed, "win"),
        fnorm, num_heads=tm.num_heads, block_b=G, interpret=True)
    pack, (k2t, v2t) = _port_cross(tm, memory)
    got = st.fused_window_wide_stack(
        torch.from_numpy(x), k2t, v2t, torch.from_numpy(tgt),
        torch.from_numpy(src), pack.stack, pack.final_norm, tm.num_heads)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the slice: sa_decode
# ---------------------------------------------------------------------------

def _jax_sa(jm, params, att, am, *, fused=False, stacked=False, window=8,
            syn=False):
    a, m = jnp.asarray(att), jnp.asarray(am)
    mem = jm.apply(params, a, m, deterministic=True, method="encode")
    out = jbf.sa_decode(jm, params, jax.random.PRNGKey(0), mem,
                        m.astype(bool), fused_fill=fused,
                        fused_interpret=fused, stacked=stacked,
                        window=window, predictor_use_syn=syn)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_sa(tm, att, am, *, fused=False, stacked=False, window=8,
             syn=False, stats=None):
    a, m = torch.from_numpy(att), torch.from_numpy(am)
    with torch.no_grad():
        mem = tbf.fused_encode(tm, a, m) if fused else tm.encode(a, m)
    out = tbf.sa_decode(tm, mem, m.bool(), fused_fill=fused, stacked=stacked,
                        window=window, predictor_use_syn=syn, stats=stats)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want, rtol=1e-5, atol=1e-5):
    for k in KEYS_EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in KEYS_CLOSE:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


CROSS = dict(rtol=2e-3, atol=2e-4)      # tests/test_pallas.py:205


@pytest.mark.parametrize("train_mode,input_mode,syn", [
    ("UIC", "add", False), ("UIC", "single", False), ("UIC", "gate", False),
    ("SAIC", "add", False), ("UIC_s", "add", True)])
def test_sa_decode_matches_jax(train_mode, input_mode, syn):
    """Plain, per-layer and whole-stack port routes against the JAX plain
    decode, at a narrow window (narrow and wide rounds) and a window >= L
    (every round wide)."""
    jm, params, tm = make_pair(train_mode, input_mode, seed=4)
    att, am = make_feats(B=B, seed=5)
    want = _jax_sa(jm, params, att, am, syn=syn)
    assert want["phrase_num"].max() > 0 and (want["seq"] > 3).any()
    _assert_same(_port_sa(tm, att, am, syn=syn), want)
    rounds = {}
    for window in (4, L):
        for stacked in (False, True):
            stats = {}
            got = _port_sa(tm, att, am, fused=True, stacked=stacked,
                           window=window, syn=syn, stats=stats)
            _assert_same(got, want, **CROSS)
            rounds[window] = stats
    assert rounds[L]["narrow"] == 0 and rounds[L]["wide"] > 0
    assert rounds[4]["rounds"] == rounds[L]["rounds"]


@pytest.mark.parametrize("stacked", [False, True])
def test_sa_fused_decode_matches_jax_kernels(uic, stacked):
    """Route for route: the port's fused fill (window twins) against the
    JAX fused fill (Pallas kernels, interpret mode), with narrow and wide
    rounds."""
    jm, params, tm = uic
    att, am = make_feats(B=B, seed=5)
    want = _jax_sa(jm, params, att, am, fused=True, stacked=stacked,
                   window=4)
    stats = {}
    got = _port_sa(tm, att, am, fused=True, stacked=stacked, window=4,
                   stats=stats)
    _assert_same(got, want)
    assert stats["narrow"] > 0 and stats["wide"] > 0
    assert stats["host_syncs"] == stats["rounds"]


def test_sa_routing_rule():
    """stacked=None follows the JAX package's rule without its interpret
    term: bf16, a 128-aligned width and B <= 128."""
    m = types.SimpleNamespace(dtype=torch.bfloat16, d_model=512)
    assert tbf.use_stacked(m, 128) and not tbf.use_stacked(m, 129)
    assert not tbf.use_stacked(types.SimpleNamespace(
        dtype=torch.float32, d_model=512), 64)
    assert not tbf.use_stacked(types.SimpleNamespace(
        dtype=torch.bfloat16, d_model=96), 64)


def test_sa_max_steps_and_early_exit(uic):
    """max_steps caps the rounds; a decode stops once every sample has
    finished, with one host sync a round."""
    jm, params, tm = uic
    att, am = make_feats(B=B, seed=5)
    full = {}
    _port_sa(tm, att, am, fused=True, window=4, stats=full)
    assert full["rounds"] <= L and full["host_syncs"] == full["rounds"]
    # a length head that says "stop" for every image: one round, no words
    bias = tm.len_head2.bias.detach().clone()
    try:
        with torch.no_grad():
            tm.len_head2.bias[0] += 100.0
        stop = {}
        out = _port_sa(tm, att, am, fused=True, window=4, stats=stop)
    finally:
        with torch.no_grad():
            tm.len_head2.bias.copy_(bias)
        tm.invalidate_packed()
    assert stop["rounds"] == 1 and not out["phrase_num"].any()
    a, m = torch.from_numpy(att), torch.from_numpy(am)
    with torch.no_grad():
        mem = tm.encode(a, m)
    two = {}
    got = tbf.sa_decode(tm, mem, m.bool(), max_steps=2, stats=two)
    assert two["rounds"] == 2
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    want = jbf.sa_decode(jm, params, jax.random.PRNGKey(0), jmem,
                         jnp.asarray(am).astype(bool), max_steps=2)
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_saic_server_matches_jax_server(uic):
    """CaptionServer(mode='SAIC') on the CPU gives the JAX SAIC server's
    captions on the same weights: three requests padded to a bucket of 4,
    then short-region requests."""
    from boficap_tpu.serve import CaptionServer as JaxCaptionServer
    jm, params, tm = uic
    att, am = make_feats(B=3, seed=21)
    n_short = 3
    reqs = [(att[0], am[0]), (att[1], am[1]), (att[2], am[2]),
            (att[1][:n_short], None), (att[2][:4], np.ones(4, np.float32))]

    def serve(srv):
        try:
            futs = [srv.submit(a, m) for a, m in reqs[:3]]
            outs = [f.wait(timeout=300) for f in futs]
            outs += [srv.submit(a, m).wait(timeout=300) for a, m in reqs[3:]]
        finally:
            srv.close()
        return outs

    got = serve(CaptionServer(tm, IX_TO_WORD, mode="SAIC", max_batch=4,
                              max_wait_ms=30.0, max_regions=R, device="cpu"))
    want = serve(JaxCaptionServer(jm, params, IX_TO_WORD, mode="SAIC",
                                  max_batch=4, max_wait_ms=30.0,
                                  max_regions=R, route="unfused"))
    assert {o["bucket"] for o in got[:3]} == {4}
    assert [o["caption"] for o in got] == [o["caption"] for o in want]
    assert any(o["caption"] for o in got)
    # each request equals a direct decode of its own (padded) features
    for (a, m), o in zip(reqs, got):
        fa = np.zeros((1, R, 2048), np.float32)
        fa[0, :a.shape[0]] = a
        fm = np.zeros((1, R), np.float32)
        fm[0, :a.shape[0]] = 1.0 if m is None else m
        direct = _port_sa(tm, fa, fm, fused=True)
        np.testing.assert_array_equal(o["seq"], direct["seq"][0])


# ---------------------------------------------------------------------------
# the compute dtype
# ---------------------------------------------------------------------------

def test_default_dtype_is_bfloat16_as_in_jax():
    """A config that names no dtype builds a bfloat16 model in the port,
    as the JAX package does."""
    import os

    from boficap_tpu.config.config import load_yaml_with_base
    from boficap_tpu.config.opts import default_config, finalize
    from boficap_tpu.models.boficap import build_model as jax_build_model
    from boficap_tpu_torch.config import load_config
    from boficap_tpu_torch.models.boficap import build_model
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "configs", "uic_sd.yml")
    model = build_model(load_config(path), 10, device="cpu")
    assert model.dtype == torch.bfloat16
    assert model.generator.proj.compute_dtype == torch.bfloat16
    jcfg = default_config()
    jcfg.update(load_yaml_with_base(path))
    assert jax_build_model(finalize(jcfg), 10).dtype == jnp.bfloat16


# bf16 seq rule: the port may pick another word only where the JAX fill's
# top-2 logprob margin is below this (two bf16 roundings apart, ~2**-7
# relative on logits of size ~1, compound over a few layers)
BF16_MARGIN_NOISE = 0.1


def test_na_decode_bf16_matches_jax_within_margin():
    """bf16 NA decode, plain routes on shared weights: the phrase plan is
    identical; seq is identical except where the JAX fill's top-2 margin is
    below BF16_MARGIN_NOISE."""
    jm, params, tm = make_pair("UIC", "add", seed=4, dtype="bfloat16")
    att, am = make_feats(B=B, seed=5)
    a, m = jnp.asarray(att), jnp.asarray(am)
    mem = jm.apply(params, a, m, deterministic=True, method="encode")
    src = m.astype(bool)
    want = jbf.na_decode(jm, params, jax.random.PRNGKey(0), mem, src)
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    got = tbf.na_decode(tm, tmem, torch.from_numpy(am).bool())
    for k in ("phrase_num", "phrase_length", "phrase_syn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert np.asarray(want["phrase_num"]).max() > 0
    # the JAX fill's top-2 margins
    plan = jbf.bound_plan(jm, params, mem, src, L, L)
    total = plan["last"] - 1
    na_mask = jnp.broadcast_to(
        jnp.arange(L)[None, None, :] < total[:, None, None], (B, L, L))
    lp = jm.apply(params, method=lambda mm: mm.generate(mm.decode_na(
        plan["extend_syn"][:, 1:-1], mem, src, na_mask)))
    top2 = jax.lax.top_k(lp.astype(jnp.float32), 2)[0]
    margin = np.asarray(top2[..., 0] - top2[..., 1])
    diff = got["seq"].numpy() != np.asarray(want["seq"])
    n_loose = int(diff.sum())
    print(f"bf16 na_decode: {n_loose} of {diff.size} positions differ, all "
          f"below the margin {BF16_MARGIN_NOISE}")
    assert not (diff & (margin >= BF16_MARGIN_NOISE)).any()
    assert n_loose <= diff.size // 4
