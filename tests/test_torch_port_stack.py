"""Port parity, the whole-stack encoder and NA decoder kernels: the plain
twins of ``fused_encoder_stack_forward`` (#4) and
``fused_decoder_stack_forward`` (#5) against the JAX package's whole-stack
Pallas kernels in interpret mode, and ``na_decode`` on the stacked route
against the JAX package's, on shared weights (float32, CPU): outputs within
1e-5, the phrase plan and ``seq`` identical.  The CUDA kernels are held
against these twins on the card (chip_smoke.py, test_torch_port_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.ops import pallas_stack as jst
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.ops import stack as st
from tests._torch_port_util import L, R, make_feats, make_pair

B = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def uic():
    return make_pair("UIC", "add", seed=4)


def test_encoder_stack_twin_matches_jax(uic):
    """#4 through ``fused_encode``: padded regions, one sample with every
    region but one masked."""
    jm, params, tm = uic
    att, am = make_feats(B=B, seed=11)
    am[2, 1:] = 0.0
    want = jbf.fused_encode(jm, params, jnp.asarray(att), jnp.asarray(am),
                            interpret=True, stacked=True)
    with torch.no_grad():
        got = tbf.fused_encode(tm, torch.from_numpy(att),
                               torch.from_numpy(am), stacked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decoder_stack_twin_matches_jax(uic):
    """#5: NA fill masks (keys < total, one empty plan), padded source."""
    jm, params, tm = uic
    rs = np.random.RandomState(12)
    D = tm.d_model
    x = rs.randn(B, L, D).astype(np.float32)
    mem = rs.randn(B, R, D).astype(np.float32)
    total = np.array([0, 3, L, 5])
    tgt = np.broadcast_to(np.arange(L)[None, None, :] < total[:, None, None],
                          (B, L, L)).copy()
    src = np.ones((B, R), bool)
    src[3, -3:] = False
    packed, fnorm = jbf._fused_ctx(jm, params, "NA")
    want = jst.fused_decoder_stack_forward(
        jnp.asarray(x), jnp.asarray(mem), jnp.asarray(tgt), jnp.asarray(src),
        jst.pack_stack(packed, "dec"), fnorm, num_heads=tm.num_heads,
        interpret=True)
    pack = tm.packed_decoder("NA")
    got = st.fused_decoder_stack_forward(
        torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(tgt),
        torch.from_numpy(src), pack.stack, pack.final_norm, tm.num_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the per-layer views of the same pack give the same stack
    from boficap_tpu_torch.ops.decoder_layer import fused_decoder_forward
    per_layer = fused_decoder_forward(
        torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(tgt),
        torch.from_numpy(src), pack.layers, pack.final_norm, tm.num_heads)
    np.testing.assert_allclose(per_layer.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("train_mode", ["UIC", "NAIC"])
def test_na_decode_stacked_matches_jax(train_mode):
    """The slice on the whole-stack route: port ``fused_encode`` and
    ``na_decode(fused_fill=True)`` with ``stacked=True`` against the JAX
    package's (interpret mode, ``stacked=True``) and its plain decode."""
    jm, params, tm = make_pair(train_mode, "add", seed=4)
    att, am = make_feats(B=B, seed=5)
    a, m = jnp.asarray(att), jnp.asarray(am)
    jmem = jbf.fused_encode(jm, params, a, m, interpret=True, stacked=True)
    want = jbf.na_decode(jm, params, jax.random.PRNGKey(0), jmem,
                         m.astype(bool), fused_fill=True,
                         fused_interpret=True, stacked=True)
    pmem = jm.apply(params, a, m, deterministic=True, method="encode")
    want_plain = jbf.na_decode(jm, params, jax.random.PRNGKey(0), pmem,
                               m.astype(bool))
    ta, tm_ = torch.from_numpy(att), torch.from_numpy(am)
    with torch.no_grad():
        mem = tbf.fused_encode(tm, ta, tm_, stacked=True)
    got = tbf.na_decode(tm, mem, tm_.bool(), fused_fill=True, stacked=True)
    assert np.asarray(want["phrase_num"]).max() > 0
    for ref in (want, want_plain):
        for k in ("seq", "phrase_num", "phrase_length", "phrase_syn"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
    for k in ("tok_logprobs", "entropy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("rule", [False, True])
def test_encode_and_fill_follow_routing_rule(uic, monkeypatch, rule):
    """``stacked=None`` takes the route ``use_stacked`` names, for the
    encoder and for the NA fill; an explicit ``stacked`` overrides it."""
    _, _, tm = uic
    calls = []

    def spy(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(tbf, name, run)

    for name in ("fused_encoder_stack_forward", "fused_encoder_forward",
                 "fused_decoder_stack_forward", "fused_decoder_forward"):
        spy(name, getattr(tbf, name))
    monkeypatch.setattr(tbf, "use_stacked", lambda model, batch: rule)
    att, am = make_feats(B=B, seed=5)
    a, m = torch.from_numpy(att), torch.from_numpy(am)
    with torch.no_grad():
        mem = tbf.fused_encode(tm, a, m)
    tbf.na_decode(tm, mem, m.bool(), fused_fill=True)
    assert calls == (["fused_encoder_stack_forward",
                      "fused_decoder_stack_forward"] if rule else
                     ["fused_encoder_forward", "fused_decoder_forward"])
    calls.clear()
    with torch.no_grad():
        tbf.fused_encode(tm, a, m, stacked=not rule)
    assert calls == ["fused_encoder_forward" if rule
                     else "fused_encoder_stack_forward"]


def _seeded_decoder(NL, D, F, H, seed):
    """A port Decoder with parameters drawn from numpy (seeded)."""
    from boficap_tpu_torch.models import layers as tl
    rs = np.random.RandomState(seed)
    dec = tl.Decoder(NL, D, F, H)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            noise = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
            p.copy_(1.0 + 0.05 * noise if name.endswith("scale")
                    else noise * (0.1 if p.dim() > 1 else 0.05))
    return dec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_stack_hoisted_kv_is_layer_chain(dtype):
    """#5's twin runs the kernel's schedule: every layer's cross K|V of the
    memory first, then the layers on them.  It is bitwise a chain of
    ``decoder_layer_plain`` (each layer projecting its own K|V), then the
    final norm, and so is the wrapper's CPU route: padded regions, an empty
    plan and one fully masked target row."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    D, H, NL, Bs, Ls, Rs = 64, 2, 2, 3, 5, 7
    pack = st.pack_decoder_stack(_seeded_decoder(NL, D, 2 * D, H, 7), dtype)
    assert pack.stack["wkv2_all"].shape == (D, NL * 2 * D)
    for i in range(NL):   # layer l's K|V at columns 2Dl ..
        assert torch.equal(pack.stack["wkv2_all"][:, 2 * D * i:2 * D * (i + 1)],
                           pack.stack["wkv2"][i])
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.randn(Bs, Ls, D).astype(np.float32)).to(dtype)
    mem = torch.from_numpy(rs.randn(Bs, Rs, D).astype(np.float32)).to(dtype)
    total = np.array([0, 3, Ls])
    tgt = np.broadcast_to(np.arange(Ls)[None, None, :] < total[:, None, None],
                          (Bs, Ls, Ls)).copy()
    tgt[2, 1] = False                      # one fully masked target row
    src = np.ones((Bs, Rs), bool)
    src[1, -3:] = False
    src[2, 2:] = False
    tgt, src = torch.from_numpy(tgt), torch.from_numpy(src)
    h = x
    for w in pack.layers:
        h = dl.decoder_layer_plain(h, mem, tgt, src, w, H)
    want = dl.refnorm_plain(h, *pack.final_norm)
    got = st.decoder_stack_plain(x, mem, tgt, src, pack.stack,
                                 pack.final_norm, H)
    routed = st.fused_decoder_stack_forward(x, mem, tgt, src, pack.stack,
                                            pack.final_norm, H)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, want)
    assert torch.equal(routed, want)
