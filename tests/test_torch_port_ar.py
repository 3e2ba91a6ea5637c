"""Port parity, the AR slice: the KV-cached AR step, ``ar_sample`` with
each option, ``ar_beam_search``, ``uic_s_ar_decode``, the NA decode with
the attention core on, and the AIC server, against the JAX package on
shared weights (CPU, float32).  ``seq`` and the phrase plan identical,
log-probs within 1e-5.

With ``use_pallas`` on, the JAX side runs its attention-core kernel in
interpret mode, switched on by ``set_pallas_attention`` inside
``try/finally`` as ``tests/test_pallas.py`` does (the JAX flag is a
process global), and the port routes the same calls through
``attention_core`` (its plain twin on the CPU)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import ar as jar
from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.models.layers import set_pallas_attention
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.models import layers as tl
from boficap_tpu_torch.serve import CaptionServer
from tests._torch_port_util import L, R, VOCAB, make_feats, make_pair

B = 4
IX_TO_WORD = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}


def _nudge_generator(params, tm, seed=7):
    """Seeded noise on the generator's bias and a raised EOS, in both
    models, so greedy captions vary and some rows end early."""
    rs = np.random.RandomState(seed)
    b = np.asarray(params["params"]["generator"]["proj"]["bias"]).copy()
    b += rs.randn(*b.shape).astype(np.float32)
    b[2] += 2.5
    params["params"]["generator"]["proj"]["bias"] = jnp.asarray(b)
    with torch.no_grad():
        tm.generator.proj.bias.copy_(torch.from_numpy(b))
    tm.invalidate_packed()
    return params


@pytest.fixture(scope="module")
def aic():
    jm, params, tm = make_pair("AIC", seed=2)
    return jm, _nudge_generator(params, tm), tm


@pytest.fixture(scope="module")
def uic_s():
    """A UIC_s pair: its A role for the AR branch, its NA role for na_decode
    with the attention core."""
    jm, params, tm = make_pair("UIC_s", "add", seed=4)
    return jm, _nudge_generator(params, tm), tm


@contextlib.contextmanager
def pallas(tm, on: bool):
    """use_pallas on both sides: the JAX global (interpret mode), reset in
    ``finally``, and the port model's attention-core routing."""
    tm.set_attention_core(on)
    set_pallas_attention(on, interpret=True)
    try:
        yield
    finally:
        set_pallas_attention(False)
        tm.set_attention_core(False)


def _memories(jm, params, tm, att, am):
    """Each package's own encode of the same features, and the masks."""
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    return (jmem, jnp.asarray(am).astype(bool), tmem,
            torch.from_numpy(am).bool())


def _same(got, want, exact=("seq",), close=("tok_logprobs", "entropy")):
    for k in exact:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in close:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


def test_ar_step_and_caches_match_jax(aic):
    """init_ar_cache + three ar_steps: log-probs and every layer's caches;
    the port writes the self-attention K/V in place at pos."""
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    jc = jm.apply(params, jmem, L + 1, method="init_ar_cache")
    jstep = jax.jit(lambda p, it, pos, c, s: jm.apply(p, it, pos, c, s,
                                                      method="ar_step"))
    with torch.no_grad():
        tc = tm.init_ar_cache(tmem, L + 1)
        ks0 = tc[0]["ks"]
        ids = np.array([[1] * B, [5, 9, 13, 17], [6, 6, 2, 40]], np.int64)
        for pos in range(3):
            jlp, jc = jstep(params, jnp.asarray(ids[pos]), jnp.int32(pos),
                            jc, jsrc)
            tlp, tc = tm.ar_step(torch.from_numpy(ids[pos]), pos, tc, tsrc)
            np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp),
                                       rtol=1e-5, atol=1e-5)
    assert tc[0]["ks"] is ks0                            # updated in place
    assert not tc[0]["ks"][:, 3:].any()
    for jl, tl_ in zip(jc, tc):
        for k in ("ks", "vs", "kc", "vc"):
            np.testing.assert_allclose(tl_[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_decode_a_matches_cached_steps_and_jax(aic):
    """The teacher-forced decode_a over a causal mask gives the KV-cached
    greedy decode's token log-probs, and JAX decode_a's log-probs."""
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    out = tar.ar_sample(tm, tmem, tsrc)
    words = torch.cat([torch.full((B, 1), 1), out["seq"][:, :-1]], 1)
    causal = tl.causal_mask(L)[None].expand(B, L, L)
    with torch.no_grad():
        lp = tm.generate(tm.decode_a(words, tmem, tsrc, causal))
    tok = torch.gather(lp, 2, out["seq"][..., None])[..., 0]
    live = out["tok_logprobs"] != 0
    np.testing.assert_allclose(tok[live].numpy(),
                               out["tok_logprobs"][live].numpy(),
                               rtol=1e-5, atol=1e-5)
    jlp = jax.jit(lambda p, w, c: jm.apply(p, method=lambda m: m.generate(
        m.decode_a(w, jmem, jsrc, c))))(params, jnp.asarray(words.numpy()),
                                        jnp.asarray(causal.numpy()))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("core", [False, True])
def test_ar_sample_matches_jax(aic, core):
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    with pallas(tm, core):
        want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem, jsrc)
        got = tar.ar_sample(tm, tmem, tsrc)
    _same(_np(got), want)
    seq = got["seq"].numpy()
    assert (seq == 2).any() and (seq[:, -1] > 3).any()   # some rows end
    ended = np.cumsum(seq == 2, 1) - (seq == 2) > 0
    assert (seq[ended] == 0).all() and not got["entropy"].numpy()[ended].any()


OPTIONS = {
    "decoding_constraint": dict(decoding_constraint=True),
    "suppress_unk_idx": dict(suppress_unk_idx=11),
    "max_steps": dict(max_steps=5),
    "block_trigrams": dict(block_trigrams=True),
    "penalty_seqs": dict(diversity_lambda=0.7),
    "bad_endings_ix": dict(bad_endings_ix=(47, 11)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_ar_sample_option_matches_jax(aic, option):
    """Each option of ar_sample changes the greedy captions here and gives
    the JAX package's."""
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    kw = dict(OPTIONS[option])
    jkw, tkw = dict(kw), dict(kw)
    if option == "penalty_seqs":
        pen = np.random.RandomState(3).randint(4, 50, size=(B, 2, L))
        pen[:, 0] = tar.ar_sample(tm, tmem, tsrc)["seq"].numpy()
        jkw["penalty_seqs"] = jnp.asarray(pen, jnp.int32)
        tkw["penalty_seqs"] = torch.from_numpy(pen)
    want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem, jsrc,
                         **jkw)
    got = tar.ar_sample(tm, tmem, tsrc, **tkw)
    _same(_np(got), want)
    base = tar.ar_sample(tm, tmem, tsrc)
    assert not torch.equal(got["seq"], base["seq"])


BEAM_OPTIONS = dict(temperature=0.7, decoding_constraint=True,
                    suppress_unk_idx=11, bad_endings_ix=(47, 11))


@pytest.mark.parametrize("K,penalty,options", [
    (1, "", False), (3, "", False), (3, "wu_0.7", False),
    (3, "avg_1.0", False), (3, "", True)])
def test_ar_beam_search_matches_jax(aic, K, penalty, options):
    """K = 1 and 3, with and without a length penalty, and with every
    option of the step (temperature, no repeat, unk, bad endings)."""
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    kw = BEAM_OPTIONS if options else {}
    want = jar.ar_beam_search(jm, params, jmem, jsrc, beam_size=K,
                              length_penalty=penalty, **kw)
    got = tar.ar_beam_search(tm, tmem, tsrc, beam_size=K,
                             length_penalty=penalty, **kw)
    _same(_np(got), want, close=("tok_logprobs", "scores"))
    assert got["seq"].shape == (B, K, L)
    if options:
        assert not torch.equal(got["seq"], tar.ar_beam_search(
            tm, tmem, tsrc, beam_size=K)["seq"])
    if K == 1:
        greedy = tar.ar_sample(tm, tmem, tsrc)
        np.testing.assert_array_equal(got["seq"][:, 0].numpy(),
                                      greedy["seq"].numpy())


def test_ar_beam_search_with_the_attention_core_matches_jax(aic):
    """K = 3 beams (B·K rows through the attention core) with use_pallas
    on both sides."""
    jm, params, tm = aic
    att, am = make_feats(B=B, seed=1)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    with pallas(tm, True):
        want = jar.ar_beam_search(jm, params, jmem, jsrc, beam_size=3)
        got = tar.ar_beam_search(tm, tmem, tsrc, beam_size=3)
    _same(_np(got), want, close=("tok_logprobs", "scores"))


def test_top_k_breaks_ties_as_jax():
    """Planted ties: the stable top-K keeps the lower index first, as
    jax.lax.top_k does; the done pool's NEG_INF entries keep pool order,
    then the candidates' beam order."""
    x = np.array([[1.0, 3.0, 3.0, -1e9, 3.0, 2.0, -1e9, -1e9],
                  [-1e9] * 8, [0.5, 0.5, 0.5, 0.5, 0.7, 0.7, 0.1, 0.7]],
                 np.float32)
    for k in (1, 3, 5, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tar._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    pool = torch.tensor([[-1e9, -1e9, -1e9], [-2.0, -1e9, -1e9]])
    cand = torch.tensor([[-1e9, -3.0, -1e9], [-1e9, -2.0, -1e9]])
    seqs = (torch.arange(6).reshape(1, 6).expand(2, 6),)
    p, (s,) = tar._merge_done_pool(pool, cand, 3,
                                   [(seqs[0][:, :3], seqs[0][:, 3:])])
    np.testing.assert_array_equal(s.numpy(), [[4, 0, 1], [0, 4, 1]])


def test_uic_s_ar_decode_matches_jax(uic_s):
    """The UIC_s AR branch: the bounding plan, then AR steps with the
    plan's syn ids, words only inside the planned length."""
    jm, params, tm = uic_s
    att, am = make_feats(B=B, seed=5)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    want = jbf.uic_s_ar_decode(jm, params, jax.random.PRNGKey(0), jmem, jsrc)
    got = _np(tbf.uic_s_ar_decode(tm, tmem, tsrc))
    _same(got, want, exact=("seq", "phrase_num", "phrase_length",
                            "phrase_syn"))
    total = got["phrase_length"].sum(1)
    assert total.max() > 0
    past = np.arange(L)[None, :] >= total[:, None]
    assert (got["seq"][past] == 0).all() and (got["seq"][~past] > 3).any()


def test_na_decode_with_the_attention_core_matches_jax(uic_s):
    """na_decode with use_pallas on (the bounding steps' and the plain
    fill's attentions through the core) gives the JAX flag-on decode, on
    the plain fill and on the fused one."""
    jm, params, tm = uic_s
    att, am = make_feats(B=B, seed=5)
    with pallas(tm, True):
        jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
        want = jbf.na_decode(jm, params, jax.random.PRNGKey(0), jmem, jsrc)
        got = tbf.na_decode(tm, tmem, tsrc)
        fused = tbf.na_decode(tm, tbf.fused_encode(tm, torch.from_numpy(att),
                                                   torch.from_numpy(am)),
                              tsrc, fused_fill=True)
    plan = ("seq", "phrase_num", "phrase_length", "phrase_syn")
    _same(_np(got), want, exact=plan)
    _same(_np(fused), want, exact=plan)
    assert np.asarray(want["phrase_num"]).max() > 0


def test_aic_server_matches_jax_server(aic):
    """CaptionServer(mode='AIC') on the CPU gives the JAX AIC server's
    captions on the same weights; each request equals a direct decode."""
    from boficap_tpu.serve import CaptionServer as JaxCaptionServer
    jm, params, tm = aic
    att, am = make_feats(B=3, seed=21)
    reqs = [(att[0], am[0]), (att[1], am[1]), (att[2], am[2]),
            (att[1][:3], None)]

    def serve(srv):
        try:
            futs = [srv.submit(a, m) for a, m in reqs[:3]]
            outs = [f.wait(timeout=300) for f in futs]
            outs += [srv.submit(a, m).wait(timeout=300) for a, m in reqs[3:]]
        finally:
            srv.close()
        return outs

    got = serve(CaptionServer(tm, IX_TO_WORD, mode="AIC", max_batch=4,
                              max_wait_ms=30.0, max_regions=R, device="cpu"))
    want = serve(JaxCaptionServer(jm, params, IX_TO_WORD, mode="AIC",
                                  max_batch=4, max_wait_ms=30.0,
                                  max_regions=R, route="unfused"))
    assert [o["caption"] for o in got] == [o["caption"] for o in want]
    assert all(o["caption"] for o in got)
    for (a, m), o in zip(reqs, got):
        fa = np.zeros((1, R, 2048), np.float32)
        fa[0, :a.shape[0]] = a
        fm = np.zeros((1, R), np.float32)
        fm[0, :a.shape[0]] = 1.0 if m is None else m
        with torch.no_grad():
            mem = tbf.fused_encode(tm, torch.from_numpy(fa),
                                   torch.from_numpy(fm))
        direct = tar.ar_sample(tm, mem, torch.from_numpy(fm).bool())
        np.testing.assert_array_equal(o["seq"], direct["seq"][0].numpy())
