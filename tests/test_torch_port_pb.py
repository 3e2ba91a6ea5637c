"""Port parity, PB_pad (the phrase-based packed baseline) against the JAX
package on the CPU, float32, on shared weights: the host packers
(``data/pb_pack.py``) bitwise; ``packed_layout`` bitwise on the genuine
width's prefix; ``pb_compress``, ``pb_length_predict`` and the packed
decode in the three norm modes, and the PB_pad forward, within 1e-5; one
XE step (dropout off: the loss and metrics within 1e-5 relative, every
gradient leaf within 1e-4 of its largest magnitude); ``pb_decode`` at the
default width, at one that clamps and at the lossless one (tokens, plans
identical; token log-probs and entropies within 1e-5), with the attention
core's routing on (JAX's kernel in interpret mode, the port's plain twin),
against the host oracle ``pb_decode_host``; ``top1`` against greedy; the
attention core's plain twin past the 128-key bound; and a checkpoint of
the port's training CLI read by the JAX package."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.data import dataset as jds
from boficap_tpu.data import pb_pack as jpack
from boficap_tpu.decode import pb as jpb
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.models.layers import set_pallas_attention
from boficap_tpu.ops.pallas_attention import attention_core as jax_core
from boficap_tpu.train import state as jax_state
from boficap_tpu_torch import config as tconfig
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.data import pb_pack as tpack
from boficap_tpu_torch.decode import pb as tpb
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.models import setup as tsetup
from boficap_tpu_torch.ops import attention as at
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import built_cache, close, same_grads
from tests._torch_port_util import L, make_feats, make_pair

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B = 6
TOL = 1e-5
L2 = L + 2
LOSSLESS = L * (L + 1) // 2 + 1
WIDTHS = {"default": None, "clamping": 6, "lossless": LOSSLESS}
NORM_MODES = ("copy", "compress", "complex")


def random_plans(rs, B, rounds):
    """Lockstep phrase plans (slot 0 = bos) and bos-framed words: every
    alive sample appends one phrase a round, a sample that appends none is
    done; the next round's phrase is appended already."""
    pl = np.zeros((B, L2), np.int64)
    pl[:, 0] = 1
    pn = np.ones(B, np.int64)
    alive = np.ones(B, bool)
    for _ in range(rounds):
        n = rs.randint(0, 5, size=B)
        n = np.where(alive & (pl.sum(1) + n <= L + 1), n, 0)
        pl[np.arange(B), pn] = np.where(n > 0, n, pl[np.arange(B), pn])
        pn += (n > 0).astype(np.int64)
        alive &= n > 0
    seq = rs.randint(4, 40, size=(B, L2)).astype(np.int64)
    seq[:, 0] = 1
    return seq, pn, pl


@pytest.mark.parametrize("seed", range(6))
def test_pack_gt_and_decoder_inputs_match_jax(seed):
    """pack_gt and pack_decoder_inputs bitwise, dtypes included."""
    rs = np.random.RandomState(seed)
    seq, pn, pl = random_plans(rs, rs.randint(2, 7), rs.randint(1, 5))
    for got, want in ((tpack.pack_gt(seq, pn, pl),
                       jpack.pack_gt(seq, pn, pl)),
                      (tpack.pack_decoder_inputs(seq, pn, pl),
                       jpack.pack_decoder_inputs(seq, pn, pl))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", range(12))
def test_packed_layout_matches_pack_decoder_inputs(seed):
    """packed_layout's prefix sums and gathers give pack_decoder_inputs'
    ids, mask and slots on the genuine width's prefix, nothing past it,
    and JAX's packed_layout over the whole buffer."""
    rs = np.random.RandomState(100 + seed)
    seq, pn, pl = random_plans(rs, rs.randint(2, 6), rs.randint(1, 5))
    host_ids, host_slot, host_mask = tpack.pack_decoder_inputs(seq, pn, pl)
    Lp = host_ids.shape[1]
    W = 2 * L2
    ids, slot, mask, starts = (t.numpy() for t in tpb.packed_layout(
        torch.from_numpy(seq), torch.from_numpy(pl), L + 1, W))
    want = [np.asarray(t) for t in jpb.packed_layout(
        jnp.asarray(seq), jnp.asarray(pl), L + 1, W)]
    for g, w in zip((ids, slot, mask, starts), want):
        np.testing.assert_array_equal(g, w)
    if Lp == 0:
        assert (ids == 0).all() and not mask.any()
        return
    np.testing.assert_array_equal(ids[:, :Lp], host_ids)
    assert (ids[:, Lp:] == 0).all()
    np.testing.assert_array_equal(mask[:, :Lp, :Lp], host_mask)
    assert not mask[:, :, Lp:].any()
    valid = host_mask.any(1)
    np.testing.assert_array_equal(slot[:, :Lp][valid], host_slot[valid])


@pytest.fixture(scope="module")
def pair():
    jm, params, tm = make_pair("PB_pad", seed=0)
    att, am = make_feats(B=B, seed=1)
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    rs = np.random.RandomState(3)
    seq, pn, pl = random_plans(rs, B, 4)
    return dict(jm=jm, params=params, tm=tm, att=att, am=am, jmem=jmem,
                tmem=tmem, seq=seq, pn=pn, pl=pl)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("predictor", [False, True])
def test_pb_compress_matches_jax(pair, predictor):
    """The per-slot phrase sums over word_embed, or the predictor's own
    table (lp_word_embed)."""
    s = pair
    want = s["jm"].apply(s["params"], jnp.asarray(s["seq"]),
                         jnp.asarray(s["pl"]), predictor=predictor,
                         method="pb_compress")
    with torch.no_grad():
        got = s["tm"].pb_compress(torch.from_numpy(s["seq"]),
                                  torch.from_numpy(s["pl"]), predictor)
    _close(got.numpy(), want)
    assert np.abs(np.asarray(want)).max() > 0


def test_pb_length_predict_matches_jax(pair):
    s = pair
    args = (s["seq"], s["pn"], s["pl"])
    want = s["jm"].apply(s["params"], *map(jnp.asarray, args), s["jmem"],
                         jnp.asarray(s["am"]).astype(bool), True,
                         method="pb_length_predict")
    with torch.no_grad():
        got = s["tm"].pb_length_predict(
            *map(torch.from_numpy, args), s["tmem"],
            torch.from_numpy(s["am"]).bool())
    assert got.shape == (B, L2, 20) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("norm_mode", NORM_MODES)
@pytest.mark.parametrize("hidden", [False, True])
def test_pb_decode_module_matches_jax(pair, norm_mode, hidden):
    """The packed decode over the host packer's layout: log-probs, or the
    hidden states the decode loop's window head reads."""
    s = pair
    ids, slot, mask = tpack.pack_decoder_inputs(s["seq"], s["pn"], s["pl"])
    args = (ids, slot, s["seq"], s["pl"])
    want = s["jm"].apply(s["params"], *map(jnp.asarray, args), s["jmem"],
                         jnp.asarray(s["am"]).astype(bool),
                         jnp.asarray(mask), True, norm_mode=norm_mode,
                         return_hidden=hidden, method="pb_decode")
    with torch.no_grad():
        got = s["tm"].pb_decode(
            *map(torch.from_numpy, args), s["tmem"],
            torch.from_numpy(s["am"]).bool(), torch.from_numpy(mask),
            norm_mode=norm_mode, return_hidden=hidden)
    _close(got.numpy(), want)


@pytest.mark.parametrize("norm_mode", NORM_MODES)
@pytest.mark.parametrize("k", [1, 2])
def test_forward_pb_pad_matches_jax(norm_mode, k):
    """The PB_pad forward (its stand-in layout), with k caption rows an
    image (the decoder grouped over one image's keys)."""
    jm, params, tm = make_pair("PB_pad", seed=2, norm_mode=norm_mode)
    att, am = make_feats(B=3, seed=4)
    rs = np.random.RandomState(k)
    seq, pn, pl = random_plans(rs, 3 * k, 3)
    # the JAX forward frames the syntax plan before its PB branch
    syn = rs.randint(4, 7, size=seq.shape).astype(np.int64)
    args = (seq, pn, pl, syn)
    want = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    *map(jnp.asarray, args), glat_p=-1.0,
                    deterministic=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(att), torch.from_numpy(am),
                 *map(torch.from_numpy, args))
    assert sorted(got) == sorted(want) == ["pb_len_logprob", "pb_logprob"]
    for key in want:
        _close(got[key].numpy(), want[key])


@pytest.fixture(scope="module")
def built():
    return built_cache()


def test_xe_step_matches_jax(built):
    """One PB_pad step over a loader batch's packed layouts: the loss, its
    two terms and every gradient leaf."""
    s = built("PB_pad")
    tm = s["tm"]
    tb = tsteps.to_device(s["batch"], "cpu")
    assert tb["pb_mask"].dtype == torch.bool
    loss, metrics = tsteps.xe_loss_fn(tm, tb, torch.Generator())
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tm.parameters(), grads)]
    close(loss.detach(), s["loss"])
    assert sorted(metrics) == sorted(s["metrics"]) == [
        "length_loss", "loss", "phrase_loss"]
    for k, v in s["metrics"].items():
        close(metrics[k], v)
    same_grads(tm, grads, s["grads"])


def test_xe_step_grad_accum_splits_the_layouts(built):
    """grad_accum 2 cuts the packed layouts at the caption rows of each
    half of the images: each half's loss is that of the half's own batch."""
    s = built("PB_pad")
    tm = s["tm"]
    tb = tsteps.to_device(s["batch"], "cpu")
    n, S = tb["att_feats"].shape[0], tb["labels"].shape[1]
    assert n == 2 and tb["pb_ids"].shape[0] == n * S
    seen = []
    real = tsteps.xe_loss_fn

    def spy(model, batch, *a, **kw):
        seen.append(batch)
        return real(model, batch, *a, **kw)

    class NoStep:
        params = list(tm.parameters())

        def step(self, grads):
            pass

    tsteps.xe_loss_fn = spy
    try:
        tsteps.make_xe_step(tm, NoStep(), grad_accum=2)(tb, None)
    finally:
        tsteps.xe_loss_fn = real
    for g, mb in enumerate(seen):
        assert mb["att_feats"].shape[0] == 1
        for key in tsteps.PB_KEYS:
            assert torch.equal(mb[key], tb[key][g * S:(g + 1) * S])


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


def _jax_decode(s, **kw):
    out = jpb.pb_decode(s["jm"], s["params"], jax.random.PRNGKey(0),
                        s["jmem"], jnp.asarray(s["am"]).astype(bool), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _same_decode(got, want):
    assert sorted(got) == sorted(want)
    for k in ("seq", "phrase_num", "phrase_length"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)
    for k in ("tok_logprobs", "entropy"):
        _close(got[k], want[k])


@pytest.mark.parametrize("core", [False, True], ids=["plain", "core"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_pb_decode_matches_jax(pair, width, core):
    """The decode loop at the default width, a clamping one and the
    lossless one; with the attention core (JAX's kernel in interpret mode,
    the port's plain twin) on every attention of the predictor and the
    packed decoder."""
    s = pair
    W = WIDTHS[width]
    with pallas(s["tm"], core):
        want = _jax_decode(s, packed_width=W)
        st = {}
        got = tpb.pb_decode(s["tm"], s["tmem"],
                            torch.from_numpy(s["am"]).bool(),
                            packed_width=W, stats=st)
    _same_decode({k: v.numpy() for k, v in got.items()}, want)
    assert st["host_syncs"] == st["rounds"] >= st["fills"] > 0
    total = want["phrase_length"].sum(-1)
    assert (total > 0).any()
    if width == "clamping":
        assert (total <= W).all()
        assert (want["phrase_num"] < _jax_decode(
            s, packed_width=LOSSLESS)["phrase_num"]).any()


@pytest.mark.parametrize("width", ["default", "lossless"])
def test_pb_decode_matches_host_oracle(pair, width):
    """pb_decode against the host loop (packed to the same width, so the
    sums run in the same order): the port's and the JAX package's."""
    s = pair
    W = WIDTHS[width] or tpb.default_width(L)
    got = tpb.pb_decode(s["tm"], s["tmem"], torch.from_numpy(s["am"]).bool(),
                        packed_width=W)
    host = tpb.pb_decode_host(s["tm"], torch.from_numpy(s["att"]),
                              torch.from_numpy(s["am"]), pad_to=W)
    jhost = jpb.pb_decode_host(s["jm"], s["params"], jax.random.PRNGKey(0),
                               jnp.asarray(s["att"]), jnp.asarray(s["am"]),
                               pad_to=W)
    for k in ("seq", "phrase_num", "phrase_length"):
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
        np.testing.assert_array_equal(host[k], np.asarray(jhost[k]),
                                      err_msg=k)
        assert host[k].dtype == np.int32


def test_pb_decode_top1_equals_greedy_and_sampling(pair):
    """top1 gives the greedy decode; a sampled decode needs a generator
    and repeats from its seed."""
    s = pair
    src = torch.from_numpy(s["am"]).bool()
    greedy = tpb.pb_decode(s["tm"], s["tmem"], src)
    top1 = tpb.pb_decode(s["tm"], s["tmem"], src, sample_method="top1",
                         generator=torch.Generator().manual_seed(1))
    for k in greedy:
        assert torch.equal(top1[k], greedy[k]), k
    with pytest.raises(ValueError, match="Generator"):
        tpb.pb_decode(s["tm"], s["tmem"], src, sample_method="sample")
    runs = [tpb.pb_decode(s["tm"], s["tmem"], src, sample_method="sample",
                          temperature=2.0,
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.parametrize("Lq,Lk", [(3, 129), (2, 211), (256, 256),
                                   (211, 36)])
def test_attention_core_plain_matches_jax_past_key_bound(Lq, Lk):
    """Past the 128 keys the row path holds: the plain twin against the
    TPU kernel (interpret mode, any Lk), float32 within 1e-5; a fully
    masked row is uniform over its Lk keys; attention_path gives the tile
    (bf16) or ffma (float32) path, also at one query row."""
    B, H, Dh = 2, 2, 16
    rs = np.random.RandomState(Lk)
    q, k, v = (rs.randn(B, H, n, Dh).astype(np.float32)
               for n in (Lq, Lk, Lk))
    mask = rs.rand(B, Lq, Lk) < 0.5
    mask[0, 0] = False
    want = jax_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), interpret=True)
    got = at.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask))
    _close(got.numpy(), want)
    _close(got[0, :, 0].numpy(), v[0].mean(axis=1))
    assert at.attention_path(Lq, Lk, torch.float32) == "ffma"
    assert at.attention_path(Lq, Lk, torch.bfloat16) == "tile"
    assert at.attention_path(1, Lk, torch.bfloat16) == (
        "row" if Lk <= at.KEY_MAX else "tile")


def test_pb_train_cli_checkpoint_reads_in_jax(tmp_path):
    """The port's training CLI trains PB_pad (2 iterations, float32, CPU:
    batches with packed layouts, a validation on decode/pb.py) and writes a
    model.ckpt that the JAX package's eval reads to the port's captions."""
    from boficap_tpu.models.boficap import build_model as jax_build_model
    from boficap_tpu_torch.convert import load_jax_checkpoint
    ck = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.train", "--cfg",
         os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
         "--train_mode", "PB_pad", "--dtype", "float32", "--batch_size", "9",
         "--save_checkpoint_every", "2", "--id", "pb", "--checkpoint_path",
         str(ck), "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "val[PB_pad]" in out.stdout
    infos = jax_state.load_infos(str(ck), "pb")
    assert infos["iter"] == 2
    opt = jax_default_config()
    opt.update(infos["opt"])
    jax_finalize(opt)
    jm = jax_build_model(opt, infos["opt"]["vocab_size"])
    z = jnp.zeros((2, opt.max_length + 2), jnp.int32)
    template = jm.init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((2, 3, opt.att_feat_size)), jnp.ones((2, 3)),
                       z, jnp.ones((2,), jnp.int32), z, z, glat_p=-1.0)
    params = jax_state.load_params(str(ck / "model.ckpt"), template)
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1}
    want = jeu.eval_split(jm, params, jds.CaptionData(opt), dict(kw))
    topt = tconfig.default_config()
    topt.update(infos["opt"])
    tconfig.finalize(topt)
    tdata = tds.CaptionData(topt)
    tm = load_jax_checkpoint(str(ck / "model.ckpt"),
                             tsetup(topt, tdata.vocab_size, device="cpu"))
    got = teu.eval_split(tm, tdata, dict(kw))
    assert [p["caption"] for p in got["predictions"]] == [
        p["caption"] for p in want["predictions"]]
    for g, w in zip(got["predictions"], want["predictions"]):
        assert abs(g["perplexity"] - w["perplexity"]) <= TOL
        assert abs(g["entropy"] - w["entropy"]) <= TOL
