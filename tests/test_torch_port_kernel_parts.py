"""Port parity, the kernel-parts tool's two kernels: the plain twins of
``ops/window_parts.py`` (what the wrappers run on CPU tensors) against the
TPU kernels of ``scripts/bench_kernel_parts.py`` (``abl_layer``,
``hb_layer``) in Pallas interpret mode, on shared weights (CPU).

The script is loaded by its file path (it imports the repo's ``bench``);
its kernels take the block-diagonal masks of ``_block_diag_masks`` over G =
8 samples, the port per-sample masks.  d_model 64, 4 heads, d_ff 128, B =
8, caches of L = 20 rows, R = 5 regions, float32: every output within
1e-5."""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.ops import pallas_decoder_layer as pdl
from boficap_tpu_torch import ops
from boficap_tpu_torch.ops import decoder_layer as dl
from boficap_tpu_torch.ops import window_parts as wp
from tests._torch_port_util import make_pair

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, LC, R = 8, 20, 5     # batch, cache rows, regions
G = 8                   # the script's batch block
TOL = 1e-5
VARIANTS = dict(wp.VARIANTS)


def _script():
    """scripts/bench_kernel_parts.py as a module (it imports ``bench`` from
    the repo root)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "bench_kernel_parts", os.path.join(ROOT, "scripts",
                                           "bench_kernel_parts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = make_pair("UIC", "add", seed=5)
    packed, _ = jbf._fused_ctx(jm, params, "SA")
    return _script(), packed[0], tm.packed_window("SA").layers[0], tm


def _inputs(D, W, seed):
    """numpy operands from a seed: x, random caches and cross K/V, a tgt
    mask with one fully masked query row, a src mask with one padded
    region."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, W, D).astype(np.float32)
    kc, vc = (rs.randn(B, LC, D).astype(np.float32) for _ in range(2))
    k2, v2 = (rs.randn(B, R, D).astype(np.float32) for _ in range(2))
    tgt = rs.rand(B, W, LC + W) < 0.6
    tgt[3, 2] = False
    src = np.ones((B, R), bool)
    src[0, -1] = False
    return x, kc, vc, k2, v2, tgt, src


def _jax(fn, jw, ops_np, H, **kw):
    x, kc, vc, k2, v2, tgt, src = ops_np
    tm_big, sm_big = pdl._block_diag_masks(jnp.asarray(tgt),
                                           jnp.asarray(src), G)
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a) for a in (x, kc, vc, k2, v2)), tm_big,
                 sm_big, jw, num_heads=H, block_b=G, **kw)
    return [np.asarray(o, np.float32) for o in out]


def _close(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layer_parts_twin_matches_jax(setup, variant):
    """#10: each of the tool's variants at W = 8 -> (out, k_new, v_new)."""
    script, jw, tw, tm = setup
    parts = VARIANTS[variant]
    ops_np = _inputs(tm.d_model, 8, seed=1)
    want = _jax(script.abl_layer, jw, ops_np, tm.num_heads, parts=parts)
    ops.reset_launch_counts()
    got = wp.fused_window_layer_parts(*map(torch.from_numpy, ops_np), tw,
                                      tm.num_heads, parts)
    assert wp.fused_window_layer_parts.launches == 0
    _close(got, want)
    if variant == "empty":
        for g in got:
            assert torch.equal(g, torch.from_numpy(ops_np[0]))


@pytest.mark.parametrize("W", [8, 16])
def test_layer_hb_twin_matches_jax(setup, W):
    """#11 at W = 8 and 16 -> (out, k_new, v_new)."""
    script, jw, tw, tm = setup
    ops_np = _inputs(tm.d_model, W, seed=2 + W)
    want = _jax(script.hb_layer, jw, ops_np, tm.num_heads)
    got = wp.fused_window_layer_hb(*map(torch.from_numpy, ops_np), tw,
                                   tm.num_heads)
    assert wp.fused_window_layer_hb.launches == 0
    _close(got, want)


def test_layer_hb_shared_max_far_below(setup):
    """#11 where head 0's cross-attention scores sit about 60 above every
    other head's, so the one max across heads leaves the others' exp near
    1e-26: the twin and the TPU kernel agree and stay finite.  Head 0's
    cross query is made its bias alone (the same vector u in every row),
    and head 0's cross keys multiples of u scoring 55-65 against it."""
    script, jw, tw, tm = setup
    H, D = tm.num_heads, tm.d_model
    Dh = D // H
    rs = np.random.RandomState(8)
    u = rs.randn(Dh).astype(np.float32)
    jw = {**jw, "wq2h": jw["wq2h"].at[:, :Dh].set(0.0),
          "bq2h": jw["bq2h"].at[:Dh].set(u)}
    tw = {**tw, "wq2": tw["wq2"].clone(), "bq2": tw["bq2"].clone()}
    tw["wq2"][:, :Dh] = 0.0
    tw["bq2"][:Dh] = torch.from_numpy(u)
    x, kc, vc, k2, v2, tgt, src = _inputs(D, 8, seed=7)
    target = rs.uniform(55, 65, (B, R, 1)).astype(np.float32)
    k2[..., :Dh] = target * (np.sqrt(Dh) / (u @ u)) * u
    # the other heads' largest score in each row, on the twin's query
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, kc=kc, vc=vc, tgt=tgt).items()}
    n0 = dl.refnorm_plain(t["x"], tw["s0"], tw["b0"])
    q, k, v = dl.linear_plain(n0, tw["wqkv"], tw["bqkv"]).split(D, -1)
    att = wp.hb_attention_plain(q, torch.cat([t["kc"], k], 1),
                                torch.cat([t["vc"], v], 1), t["tgt"], H)
    x1 = dl.linear_plain(att, tw["wo"], tw["bo"], res=t["x"])
    q2 = dl.linear_plain(dl.refnorm_plain(x1, tw["s1"], tw["b1"]),
                         tw["wq2"], tw["bq2"]).numpy()
    s = np.einsum("bqhd,bkhd->bqhk", q2.reshape(B, 8, H, Dh),
                  k2.reshape(B, R, H, Dh)) / np.sqrt(Dh)
    s = np.where(src[:, None, None, :], s, -np.inf)
    gap = s[:, :, 0].max(-1) - s[:, :, 1:].max((-2, -1))
    assert 45 < gap.min() and gap.max() < 75
    ops_np = (x, kc, vc, k2, v2, tgt, src)
    want = _jax(script.hb_layer, jw, ops_np, H)
    got = wp.fused_window_layer_hb(*map(torch.from_numpy, ops_np), tw, H)
    for g in got:
        assert torch.isfinite(g).all()
    _close(got, want)


def test_tool_runs_on_cpu(setup):
    """The port's kernel-parts tool (``python -m
    boficap_tpu_torch.tools.bench_kernel_parts``) drives both of the
    script's mains on the plain twins: each variant's stack, and #11
    against #8 one layer apart by rounding only (every key visible)."""
    from boficap_tpu_torch.tools import bench_kernel_parts as tool
    _, _, _, tm = setup
    lines = []
    kw = dict(batch=2, warm=0, reps=1, out=lines.append)
    parts = tool.run_parts(tm, seed=0, regions=5, **kw)
    hb = tool.run_hb(tm, seed=0, regions=5, **kw)
    assert list(parts) == [name for name, _ in wp.VARIANTS]
    assert set(hb) == {"one_layer_max_abs_diff", "hb_w8", "cur_w8", "hb_w16",
                       "cur_w16"}
    assert hb["one_layer_max_abs_diff"] < 1e-5
    assert len(lines) == len(parts) + len(hb)
    hb.pop("one_layer_max_abs_diff")
    assert all(r["ms"] > 0 for r in (*parts.values(), *hb.values()))


def test_full_parts_is_the_window_layer(setup):
    """Every part on: the twin is #8's (``window_layer_plain``) bitwise."""
    _, _, tw, tm = setup
    args = (*map(torch.from_numpy, _inputs(tm.d_model, 8, seed=3)), tw,
            tm.num_heads)
    for g, w in zip(wp.fused_window_layer_parts(*args, wp.ALL_PARTS),
                    dl.window_layer_plain(*args)):
        assert torch.equal(g, w)


def test_unknown_part_raises(setup):
    _, _, tw, tm = setup
    args = (*map(torch.from_numpy, _inputs(tm.d_model, 8, seed=4)), tw,
            tm.num_heads)
    with pytest.raises(ValueError, match="unknown part"):
        wp.fused_window_layer_parts(*args, {"proj", "attn"})
    with pytest.raises(ValueError, match="unknown part"):
        wp.window_layer_parts_plain(*args, "proj")
    with pytest.raises(ValueError, match="unknown part"):
        wp.kernel_launches({"ffn", "mlp"})


def test_kernel_launches_by_variant():
    """The launches csrc/window_parts.cu makes a call, by variant: 11 for
    the full layer (as #8: three norms, six products, two attentions), a
    switch dropping its part's launches, no copy launch while ``proj`` is
    on (the qkv product's epilogue writes q and the fresh K/V)."""
    totals = {name: sum(wp.kernel_launches(parts).values())
              for name, parts in wp.VARIANTS}
    assert totals == {"full": 11, "no_self": 10, "no_cross": 7, "no_ffn": 8,
                      "no_norm": 8, "proj_only": 2, "empty": 1}
    assert wp.kernel_launches(wp.ALL_PARTS) == {
        "refnorm": 3, "products": 6, "attention": 2, "copy": 0}
    for _, parts in wp.VARIANTS:
        if "proj" in parts:
            assert wp.kernel_launches(parts)["copy"] == 0
    assert wp.kernel_launches(frozenset()) == {
        "refnorm": 0, "products": 0, "attention": 0, "copy": 1}
    # without proj one norm launch writes n0 into k_new and v_new
    assert wp.kernel_launches({"norm", "cross"}) == {
        "refnorm": 2, "products": 2, "attention": 1, "copy": 0}
    assert wp.HB_LAUNCHES == {"refnorm": 3, "products": 6, "hb_attention": 2}
    assert wp.parts_mask(wp.ALL_PARTS) == 31
    assert [wp.parts_mask({p}) for p in wp.PARTS] == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_product_tiles_fill_the_card(dtype):
    """The tile plan's mirror (csrc/window_parts.cu
    ``bfc_window_parts_tile``): at B = 64, W = 8 (512 rows) each of the
    layer's six products runs at least 120 blocks on the 132 SMs; at bf16
    the tile follows N alone (BM 64, BN 32 / 64 / 128 for D, 3D, d_ff), so
    a B = 7 call takes the same tiles and rows stay bitwise
    batch-independent."""
    D, F = 512, 2048
    big = wp.layer_products(64, 8, D, F)
    small = wp.layer_products(7, 8, D, F)
    assert [p[0] for p in big] == ["qkv", "out", "q2", "out2", "w1", "w2"]
    for (name, M, N, K), (_, m7, n7, _) in zip(big, small):
        bm, bn, blocks = wp.product_tile(M, N, dtype)
        assert blocks >= 120, (name, blocks)
        assert blocks == -(-M // bm) * -(-N // bn)
        if dtype == torch.bfloat16:
            assert bm == 64 and bn == {D: 32, 3 * D: 64, F: 128}[N]
            assert wp.product_tile(m7, n7, dtype)[:2] == (bm, bn)
        else:
            assert (bm, bn) == wp.ffma_tile(M, N)
    assert [wp.tile_n(n) for n in (96, 512, 1023, 1024, 1536, 2047, 2048)] \
        == [32, 32, 32, 64, 64, 64, 128]


def _parent_hb_bytes(Lk, D, H):
    # the hb block this design replaced: every head's scores and one
    # head's K or V, float32, at once
    return 4 * (16 * D + 16 * H * Lk + Lk * (D // H + 1) + 16) + 16 * Lk


@pytest.mark.parametrize("esize", [2, 4])
def test_hb_shared_memory_fits(esize):
    """The hb block's staging (its heads' K and V in two chunks of 64 keys,
    every key's score) fits the card's 227 KB up to 256 keys at D = 512
    at both dtypes, grows with the keys, and takes at least as many keys
    as the block it replaced at every width tried."""
    assert wp.hb_cluster(8) == 8 and wp.hb_cluster(3) == 1
    assert wp.hb_cluster(12) == 4 and wp.hb_cluster(6) == 2
    sizes = [wp.hb_shared_bytes(Lk, 512, 8, esize) for Lk in range(1, 257)]
    assert max(sizes) == sizes[-1] <= dl.SMEM_LIMIT
    assert all(a < b for a, b in zip(sizes, sizes[1:]))
    # one head a block: Q 16 x 64 float32, two chunks of K or V (64
    # elements + 16 bytes a key), 16 score rows, 32 maxima, the mask bytes
    row = 64 * esize + 16
    assert wp.hb_shared_bytes(28, 512, 8, esize) == (
        4 * 16 * 64 + 2 * 28 * row + 4 * 16 * 28 + 128 + 16 * 28)
    assert wp.hb_shared_bytes(196, 512, 8, esize) == (
        4 * 16 * 64 + 2 * 64 * row + 4 * 16 * 196 + 128 + 16 * 196)

    def most_keys(fn):
        return max(k for k in range(1, 4000) if fn(k) <= dl.SMEM_LIMIT)

    for D, H in ((512, 8), (96, 3), (768, 12), (256, 4)):
        assert most_keys(lambda k: wp.hb_shared_bytes(k, D, H, esize)) >= \
            most_keys(lambda k: _parent_hb_bytes(k, D, H))


def test_staging_limits_raise():
    """A shape the hb block cannot stage raises ValueError before any
    launch (float32: 3000 cross keys over 8 heads, 900 over 3: every
    key's score row passes 227 KB); the window widths and key counts the
    tool and the card tests use pass, and so do key counts past the
    replaced block's limits (253 keys at D = 512, 665 at D = 96)."""
    wp.check_staging(20, 8, 36, 512, 8, torch.bfloat16)
    wp.check_staging(20, 16, 196, 512, 8, torch.float32)
    wp.check_staging(9, 16, 196, 96, 3, torch.float32)
    wp.check_staging(500, 8, 36, 512, 8, torch.float32)
    wp.check_staging(9, 8, 700, 96, 3, torch.float32)
    with pytest.raises(ValueError, match="hb block"):
        wp.check_staging(20, 8, 900, 96, 3, torch.float32)
    with pytest.raises(ValueError, match="self-attention"):
        wp.check_staging(3000, 8, 36, 512, 8, torch.float32)
