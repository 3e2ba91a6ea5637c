"""Port parity, kernels: the plain PyTorch versions of the port's layer
and head kernels (what the wrappers run on CPU tensors) against the JAX
package's Pallas kernels run in interpret mode, as tests/test_pallas.py
runs them (float32, CPU).  The CUDA kernels themselves are held against
these plain versions on the card (chip_smoke.py, test_torch_port_cuda.py).
"""

import ctypes
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.models import layers as jl
from boficap_tpu.ops import pallas_decoder_layer as pdl
from boficap_tpu_torch.convert import load_jax_params
from boficap_tpu_torch.models import layers as tl
from boficap_tpu_torch.ops import attention as at
from boficap_tpu_torch.ops import decoder_layer as dl
from boficap_tpu_torch.ops import stack as st
from tests._torch_port_util import to_numpy_tree

CSRC = Path(dl.__file__).resolve().parent.parent / "csrc"
D, H, F = 64, 4, 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _jittered(module, *args):
    params = module.init(jax.random.PRNGKey(0), *args)
    tree = to_numpy_tree(jax.device_get(params))
    rs = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: (a + rs.randn(*a.shape) * 0.1).astype(np.float32), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_encoder_layer_plain_matches_pallas():
    """Padded regions and one sample with every region masked."""
    rs = np.random.RandomState(0)
    B, R = 4, 5
    x = rs.randn(B, R, D).astype(np.float32)
    src = np.ones((B, R), bool)
    src[1, -2:] = False
    src[2] = False
    jm = jl.Encoder(1, D, F, H, 0.0, jnp.float32)
    tree = _jittered(jm, jnp.asarray(x), jnp.asarray(src))
    packed, _ = pdl.pack_encoder_weights(
        jax.tree_util.tree_map(jnp.asarray, tree["params"]), jnp.float32)
    G = math.gcd(B, 8)
    m_big, _ = pdl._block_diag_masks(
        jnp.broadcast_to(jnp.asarray(src)[:, None, :], (B, R, R)),
        jnp.asarray(src), G)
    want = pdl.fused_encoder_layer(jnp.asarray(x), m_big, packed[0],
                                   num_heads=H, interpret=True)
    enc = load_jax_params(tl.Encoder(1, D, F, H), tree)
    w = dl.pack_encoder_layer(enc.layer0, torch.float32)
    got = dl.fused_encoder_layer(_t(x), _t(src), w, H)     # CPU: plain twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        dl.encoder_layer_plain(_t(x), _t(src), w, H).numpy(),
        np.asarray(want), **TOL)


def test_decoder_layer_plain_matches_pallas():
    """NA fill masks: keys < total (one empty plan), padded source."""
    rs = np.random.RandomState(1)
    B, L, R = 4, 8, 5
    x = rs.randn(B, L, D).astype(np.float32)
    mem = rs.randn(B, R, D).astype(np.float32)
    total = np.array([0, 3, 8, 5])
    tgt = np.broadcast_to(np.arange(L)[None, None, :] < total[:, None, None],
                          (B, L, L)).copy()
    src = np.ones((B, R), bool)
    src[3, -3:] = False
    jm = jl.Decoder(1, D, F, H, 0.0, jnp.float32)
    args = [jnp.asarray(a) for a in (x, mem, src, tgt)]
    tree = _jittered(jm, *args)
    packed, _ = pdl.pack_decoder_weights(
        jax.tree_util.tree_map(jnp.asarray, tree["params"]), jnp.float32)
    tm_big, sm_big = pdl._block_diag_masks(jnp.asarray(tgt),
                                           jnp.asarray(src), math.gcd(B, 8))
    want = pdl.fused_decoder_layer(jnp.asarray(x), jnp.asarray(mem), tm_big,
                                   sm_big, packed[0], num_heads=H,
                                   interpret=True)
    dec = load_jax_params(tl.Decoder(1, D, F, H), tree)
    w = dl.pack_layer_weights(dec.layer0, torch.float32)
    got = dl.fused_decoder_layer(_t(x), _t(mem), _t(tgt), _t(src), w, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["random", "tie", "padded"])
def test_greedy_head_plain_matches_pallas(case):
    """ids identical (first maximum on a planted tie), token logprob,
    entropy and the PAD column's logprob within 1e-5.  "padded": V = 1001
    (not a multiple of 8) through the zero-padded pack (``pad_head``), with
    a tie between column 600 and the last real column V - 1."""
    rs = np.random.RandomState(2)
    B, T = 3, 7
    V = 1001 if case == "padded" else 1000   # not a multiple of any tile
    pad_id = 7
    h = rs.randn(B, T, D).astype(np.float32)
    w = (rs.randn(D, V) * 0.05).astype(np.float32)
    b = (rs.randn(V) * 0.01).astype(np.float32)
    if case == "tie":
        for c in (517, 900):
            w[:, c] = w[:, 13]
        b[[13, 517, 900]] = 30.0
    if case == "padded":
        w[:, V - 1] = w[:, 600]
        b[[600, V - 1]] = 30.0
    want = pdl.fused_greedy_head(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b), pad_id=pad_id,
                                 interpret=True)
    if case == "padded":
        pack = dl.pad_head(_t(w), _t(b))
        assert pack.w.shape == (D, 1008) and pack.V == V
        got = dl.fused_greedy_head(_t(h), *pack, pad_id=pad_id)
    else:
        got = dl.fused_greedy_head(_t(h), _t(w), _t(b), pad_id=pad_id)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case == "tie":
        assert (got[0] == 13).all()
    if case == "padded":
        assert (got[0] == 600).all()
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [9491, 1000])
def test_pack_head_weights_pads(dtype, V):
    """pack_head_weights pads W [D, V] and b [V] with zero columns to the
    next multiple of 8 (16-byte rows at bf16, for TMA), keeps the real
    columns bit for bit and carries V."""
    rs = np.random.RandomState(4)
    proj = tl.Dense(D, V)
    with torch.no_grad():
        proj.weight.copy_(_t(rs.randn(V, D).astype(np.float32)))
        proj.bias.copy_(_t(rs.randn(V).astype(np.float32)))
    pack = dl.pack_head_weights(proj, dtype)
    Vp = -(-V // 8) * 8
    assert pack.V == V and pack.w.shape == (D, Vp) and pack.b.shape == (Vp,)
    assert pack.w.dtype == dtype and pack.w.is_contiguous()
    w, b = dl._kernel_of(proj, dtype), proj.bias.detach().to(dtype)
    assert torch.equal(pack.w[:, :V], w) and torch.equal(pack.b[:V], b)
    assert not pack.w[:, V:].any() and not pack.b[V:].any()


def test_wrappers_reject_other_devices():
    """CPU tensors take the plain twin; a device with no kernel raises."""
    x = torch.zeros((1, 2, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dl.fused_encoder_layer(x, None, {}, H)


def test_launch_counts_untouched_on_cpu():
    from boficap_tpu_torch import ops
    from boficap_tpu_torch.ops.attention import attention_core
    ops.reset_launch_counts()
    h = torch.randn(1, 2, D)
    dl.fused_greedy_head(h, *dl.pad_head(torch.randn(D, 9), torch.randn(9)))
    q = torch.randn(1, 2, 3, 8)
    attention_core(q, q, q, torch.ones(1, 3, 3, dtype=torch.bool))
    dl.fused_linear(h, torch.randn(D, 9), torch.randn(9))
    dl.fused_refnorm(h, torch.ones(D), torch.zeros(D))
    assert ops.launch_counts() == {
        "encoder_layer": 0, "decoder_layer": 0, "greedy_head": 0,
        "window_layer": 0, "linear": 0, "refnorm": 0, "encoder_stack": 0,
        "decoder_stack": 0, "window_stack": 0, "window_wide_stack": 0,
        "attention_core": 0, "window_layer_parts": 0, "window_layer_hb": 0}


@pytest.mark.parametrize("width", [512, 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_refnorm_plain_matches_jax(dtype, width):
    """RefLayerNorm's plain twin (what fused_refnorm runs on CPU tensors)
    against the JAX package's _refnorm on the same numpy rows, at the
    serving width and an odd one: float32 within 1e-5, bf16 within one bf16
    ulp of the JAX result; the plain route counts no launch."""
    rs = np.random.RandomState(width)
    x = (rs.randn(6, 5, width) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(width)).astype(np.float32)
    bias = (0.1 * rs.randn(width)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(pdl._refnorm(jnp.asarray(xt.float().numpy()).astype(jdt),
                                   jnp.asarray(scale), jnp.asarray(bias), jdt)
                      .astype(jnp.float32))
    dl.fused_refnorm.launches = 0
    got = dl.fused_refnorm(xt, _t(scale), _t(bias))
    assert got.dtype == dtype and dl.fused_refnorm.launches == 0
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        _, e = np.frexp(np.maximum(np.abs(want), 1e-30))
        err = np.abs(got.float().numpy() - want)
        assert (err <= np.ldexp(np.ones_like(want), e - 8)).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,with_res", [(False, False), (True, True)])
def test_fused_linear_runs_plain_on_cpu(dtype, relu, with_res):
    """On CPU tensors the product's wrapper is linear_plain, bit for bit,
    at any width (the TMA width rule binds only the card), and its launch
    count stays 0."""
    rs = np.random.RandomState(3)
    M, K, N = 5, 12, 10

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)

    a, w, b = t(M, K), t(K, N), t(N)
    res = t(M, N) if with_res else None
    dl.fused_linear.launches = 0
    got = dl.fused_linear(a, w, b, relu=relu, res=res)
    assert torch.equal(got, dl.linear_plain(a, w, b, relu=relu, res=res))
    assert got.dtype == dtype and got.shape == (M, N)
    assert dl.fused_linear.launches == 0


def test_product_shape_check():
    """The layer kernels' bf16 product (TMA) takes widths that are
    multiples of 8 and 16-byte aligned operands; float32 takes any."""
    bf = torch.bfloat16
    dl.check_product_shape(bf, {"D": 96, "d_ff": 200},
                           {"x": torch.zeros(4, 96, dtype=bf)})
    dl.check_product_shape(torch.float32, {"D": 100, "d_ff": 3},
                           {"x": torch.zeros(9)[1:]})
    for bad in ({"D": 100, "d_ff": 200}, {"D": 96, "d_ff": 196}):
        with pytest.raises(ValueError, match="multiples of 8"):
            dl.check_product_shape(bf, bad)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dl.check_product_shape(bf, {"K": 8},
                               {"a": torch.zeros(9, dtype=bf)[1:]})


def _window_operands(dtype, D=16, F=24, Hn=2, NL=2, B=2, W=3, L=5, R=4):
    """Small window-kernel operands from a seed: stacked weights [NL, ...]
    (norms float32), x [B,W,D], caches [NL,B,L,D], cross K/V [NL,B,R,D],
    window starts, tgt [B,W,L+W] with a fully masked row, src [B,R]."""
    rs = np.random.RandomState(9)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dt)

    stacked = {k: t(*s, dt=torch.float32 if k in dl._NORM_KEYS
                    else dtype) * 0.3
               for k, s in dl.weight_shapes(dl._WIN_KEYS, D, F,
                                            (NL,)).items()}
    tgt = torch.from_numpy(rs.rand(B, W, L + W) < 0.6)
    tgt[0, 1] = False
    src = torch.ones(B, R, dtype=torch.bool)
    src[1, -1] = False
    norm = (t(D, dt=torch.float32), t(D, dt=torch.float32))
    return (stacked, norm, t(B, W, D), t(NL, B, L, D), t(NL, B, L, D),
            t(NL, B, R, D), t(NL, B, R, D),
            torch.tensor([0, L - W], dtype=torch.int32), tgt, src)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_wrappers_run_plain_on_cpu(dtype):
    """On CPU tensors #8, #6 and #7's wrappers are their plain twins, bit
    for bit, and count no launch."""
    from boficap_tpu_torch import ops
    stacked, norm, x, kc, vc, k2, v2, ws, tgt, src = _window_operands(dtype)
    Hn, L = 2, kc.shape[2]
    ops.reset_launch_counts()
    w0 = {k: v[0] for k, v in stacked.items()}
    args = (x, kc[0], vc[0], k2[0], v2[0], tgt, src, w0, Hn)
    for g, p in zip(dl.fused_window_decoder_layer(*args),
                    dl.window_layer_plain(*args)):
        assert torch.equal(g, p)
    got = st.fused_window_decoder_stack(x, ws, kc.clone(), vc.clone(), k2, v2,
                                        tgt, src, stacked, norm, Hn)
    want = st.window_stack_plain(x, ws, kc.clone(), vc.clone(), k2, v2, tgt,
                                 src, stacked, norm, Hn)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    xw = torch.cat([x, x[:, :L - x.shape[1]]], 1)
    tw = torch.ones(x.shape[0], L, L, dtype=torch.bool)
    for g, p in zip(
            st.fused_window_wide_stack(xw, k2, v2, tw, src, stacked, norm, Hn),
            st.window_wide_stack_plain(xw, k2, v2, tw, src, stacked, norm,
                                       Hn)):
        assert torch.equal(g, p)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("D,F", [(20, 24), (16, 28)])
def test_window_width_check_before_launch(monkeypatch, D, F):
    """The window wrappers' launch paths (``window_layer_call``,
    ``_launch_stack``) raise ValueError on a bf16 D or d_ff that is not a
    multiple of 8 before they reach the kernel libraries; float32 and good
    bf16 widths go on to them."""
    def no_launch():
        raise AssertionError("reached the kernel libraries")

    monkeypatch.setattr(dl, "_kernels", no_launch)
    monkeypatch.setattr(st, "_kernels", no_launch)
    for dtype, d, f, err in ((torch.bfloat16, D, F, ValueError),
                             (torch.float32, D, F, AssertionError),
                             (torch.bfloat16, 16, 24, AssertionError)):
        stacked, norm, x, kc, vc, k2, v2, ws, tgt, src = _window_operands(
            dtype, D=d, F=f)
        w0 = {k: v[0] for k, v in stacked.items()}
        with pytest.raises(err):
            dl.window_layer_call(x, kc[0], vc[0], k2[0], v2[0], tgt, src, w0,
                                 2)
        with pytest.raises(err):
            st._launch_stack("window_stack", x, kc, vc, k2, v2, ws,
                             tgt, src, stacked, 2, kc.shape[2] + x.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_bound_check_before_launch(monkeypatch, dtype):
    """The layer and stack wrappers' launch paths hand attentions past the
    row path's KEY_MAX keys to the kernel libraries (196: a 14 x 14 image
    grid; the encoder's self-attention and every cross-attention), and
    raise ValueError before they reach them where a block's staging would
    exceed the card's shared memory (dl.SMEM_LIMIT), or where the window
    layers' self-attention (a cache and fresh rows) would pass KEY_MAX."""
    def no_launch():
        raise AssertionError("reached the kernel libraries")

    monkeypatch.setattr(dl, "_kernels", no_launch)
    monkeypatch.setattr(st, "_kernels", no_launch)
    rs = np.random.RandomState(4)
    d, f, hn, B, Lq = 16, 24, 2, 2, 3
    over = 3000          # regions whose staging exceeds SMEM_LIMIT

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)

    def weights(keys):
        return {k: (torch.ones(sh) if k in dl._NORM_KEYS else t(*sh))
                for k, sh in dl.weight_shapes(keys, d, f).items()}

    for rows in (196, over):
        fits = all(dl.shared_bytes(q, rows, d // hn, dtype) <= dl.SMEM_LIMIT
                   for q in (rows, Lq))
        assert fits == (rows == 196)
    enc, dec = weights(dl._ENC_KEYS), weights(dl._DEC_KEYS)
    for rows, err in ((196, AssertionError), (over, ValueError)):
        x = t(B, rows, d)
        mask = torch.ones(B, rows, dtype=torch.bool)
        with pytest.raises(err, match="shared memory" if err is ValueError
                           else "kernel libraries"):
            dl.encoder_call("encoder_layer", x, mask, enc, hn)
        with pytest.raises(err, match="shared memory" if err is ValueError
                           else "kernel libraries"):
            dl.decoder_call("decoder_layer", t(B, Lq, d), x,
                            torch.ones(B, Lq, Lq, dtype=torch.bool), mask,
                            dec, hn)
    stacked, norm, x, kc, vc, k2, v2, ws, tgt, src = _window_operands(dtype)
    W = x.shape[1]
    w0 = {k: v[0] for k, v in stacked.items()}
    # the cross-attention over 196 regions goes on to the libraries
    k2r = torch.zeros(k2.shape[0], B, 196, d, dtype=dtype)
    src_r = torch.ones(B, 196, dtype=torch.bool)
    with pytest.raises(AssertionError, match="kernel libraries"):
        dl.window_layer_call(x, kc[0], vc[0], k2r[0], k2r[0], tgt, src_r, w0,
                             hn)
    with pytest.raises(AssertionError, match="kernel libraries"):
        st._launch_stack("window_stack", x, kc, vc, k2r, k2r, ws, tgt, src_r,
                         stacked, hn, kc.shape[2] + W)
    # the self-attention over a cache and the window: at most KEY_MAX keys
    big = torch.zeros(kc.shape[0], B, dl.KEY_MAX + 1 - W, d, dtype=dtype)
    tgt_big = torch.ones(B, W, dl.KEY_MAX + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="key bound"):
        dl.window_layer_call(x, big[0], big[0], k2[0], v2[0], tgt_big, src,
                             w0, hn)
    with pytest.raises(ValueError, match="key bound"):
        st._launch_stack("window_stack", x, big, big, k2, v2, ws, tgt_big,
                         src, stacked, hn, dl.KEY_MAX + 1)


@pytest.mark.parametrize("NL", [1, 2, 6])
def test_decoder_launches_mirror(NL):
    """``decoder_launches``, the Python mirror of csrc/decoder_layer.cu's
    launches by kind (chip_smoke.layer_split holds the card's profile to
    it): #2 launches 12 kernels; the stack one product for every layer's
    cross K|V, then each layer's launches without its own projection (67
    at the serving NL = 6, where one launch a layer projected its own)."""
    layer = dl.decoder_launches()
    assert layer == {"products": 7, "attention": 2, "refnorm": 3}
    stack = dl.decoder_launches(NL)
    assert set(stack) == set(layer)
    assert stack["products"] == 1 + NL * (layer["products"] - 1)
    assert all(stack[k] == NL * layer[k] for k in ("attention", "refnorm"))
    assert sum(stack.values()) == NL * sum(layer.values()) - (NL - 1)


def test_decoder_stack_needs_side_by_side_kv(monkeypatch):
    """The stack's launch path (``decoder_call`` with NL) raises ValueError,
    before it reaches the kernel libraries, on weights without
    ``wkv2_all`` or with one of the wrong shape; ``pack_decoder_stack``'s
    weights go on to them."""
    def no_launch():
        raise AssertionError("reached the kernel libraries")

    monkeypatch.setattr(dl, "_kernels", no_launch)
    rs = np.random.RandomState(5)
    d, f, hn, B, Lq, R, NL = 16, 24, 2, 2, 3, 4, 2

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    stacked = {k: (torch.ones(sh) if k in dl._NORM_KEYS else t(*sh))
               for k, sh in dl.weight_shapes(dl._DEC_KEYS, d, f, (NL,)).items()}
    args = (t(B, Lq, d), t(B, R, d), torch.ones(B, Lq, Lq, dtype=torch.bool),
            torch.ones(B, R, dtype=torch.bool))
    with pytest.raises(ValueError, match="wkv2_all"):
        dl.decoder_call("decoder_stack", *args, stacked, hn, NL=NL)
    stacked["wkv2_all"] = t(d, 2 * d)
    with pytest.raises(ValueError, match="wkv2_all"):
        dl.decoder_call("decoder_stack", *args, stacked, hn, NL=NL)
    stacked["wkv2_all"] = t(d, NL * 2 * d)
    with pytest.raises(AssertionError, match="kernel libraries"):
        dl.decoder_call("decoder_stack", *args, stacked, hn, NL=NL)


def _c_entries():
    """(library, entry) for every C entry the kernel libraries export."""
    from boficap_tpu_torch.ops._build import SIGNATURES
    return [(lib, fn) for lib, fns in SIGNATURES.items() for fn in fns]


@pytest.mark.parametrize("lib,entry", _c_entries())
def test_signatures_mirror_c(lib, entry):
    """Each entry's ctypes signature in ops/_build.py SIGNATURES lists the
    argument and return kinds of its extern "C" definition: pointer, int,
    long long, int pointer (the card loads the symbol, but ctypes cannot
    check its arguments)."""
    from boficap_tpu_torch.ops._build import SIGNATURES
    src = (CSRC / f"{lib}.cu").read_text() + (CSRC / "common.cuh").read_text()
    m = re.search(r'extern "C" ([\w\s\*]+?)\s*\b' + entry + r"\((.*?)\)\s*\{",
                  src, re.S)
    assert m, f"{entry} not defined in {lib}.cu"

    def kind(decl: str) -> str:
        d = decl.replace(" ", "")
        if "char*" in d:
            return "str"
        if d.startswith("int*"):
            return "iptr"
        if "*" in d:
            return "ptr"
        return "ll" if d.startswith("longlong") else "int"

    params = [p for p in m.group(2).split(",") if p.strip()]
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_longlong: "ll", ctypes.c_char_p: "str",
             ctypes.POINTER(ctypes.c_int): "iptr"}
    argtypes, restype = SIGNATURES[lib][entry]
    assert [kind(p) for p in params] == [kinds[t] for t in argtypes]
    assert kind(m.group(1)) == kinds[restype]


@pytest.mark.parametrize("entry,mirror", [
    ("encoder_layer", dl._EncoderLayerArgs),
    ("decoder_layer", dl._DecoderLayerArgs),
    ("window_layer", dl._WindowLayerArgs),
    ("window_stack", st._WindowStackArgs),
    ("window_parts", dl._WindowLayerArgs),
    ("attention_core", at._AttentionCoreArgs)])
def test_args_struct_mirrors_c(entry, mirror):
    """The wrapper's ctypes struct lists the C entry's argument struct
    fields in order, each a pointer, long long or int as in C (the card
    checks only the total size)."""
    src = (CSRC / f"{entry}.cu").read_text()
    body = re.search(r"struct Bfc\w+Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = ("ptr" if "*" in decl else
                "ll" if decl.startswith("long long") else "int")
        names = re.sub(r"^(const\s+)?(void|float|long long|int)\s*", "",
                       decl)
        fields += [(n.strip(" *"), kind) for n in names.split(",")]
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "ll",
             ctypes.c_int: "int"}
    assert fields == [(n, kinds[t]) for n, t in mirror._fields_]


@pytest.mark.parametrize("Lq", [1, 20, 196])
def test_attention_plain_normalises_before_rounding_past_key_max(Lq):
    """``attention_plain`` at bf16 over 196 keys (two of the kernels'
    KEY_MAX chunks) with padded keys and a fully masked sample is the
    reference's form bitwise: the float32 softmax, normalised, rounded to
    bf16, then multiplied by V (pallas_decoder_layer.py:117); and so it is
    at KEY_MAX keys."""
    rs = np.random.RandomState(Lq)
    B, Hn, Dh, Lk = 3, 2, 16, 196
    bf = torch.bfloat16

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(bf)

    q, k, v = t(B, Lq, Hn * Dh), t(B, Lk, Hn * Dh), t(B, Lk, Hn * Dh)
    mask = torch.arange(Lk)[None, :] < torch.tensor([Lk, 150, 0])[:, None]
    assert Lk > dl.KEY_MAX
    for keys in (Lk, dl.KEY_MAX):
        s = torch.einsum("bqhd,bkhd->bhqk",
                         q.float().reshape(B, Lq, Hn, Dh),
                         k[:, :keys].float().reshape(B, keys, Hn, Dh))
        s = torch.where(mask[:, None, None, :keys], s / math.sqrt(Dh),
                        dl.MASK_FILL)
        p = torch.softmax(s, -1).to(bf).float()
        want = torch.einsum("bhqk,bkhd->bqhd", p,
                            v[:, :keys].float().reshape(B, keys, Hn, Dh))
        got = dl.attention_plain(q, k[:, :keys], v[:, :keys],
                                 mask[:, :keys], Hn)
        assert torch.equal(got, want.to(bf).reshape(B, Lq, -1)), keys
