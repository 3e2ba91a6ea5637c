"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card and nvcc every test here skips with
the probe's reason.  Run on the GPU machine with

    python -m pytest tests/test_torch_port_cuda.py -m cuda

Shapes are small and deliberately ragged (not multiples of the 64-wide
tiles) so the kernels' edge masking is exercised; ``chip_smoke.py``
checks the serving shapes.  The product of the layer and window kernels
(``fused_linear``), bf16 on the tensor cores and float32 on FFMA, is
checked on its own at ragged shapes up to 2304 rows, and for bitwise batch
independence; so is the head at both dtypes, and the wide window
round (#7) at bf16, and the narrow round (#6) on a fully masked query row,
which averages over the cache as it was before the round wrote it.  The NA
decoder stack (#5), with its hoisted cross K/V and its chained launches,
is held bitwise to a chain of #2 calls, for batch independence, and to
itself over 50 calls back to back.  Evaluation: a checkpoint the port
writes loads bitwise on the card, and ``eval_split`` on the kernels gives
the plain path's captions at float32.  The RL stage: the sampler on the
kernels draws captions whose token log-probs are ``rl_rescore``'s plain
values (float32, 1e-4), the re-score launches no kernel, and each sampling
method's draws from a CUDA generator follow their closed form.  The
remaining decoders: NNAIC on the kernels gives the plain path's captions
at float32, its length-0 rows (every key masked) included; diverse beam
search with the attention core gives the plain attend's beams.  The
attention core past 128 keys (129, 211 and 256) on the tile and ffma paths
against its twin, and the PB_pad decode with the core against the plain
path at a packed width of 211.
"""

import pytest
import torch

from boficap_tpu_torch.models import layers as tl
from boficap_tpu_torch.ops import decoder_layer as dl

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    from boficap_tpu_torch.ops import _build
    if _build.find_nvcc() is None:
        pytest.skip(f"no nvcc: {_build.probe()}")
    _build.kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _layer(cls, *args, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = cls(*args)
    with torch.no_grad():
        for name, p in m.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.05 * noise)
            else:
                p.copy_(noise * (0.1 if p.dim() > 1 else 0.05))
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_layer_kernel(cuda, dtype):
    D, F, H, B, R = 96, 200, 3, 5, 7
    w = dl.pack_encoder_layer(_layer(tl.EncoderLayer, D, F, H).to(cuda),
                              dtype)
    x = torch.randn(B, R, D, device=cuda).to(dtype)
    mask = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        [0, 7, 3, 5, 1], device=cuda)[:, None]
    got = dl.fused_encoder_layer(x, mask, w, H)
    want = dl.encoder_layer_plain(x, mask, w, H)
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_layer_kernel(cuda, dtype):
    D, F, H, B, L, R = 96, 200, 3, 5, 9, 7
    w = dl.pack_layer_weights(_layer(tl.DecoderLayer, D, F, H).to(cuda),
                              dtype)
    x = torch.randn(B, L, D, device=cuda).to(dtype)
    mem = torch.randn(B, R, D, device=cuda).to(dtype)
    total = torch.tensor([0, 9, 4, 1, 6], device=cuda)
    tgt = (torch.arange(L, device=cuda)[None, None, :]
           < total[:, None, None]).expand(B, L, L).contiguous()
    src = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        [7, 2, 7, 5, 3], device=cuda)[:, None]
    got = dl.fused_decoder_layer(x, mem, tgt, src, w, H)
    want = dl.decoder_layer_plain(x, mem, tgt, src, w, H)
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[dtype]


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("N", [1, 37, 512, 1280])
@pytest.mark.parametrize("V", [1001, 9491])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_head_kernel(cuda, dtype, V, N):
    """The head through the padded pack against its plain twin: float32 ids
    equal, bf16 ids apart only where the plain logits' top-2 gap is within
    one bf16 ulp; the PAD column in the last 128-wide chunk; the first rows
    bitwise those of a head of those rows alone; planted ties within one
    chunk, across chunks and at the last real column V - 1 resolve to the
    lower index."""
    D = 80
    g = torch.Generator().manual_seed(V + N)
    h = torch.randn(N, 1, D, generator=g).to(cuda, dtype)
    w = (torch.randn(D, V, generator=g) * 0.05).to(cuda, dtype)
    b = (torch.randn(V, generator=g) * 0.01).to(cuda, dtype)
    pad_id = V - 3
    pack = dl.pad_head(w, b)
    got = dl.fused_greedy_head(h, *pack, pad_id=pad_id)
    want = dl.greedy_head_plain(h, w, b, pad_id=pad_id)
    torch.cuda.synchronize()
    diff = got[0] != want[0]
    if dtype == torch.float32:
        assert not diff.any()
    else:
        logits = (torch.matmul(h.float(), w.float()).to(dtype) + b).float()
        top2 = logits.topk(2, dim=-1).values
        loose = top2[..., 0] - top2[..., 1] <= _bf16_ulp(top2[..., 0])
        assert not (diff & ~loose).any()
    for x, y in zip(got[1:], want[1:]):
        assert (x - y).abs().max().item() < TOL[dtype] * 10
    n = min(N, 37)
    part = dl.fused_greedy_head(h[:n].contiguous(), *pack, pad_id=pad_id)
    torch.cuda.synchronize()
    for x, y in zip(part, got):
        assert torch.equal(x, y[:n])
    for lo, hi in ((130, 133), (70, 700), (5, V - 1)):
        w2, b2 = w.clone(), b.clone()
        w2[:, hi] = w2[:, lo]
        b2[[lo, hi]] = 30.0
        ids = dl.fused_greedy_head(h, *dl.pad_head(w2, b2), pad_id=pad_id)[0]
        assert (ids == lo).all(), (lo, hi, ids.unique().tolist())


def test_greedy_head_rejects_bad_width(cuda):
    """At bf16 the head's product reads h and W with TMA: a D that is not a
    multiple of 8, or a W not padded to one, raises ValueError before any
    launch; float32 takes both."""
    V = 1001
    for D, padded in ((84, True), (80, False)):
        h = torch.randn(3, 2, D, device=cuda)
        w = torch.randn(D, V, device=cuda) * 0.05
        b = torch.zeros(V, device=cuda)
        args32 = dl.pad_head(w, b) if padded else (w, b)
        args16 = dl.pad_head(w.bfloat16(), b.bfloat16()) if padded else (
            w.bfloat16(), b.bfloat16())
        dl.fused_greedy_head.launches = 0
        with pytest.raises(ValueError, match="multiples of 8"):
            dl.fused_greedy_head(h.bfloat16(), *args16)
        assert dl.fused_greedy_head.launches == 0
        got = dl.fused_greedy_head(h, *args32)
        want = dl.greedy_head_plain(h, w, b)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])


def test_wrapper_raises_on_bad_input(cuda):
    D, H = 64, 4
    w = dl.pack_encoder_layer(_layer(tl.EncoderLayer, D, 128, H).to(cuda),
                              torch.float32)
    x = torch.randn(2, 3, D, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dl.fused_encoder_layer(x.transpose(0, 1), torch.ones(
            3, 2, dtype=torch.bool, device=cuda), w, H)
    with pytest.raises(TypeError):
        dl.fused_encoder_layer(x.half(), torch.ones(
            2, 3, dtype=torch.bool, device=cuda), w, H)


# the bf16 product's ragged test shapes: M below, at and above the 64- and
# 128-row tiles; N and K not multiples of the 64-wide tiles
PRODUCT_M = (1, 37, 2304)
PRODUCT_N = (72, 288, 1536)
PRODUCT_K = (96, 200, 2048)


def _product_operands(cuda, M, N, K, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(cuda, dtype)
    b = (torch.randn(N, generator=g) * 0.1).to(cuda, dtype)
    res = torch.randn(M, N, generator=g).to(cuda, dtype)
    return a, w, b, res


@pytest.mark.parametrize("K", PRODUCT_K)
@pytest.mark.parametrize("N", PRODUCT_N)
@pytest.mark.parametrize("M", PRODUCT_M)
def test_fused_linear_kernel(cuda, M, N, K):
    """The layer kernels' bf16 product (TMA, wgmma) against linear_plain,
    with and without ReLU and the residual; each call launches once."""
    bf = torch.bfloat16
    a, w, b, res = _product_operands(cuda, M, N, K, bf)
    dl.fused_linear.launches = 0
    for relu, r in ((False, None), (True, None), (False, res), (True, res)):
        got = dl.fused_linear(a, w, b, relu=relu, res=r)
        want = dl.linear_plain(a, w, b, relu=relu, res=r)
        torch.cuda.synchronize()
        assert got.shape == (M, N) and got.dtype == bf
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) < TOL[bf]
    assert dl.fused_linear.launches == 4


@pytest.mark.parametrize("M,N,K", [
    (m, n, k) for m in PRODUCT_M for n in PRODUCT_N for k in PRODUCT_K]
    + [(37, 75, 101), (300, 101, 75), (1, 75, 75)])
def test_fused_linear_float32(cuda, M, N, K):
    """float32 products run on the FFMA product (csrc/ffma_gemm.cuh) at any
    width: the ragged shapes of the bf16 product and odd widths (75, 101,
    the 4-byte copy path), with and without ReLU and the residual."""
    f32 = torch.float32
    a, w, b, res = _product_operands(cuda, M, N, K, f32)
    dl.fused_linear.launches = 0
    for relu, r in ((False, None), (True, None), (False, res), (True, res)):
        got = dl.fused_linear(a, w, b, relu=relu, res=r)
        want = dl.linear_plain(a, w, b, relu=relu, res=r)
        torch.cuda.synchronize()
        assert got.shape == (M, N) and got.dtype == f32
        assert _rel(got, want) < TOL[f32]
    assert dl.fused_linear.launches == 4


@pytest.mark.parametrize("N,K", [(1536, 512), (512, 2048), (203, 101)])
def test_fused_linear_float32_batch_independent(cuda, N, K):
    """Row r of a float32 product is bitwise the same whatever M: one fmaf
    chain an element, whichever tile M and N select (128 x 128 at 6400
    rows, 32 x 64 at 37 and 1)."""
    a, w, b, res = _product_operands(cuda, 6400, N, K, torch.float32, 1)
    full = dl.fused_linear(a, w, b, relu=True, res=res)
    for rows in (37, 1):
        part = dl.fused_linear(a[:rows], w, b, relu=True, res=res[:rows])
        torch.cuda.synchronize()
        assert torch.equal(full[:rows], part)
    assert (dl.product_tile(6400, N, torch.float32)[:2]
            != dl.product_tile(37, N, torch.float32)[:2])


@pytest.mark.parametrize("K", PRODUCT_K)
@pytest.mark.parametrize("N", PRODUCT_N)
def test_fused_linear_batch_independent(cuda, N, K):
    """Row r of a bf16 product is bitwise the same whatever M: the first
    37 rows of an M = 2304 product equal the M = 37 product, though the
    two take different tiles (no split-K; one k order per element)."""
    a, w, b, res = _product_operands(cuda, 2304, N, K, torch.bfloat16, 1)
    full = dl.fused_linear(a, w, b, relu=True, res=res)
    part = dl.fused_linear(a[:37], w, b, relu=True, res=res[:37])
    torch.cuda.synchronize()
    assert torch.equal(full[:37], part)


def test_product_tiles(cuda):
    """(BM, BN, blocks) of the serving shapes.  bf16: BN from N alone, BM =
    128 where that still fills the 132 SMs.  float32: 128 x 128 where its
    blocks fill at least 3/4 of the 132-block waves they take, else 32 x 64
    (the narrow SA round's 512-row products among them)."""
    assert dl.product_tile(2304, 1536) == (128, 128, 216)
    assert dl.product_tile(2304, 512) == (128, 64, 144)
    assert dl.product_tile(1280, 1536) == (64, 128, 240)
    assert dl.product_tile(1280, 512) == (64, 64, 160)
    assert dl.product_tile(1, 72) == (64, 64, 2)
    f32 = torch.float32
    assert dl.product_tile(2304, 1536, f32) == (128, 128, 216)
    assert dl.product_tile(1280, 1536, f32) == (128, 128, 120)
    assert dl.product_tile(2304, 2048, f32) == (32, 64, 2304)
    assert dl.product_tile(2304, 512, f32) == (32, 64, 576)
    assert dl.product_tile(1280, 2048, f32) == (32, 64, 1280)
    assert dl.product_tile(512, 512, f32) == (32, 64, 128)
    assert dl.product_tile(1, 72, f32) == (32, 64, 2)


def test_product_rejects_bad_width(cuda):
    """A bf16 width that is not a multiple of 8 raises ValueError (TMA's
    16-byte strides), in the product and in a layer; float32 takes it."""
    bf = torch.bfloat16
    a, w, b, _ = _product_operands(cuda, 4, 24, 100, bf)
    with pytest.raises(ValueError, match="multiples of 8"):
        dl.fused_linear(a, w, b)
    D, F, H = 100, 200, 4
    layer = _layer(tl.EncoderLayer, D, F, H).to(cuda)
    x = torch.randn(2, 3, D, device=cuda)
    mask = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        dl.fused_encoder_layer(x.to(bf), mask,
                               dl.pack_encoder_layer(layer, bf), H)
    w32 = dl.pack_encoder_layer(layer, torch.float32)
    got = dl.fused_encoder_layer(x, mask, w32, H)
    torch.cuda.synchronize()
    assert _rel(got, dl.encoder_layer_plain(x, mask, w32, H)) < 1e-4


def _cycle(values, n):
    return (list(values) * (n // len(values) + 1))[:n]


def _window_operands(cuda, dtype, NL, B, W, L, R, D, F, H):
    """Per-layer and stacked window weights, activations, caches, cross
    K/V, window starts (some clipped at L - W) and masks with a fully masked
    sample and padded regions; the per-sample patterns repeat past B = 5."""
    from boficap_tpu_torch.ops import stack as st
    dec = _layer(tl.Decoder, NL, D, F, H).to(cuda)
    pack = st.pack_window_weights(dec, dtype)
    layers, stacked = pack.layers, pack.stack
    g = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(cuda, dtype)

    x = rnd(B, W, D)
    kc, vc = rnd(NL, B, L, D), rnd(NL, B, L, D)
    k2, v2 = rnd(NL, B, R, D), rnd(NL, B, R, D)
    w_start = torch.tensor(_cycle([0, L - W, 2, 1, L - W], B),
                           dtype=torch.int32, device=cuda)
    tgt = (torch.rand((B, W, L + W), generator=g) < 0.6).to(cuda)
    tgt[1] = False
    src = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        _cycle([7, 2, 7, 5, 3], B), device=cuda)[:, None]
    norm = (torch.rand(D, generator=g).to(cuda) + 0.5,
            torch.randn(D, generator=g).to(cuda) * 0.1)
    return layers, stacked, x, kc, vc, k2, v2, w_start, tgt, src, norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_layer_kernel(cuda, dtype):
    """#8 at ragged widths (D = 96, F = 200: not multiples of the 64-wide
    tiles); k_new / v_new are written by its self-attention block."""
    D, F, H, B, W, L, R = 96, 200, 3, 5, 3, 9, 7
    layers, _, x, kc, vc, k2, v2, _, tgt, src, _ = _window_operands(
        cuda, dtype, 1, B, W, L, R, D, F, H)
    args = (x, kc[0], vc[0], k2[0], v2[0], tgt, src, layers[0], H)
    got = dl.fused_window_decoder_layer(*args)
    want = dl.window_layer_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert _rel(g, w) < TOL[dtype]


# window rounds: a few samples, and the serving batch's rows (B = 64,
# W = 8 or L = 20: M = 512 and 1280, more blocks and other grids)
@pytest.mark.parametrize("B,W,L,R", [(5, 3, 9, 7), (64, 8, 20, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_stack_kernel(cuda, dtype, B, W, L, R):
    """A narrow round (#6) at ragged widths: caches updated in place, rows
    outside each window bit-identical, in-window rows the fresh K/V."""
    from boficap_tpu_torch.ops import stack as st
    D, F, H, NL = 96, 200, 3, 2
    _, stacked, x, kc, vc, k2, v2, ws, tgt, src, norm = _window_operands(
        cuda, dtype, NL, B, W, L, R, D, F, H)
    kc_k, vc_k = kc.clone(), vc.clone()
    kc_p, vc_p = kc.clone(), vc.clone()
    h, kc_out, _ = st.fused_window_decoder_stack(
        x, ws, kc_k, vc_k, k2, v2, tgt, src, stacked, norm, H)
    hp, _, _ = st.window_stack_plain(x, ws, kc_p, vc_p, k2, v2, tgt, src,
                                     stacked, norm, H)
    torch.cuda.synchronize()
    assert kc_out is kc_k
    assert _rel(h, hp) < TOL[dtype]
    pos = torch.arange(L, device=cuda)[None, :]
    inside = (pos >= ws.long()[:, None]) & (pos < ws.long()[:, None] + W)
    for got, want, old in ((kc_k, kc_p, kc), (vc_k, vc_p, vc)):
        assert torch.equal(got[:, ~inside], old[:, ~inside])
        assert _rel(got[:, inside], want[:, inside]) < TOL[dtype]


@pytest.mark.parametrize("B,L,R", [(5, 9, 7), (64, 20, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_wide_stack_kernel(cuda, dtype, B, L, R):
    """A wide round (#7) at ragged widths: each layer's fresh K/V are its
    new cache."""
    from boficap_tpu_torch.ops import stack as st
    D, F, H, NL = 96, 200, 3, 2
    _, stacked, x, _, _, k2, v2, _, tgt, src, norm = _window_operands(
        cuda, dtype, NL, B, L, L, R, D, F, H)
    tgt = tgt[:, :, L:].contiguous()
    got = st.fused_window_wide_stack(x, k2, v2, tgt, src, stacked, norm, H)
    want = st.window_wide_stack_plain(x, k2, v2, tgt, src, stacked, norm, H)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert _rel(g, w) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_stack_masked_row_reads_old_cache(cuda, dtype):
    """A fully masked query row averages uniformly over every key, the
    cache's stale copies of in-window positions included, so it shows
    whether #6's self-attention read the cache before this layer's fresh
    K/V were written into it: the kernel equals the plain twin (read,
    then write); at float32 it is far from a twin that writes first."""
    from boficap_tpu_torch.ops import stack as st
    D, F, H, B, W, L, R, NL = 96, 200, 3, 5, 3, 9, 7, 2
    _, stacked, x, kc, vc, k2, v2, ws, tgt, src, norm = _window_operands(
        cuda, dtype, NL, B, W, L, R, D, F, H)
    tgt[0, 1] = False                     # sample 0, row 1: fully masked
    h, _, _ = st.fused_window_decoder_stack(
        x, ws, kc.clone(), vc.clone(), k2, v2, tgt, src, stacked, norm, H)
    hp, _, _ = st.window_stack_plain(x, ws, kc.clone(), vc.clone(), k2, v2,
                                     tgt, src, stacked, norm, H)
    # the wrong order: each layer's fresh K/V written before it attends
    xw, kw, vw = x, kc.clone(), vc.clone()
    for i in range(NL):
        w = {k: t[i] for k, t in stacked.items()}
        _, kn, vn = dl.window_layer_plain(xw, kw[i], vw[i], k2[i], v2[i], tgt,
                                          src, w, H)
        dl.scatter_window(kw[i], kn, ws)
        dl.scatter_window(vw[i], vn, ws)
        xw, _, _ = dl.window_layer_plain(xw, kw[i], vw[i], k2[i], v2[i], tgt,
                                         src, w, H)
    wrong = dl.refnorm_plain(xw, *norm)
    torch.cuda.synchronize()
    assert _rel(h[0, 1], hp[0, 1]) < TOL[dtype]
    assert _rel(h, hp) < TOL[dtype]
    if dtype == torch.float32:
        assert _rel(h[0, 1], wrong[0, 1]) > 100 * TOL[dtype]


def test_window_wide_stack_batch_independent(cuda):
    """#7 at bf16 and full uic_sd width: the first 5 samples of a B = 64
    round equal a B = 5 round bitwise, h and every layer's new cache (the
    products take other tiles at the two batches; attention and refnorm
    run per sample)."""
    from boficap_tpu_torch.ops import stack as st
    bf = torch.bfloat16
    D, F, H, B, L, R, NL = 512, 2048, 8, 64, 20, 36, 2
    _, stacked, x, _, _, k2, v2, _, tgt, src, norm = _window_operands(
        cuda, bf, NL, B, L, L, R, D, F, H)
    tgt = tgt[:, :, L:].contiguous()
    assert dl.product_tile(B * L, F)[:2] != dl.product_tile(5 * L, F)[:2]
    full = st.fused_window_wide_stack(x, k2, v2, tgt, src, stacked, norm, H)
    part = st.fused_window_wide_stack(
        x[:5].contiguous(), k2[:, :5].contiguous(), v2[:, :5].contiguous(),
        tgt[:5].contiguous(), src[:5].contiguous(), stacked, norm, H)
    torch.cuda.synchronize()
    assert torch.equal(full[0][:5], part[0])
    assert torch.equal(full[1][:, :5], part[1])
    assert torch.equal(full[2][:, :5], part[2])


@pytest.mark.parametrize("D,F,H", [(100, 200, 4), (96, 196, 3)])
def test_window_kernels_reject_bad_width(cuda, D, F, H):
    """A bf16 window call (#6, #7, #8) whose D or d_ff is not a multiple of
    8 raises ValueError (the tensor-core product reads rows with TMA) and
    launches nothing; float32 takes the same widths."""
    from boficap_tpu_torch import ops
    from boficap_tpu_torch.ops import stack as st
    B, W, L, R, NL = 2, 3, 5, 4, 2
    for dtype in (torch.bfloat16, torch.float32):
        layers, stacked, x, kc, vc, k2, v2, ws, tgt, src, norm = \
            _window_operands(cuda, dtype, NL, B, W, L, R, D, F, H)
        xw = torch.randn(B, L, D, device=cuda).to(dtype)
        wide_tgt = torch.ones(B, L, L, dtype=torch.bool, device=cuda)
        calls = (
            lambda: dl.fused_window_decoder_layer(
                x, kc[0], vc[0], k2[0], v2[0], tgt, src, layers[0], H),
            lambda: st.fused_window_decoder_stack(
                x, ws, kc, vc, k2, v2, tgt, src, stacked, norm, H),
            lambda: st.fused_window_wide_stack(
                xw, k2, v2, wide_tgt, src, stacked, norm, H))
        ops.reset_launch_counts()
        for call in calls:
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="multiples of 8"):
                    call()
            else:
                for t in call():
                    assert torch.isfinite(t.float()).all()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        n = 0 if dtype == torch.bfloat16 else 1
        assert [counts[k] for k in ("window_layer", "window_stack",
                                    "window_wide_stack")] == [n, n, n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_stack_kernel(cuda, dtype):
    """#4: every encoder layer in one call, a fully masked sample."""
    from boficap_tpu_torch.ops import stack as st
    D, F, H, B, R, NL = 96, 200, 3, 5, 7, 3
    pack = st.pack_encoder_stack(_layer(tl.Encoder, NL, D, F, H).to(cuda),
                                 dtype)
    x = torch.randn(B, R, D, device=cuda).to(dtype)
    mask = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        [0, 7, 3, 5, 1], device=cuda)[:, None]
    got = st.fused_encoder_stack_forward(x, mask, pack.stack,
                                         pack.final_norm, H)
    want = st.encoder_stack_plain(x, mask, pack.stack, pack.final_norm, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_stack_kernel(cuda, dtype):
    """#5: every decoder layer in one call, an empty plan, padded regions."""
    from boficap_tpu_torch.ops import stack as st
    D, F, H, B, L, R, NL = 96, 200, 3, 5, 9, 7, 3
    pack = st.pack_decoder_stack(_layer(tl.Decoder, NL, D, F, H).to(cuda),
                                 dtype)
    x = torch.randn(B, L, D, device=cuda).to(dtype)
    mem = torch.randn(B, R, D, device=cuda).to(dtype)
    total = torch.tensor([0, 9, 4, 1, 6], device=cuda)
    tgt = (torch.arange(L, device=cuda)[None, None, :]
           < total[:, None, None]).expand(B, L, L).contiguous()
    src = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        [7, 2, 7, 5, 3], device=cuda)[:, None]
    got = st.fused_decoder_stack_forward(x, mem, tgt, src, pack.stack,
                                         pack.final_norm, H)
    want = st.decoder_stack_plain(x, mem, tgt, src, pack.stack,
                                  pack.final_norm, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < TOL[dtype]


def _decoder_operands(cuda, dtype, NL, B, L, R, D=512, F=1024, H=8,
                      seed=0):
    """A seeded decoder stack's pack and NA fill operands: an empty plan
    (sample 0), one fully masked target row (sample 1, row 2), padded
    regions (sample 2 has 3 of R)."""
    from boficap_tpu_torch.ops import stack as st
    pack = st.pack_decoder_stack(
        _layer(tl.Decoder, NL, D, F, H, seed=seed).to(cuda), dtype)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((B, L, D), generator=g).to(cuda, dtype)
    mem = torch.randn((B, R, D), generator=g).to(cuda, dtype)
    total = torch.randint(1, L + 1, (B,), generator=g)
    total[0] = 0
    tgt = (torch.arange(L)[None, None, :] < total[:, None, None]).expand(
        B, L, L).contiguous()
    live = torch.randint(1, R + 1, (B,), generator=g)
    live[min(2, B - 1)] = 3
    src = torch.arange(R)[None, :] < live[:, None]
    if B > 1 and L > 2:
        tgt[1, 2] = False
    return pack, x, mem, tgt.to(cuda), src.to(cuda)


@pytest.mark.parametrize("B,R", [(5, 7), (3, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_stack_is_layer_chain(cuda, dtype, B, R):
    """#5 against a chain of NL #2 calls and the final norm, bitwise: the
    stack's one product for every layer's cross K|V sums each output as
    #2's own projection does (BN from the layer's width 2D), and its launch
    chain orders the layers as the stream does.  B * R = 35 and 108 rows
    of that product: not a multiple of its 64- or 128-row tile.  Both
    within TOL of the plain twin."""
    from boficap_tpu_torch.ops import stack as st
    NL, L, H = 6, 9, 8
    pack, x, mem, tgt, src = _decoder_operands(cuda, dtype, NL, B, L, R)
    got = st.fused_decoder_stack_forward(x, mem, tgt, src, pack.stack,
                                         pack.final_norm, H)
    chain = dl.fused_decoder_forward(x, mem, tgt, src, pack.layers,
                                     pack.final_norm, H)
    want = st.decoder_stack_plain(x, mem, tgt, src, pack.stack,
                                  pack.final_norm, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, chain)
    assert _rel(got, want) < TOL[dtype]


def test_decoder_stack_rows_batch_independent(cuda):
    """bf16 at the serving shape (B = 64, L = 20, R = 36, full width): each
    of a few samples through the stack alone (B = 1) equals its row of the
    B = 64 call bitwise."""
    from boficap_tpu_torch.ops import stack as st
    NL, B, L, R, H = 6, 64, 20, 36, 8
    pack, x, mem, tgt, src = _decoder_operands(cuda, torch.bfloat16, NL, B,
                                               L, R, F=2048)
    full = st.fused_decoder_stack_forward(x, mem, tgt, src, pack.stack,
                                          pack.final_norm, H)
    for i in (0, 1, 2, 37, 63):
        one = st.fused_decoder_stack_forward(
            x[i:i + 1].contiguous(), mem[i:i + 1].contiguous(),
            tgt[i:i + 1].contiguous(), src[i:i + 1].contiguous(),
            pack.stack, pack.final_norm, H)
        torch.cuda.synchronize()
        assert torch.equal(full[i:i + 1], one), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_stack_repeats_bitwise(cuda, dtype):
    """50 stack calls back to back, at the serving shape, with an empty
    plan, a fully masked target row and padded regions, give bitwise equal
    outputs: a race in the launch chain (a kernel reading or writing before
    its predecessor is done) would show as calls that differ."""
    from boficap_tpu_torch.ops import stack as st
    NL, B, L, R, H = 6, 64, 20, 36, 8
    pack, x, mem, tgt, src = _decoder_operands(cuda, dtype, NL, B, L, R,
                                               F=2048, seed=3)
    outs = [st.fused_decoder_stack_forward(x, mem, tgt, src, pack.stack,
                                           pack.final_norm, H)
            for _ in range(50)]
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    for i, o in enumerate(outs[1:], 1):
        assert torch.equal(o, outs[0]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_core_kernel(cuda, dtype):
    """#9 on the views attend hands it: transposed [B,L,H,Dh] projections,
    a query broadcast over the batch, a [B,Lk] mask expanded over the rows
    with a fully masked sample; and a rank-3 mask with a fully masked row.
    The launch is counted; the output is a view of [B,Lq,H,Dh] rows."""
    from boficap_tpu_torch.ops import attention as at
    B, H, Lq, Lk, Dh = 5, 3, 4, 37, 40
    g = torch.Generator().manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(cuda, dtype)

    q1, k, v = rnd(1, Lq, H, Dh), rnd(B, Lk, H, Dh), rnd(B, Lk, H, Dh)
    m2 = torch.arange(Lk, device=cuda)[None, :] < torch.tensor(
        [0, 37, 5, 1, 20], device=cuda)[:, None]
    m3 = (torch.rand((B, Lq, Lk), generator=g) < 0.5).to(cuda)
    m3[2, 1] = False
    qv = q1.expand(B, Lq, H, Dh).transpose(1, 2)
    kv, vv = k.transpose(1, 2), v.transpose(1, 2)
    at.attention_core.launches = 0
    for mask in (m2[:, None, :].expand(B, Lq, Lk), m3):
        got = at.attention_core(qv, kv, vv, mask)
        want = at.attention_core_plain(qv, kv, vv, mask)
        torch.cuda.synchronize()
        assert got.shape == (B, H, Lq, Dh) and got.dtype == dtype
        assert got.transpose(1, 2).is_contiguous()
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) < TOL[dtype]
    assert at.attention_core.launches == 2


def test_attention_core_wrapper_checks(cuda):
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops._build import kernels
    lib = kernels().attention_core
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for Lq, Lk, Dh in ((1, 36, 64), (22, 22, 64), (5, 300, 96)):
            assert lib.bfc_attention_core_scratch(Lq, Lk, Dh, code) == \
                at.shared_bytes(Lq, Lk, Dh, dtype)
    q = torch.zeros(2, 2, 3, 8, device=cuda)
    k = torch.zeros(2, 2, 4, 8, device=cuda)
    m = torch.ones(2, 3, 4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        at.attention_core(q, k.bfloat16(), k, m)
    with pytest.raises(ValueError, match="on"):
        at.attention_core(q, k, k, m.cpu())
    with pytest.raises(TypeError):
        at.attention_core(q.half(), k.half(), k.half(), m)


# the attention block's paths (csrc/attention.cuh) at each caller's (Lq,
# Lk): the decode steps (one query row), the row path's edge, the layers'
# self and cross attentions, a window round (narrow 8 x 28), the key bound
ATTENTION_SHAPES = [(1, 36), (1, 22), (2, 36), (3, 36), (8, 28), (20, 20),
                    (20, 36), (36, 36), (1, 128), (40, 128)]


def _paths(dtype):
    return ("row", "tile") if dtype == torch.bfloat16 else ("row", "ffma")


def _attention_operands(cuda, dtype, B, Lq, Lk, seed=5, H=8, Dh=64):
    """Transposed views of [B, L, H, Dh] projections (as attend hands them
    over), a padded [B, Lk] mask expanded over the rows with a fully masked
    sample (0), and a fully masked row (sample 1, row 0)."""
    g = torch.Generator().manual_seed(seed)

    def heads(rows):
        return torch.randn((B, rows, H, Dh), generator=g).to(
            cuda, dtype).transpose(1, 2)

    live = torch.randint(1, Lk + 1, (B,), generator=g)
    live[0] = 0
    mask = (torch.arange(Lk)[None, None, :] < live[:, None, None]).expand(
        B, Lq, Lk).contiguous()
    mask[1, 0] = False
    return heads(Lq), heads(Lk), heads(Lk), mask.to(cuda)


@pytest.mark.parametrize("Lq,Lk", ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_paths_against_plain(cuda, dtype, Lq, Lk):
    """Each path the dtype has (row and tile at bf16, row and ffma at
    float32), forced through attention_core, against the plain twin at each
    caller's shape; the path left to itself is attention_path's, and one
    launch is counted a call."""
    from boficap_tpu_torch.ops import attention as at
    q, k, v, m = _attention_operands(cuda, dtype, 6, Lq, Lk)
    want = at.attention_core_plain(q, k, v, m)
    at.attention_core.launches = 0
    for path in (None, *_paths(dtype)):
        got = at.attention_core(q, k, v, m, path=path)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) < TOL[dtype], path
    assert at.attention_core.launches == 3
    assert at.attention_path(Lq, Lk, dtype) in _paths(dtype)


@pytest.mark.parametrize("Lk", [36, 28, 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_masked_row_uniform_over_real_keys(cuda, dtype, Lk):
    """A fully masked row (every score -1e9) comes out uniform over exactly
    its Lk keys on every path: the padded key columns up to the n8 / k16
    tile (Lk not a multiple of 8) add exactly 0.  bf16: p = bf16(1 / Lk),
    the sum of p v in float32, rounded once."""
    from boficap_tpu_torch.ops import attention as at
    for Lq in (1, 20):
        q, k, v, m = _attention_operands(cuda, dtype, 3, Lq, Lk)
        p = torch.tensor(1.0 / Lk).to(dtype).float()
        uniform = (p * v[0].float().sum(1)).to(dtype).float()   # [H, Dh]
        for path in _paths(dtype):
            got = at.attention_core(q, k, v, m, path=path)
            torch.cuda.synchronize()
            err = (got[0].float() - uniform[:, None]).abs().max().item()
            bound = 1e-6 if dtype == torch.float32 else 2 * _bf16_ulp(
                uniform).max().item()
            assert err <= bound, (path, Lq, err)


@pytest.mark.parametrize("Lq,Lk", [(1, 36), (36, 36), (20, 28)])
def test_attention_rows_batch_independent(cuda, Lq, Lk):
    """bf16, both paths: the first 37 samples of a B = 64 call equal a
    37-sample call bitwise."""
    from boficap_tpu_torch.ops import attention as at
    q, k, v, m = _attention_operands(cuda, torch.bfloat16, 64, Lq, Lk)
    for path in _paths(torch.bfloat16):
        full = at.attention_core(q, k, v, m, path=path)
        part = at.attention_core(q[:37], k[:37], v[:37], m[:37], path=path)
        torch.cuda.synchronize()
        assert torch.equal(full[:37], part), path


def test_attention_path_choice_matches_c(cuda):
    """The C library's path (bfc_attention_path) is ops.attention's
    attention_path at every query and key count around the edges."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops._build import kernels
    lib = kernels().attention_core
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for Lq in range(1, 41):
            for Lk in (1, 8, 22, 28, 36, 127, 128, 129):
                c = lib.bfc_attention_path(Lq, Lk, code)
                py = at.attention_path(Lq, Lk, dtype)
                assert (None if c < 0 else at.PATHS[c]) == py, (Lq, Lk)
                assert lib.bfc_attention_core_scratch(Lq, Lk, 64, code) == \
                    at.shared_bytes(Lq, Lk, 64, dtype)


@pytest.mark.parametrize("rows,d", [(512, 512), (2304, 512), (37, 77),
                                    (9, 1500)])
def test_refnorm_kernel(cuda, rows, d):
    """The one-pass RefLayerNorm (fused_refnorm): float32 within 1e-6 of a
    float64 reference, bf16 within TOL of its plain twin, at the serving
    rows, an odd width and a row wider than the registers hold."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=g) * 3 + 1).to(cuda)
    scale = (1 + 0.1 * torch.randn((d,), generator=g)).to(cuda)
    bias = (0.1 * torch.randn((d,), generator=g)).to(cuda)
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    var = ((xd - mean) ** 2).sum(-1, keepdim=True) / (d - 1)
    ref = (xd - mean) / (var.sqrt() + dl.NORM_EPS) * scale.double() \
        + bias.double()
    dl.fused_refnorm.launches = 0
    got = dl.fused_refnorm(x, scale, bias)
    got16 = dl.fused_refnorm(x.bfloat16(), scale, bias)
    torch.cuda.synchronize()
    assert dl.fused_refnorm.launches == 2
    assert _rel(got.double(), ref) < 1e-6
    assert _rel(got16, dl.refnorm_plain(x.bfloat16(), scale, bias)) < \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_row_path_reads_old_cache(cuda, dtype):
    """A narrow round (#6) whose window fits the row path (W = 1 = LQ_ROW):
    the row path writes the fresh K/V after it has read every cache key,
    so a fully masked row averages the cache as it was, as the plain twin
    does; rows outside each window stay bit-identical."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import stack as st
    D, F, H, B, W, L, R, NL = 96, 200, 3, 5, 1, 9, 7, 2
    assert at.attention_path(W, L + W, dtype) == "row"
    _, stacked, x, kc, vc, k2, v2, ws, tgt, src, norm = _window_operands(
        cuda, dtype, NL, B, W, L, R, D, F, H)
    tgt[0, 0] = False                     # sample 0's one row: fully masked
    kc_k, vc_k = kc.clone(), vc.clone()
    kc_p, vc_p = kc.clone(), vc.clone()
    h, _, _ = st.fused_window_decoder_stack(
        x, ws, kc_k, vc_k, k2, v2, tgt, src, stacked, norm, H)
    hp, _, _ = st.window_stack_plain(x, ws, kc_p, vc_p, k2, v2, tgt, src,
                                     stacked, norm, H)
    torch.cuda.synchronize()
    assert _rel(h[0, 0], hp[0, 0]) < TOL[dtype]
    assert _rel(h, hp) < TOL[dtype]
    pos = torch.arange(L, device=cuda)[None, :]
    inside = (pos >= ws.long()[:, None]) & (pos < ws.long()[:, None] + W)
    for got, want, old in ((kc_k, kc_p, kc), (vc_k, vc_p, vc)):
        assert torch.equal(got[:, ~inside], old[:, ~inside])
        assert _rel(got[:, inside], want[:, inside]) < TOL[dtype]


@pytest.mark.parametrize("dtype,D,F,H", [(torch.bfloat16, 24, 48, 2),
                                         (torch.float32, 100, 200, 4)])
@pytest.mark.parametrize("R", [1, 7])
def test_attention_unaligned_heads(cuda, dtype, D, F, H, R):
    """Layer kernels whose heads are not 16-byte chunks (bf16 Dh = 12,
    float32 Dh = 25: widths the layer wrappers take) read their attention
    operands element by element in the same lane layout: the row path at
    one query row, the tile or ffma path at seven, against the plain
    twin."""
    from boficap_tpu_torch.ops import attention as at
    w = dl.pack_encoder_layer(_layer(tl.EncoderLayer, D, F, H).to(cuda),
                              dtype)
    x = torch.randn(5, R, D, device=cuda).to(dtype)
    mask = torch.arange(R, device=cuda)[None, :] < torch.tensor(
        [0, 7, 3, 5, 1], device=cuda)[:, None]
    assert at.attention_path(R, R, dtype) == ("row" if R == 1 else
                                              at.attention_path(7, 7, dtype))
    got = dl.fused_encoder_layer(x, mask, w, H)
    want = dl.encoder_layer_plain(x, mask, w, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < TOL[dtype]


# ---------------------------------------------------------------------------
# evaluation on the card: a checkpoint round trip, eval_split's routes
# ---------------------------------------------------------------------------

def _eval_model(device, dtype="float32", seed=0):
    """A small UIC model from a seed with its length and syntax heads
    nudged (random weights plan empty captions), on ``device``."""
    from boficap_tpu_torch.config import make_config
    from boficap_tpu_torch.convert import init_params
    cfg = make_config(train_mode="UIC", N_enc=2, N_dec=2, N_len=1,
                      d_model=64, d_ff=128, num_att_heads=4, max_length=8,
                      max_boxes=9, dtype=dtype)
    model = init_params(cfg, 40, seed=seed, device=device).eval()
    with torch.no_grad():
        model.len_head2.bias += torch.tensor(
            [-1.0] + [1.5] * 3 + [0.0] * 16, device=device)
        model.syn_head2.bias += torch.tensor(
            [0.0] * 4 + [2.0] * 3 + [0.0] * 3, device=device)
    model.invalidate_packed()
    return cfg, model


def _eval_loader(cfg):
    from boficap_tpu_torch.config import default_config, finalize
    from boficap_tpu_torch.data.dataset import CaptionData
    opt = default_config()
    opt.update(dict(cfg))
    opt.update(input_json="synthetic", input_att_dir="synthetic",
               batch_size=4, data_prefetch=0)
    return CaptionData(finalize(opt))


def test_eval_checkpoint_round_trip(cuda, tmp_path):
    """The port writes a model.ckpt (flax's format) and infos; a model on
    the card loaded from them holds every parameter bitwise and evaluates
    as the written one."""
    import types
    from boficap_tpu_torch.convert import load_jax_checkpoint, to_jax_tree
    from boficap_tpu_torch.eval.eval_utils import eval_split
    from boficap_tpu_torch.train import state
    cfg, model = _eval_model(cuda)
    ck = types.SimpleNamespace(checkpoint_path=str(tmp_path), id="rt")
    state.save_checkpoint(ck, to_jax_tree(model), {"opt": dict(cfg)})
    _, loaded = _eval_model(cuda, seed=1)
    load_jax_checkpoint(str(tmp_path / "model.ckpt"), loaded)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a, b), n
    assert state.load_infos(str(tmp_path), "rt")["opt"] == dict(cfg)
    kw = {"split": "test", "verbose_loss": 0, "language_eval": 1}
    a = eval_split(model, _eval_loader(cfg), kw, "SAIC")
    b = eval_split(loaded, _eval_loader(cfg), kw, "SAIC")
    assert a["predictions"] == b["predictions"]


@pytest.mark.parametrize("mode", ["NAIC", "SAIC"])
def test_eval_split_kernels_match_plain(cuda, mode):
    """float32: use_cuda_fill auto (the kernels: the per-layer route, as a
    float32 model takes) against 0 (the plain path on the card), captions
    identical; the kernels launched only on the auto run."""
    from boficap_tpu_torch.eval.eval_utils import eval_split
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, model = _eval_model(cuda)
    out = {}
    for flag in ("0", "auto"):
        reset_launch_counts()
        out[flag] = eval_split(model, _eval_loader(cfg),
                               {"split": "test", "verbose_loss": 0,
                                "language_eval": 1, "use_cuda_fill": flag},
                               mode)
        torch.cuda.synchronize()
        launched = sum(launch_counts().values())
        assert (launched > 0) == (flag == "auto"), (flag, launch_counts())
    assert [p["caption"] for p in out["auto"]["predictions"]] == [
        p["caption"] for p in out["0"]["predictions"]]
    assert any(p["caption"] for p in out["auto"]["predictions"])
    assert out["auto"]["lang_stats"]["CIDEr"] == out["0"]["lang_stats"][
        "CIDEr"]


def test_use_cuda_fill_forced_on_cpu_model_raises(cuda):
    from boficap_tpu_torch.eval.eval_utils import use_cuda_fill
    _, model = _eval_model("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        use_cuda_fill("1", model)
    assert use_cuda_fill("1", model.to(cuda)) is True


# ---------------------------------------------------------------------------
# training on the card: the XE step against the CPU, the packs after an
# update, the wrappers' refusal of tensors that require grad
# ---------------------------------------------------------------------------

def _train_setup(device, cfg, model):
    from boficap_tpu_torch.convert import flax_layout
    from boficap_tpu_torch.train import optim, steps
    layout = flax_layout(model)
    opt = optim.Optimizer(optim.build_optimizer(cfg, layout), model, layout)
    return opt, steps.make_xe_step(model, opt)


def test_xe_step_on_card_matches_cpu(cuda):
    """float32, dropout off: one XE step on the card gives the CPU's loss
    to 1e-5 relative and every gradient leaf to 1e-4 of its largest
    magnitude."""
    from boficap_tpu_torch.config import make_config
    from boficap_tpu_torch.convert import init_params
    from boficap_tpu_torch.train import steps
    cfg = make_config(train_mode="UIC", N_enc=2, N_dec=2, N_len=1,
                      d_model=64, d_ff=128, num_att_heads=4, max_length=8,
                      max_boxes=9, dtype="float32", dropout=0.0,
                      drop_prob_lm=0.0, self_dis=True)
    batch = _eval_loader(cfg).get_batch("train")
    out = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, 40, seed=0, device=dev)
        loss, _ = steps.xe_loss_fn(model, steps.to_device(batch, dev),
                                   torch.Generator(device=dev))
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        out[str(dev)] = (loss.detach().cpu(),
                         [None if g is None else g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    gmax = max(g.abs().max().item() for g in gc if g is not None)
    for a, b in zip(gg, gc):
        if b is None:
            assert a is None
            continue
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= max(1e-4 * scale, 1e-6 * gmax)


def test_packs_rebuilt_after_step_and_kernel_eval_matches_plain(cuda):
    """After an optimizer step the model's kernel packs are new objects
    holding the updated weights, and eval on the kernels gives the plain
    path's captions on those weights (float32)."""
    from boficap_tpu_torch.eval.eval_utils import eval_split
    from boficap_tpu_torch.train import steps
    cfg, model = _eval_model(cuda)
    loader = _eval_loader(cfg)
    old = model.packed_decoder("NA")
    w_old = old.stack["wqkv"].clone()
    opt, step = _train_setup(cuda, cfg, model)
    step(steps.to_device(loader.get_batch("train"), cuda),
         torch.Generator(device=cuda))
    new = model.packed_decoder("NA")
    assert new is not old and not torch.equal(new.stack["wqkv"], w_old)
    out = {}
    for flag in ("0", "auto"):
        out[flag] = eval_split(model, _eval_loader(cfg),
                               {"split": "test", "language_eval": 0,
                                "use_cuda_fill": flag}, "NAIC")
    assert [p["caption"] for p in out["auto"]["predictions"]] == [
        p["caption"] for p in out["0"]["predictions"]]
    assert out["auto"]["loss"] == pytest.approx(out["0"]["loss"], rel=1e-5)


def test_wrappers_refuse_tensors_that_require_grad(cuda):
    """No kernel has a backward: a wrapper given a tensor that requires
    grad raises ValueError (and computes under no_grad)."""
    from boficap_tpu_torch.ops.attention import attention_core
    D, H = 64, 4
    layer = _layer(tl.EncoderLayer, D, 128, H).to(cuda)
    w = dl.pack_encoder_layer(layer, torch.float32)
    x = torch.randn(2, 5, D, device=cuda, requires_grad=True)
    mask = torch.ones(2, 5, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="requires grad"):
        dl.fused_encoder_layer(x, mask, w, H)
    q = torch.randn(2, H, 3, D // H, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        attention_core(q, q.detach(), q.detach(),
                       torch.ones(2, 3, 3, dtype=torch.bool, device=cuda))
    with torch.no_grad():
        assert torch.isfinite(dl.fused_encoder_layer(x, mask, w, H)).all()


# ---------------------------------------------------------------------------
# the RL stage on the card: the sampler on the kernels, the draw law
# ---------------------------------------------------------------------------

def test_rl_sampler_on_kernels_matches_rescore(cuda):
    """make_rl_sample on the card (the encoder, NA fill and SA round
    kernels, float32) draws captions whose tok_logprobs are rl_rescore's
    plain autograd values at the drawn words (1e-4), and the re-score
    launches no kernel."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.train import steps
    cfg, model = _eval_model(cuda)
    batch = steps.to_device(_eval_loader(cfg).get_batch("train"), cuda)
    att, am = batch["att_feats"], batch["att_masks"]
    n = 3
    reset_launch_counts()
    samples = steps.make_rl_sample(model, "sample", 1.0, n)(
        att, am, torch.Generator(device=cuda).manual_seed(0))
    launched = dict(launch_counts())
    assert launched.get("encoder_layer", 0) + launched.get(
        "encoder_stack", 0) > 0
    assert launched.get("decoder_layer", 0) + launched.get(
        "decoder_stack", 0) > 0
    reset_launch_counts()
    lps = steps.rl_rescore(model, att, am, samples, n)
    assert not any(launch_counts().values())
    checked = 0
    for key in ("sa", "na"):
        d = samples[key]
        got = torch.gather(lps[f"{key}_logprob"], -1,
                           d["seq"][..., None])[..., 0].detach()
        m = (torch.arange(d["seq"].shape[1], device=cuda)[None, :]
             < d["phrase_length"].sum(-1)[:, None])
        checked += int(m.sum())
        assert (got[m] - d["tok_logprobs"][m]).abs().max().item() <= 1e-4
    assert checked > 0


@pytest.mark.parametrize("method", ["sample", "gumbel", "top3", "top0.9"])
def test_sampling_law_on_card(cuda, method):
    """20,000 draws from a fixed row with a CUDA generator against the
    closed form (chi-square, fixed seed, p > 1e-4), temperature 0.7."""
    from scipy import stats
    from boficap_tpu_torch.decode import sampling
    T, draws = 0.7, 20_000
    lp = torch.log(torch.tensor([0.3, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05]))
    src = lp if method == "gumbel" else lp / T
    if method.startswith("top"):
        num = float(method[3:])
        src = (sampling.top_p_filter(src, num) if num < 1
               else sampling.top_k_filter(src, int(num)))
    want = torch.softmax(src.double(), -1).numpy()
    ids, _ = sampling.sample_next_word(
        lp.to(cuda).expand(draws, -1), method, T,
        torch.Generator(device=cuda).manual_seed(11))
    counts = torch.bincount(ids.cpu(), minlength=lp.numel()).numpy()
    live = want > 1e-9
    assert counts[~live].sum() == 0
    expected = want[live] / want[live].sum()
    assert stats.chisquare(counts[live], draws * expected).pvalue > 1e-4


# ---------------------------------------------------------------------------
# the remaining decoders on the card: NNAIC on the kernels, diverse beam
# search with the attention core
# ---------------------------------------------------------------------------

def _small_model(device, train_mode, **fields):
    from boficap_tpu_torch.config import make_config
    from boficap_tpu_torch.convert import init_params
    cfg = make_config(train_mode=train_mode, N_enc=2, N_dec=2, d_model=64,
                      d_ff=128, num_att_heads=4, max_length=8, max_boxes=9,
                      dtype="float32", **fields)
    return init_params(cfg, 40, seed=0, device=device).eval()


@pytest.mark.parametrize("stacked", [False, True])
def test_nnaic_decode_kernels_match_plain(cuda, stacked):
    """float32: nnaic_decode on the encoder, A-stack and head kernels (per
    layer, or the whole stacks) against the plain path, with planted
    lengths 0 (every key masked: the uniform softmax over all L keys) and
    L - 1: seq and length identical, token log-prob and entropy within
    1e-4, PAD past the length with lp[:, PAD]."""
    from boficap_tpu_torch.decode import bound_fill as bf
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    model = _small_model(cuda, "NNAIC")
    planted = torch.tensor([0, 7, 3, 0, 1, 5], device=cuda)
    model.nnaic_length = lambda memory, rng=None: planted
    g = torch.Generator().manual_seed(3)
    att = torch.randn(6, 9, 2048, generator=g).to(cuda)
    am = (torch.arange(9)[None, :] < torch.tensor([9, 4, 9, 2, 7, 9])[:, None]
          ).float().to(cuda)
    want = bf.nnaic_decode(model, model.encode(att, am), am.bool())
    reset_launch_counts()
    got = bf.nnaic_decode(model, bf.fused_encode(model, att, am,
                                                 stacked=stacked),
                          am.bool(), fused_fill=True, stacked=stacked)
    torch.cuda.synchronize()
    counts = launch_counts()
    kind = "stack" if stacked else "layer"
    assert counts[f"encoder_{kind}"] and counts[f"decoder_{kind}"]
    assert counts["greedy_head"] == 1
    assert torch.equal(got["length"], planted)
    assert torch.equal(got["seq"], want["seq"])
    for k in ("tok_logprobs", "entropy"):
        assert (got[k] - want[k]).abs().max().item() <= 1e-4, k
    past = torch.arange(8, device=cuda)[None, :] >= planted[:, None]
    assert (got["seq"][past] == 0).all() and (got["seq"][~past] > 3).any()


def test_diverse_beam_search_core_matches_plain(cuda):
    """float32, beam 4 in 2 groups: the attention core (#9) on every step's
    cross-attention against the plain attend, beams identical, scores and
    token log-probs within 1e-4; #9 launched N_dec x L x G times."""
    from boficap_tpu_torch.decode import ar
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    model = _small_model(cuda, "AIC")
    with torch.no_grad():
        model.generator.proj.bias += torch.randn(
            44, generator=torch.Generator().manual_seed(7)).to(cuda)
    g = torch.Generator().manual_seed(4)
    att = torch.randn(5, 9, 2048, generator=g).to(cuda)
    am = (torch.arange(9)[None, :] < torch.tensor([9, 3, 9, 6, 1])[:, None]
          ).float().to(cuda)
    mem, src = model.encode(att, am), am.bool()
    kw = dict(beam_size=4, group_size=2, diversity_lambda=0.8)
    want = ar.ar_diverse_beam_search(model, mem, src, **kw)
    model.set_attention_core(True)
    try:
        reset_launch_counts()
        got = ar.ar_diverse_beam_search(model, mem, src, **kw)
        torch.cuda.synchronize()
        assert launch_counts()["attention_core"] == 2 * 8 * 2
    finally:
        model.set_attention_core(False)
    assert torch.equal(got["seq"], want["seq"])
    for k in ("scores", "tok_logprobs"):
        assert (got[k] - want[k]).abs().max().item() <= 1e-4, k


@pytest.mark.parametrize("Lq,Lk", [(129, 129), (211, 211), (256, 256),
                                   (1, 211), (211, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_past_key_bound_against_plain(cuda, dtype, Lq, Lk):
    """The attention core past the row path's 128 keys (PB_pad's lossless
    packed width is 211): the path attention_path gives (tile at bf16, with
    its online softmax over chunks of 128 keys; ffma at float32), and that
    path forced, against the plain twin, with a fully masked sample and
    row; the row path forced raises ValueError before any launch."""
    from boficap_tpu_torch.ops import attention as at
    q, k, v, m = _attention_operands(cuda, dtype, 6, Lq, Lk)
    want = at.attention_core_plain(q, k, v, m)
    path = at.attention_path(Lq, Lk, dtype)
    assert path == ("tile" if dtype == torch.bfloat16 else "ffma")
    at.attention_core.launches = 0
    for forced in (None, path):
        got = at.attention_core(q, k, v, m, path=forced)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) < TOL[dtype], forced
    if Lk > at.KEY_MAX:
        with pytest.raises(ValueError, match="key bound"):
            at.attention_core(q, k, v, m, path="row")
    assert at.attention_core.launches == 2


@pytest.mark.parametrize("width", [44, 211])
def test_pb_decode_core_matches_plain(cuda, width):
    """float32: pb_decode with the attention core (#9) on the predictor's
    and the packed decoder's attentions, and the encoder kernels, against
    the plain path at packed widths 44 and 211 (pb.yml's default and
    lossless widths, L = 20; this model's L = 8, so #9 attends over 211
    keys and nothing clamps): tokens and plans identical, token log-probs
    and entropies within 1e-4; #9 launched 2 a round for the predictor and
    2 a layer a fill."""
    from boficap_tpu_torch.decode import bound_fill as bf
    from boficap_tpu_torch.decode import pb
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    model = _small_model(cuda, "PB_pad")
    with torch.no_grad():
        model.len_head2.bias += torch.tensor(
            [-2.0] + [1.5] * 4 + [0.0] * 15, device=cuda)
    g = torch.Generator().manual_seed(6)
    att = torch.randn(7, 9, 2048, generator=g).to(cuda)
    am = (torch.arange(9)[None, :] < torch.tensor([9, 4, 9, 2, 7, 9, 1])
          [:, None]).float().to(cuda)
    want = pb.pb_decode(model, model.encode(att, am), am.bool(),
                        packed_width=width)
    model.set_attention_core(True)
    try:
        reset_launch_counts()
        st = {}
        got = pb.pb_decode(model, bf.fused_encode(model, att, am), am.bool(),
                           packed_width=width, stats=st)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        model.set_attention_core(False)
    assert counts["attention_core"] == (2 * model.n_lp * st["rounds"]
                                        + 2 * model.N_dec * st["fills"])
    assert counts["encoder_layer"] == model.N_enc
    assert st["host_syncs"] == st["rounds"] > 1
    for k in ("seq", "phrase_num", "phrase_length"):
        assert torch.equal(got[k], want[k]), k
    for k in ("tok_logprobs", "entropy"):
        assert (got[k] - want[k]).abs().max().item() <= 1e-4, k
    assert (want["phrase_num"] > 1).any()
