"""Port parity, kernel #9: the attention core's plain twin against the JAX
package's TPU kernel (``ops/pallas_attention.py``, interpret mode) on the
same numpy inputs, the views ``MultiHeadAttention.attend`` hands it, and
the wrapper's operand checks (CPU).  float32 within 1e-5; bfloat16 within
one bf16 ulp of the result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.ops.pallas_attention import attention_core as jax_core
from boficap_tpu_torch.models import layers as tl
from boficap_tpu_torch.ops import attention as at

SHAPES = [(8, 4, 20, 20, 64), (6, 8, 22, 36, 64), (4, 2, 1, 22, 32)]


def _inputs(B, H, Lq, Lk, Dh, seed):
    """q/k/v [B,H,L,Dh] and a prefix mask [B,Lq,Lk] with one fully masked
    row (sample 0, row 0) and one fully masked sample (the last)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, Lq, Dh).astype(np.float32)
    k = rs.randn(B, H, Lk, Dh).astype(np.float32)
    v = rs.randn(B, H, Lk, Dh).astype(np.float32)
    vis = rs.randint(1, Lk + 1, size=(B, Lq))
    mask = np.arange(Lk)[None, None, :] < vis[:, :, None]
    mask[0, 0] = False
    mask[-1] = False
    return q, k, v, mask


def _ulp_bf16(x):
    """One bfloat16 ulp at |x| (8 significant bits), float32."""
    _, e = np.frexp(np.maximum(np.abs(x), 1e-30))
    return np.ldexp(np.ones_like(x), e - 8)


@pytest.mark.parametrize("B,H,Lq,Lk,Dh", SHAPES)
def test_attention_core_plain_matches_jax(B, H, Lq, Lk, Dh):
    q, k, v, mask = _inputs(B, H, Lq, Lk, Dh, seed=Lk)
    want = jax_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), interpret=True)
    got = at.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, H, Lq, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # a fully masked row comes out uniform over its Lk keys (finite fill)
    np.testing.assert_allclose(got[0, :, 0].numpy(),
                               v[0].mean(axis=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,Lq,Lk,Dh", SHAPES[1:])
def test_attention_core_plain_bf16_within_one_ulp(B, H, Lq, Lk, Dh):
    q, k, v, mask = _inputs(B, H, Lq, Lk, Dh, seed=Lk + 1)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    want = np.asarray(jax_core(*jx, jnp.asarray(mask), interpret=True)
                      .astype(jnp.float32))
    got = at.attention_core(*bf, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= _ulp_bf16(want)).all(), err.max()


def test_attention_core_takes_views():
    """What attend hands the kernel: transposed [B,L,H,Dh] projections, a
    query broadcast over the batch (sample stride 0) and a [B,Lk] mask
    expanded over the query rows (row stride 0) give the result of the
    contiguous operands."""
    B, H, Lq, Lk, Dh = 5, 4, 3, 7, 16
    rs = np.random.RandomState(3)
    q1 = torch.from_numpy(rs.randn(1, Lq, H, Dh).astype(np.float32))
    kb = torch.from_numpy(rs.randn(B, Lk, H, Dh).astype(np.float32))
    vb = torch.from_numpy(rs.randn(B, Lk, H, Dh).astype(np.float32))
    m2 = torch.from_numpy(rs.rand(B, Lk) < 0.7)
    m2[1] = False
    qv = q1.expand(B, Lq, H, Dh).transpose(1, 2)
    mv = m2[:, None, :].expand(B, Lq, Lk)
    assert qv.stride(0) == 0 and mv.stride(1) == 0
    got = at.attention_core(qv, kb.transpose(1, 2), vb.transpose(1, 2), mv)
    want = at.attention_core(qv.contiguous(), kb.transpose(1, 2).contiguous(),
                             vb.transpose(1, 2).contiguous(), mv.contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    at.check_operands(qv, kb.transpose(1, 2), vb.transpose(1, 2), mv)


@pytest.mark.parametrize("n_keys", [1, 11, 21])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_core_takes_the_ar_step_cache(dtype, n_keys):
    """What the KV-cached AR step hands the kernel for its self-attention
    (Decoder.step, DecoderLayer.step): K and V the views [:, :n_keys] of
    [B, 21, H, Dh] caches, transposed, and an all-True row expanded over
    the batch (sample stride 0) and the query row.  Every path of the
    dtype takes them, and they give the result of the contiguous operands
    (float32: up to the order of its sums)."""
    B, H, Dh, rows = 3, 8, 64, 21
    g = torch.Generator().manual_seed(n_keys)
    q = torch.randn(B, 1, H, Dh, generator=g).to(dtype).transpose(1, 2)
    ks = torch.randn(B, rows, H, Dh, generator=g).to(dtype)
    vs = torch.randn(B, rows, H, Dh, generator=g).to(dtype)
    keep = torch.ones(rows, dtype=torch.bool)
    mv = keep[None, :n_keys].expand(B, n_keys)[:, None, :].expand(
        B, 1, n_keys)
    k, v = ks[:, :n_keys].transpose(1, 2), vs[:, :n_keys].transpose(1, 2)
    assert mv.stride(0) == 0 and k.stride(0) == rows * H * Dh
    for path in (None, *(("row", "tile") if dtype == torch.bfloat16 else
                         ("row", "ffma", "ffma_long"))):
        at.check_operands(q, k, v, mv, path)
    assert at.attention_path(1, n_keys, dtype) == "row"
    got = at.attention_core(q, k, v, mv)
    want = at.attention_core(q, k.contiguous(), v.contiguous(),
                             mv.contiguous())
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("mask_rank", [2, 3, 4])
def test_attend_routes_rank_2_and_3_masks(monkeypatch, mask_rank):
    """use_core sends a rank-2/3-masked attend through the attention core
    and equals the plain math (Dh = 16: 1/sqrt(Dh) is exact); a rank-4
    mask, or use_core off, keeps the plain path."""
    B, Lq, Lk, D, H = 3, 4, 6, 64, 4
    mha = tl.MultiHeadAttention(H, D)
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)
                                     * 0.2))
    qh = torch.from_numpy(rs.randn(B, Lq, H, D // H).astype(np.float32))
    kh = torch.from_numpy(rs.randn(B, Lk, H, D // H).astype(np.float32))
    vh = torch.from_numpy(rs.randn(B, Lk, H, D // H).astype(np.float32))
    m = torch.from_numpy(rs.rand(B, Lq, Lk) < 0.6)
    mask = {2: m[:, 0], 3: m, 4: m[:, None]}[mask_rank]
    calls = []

    def spy(*a):
        calls.append(a)
        return at.attention_core(*a)

    monkeypatch.setattr(tl, "attention_core", spy)
    with torch.no_grad():
        plain = mha.attend(qh, kh, vh, mask)
        mha.use_core = True
        routed = mha.attend(qh, kh, vh, mask)
    assert len(calls) == (1 if mask_rank in (2, 3) else 0)
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_check_operands_rejects_what_the_kernel_does_not_take():
    B, H, Lq, Lk, Dh = 2, 2, 3, 4, 8
    q = torch.zeros(B, H, Lq, Dh)
    k = torch.zeros(B, H, Lk, Dh)
    m = torch.ones(B, Lq, Lk, dtype=torch.bool)
    at.check_operands(q, k, k, m)
    with pytest.raises(ValueError, match="rank"):
        at.check_operands(q[0], k, k, m)
    with pytest.raises(ValueError, match="mask has shape"):
        at.check_operands(q, k, k, m[:, :1])
    with pytest.raises(TypeError, match="torch.bool"):
        at.check_operands(q, k, k, m.float())
    with pytest.raises(TypeError):
        at.check_operands(q, k.double(), k, m)
    with pytest.raises(ValueError, match="dense"):
        at.check_operands(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          k, m)
    # a block's shared memory: the ffma path stages Q whole
    big = torch.zeros(1, 1, 2000, 64)
    kb = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="shared memory"):
        at.check_operands(big, kb, kb, torch.ones(1, 2000, 8,
                                                  dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_operands_key_bound_and_alignment(dtype):
    """The row path forced past its key bound (row_key_max: ROW_KEY_MAX at
    bf16, KEY_MAX at float32; its score row sits in registers), and a q, k
    or v view whose base, row stride or head width is not 16-byte aligned,
    raise ValueError before any launch; the bound itself on the row path
    (and KEY_MAX + 1, a wide row at bf16), more keys on the path
    attention_path gives (tile or ffma_long), and the aligned views attend
    hands over pass."""
    B, H, Lq, Dh = 2, 2, 1, 32
    bound = at.row_key_max(dtype)
    assert bound == (at.ROW_KEY_MAX if dtype == torch.bfloat16 else
                     at.KEY_MAX)
    q = torch.zeros(B, H, Lq, Dh, dtype=dtype)
    for n in sorted({min(at.KEY_MAX + 1, bound), bound}):
        edge = torch.zeros(B, H, n, Dh, dtype=dtype)
        at.check_operands(q, edge, edge, torch.ones(B, Lq, n,
                                                    dtype=torch.bool), "row")
    over = torch.zeros(B, H, bound + 1, Dh, dtype=dtype)
    m_over = torch.ones(B, Lq, bound + 1, dtype=torch.bool)
    at.check_operands(q, over, over, m_over)
    assert at.attention_path(Lq, bound + 1, dtype) == (
        "tile" if dtype == torch.bfloat16 else "ffma_long")
    with pytest.raises(ValueError, match="key bound"):
        at.check_operands(q, over, over, m_over, "row")
    Lk = 5
    k = torch.zeros(B, H, Lk, Dh, dtype=dtype)
    m = torch.ones(B, Lq, Lk, dtype=torch.bool)
    # a base one element off 16 bytes
    flat = torch.zeros(B * H * Lk * Dh + 1, dtype=dtype)
    shifted = flat[1:].view(B, H, Lk, Dh)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.check_operands(q, shifted, k, m)
    # a row stride of H * Dh + 1 elements ([B, Lk, H*Dh + 1] projections)
    wide = torch.zeros(B, Lk, H * Dh + 1, dtype=dtype)[..., :H * Dh]
    strided = wide.view(B, Lk, H, Dh).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.check_operands(q, k, strided, m)
    # a head width that is not a whole number of 16-byte chunks
    odd = 16 // q.element_size() + 1
    with pytest.raises(ValueError, match="16 bytes"):
        at.check_operands(q[..., :odd].contiguous(), k[..., :odd].contiguous(),
                          k[..., :odd].contiguous(), m)


# (Lq, Lk) of every caller of the attention block at the serving shapes:
# the attention core's cases (chip_smoke.attention_cases) and the layer
# kernels' attentions, with the path each takes (LQ_ROW = 1; one bf16
# query row on the row path up to ROW_KEY_MAX keys, float32 past KEY_MAX
# keys on ffma_long)
CALLERS = {
    "ar_cross": (1, 36, "row", "row"),
    "bound_self": (1, 22, "row", "row"),
    "beam_cross": (1, 36, "row", "row"),
    "ar_self_1": (1, 1, "row", "row"),
    "ar_self_11": (1, 11, "row", "row"),
    "ar_self_21": (1, 21, "row", "row"),
    "encoder_self": (36, 36, "ffma", "tile"),
    "rank3": (20, 20, "ffma", "tile"),
    "decoder_self": (20, 20, "ffma", "tile"),
    "decoder_cross": (20, 36, "ffma", "tile"),
    "narrow_self": (8, 28, "ffma", "tile"),
    "narrow_cross": (8, 36, "ffma", "tile"),
    "wide_self": (20, 20, "ffma", "tile"),
    "wide_cross": (20, 36, "ffma", "tile"),
    "past_the_key_bound": (1, 129, "ffma_long", "row"),
    "past_the_row_bound": (1, 257, "ffma_long", "tile"),
    # PB_pad: the predictor's self-attention over L + 2 slots, the packed
    # decoder's self-attention at the default and the lossless width, and
    # its cross-attention
    "pb_predictor": (22, 22, "ffma", "tile"),
    "pb_self_default": (44, 44, "ffma", "tile"),
    "pb_self_lossless": (211, 211, "ffma_long", "tile"),
    "pb_cross_lossless": (211, 36, "ffma", "tile"),
    # a 14 x 14 image grid (196 regions): AIC's AR step (grid_cross), the
    # encoder's self-attention, the decoder's and the wide round's
    # cross-attention, the narrow round's
    "grid_cross": (1, 196, "ffma_long", "row"),
    "grid_encoder_self": (196, 196, "ffma_long", "tile"),
    "grid_decoder_cross": (20, 196, "ffma_long", "tile"),
    "grid_narrow_cross": (8, 196, "ffma_long", "tile"),
    "no_keys": (3, 0, None, None),
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_path_for_every_caller(caller, dtype):
    Lq, Lk, f32, bf16 = CALLERS[caller]
    assert at.LQ_ROW == 1
    want = f32 if dtype == torch.float32 else bf16
    assert at.attention_path(Lq, Lk, dtype) == want


@pytest.mark.parametrize("Lq,Lk,Dh,dtype,want", [
    (1, 36, 64, torch.bfloat16, 0),                    # row: no staging
    (1, 128, 64, torch.float32, 0),
    (2, 36, 64, torch.bfloat16, 2 * (16 + 2 * 48) * 72),
    (36, 36, 64, torch.bfloat16, 2 * (48 + 2 * 48) * 72),    # tile
    (20, 28, 40, torch.bfloat16, 2 * (32 + 2 * 32) * 56),
    (8, 128, 128, torch.bfloat16, 2 * (16 + 2 * 128) * 136),
    (20, 20, 64, torch.float32,                        # ffma, float32 rows
     4 * (20 * 65 + 20 * 64 + 20 * 64 + 4 * 20)),
    # past the key bound at float32: ffma_long's Q^T [Dh][32 + 4], score
    # rows [32][Lk to 4], K/V ring [2][32][Dh + 1] and mask bits [32][Lk /
    # 32 words], whatever Lq
    (3, 500, 64, torch.float32,
     4 * (64 * 36 + 32 * 500 + 2 * 32 * 65 + 32 * 16)),
    # PB_pad's lossless packed width, and 256 keys: past 48 KB on both
    # paths (the kernels opt in to the larger carve-out); bf16 past the key
    # bound stages the query rows of one group of up to 16 tiles
    (211, 211, 64, torch.float32,
     4 * (64 * 36 + 32 * 212 + 2 * 32 * 65 + 32 * 7)),
    (211, 211, 64, torch.bfloat16, 2 * (224 + 2 * 224) * 72),
    (256, 256, 64, torch.float32,
     4 * (64 * 36 + 32 * 256 + 2 * 32 * 65 + 32 * 8)),
    (256, 256, 64, torch.bfloat16, 2 * (256 + 2 * 256) * 72),
    (300, 196, 64, torch.bfloat16, 2 * (256 + 2 * 208) * 72),
    (20, 196, 64, torch.bfloat16, 2 * (32 + 2 * 208) * 72),
    (1, 129, 64, torch.bfloat16, 0),         # one query row: the wide row
    (1, 196, 64, torch.float32,              # ... at float32: ffma_long
     4 * (64 * 36 + 32 * 196 + 2 * 32 * 65 + 32 * 7)),
    (1, 257, 64, torch.bfloat16, 2 * (16 + 2 * 272) * 72),  # past it
])
def test_shared_bytes_follow_the_staging(Lq, Lk, Dh, dtype, want):
    """A block's shared memory on each path: none on the row path; bf16 Q,
    K and V tiles of 16 rows, each row padded to a multiple of 16 columns
    plus 8 (ldmatrix without bank conflicts) on the tile path; the float32
    staging of the ffma block, and of the ffma_long block past KEY_MAX
    keys."""
    assert at.shared_bytes(Lq, Lk, Dh, dtype) == want


@pytest.mark.parametrize("Lq,Lk", [(1, 196), (211, 211), (196, 196),
                                   (20, 196)])
def test_attention_core_float32_past_key_bound_matches_jax(Lq, Lk):
    """The attention core's twin at float32 past 128 keys, on the shapes of
    the ffma_long block (AIC's step over a 14 x 14 grid, PB_pad's lossless
    packed width, the encoder's self-attention and a cross-attention over
    196 regions), against the JAX kernel in
    interpret mode at Dh = 64, padded keys, a fully masked sample and a
    fully masked row among them: within 1e-5."""
    rs = np.random.RandomState(Lq + Lk)
    B, H, Dh = 3, 2, 64
    q, k, v = (rs.randn(B, H, n, Dh).astype(np.float32)
               for n in (Lq, Lk, Lk))
    mask = np.broadcast_to(
        np.arange(Lk)[None, None, :] < np.array([Lk, 150, 0])[:, None, None],
        (B, Lq, Lk)).copy()
    mask[1, Lq - 1] = False
    want = jax_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), interpret=True)
    got = at.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask))
    assert at.attention_path(Lq, Lk, torch.float32) == "ffma_long"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for b, i in ((2, 0), (1, Lq - 1)):
        np.testing.assert_allclose(got[b, :, i].numpy(), v[b].mean(axis=1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Lk", [1, 36, 128])
@pytest.mark.parametrize("Lq", [1, 2, 3])
def test_attention_core_plain_matches_jax_at_path_edges(Lq, Lk):
    """The plain twin against the TPU kernel (interpret mode) on each side
    of the row path's edge (Lq = LQ_ROW = 1, then 2 and 3) and at one key,
    36 and the key bound, float32 within 1e-5; a fully masked row comes out
    uniform over exactly its Lk keys."""
    assert at.LQ_ROW == 1 and at.KEY_MAX == 128
    B, H, Dh = 2, 2, 16
    q, k, v, mask = _inputs(B, H, Lq, Lk, Dh, seed=7 * Lq + Lk)
    want = jax_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), interpret=True)
    got = at.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for b, i in ((0, 0), (B - 1, Lq - 1)):
        assert not mask[b, i].any()
        np.testing.assert_allclose(got[b, :, i].numpy(), v[b].mean(axis=1),
                                   rtol=1e-5, atol=1e-5)
