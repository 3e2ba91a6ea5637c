"""The KV-cached AR step's self-attention on the attention core (CPU: its
plain twin): ``DecoderLayer.step`` with ``use_core`` reads the cache rows
0..pos alone, as views, under an all-True [B, pos + 1] mask, and gives the
plain rank-4 step's output within float32 rounding at every pos, at
float32 and bf16; the cache writes are bitwise the plain step's, and NaN
rows past pos change nothing (no row past pos is read).  Under
``obs.enable()`` an AIC ``ar_sample`` counts ``attend``'s calls by
branch."""

import pytest
import torch

from boficap_tpu_torch import obs
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import fill_random, init_params
from boficap_tpu_torch.decode.ar import ar_sample
from boficap_tpu_torch.models import layers as tl

D, F, H, B, R, STEPS = 64, 128, 4, 5, 7, 9
DTYPES = [torch.float32, torch.bfloat16]
# the plain step's output against the core step's, relative: float32 sums
# in another order, then (bf16) at most one flipped rounding of the output,
# an ulp (2 ** -7 of the value)
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _layer(dtype):
    return fill_random(tl.DecoderLayer(D, F, H, dtype, dropout_rate=0.0),
                       seed=3)


def _inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    memory = torch.randn(B, R, D, generator=g).to(dtype)
    src = torch.arange(R)[None, :] < torch.tensor([7, 3, 5, 1, 6])[:, None]
    xs = torch.randn(STEPS, B, 1, D, generator=g).to(dtype)
    return memory, src, xs


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _step(layer, core: bool, x_t, cache, pos, src):
    """One step with the self-attention's mask as ``Decoder.step`` makes
    it: an all-True row expanded over B (batch stride 0), or step_mask."""
    layer.self_attn.use_core = core
    layer.src_attn.use_core = core
    try:
        vis = (torch.ones(STEPS, dtype=torch.bool)[None, :pos + 1]
               .expand(B, pos + 1) if core else tl.step_mask(STEPS, pos))
        out, _ = layer.step(x_t, cache, pos, src, vis)
    finally:
        layer.self_attn.use_core = layer.src_attn.use_core = False
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@torch.no_grad()
def test_core_step_matches_plain_step(dtype):
    """Every pos of a run of steps: the core step from the plain run's
    cache gives its output within float32 rounding and writes the same
    K/V row, bitwise; the plain run goes on from its own cache."""
    layer = _layer(dtype)
    memory, src, xs = _inputs(dtype)
    cache = layer.init_cache(memory, STEPS)
    for pos in range(STEPS):
        core_cache = _clone(cache)
        got = _step(layer, True, xs[pos], core_cache, pos, src)
        want = _step(layer, False, xs[pos], cache, pos, src)
        assert got.dtype == want.dtype == dtype
        assert torch.allclose(got.float(), want.float(), rtol=RTOL[dtype],
                              atol=1e-5), pos
        for k in ("ks", "vs", "kc", "vc"):
            assert torch.equal(core_cache[k], cache[k]), (pos, k)


@pytest.mark.parametrize("dtype", DTYPES)
@torch.no_grad()
def test_core_step_reads_no_row_past_pos(dtype):
    """The cache's rows past pos filled with NaN: the core step's output
    is finite and bitwise the output over zeroed rows, at every pos."""
    layer = _layer(dtype)
    memory, src, xs = _inputs(dtype, seed=1)
    cache = layer.init_cache(memory, STEPS)
    for pos in range(STEPS):
        poisoned = _clone(cache)
        poisoned["ks"][:, pos + 1:] = float("nan")
        poisoned["vs"][:, pos + 1:] = float("nan")
        got = _step(layer, True, xs[pos], poisoned, pos, src)
        want = _step(layer, True, xs[pos], cache, pos, src)
        assert torch.isfinite(got).all(), pos
        assert torch.equal(got, want), pos


@pytest.mark.parametrize("core", [True, False])
@torch.no_grad()
def test_ar_sample_counts_attend_calls_by_branch(core):
    """An AIC ar_sample under the counters: with use_core every attend of
    the L steps takes the core (self and cross, N_dec layers), none the
    plain path; without it, every one the plain path."""
    cfg = make_config(train_mode="AIC", N_enc=2, N_dec=2, d_model=D,
                      d_ff=F, num_att_heads=H, max_length=6, max_boxes=R,
                      dtype="float32")
    model = init_params(cfg, 40, seed=0, device="cpu").eval()
    g = torch.Generator().manual_seed(2)
    att = torch.randn(B, R, 2048, generator=g)
    am = torch.ones(B, R)
    memory = model.encode(att, am)
    model.set_attention_core(core)
    obs.enable()
    try:
        ar_sample(model, memory, am.bool())
        counts = obs.snapshot()["counts"]
    finally:
        obs.disable()
        obs.reset()
        model.set_attention_core(False)
    calls = 2 * cfg.N_dec * cfg.max_length
    assert counts.get(tl.CORE_CALLS, 0) == (calls if core else 0)
    assert counts.get(tl.PLAIN_CALLS, 0) == (0 if core else calls)
