"""The yardstick on the CPU: the generators repeat from the seed, the plain
reference equals the port's plain path at a tiny size, the frozen FLOP
counts equal ``torch.utils.flop_counter`` on the reference, and the
reference loads nothing of the port."""

import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import gen
from portbench.reference import boficap_ref
from portbench.roofline import counts
from portbench.tests import tiny

BIG_SEED = 2 ** 31 + 977

TINY = {"uic": dict(train_mode="UIC", N_len=1, N_enc=2, N_dec=2, d_model=32,
                    d_ff=64, num_att_heads=4, vocab_size=40,
                    att_feat_size=16, max_length=20, max_boxes=6,
                    caption_model="transformer", decoder_input_mode="add",
                    dtype="float32", use_pallas=False),
        "aic": dict(train_mode="AIC", N_enc=2, N_dec=2, d_model=32, d_ff=64,
                    num_att_heads=4, vocab_size=40, att_feat_size=16,
                    max_length=20, caption_model="transformer",
                    dtype="float32", use_pallas=False)}


def weights_for(cfg, seed=BIG_SEED, nudge=False):
    shapes = boficap_ref.param_shapes(cfg)
    laws = {n: boficap_ref.param_law(n) for n, _ in shapes}
    w = gen.make_weights(shapes, laws, seed, "cpu")
    if nudge:
        gen.nudge_plans(w, seed)
    return w


@pytest.mark.parametrize("what", ["weights", "store", "corpus"])
def test_generators_repeat_from_the_seed(what):
    def make(seed):
        if what == "weights":
            return list(weights_for(TINY["uic"], seed, nudge=True).values())
        if what == "store":
            return list(gen.make_store(7, 6, 16, 2, seed, "cpu"))
        return [torch.as_tensor(v) for v in
                gen.make_corpus(6, 40, 20, 5, seed).values()]
    a, b, c = make(BIG_SEED), make(BIG_SEED), make(BIG_SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_store_and_corpus_laws():
    att, am = gen.make_store(200, 36, 8, 10, BIG_SEED, "cpu")
    live = am.sum(1)
    assert live.min() >= 10 and live.max() <= 36
    assert torch.equal(am, (torch.arange(36)[None] < live[:, None]).float())
    c = gen.make_corpus(50, 9487, 20, 5, BIG_SEED)
    total = (c["labels"] > 0).sum(1)
    assert total.min() >= 4 and total.max() <= 20
    assert (c["phrase_length"].sum(1) == total).all()
    assert c["labels"].max() < 9487 + 4 and c["labels"][c["labels"] > 0
                                                        ].min() >= 4


def program_model(cfg, weights):
    from portbench.program import build_model
    return build_model(cfg, weights, torch.device("cpu"))


def inputs(n=5, R=6, F=16):
    att, am = gen.make_store(n, R, F, 2, BIG_SEED, "cpu")
    return att, am


@torch.no_grad()
def test_reference_equals_the_plain_path_uic():
    from boficap_tpu_torch.decode import bound_fill as bf
    cfg = TINY["uic"]
    w = weights_for(cfg, nudge=True)
    model = program_model(cfg, w)
    ref = boficap_ref.Reference(w, cfg)
    att, am = inputs()
    mem, src = ref.encode(att, am)
    torch.testing.assert_close(model.encode(att, am), mem, rtol=1e-5,
                               atol=1e-5)
    out = bf.na_decode(model, mem, src)
    assert int(out["phrase_num"].sum()) > 0
    L = cfg["max_length"]
    ext = torch.full((att.shape[0], L + 2), 0)
    ext[:, 0] = boficap_ref.LEN
    ext[:, 1:3] = 5
    last = torch.tensor([1, 2, 3, 3, 1])
    r_len, r_syn = ref.bound_logprobs(mem, src, ext, last)
    p_len, p_syn = model.bound_step(ext, last, mem, src, True)
    torch.testing.assert_close(p_len, r_len, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(p_syn, r_syn, rtol=1e-5, atol=1e-5)
    total = torch.tensor([0, 3, 7, 20, 11])
    syn = torch.randint(4, 7, (att.shape[0], L),
                        generator=torch.Generator().manual_seed(3))
    mask = (torch.arange(L)[None, None] < total[:, None, None]).expand(
        -1, L, L)
    p = model.generate(model.decode_na(syn, mem, src, mask))
    r = ref.na_fill_logprobs(mem, src, syn, total)
    live = torch.arange(L)[None] < total[:, None]
    torch.testing.assert_close(p[live], r[live], rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_reference_equals_the_plain_path_aic():
    from boficap_tpu_torch.decode import ar
    cfg = TINY["aic"]
    w = weights_for(cfg)
    model = program_model(cfg, w)
    ref = boficap_ref.Reference(w, cfg)
    att, am = inputs()
    mem, src = ref.encode(att, am)
    out = ar.ar_sample(model, model.encode(att, am), src)
    lp = ref.ar_logprobs(mem, src, out["seq"])
    tok = lp.gather(-1, out["seq"][..., None])[..., 0]
    live = out["seq"] != 0
    torch.testing.assert_close(out["tok_logprobs"][live], tok[live],
                               rtol=1e-4, atol=1e-4)


def test_fp8_control_differs():
    cfg = TINY["uic"]
    w = weights_for(cfg, nudge=True)
    att, am = inputs()
    a = boficap_ref.Reference(w, cfg).encode(att, am)[0]
    b = boficap_ref.Reference(w, cfg, quant="fp8").encode(att, am)[0]
    err = (a - b).abs().max()
    assert 1e-3 < err < 1.0


@pytest.mark.parametrize("part", ["encoder", "decoder", "head", "attention"])
def test_frozen_counts_match_the_flop_counter(part):
    cfg = dict(TINY["uic"], N_enc=1, N_dec=1)
    w = weights_for(cfg)
    ref = boficap_ref.Reference(w, cfg)
    B, R, L, d, dff = 3, 6, 20, 32, 64
    att, am = inputs(B)
    mem = torch.randn(B, R, d)
    src = am.bool()
    with FlopCounterMode(display=False) as fc:
        if part == "encoder":
            ref.encode(att, am)
        elif part == "decoder":
            ref.decoder(torch.randn(B, L, d), mem, src,
                        torch.ones(1, L, L, dtype=torch.bool))
        elif part == "head":
            ref.logprobs(torch.randn(B, L, d))
        else:
            ref.mha(torch.randn(B, 1, d), mem, src[:, None, :],
                    "decoder0.layer0.src_attn")
    got = fc.get_total_flops()
    if part == "encoder":
        want = (B * counts.embed_flops(R, 16, d)
                + counts.encoder_layer(B, R, d, dff, "float32")["flops"])
    elif part == "decoder":
        want = counts.decoder_layer(B, L, R, d, dff, "float32")["flops"]
    elif part == "head":
        want = counts.greedy_head(B * L, d, 44, "float32")["flops"]
    else:
        H = 4
        core = counts.attention_core(B, H, 1, R, d // H, "float32")["flops"]
        want = core + 2 * B * 1 * 2 * d * d + 2 * B * R * 2 * d * d
    assert got == want, (got, want)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; import portbench.reference.boficap_ref, "
            "portbench.reference.compare, portbench.roofline.counts, "
            "portbench.gen; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tiny.REPO,
                       env=dict(os.environ, PYTHONPATH=tiny.REPO))
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout))
    assert not loaded & {"boficap_tpu_torch", "boficap_tpu", "jax", "jaxlib",
                         "flax"}


def test_frozen_xe_forward_count_matches_the_flop_counter():
    """The UIC training forward's products, counted on the port's own
    plain forward (deterministic) at a tiny size."""
    from portbench.program import build_model
    cfg = dict(TINY["uic"], self_dis=True, dropout=0.1)
    w = weights_for(cfg, nudge=True)
    model = build_model(cfg, w, torch.device("cpu"))
    n, k, R, L = 2, 3, 6, cfg["max_length"]
    att, am = inputs(n)
    corpus = gen.make_corpus(n, cfg["vocab_size"], L, k, BIG_SEED)
    lab = torch.zeros((n * k, L + 2), dtype=torch.long)
    lab[:, 1:L + 1] = torch.as_tensor(corpus["labels"]).long()
    # the collate's phrase columns: L + 1, the last always empty
    pl, ps = (torch.nn.functional.pad(torch.as_tensor(corpus[k]).long(),
                                      (0, 1))
              for k in ("phrase_length", "phrase_syn"))
    with FlopCounterMode(display=False) as fc:
        model(att, am, lab, torch.as_tensor(corpus["phrase_num"]).long(),
              pl, ps)
    want = counts.uic_xe_forward_flops(cfg, n, k, R)
    assert fc.get_total_flops() == want, (fc.get_total_flops(), want)


@pytest.mark.parametrize("block", [1, 4])
def test_train_reference_follows_the_program(block):
    """Three UIC XE steps with dropout on: the program's plain step, fed by
    its own loader, against the reference over the same images, with the
    masks replayed from a generator seeded alike and the batch run in
    blocks of ``block`` images."""
    from portbench.cell import Cell
    from portbench.kinds import train
    from portbench.reference import compare
    cfg = dict(tiny_cfg("uic_sd"), N_dec=2)
    tr = dict(kind="train", images_per_step=4, corpus_images=12, regions=6,
              live_min=2, checked_steps=3, reference_images=block)
    cell = Cell(name="t", cfg=cfg, traffic=tr, limits={}, seed=BIG_SEED,
                seconds=0.0, trace=False, device=torch.device("cpu"),
                age_s=lambda: 0.0)
    w, corpus, att, am, host = train.make_inputs(cell)
    t = train.Trainer(cell, w, corpus, host)
    first = t.first_steps(3, w)
    t.close()
    assert len({i for ids in first["ids"] for i in ids}) == 12
    ref = train.reference_readings(cell, w, corpus, att, am, first["ids"])
    gaps = compare.train_gaps(first, ref)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-5, gaps
    assert gaps["change_gap"] < 1e-3, gaps
    ctl = train.reference_readings(cell, w, corpus, att, am, first["ids"],
                                   quant="fp8")
    assert compare.train_gaps(ctl, ref)["grad_gap"] > 1e-2


def tiny_cfg(name):
    import json
    with open(os.path.join(tiny.PKG, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(tiny.TINY_MODEL)
    return cfg


@pytest.mark.parametrize("part", ["window", "linear"])
def test_frozen_kernel_counts_match_the_flop_counter(part):
    """The window layer's and one product's frozen counts against the flop
    counter on the port's plain twins (a cross-check at a tiny size)."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    B, W, L, R, D, F, H = 3, 4, 20, 6, 32, 64, 4
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    if part == "linear":
        with FlopCounterMode(display=False) as fc:
            dl.linear_plain(rnd(B, 7, D), rnd(D, F), rnd(F))
        assert fc.get_total_flops() == counts.linear(B * 7, D, F,
                                                     "float32")["flops"]
        return
    w = {"wqkv": rnd(D, 3 * D), "bqkv": rnd(3 * D), "wo": rnd(D, D),
         "bo": rnd(D), "wq2": rnd(D, D), "bq2": rnd(D), "wo2": rnd(D, D),
         "bo2": rnd(D), "w1": rnd(D, F), "bf1": rnd(F), "w2": rnd(F, D),
         "bf2": rnd(D)}
    for i in range(3):
        w[f"s{i}"], w[f"b{i}"] = torch.ones(D), torch.zeros(D)
    tgt = torch.ones(B, W, L + W, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        dl.window_layer_plain(rnd(B, W, D), rnd(B, L, D), rnd(B, L, D),
                              rnd(B, R, D), rnd(B, R, D), tgt,
                              torch.ones(B, R, dtype=torch.bool), w, H)
    assert fc.get_total_flops() == counts.window_layer(
        B, W, L, R, D, F, "float32")["flops"]
