"""The port's config reader, random initialisation, checkpoints and the
weight bridge's error paths (CPU)."""

import glob
import os

import numpy as np
import pytest
import torch

from boficap_tpu.config.config import load_yaml_with_base
from boficap_tpu.config.opts import default_config, finalize
from boficap_tpu_torch.config import load_config, make_config, read_flat_yaml
from boficap_tpu_torch.convert import (init_params, load_checkpoint,
                                       load_jax_params, save_checkpoint)
from boficap_tpu_torch.models import layers as tl

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MODEL_FIELDS = ("train_mode", "d_model", "d_ff", "N_enc", "N_dec", "N_len",
                "num_att_heads", "max_length", "decoder_input_mode",
                "max_boxes", "att_feat_size", "dtype", "use_pallas")


def test_reader_matches_jax_loader_on_every_config():
    """Every shipped config gives build_model the same fields as the JAX
    package's loader (defaults, _BASE_ chain, finalize), the compute dtype
    and use_pallas included."""
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))
    assert len(paths) > 20
    for path in paths:
        got = load_config(path)
        want = default_config()
        want.update(load_yaml_with_base(path))
        want = finalize(want)
        for k in MODEL_FIELDS:
            assert got[k] == want[k], (os.path.basename(path), k)


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "a: [1, 2]\n",
                                  "a b: 1\n", "just words\n"])
def test_reader_rejects_what_it_does_not_parse(tmp_path, text):
    p = tmp_path / "bad.yml"
    p.write_text(text)
    with pytest.raises(ValueError):
        read_flat_yaml(str(p))


def _tiny_cfg():
    return make_config(train_mode="UIC", N_enc=1, N_dec=1, N_len=1,
                       d_model=32, d_ff=64, num_att_heads=4, max_length=6,
                       att_feat_size=16, max_boxes=5)


def test_init_params_seeded_and_checkpoint_roundtrip(tmp_path):
    cfg = _tiny_cfg()
    a = init_params(cfg, 20, seed=3, device="cpu")
    b = init_params(cfg, 20, seed=3, device="cpu")
    c = init_params(cfg, 20, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.layer0.self_attn.wq.weight"],
                           sc["encoder.layer0.self_attn.wq.weight"])
    assert torch.equal(sa["lp_norm.scale"], torch.ones(32))
    path = str(tmp_path / "m.pt")
    save_checkpoint(a, cfg, 20, path)
    r = load_checkpoint(path, device="cpu")
    sr = r.state_dict()
    assert sorted(sr) == sorted(sa)
    assert all(torch.equal(sa[k], sr[k]) for k in sa)
    att = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 16)
                           .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(a.encode(att), r.encode(att))


def test_load_jax_params_rejects_mismatched_trees():
    good = {"scale": np.ones(8), "bias": np.zeros(8)}
    load_jax_params(tl.RefLayerNorm(8), good)
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(tl.RefLayerNorm(8), {"scale": np.ones(8)})
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_params(tl.RefLayerNorm(8), {**good, "extra": np.ones(8)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tl.RefLayerNorm(8), {"scale": np.ones(9),
                                             "bias": np.zeros(8)})


@pytest.mark.parametrize("use_pallas", [False, True])
def test_build_model_routes_attention_by_use_pallas(use_pallas):
    """use_pallas sets the attention-core routing on every attention of the
    model, as the JAX package's models.setup sets its global; an AR model
    holds no length predictor, as its flax tree holds none."""
    from boficap_tpu_torch.models.boficap import build_model
    cfg = _tiny_cfg()
    cfg.use_pallas = use_pallas
    model = build_model(cfg, 20, device="cpu")
    mhas = [m for m in model.modules()
            if isinstance(m, tl.MultiHeadAttention)]
    assert len(mhas) == 5          # encoder 1, decoder 2, predictor 2
    assert all(m.use_core == use_pallas for m in mhas)
    model.set_attention_core(not use_pallas)
    assert all(m.use_core != use_pallas for m in mhas)
    ar = build_model(make_config(train_mode="AIC", N_enc=1, N_dec=1,
                                 d_model=32, d_ff=64, num_att_heads=4),
                     20, device="cpu")
    assert ar.n_lp == 0 and not any(
        n.startswith(("lp", "len_head", "syn_")) for n, _ in
        ar.named_parameters())
