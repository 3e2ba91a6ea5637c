"""Port parity, the import of the original PyTorch reference's
``model.pth`` (``convert.py``: ``torch_to_flax``,
``load_reference_checkpoint``; ``tools/convert.py``)
against the JAX package's ``utils/convert.py`` and ``tools/convert.py``
(CPU).  The reference state_dict is built from the key schema
(``tests/_torch_port_refschema.py``) for every train_mode's decoder map,
at use_bn 0 and 1, with the keys the converters ignore: the port's tree
equals JAX's bitwise, key order included, so a model loaded from it
(``load_jax_params``) is the one JAX's tree gives, and without the
BatchNorm it holds the source model's weights bitwise.
Unknown keys, use_bn 2 and a state_dict without att_embed raise in both.
The port's CLI writes the ``model.ckpt`` bytes the JAX CLI writes (run in
a process of its own) and infos the JAX CLI's equal."""

import argparse
import os
import pickle
import subprocess
import sys

import pytest
import torch

from boficap_tpu.utils import convert as jconv
from boficap_tpu_torch import convert as tconv
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.models.boficap import build_model
from boficap_tpu_torch.tools import convert as tcli
from boficap_tpu_torch.train.state import load_infos
from tests._torch_port_refschema import reference_state_dict

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
VOCAB = 20
MODES = ("AIC", "auto", "NNAIC", "NAIC", "SAIC", "UIC", "UIC_ds", "UIC_s",
         "UIC_u", "PB_pad")


def _cfg(mode, n_len=1):
    return make_config(train_mode=mode, N_enc=2, N_dec=1, N_len=n_len,
                       d_model=16, d_ff=32, num_att_heads=2, max_length=6,
                       max_boxes=5, dtype="float32")


def _model(mode, n_len=1, seed=1):
    return tconv.init_params(_cfg(mode, n_len), VOCAB, seed=seed,
                             device="cpu")


def _same_tree(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _same_tree(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("use_bn", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_torch_to_flax_matches_jax(mode, use_bn):
    n_len = 0 if mode == "SAIC" else 2 if mode == "UIC_s" else 1
    src = _model(mode, n_len)
    sd = reference_state_dict(tconv.to_jax_tree(src), mode, use_bn=use_bn)
    assert any("pos_embed" in k for k in sd)
    want = jconv.torch_to_flax(sd, mode)
    got = tconv.torch_to_flax(sd, mode)
    _same_tree(got, want)
    ported = tconv.load_jax_params(build_model(_cfg(mode, n_len), VOCAB,
                                               "cpu"), got)
    for (n, a), (_, b) in zip(ported.named_parameters(),
                              src.named_parameters()):
        # the BatchNorm folds into att_embed: only its weights move
        assert torch.equal(a, b) or (use_bn and n.startswith("att_embed")), n


def test_decoder_maps_match_jax():
    for mode in MODES:
        assert tconv._decoder_map(mode) == jconv._decoder_map(mode)


@pytest.mark.parametrize("mode", ["UIC", "PB_pad"])
def test_unknown_key_raises_in_both(mode):
    sd = reference_state_dict(tconv.to_jax_tree(_model(mode)), mode)
    for bad in ("model.decoder.layers.0.mystery.weight", "model.nonesuch",
                "stray"):
        broken = dict(sd, **{bad: torch.zeros(2)})
        for conv in (tconv.torch_to_flax, jconv.torch_to_flax):
            with pytest.raises(KeyError):
                conv(broken, mode)


def test_att_embed_errors_in_both():
    """use_bn=2 (a BatchNorm after the ReLU) cannot fold: both raise
    NotImplementedError; without att_embed keys both raise KeyError."""
    sd = reference_state_dict(tconv.to_jax_tree(_model("UIC")), "UIC",
                              use_bn=1)
    bn2 = dict(sd, **{"att_embed.4.weight": torch.ones(16)})
    nothing = {k: v for k, v in sd.items() if not k.startswith("att_embed")}
    for conv in (tconv.torch_to_flax, jconv.torch_to_flax):
        with pytest.raises(NotImplementedError, match="use_bn=2"):
            conv(bn2, "UIC")
        with pytest.raises(KeyError, match="att_embed"):
            conv(nothing, "UIC")


def test_load_reference_checkpoint_reads_weights_only(tmp_path):
    """A model.pth by torch.save reads back to the JAX converter's tree; a
    file that holds an object other than tensors and containers raises
    (``weights_only``)."""
    sd = reference_state_dict(tconv.to_jax_tree(_model("NAIC")), "NAIC")
    path = tmp_path / "model.pth"
    torch.save(sd, path)
    _same_tree(tconv.load_reference_checkpoint(str(path), "NAIC"),
               jconv.torch_to_flax(sd, "NAIC"))
    bad = tmp_path / "bad.pth"
    torch.save({"opt": argparse.Namespace(x=1), **sd}, bad)
    with pytest.raises(pickle.UnpicklingError):
        tconv.load_reference_checkpoint(str(bad), "NAIC")


def _run_jax_cli(argv, cwd):
    """The JAX package's tools/convert.py in a process of its own."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "convert.py"), *argv],
        cwd=cwd, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("with_infos", [True, False],
                         ids=["infos", "train_mode_and_json"])
def test_convert_cli_writes_the_jax_clis_bytes(tmp_path, with_infos):
    """The same model.pth through both CLIs: model.ckpt byte for byte, the
    infos equal (the reference's Namespace opt as a plain dict), and the
    file loads into a PB_pad model bitwise."""
    mode = "PB_pad"
    src = _model(mode)
    sd = reference_state_dict(tconv.to_jax_tree(src), mode)
    pth = tmp_path / "model.pth"
    torch.save(sd, pth)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    if with_infos:
        infos = tmp_path / "infos_ref.pkl"
        with open(infos, "wb") as f:
            pickle.dump({"opt": argparse.Namespace(train_mode=mode, N_enc=2,
                                                   d_model=16),
                         "vocab": vocab, "iter": 7}, f)
        extra = ["--infos", str(infos)]
    else:
        js = tmp_path / "cocotalk.json"
        js.write_text('{"ix_to_word": %s}' % str(vocab).replace("'", '"'))
        extra = ["--train_mode", mode, "--input_json", str(js)]
    outs = {}
    for side in ("jax", "port"):
        out_dir = tmp_path / side
        argv = ["--torch", str(pth), "--out_dir", str(out_dir), "--id",
                "conv", *extra]
        if side == "jax":
            _run_jax_cli(argv, str(tmp_path))
        else:
            tcli.main(argv)
        outs[side] = out_dir
    got = (outs["port"] / "model.ckpt").read_bytes()
    assert got == (outs["jax"] / "model.ckpt").read_bytes()
    ti = load_infos(str(outs["port"]), "conv")
    with open(outs["jax"] / "infos_conv.pkl", "rb") as f:
        ji = pickle.load(f)
    assert ti == ji
    assert ti["opt"]["train_mode"] == mode and ti["vocab"] == vocab
    loaded = tconv.load_jax_checkpoint(str(outs["port"] / "model.ckpt"),
                                       build_model(_cfg(mode), VOCAB, "cpu"))
    for (n, a), (_, b) in zip(loaded.named_parameters(),
                              src.named_parameters()):
        assert torch.equal(a, b), n
