"""The port's evaluation (``eval/eval_utils.py``, ``tools/eval.py``,
``config.py``'s eval options) against the JAX package's, on the CPU:
branch selection, option precedence, ``eval_split`` on shared weights for
every ported branch, what raises because it is not ported, and the eval
CLI against the JAX CLI on one checkpoint the JAX package wrote.

Tolerances (ROADMAP rule (a)): captions and ids identical, perplexity and
entropy to 1e-5, every other language metric equal (the same strings go
through the same pure-Python arithmetic)."""

import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.config.opts import DEFAULTS as JAX_DEFAULTS
from boficap_tpu.data import dataset as jds
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.train import state as jax_state
from boficap_tpu_torch import config as tconfig
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.models import setup as tsetup
from boficap_tpu_torch.tools import eval as teval
from tests._torch_port_util import L, VOCAB, make_pair
from tests.test_model import tiny_cfg
from tools import eval as jeval

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = 1e-5
TRAIN_MODES = ("AIC", "auto", "NAIC", "SAIC", "NNAIC", "PB_pad", "UIC",
               "UIC_ds", "UIC_s", "UIC_u")
INFERENCE_MODES = ("", "NAIC", "SAIC", "AIC", "NNAIC", "PB_pad")


def test_defaults_are_the_jax_packages():
    """The port's option defaults equal the JAX package's key for key, plus
    use_cuda_fill."""
    port = dict(tconfig.DEFAULTS)
    assert port.pop("use_cuda_fill") == "auto"
    assert port == JAX_DEFAULTS


@pytest.mark.parametrize("train_mode", TRAIN_MODES)
def test_branch_for_every_mode_pair(train_mode):
    for inf in INFERENCE_MODES:
        assert teu._branch_for(train_mode, inf) == jeu._branch_for(
            train_mode, inf), (train_mode, inf)


# ---------------------------------------------------------------------------
# build_eval_opt: explicit CLI > --cfg > parser defaults > saved opts
# ---------------------------------------------------------------------------

def _saved_opt(**kw):
    opt = jax_default_config()
    opt.update({"train_mode": "UIC", "id": "ckpt", "beam_size": 5,
                "batch_size": 10, "input_json": "saved.json",
                "drop_prob_lm": 0.5, "decoding_constraint": 1,
                "block_trigrams": 1, "length_penalty": "wu_0.5",
                "N_enc": 2, "d_model": 64, **kw})
    return dict(jax_finalize(opt))


def _flat_yaml(tmp_path):
    base = tmp_path / "base.yml"
    base.write_text("drop_prob_lm: 0.3\nsplit: train\n")
    y = tmp_path / "evalknobs.yml"
    y.write_text("_BASE_: base.yml\nbeam_size: 4  # a comment\n"
                 "split: val\ninference_mode: NAIC\ndrop_prob_lm: 0.25\n"
                 "batch_size: 7\n")
    return str(y)


CASES = {
    "defaults": ([], {}),
    "explicit": (["--beam_size", "3", "--split=val", "--num_images", "7",
                  "--language_eval", "1"], {}),
    "cfg": (["--cfg", "{yaml}"], {}),
    "cfg_and_explicit": (["--cfg", "{yaml}", "--beam_size=2",
                          "--inference_mode", "SAIC", "--batch_size", "3"],
                         {}),
    "replace_keys": (["--batch_size", "3", "--input_json", "x.json",
                      "--id", "newid", "--input_att_dir", ""], {}),
    "saved_zero": ([], {"decoding_constraint": 0, "suppress_UNK": 0,
                        "verbose_loss": 1}),
    "empty_string": (["--length_penalty="], {}),
    "use_box": ([], {"use_box": 1, "att_feat_size": 2053}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_eval_opt_matches_jax(case, tmp_path):
    argv, saved_kw = CASES[case]
    yaml = _flat_yaml(tmp_path)
    argv = ["--model", "m", "--infos_path", "i", "--device", "cpu"] + [
        a.replace("{yaml}", yaml) for a in argv]
    infos = {"opt": _saved_opt(**saved_kw)}
    got = dict(teval.build_eval_opt(teval.parse_eval_opt(argv), infos))
    want = dict(jeval.build_eval_opt(jeval.parse_eval_opt(argv), infos))
    assert got.pop("use_cuda_fill") == "auto"
    assert got == want


def test_build_eval_opt_device_and_hand_built_namespace():
    """--device defaults to cuda (the JAX CLI's to tpu); a namespace built
    by hand (no _explicit) defers its 0 to the saved opt, as JAX's."""
    infos = {"opt": _saved_opt()}
    argv = ["--model", "m", "--infos_path", "i"]
    got = dict(teval.build_eval_opt(teval.parse_eval_opt(argv), infos))
    want = dict(jeval.build_eval_opt(jeval.parse_eval_opt(argv), infos))
    assert (got.pop("device"), want.pop("device")) == ("cuda", "tpu")
    got.pop("use_cuda_fill")
    assert got == want
    ns = dict(model="m", infos_path="i", cfg="", beam_size=0, split="test")
    got = teval.build_eval_opt(argparse.Namespace(**ns), infos)
    want = jeval.build_eval_opt(argparse.Namespace(**ns), infos)
    assert got.beam_size == want.beam_size == 5
    assert got.split == want.split == "test"


# ---------------------------------------------------------------------------
# eval_split on shared weights
# ---------------------------------------------------------------------------

LOADER = dict(input_json="synthetic", input_att_dir="synthetic",
              batch_size=3, max_boxes=9, seq_per_img=2, data_prefetch=0)


def _loaders(train_mode, vocab=VOCAB):
    """A JAX and a port CaptionData over the same 25-image corpus: the test
    split's 5 images take two batches of 3, the second wrapping."""
    out = []
    for mod, make, fin in ((jds, jax_default_config, jax_finalize),
                           (tds, tconfig.default_config, tconfig.finalize)):
        cfg = make()
        cfg.update(train_mode=train_mode, **LOADER)
        labels = mod.LabelStore.synthetic(n_images=25, vocab_size=vocab, L=L)
        out.append(mod.CaptionData(fin(cfg), labels=labels))
    return out


def _same_result(got, want):
    gp, wp = got["predictions"], want["predictions"]
    assert [p["image_id"] for p in gp] == [p["image_id"] for p in wp]
    assert [p["caption"] for p in gp] == [p["caption"] for p in wp]
    for g, w in zip(gp, wp):
        for k in ("perplexity", "entropy"):
            if w[k] is None:
                assert g[k] is None
            else:
                assert abs(g[k] - w[k]) <= TOL, (k, g[k], w[k])
    assert got["n_images"] == want["n_images"]
    assert got["gts_words"] == want["gts_words"]
    gs, ws = dict(got["lang_stats"]), dict(want["lang_stats"])
    for k in ("perplexity", "entropy"):
        g, w = gs.pop(k), ws.pop(k)
        assert (g is None and w is None) or abs(g - w) <= TOL, k
    assert gs == ws


@pytest.mark.parametrize("train_mode,inference_mode,beam", [
    ("UIC", "NAIC", 1), ("UIC", "SAIC", 1), ("AIC", "", 1), ("AIC", "", 3),
    ("UIC_s", "SAIC", 1), ("UIC_s", "AIC", 1)])
def test_eval_split_matches_jax(train_mode, inference_mode, beam):
    jm, params, tm = make_pair(train_mode, "add", seed=6)
    jdata, tdata = _loaders(train_mode)
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "beam_size": beam, "verbose_loss": 0, "remove_bad_endings": 1}
    want = jeu.eval_split(jm, params, jdata, dict(kw),
                          inference_mode=inference_mode)
    got = teu.eval_split(tm, tdata, dict(kw), inference_mode=inference_mode)
    _same_result(got, want)
    assert got["n_images"] == 5
    assert any(p["caption"] for p in got["predictions"])
    assert np.isfinite(got["images_per_s"]) and got["compile_time"] > 0


def test_eval_split_num_images_and_single_batch_rate():
    """num_images cuts the scored set as JAX's does; a one-batch eval
    decodes its batch again for the rate."""
    jm, params, tm = make_pair("UIC", "add", seed=6)
    jdata, tdata = _loaders("UIC")
    kw = {"split": "test", "num_images": 2, "language_eval": 0,
          "verbose_loss": 0}
    want = jeu.eval_split(jm, params, jdata, dict(kw), inference_mode="NAIC")
    got = teu.eval_split(tm, tdata, dict(kw), inference_mode="NAIC")
    assert [p["caption"] for p in got["predictions"]] == [
        p["caption"] for p in want["predictions"]]
    assert got["n_images"] == 2 and got["lang_stats"] is None
    assert got["decode_time"] > 0 and np.isfinite(got["images_per_s"])


@pytest.fixture(scope="module")
def uic_cpu():
    _, _, tm = make_pair("UIC", "add", seed=6)
    return tm


@pytest.mark.parametrize("kw,match", [
    ({"train_mode": "NNAIC"}, "item 6"),
    ({"train_mode": "PB_pad"}, "item 7"),
    ({"verbose_loss": 1}, "item 4"),
    ({"train_mode": "AIC", "sample_n": 2}, "item 5"),
    ({"train_mode": "AIC", "beam_size": 2, "group_size": 2}, "item 6"),
    ({"sample_method": "sample"}, "greedy"),
])
def test_not_ported_options_raise(uic_cpu, kw, match):
    _, tdata = _loaders("UIC")
    base = {"split": "test", "verbose_loss": 0}
    with pytest.raises(NotImplementedError, match=match):
        teu.eval_split(uic_cpu, tdata, {**base, **kw}, inference_mode="SAIC")


def test_use_cuda_fill_on_cpu(uic_cpu):
    """auto and 0 run the plain path on a CPU model; 1 raises there."""
    assert teu.use_cuda_fill("auto", uic_cpu) is False
    assert teu.use_cuda_fill("0", uic_cpu) is False
    for flag in ("1", True, "on"):
        with pytest.raises(ValueError, match="CUDA"):
            teu.use_cuda_fill(flag, uic_cpu)
    _, tdata = _loaders("UIC")
    with pytest.raises(ValueError, match="CUDA"):
        teu.eval_split(uic_cpu, tdata, {"split": "test", "verbose_loss": 0,
                                        "use_cuda_fill": "1"}, "NAIC")


def test_setup_registry():
    cfg = tconfig.make_config(train_mode="UIC", N_enc=1, N_dec=1, N_len=1,
                              d_model=32, d_ff=64, num_att_heads=4)
    assert tsetup(cfg, 20, device="cpu").tgt_vocab == 24
    cfg.caption_model = "updown"
    with pytest.raises(NotImplementedError, match="item 9"):
        tsetup(cfg, 20, device="cpu")
    cfg.caption_model = "nonesuch"
    with pytest.raises(ValueError):
        tsetup(cfg, 20, device="cpu")


# ---------------------------------------------------------------------------
# the CLI against the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX package's save_checkpoint writes: a tiny UIC
    model (make_pair's nudged weights: its NA and SA plans are not empty)
    over the CLI's own synthetic corpus (40 words), float32, with the infos
    tools/train.py keeps."""
    cid = "cli"
    _, params, _ = make_pair("UIC", "add", seed=2, vocab=40)
    cfg = tiny_cfg("UIC")
    cfg.update(max_length=L, dtype="float32", input_json="synthetic",
               input_att_dir="synthetic", batch_size=4, max_boxes=9,
               id=cid, checkpoint_path=str(tmp_path_factory.mktemp("ckpt")))
    jax_finalize(cfg)
    data = jds.CaptionData(cfg)
    infos = {"iter": 0, "epoch": 0, "loader_state_dict": data.state_dict(),
             "vocab": data.ix_to_word, "opt": dict(cfg),
             "best_val_score": None}
    state = jax_state.create_state(params, optax.sgd(0.1))
    jax_state.save_checkpoint(cfg, state, infos, {})
    return (os.path.join(cfg.checkpoint_path, "model.ckpt"),
            os.path.join(cfg.checkpoint_path, f"infos_{cid}.pkl"))


def _run_jax_cli(argv, cwd):
    """The JAX package's tools/eval.py in a process of its own (its main
    sets process-wide JAX options), with its compile cache under tmp."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(cwd, ".jax_cache"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "eval.py"), *argv],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _cli_pair(tmp_path, monkeypatch, capsys, model, infos, mode,
              extra=()):
    argv = ["--model", model, "--infos_path", infos, "--device", "cpu",
            "--inference_mode", mode, "--language_eval", "1",
            "--num_images", "-1", *extra]
    jdir, tdir = tmp_path / f"jax_{mode}", tmp_path / f"port_{mode}"
    jdir.mkdir()
    tdir.mkdir()
    jout = _run_jax_cli(argv, str(jdir))
    monkeypatch.chdir(tdir)
    result = teval.main(argv)
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "decode_time" in out and "images/s" in out
    return jdir, tdir, result


def _same_outputs(jdir, tdir, cid, n_test):
    jv = json.loads((jdir / "vis" / "vis.json").read_text())
    tv = json.loads((tdir / "vis" / "vis.json").read_text())
    assert len(tv) == n_test
    for k in ("image_id", "caption"):
        assert [p[k] for p in tv] == [p[k] for p in jv]
    for g, w in zip(tv, jv):
        assert sorted(g) == sorted(w)
        for k in ("perplexity", "entropy"):
            assert abs(g[k] - w[k]) <= TOL
    jr = json.loads((jdir / "eval_results" / f"{cid}_test.json").read_text())
    tr = json.loads((tdir / "eval_results" / f"{cid}_test.json").read_text())
    assert [p["caption"] for p in tr["predictions"]] == [
        p["caption"] for p in jr["predictions"]]
    _same_result({"predictions": tr["predictions"], "n_images": 0,
                  "gts_words": 0, "lang_stats": tr["lang_stats"]},
                 {"predictions": jr["predictions"], "n_images": 0,
                  "gts_words": 0, "lang_stats": jr["lang_stats"]})


def test_eval_cli_matches_jax_cli(jax_checkpoint, tmp_path, monkeypatch,
                                  capsys):
    """Both CLIs, --device cpu, on one checkpoint the JAX package wrote,
    SAIC (the CLI's default mode) over the synthetic test split (6
    images); then --only_lang_eval scores the port's cached predictions."""
    model, infos = jax_checkpoint
    jdir, tdir, result = _cli_pair(tmp_path, monkeypatch, capsys, model,
                                   infos, "SAIC")
    _same_outputs(jdir, tdir, "cli", 6)
    assert any(p["caption"] for p in result["predictions"])
    stats = teval.main(["--model", model, "--infos_path", infos,
                        "--device", "cpu", "--only_lang_eval", "1"])
    assert stats == result["lang_stats"]


@pytest.mark.parametrize("flag,match", [("--image_folder", "item 10"),
                                        ("--dump_attention", "item 12"),
                                        ("--report_flops", "item 12")])
def test_eval_cli_not_ported_flags_raise(jax_checkpoint, tmp_path,
                                        monkeypatch, flag, match):
    model, infos = jax_checkpoint
    monkeypatch.chdir(tmp_path)
    value = str(tmp_path) if flag == "--image_folder" else "1"
    with pytest.raises(NotImplementedError, match=match):
        teval.main(["--model", model, "--infos_path", infos, "--device",
                    "cpu", flag, value])


@pytest.mark.slow
def test_trained_checkpoint_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """ROADMAP queue 1, item 2's "done means": a model trained by the JAX
    package's tools/train.py on configs/synthetic_smoke.yml, with no
    nudges; the port's CLI against JAX's on model_best.ckpt, NAIC and
    SAIC, both evaluating at float32 (``--cfg`` with ``dtype: float32``:
    rule (a) holds the two at float32; the config's default bfloat16
    rounds apart on the two sides)."""
    ck = tmp_path / "ckpt"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / ".jax_cache"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train.py"), "--cfg",
         os.path.join(ROOT, "configs", "synthetic_smoke.yml"), "--id",
         "trained", "--checkpoint_path", str(ck), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    model = str(ck / "model_best.ckpt")
    infos = str(ck / "infos_trained_best.pkl")
    f32 = tmp_path / "float32.yml"
    f32.write_text("dtype: float32\n")
    for mode in ("NAIC", "SAIC"):
        jdir, tdir, _ = _cli_pair(tmp_path, monkeypatch, capsys, model,
                                  infos, mode, ("--cfg", str(f32)))
        _same_outputs(jdir, tdir, "trained", 6)
