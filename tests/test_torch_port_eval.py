"""The port's evaluation (``eval/eval_utils.py``, ``tools/eval.py``,
``config.py``'s eval options) against the JAX package's, on the CPU:
branch selection, option precedence, ``eval_split`` on shared weights for
every branch (NNAIC, PB_pad, diverse beam search and ``sample_n``
captions with the multi-sample metrics among them), the eval CLI against the JAX CLI on one checkpoint the JAX package
wrote, and an NNAIC checkpoint of the port's training CLI read by the JAX
package.

Tolerances (ROADMAP rule (a)): captions and ids identical, perplexity and
entropy to 1e-5, every other language metric equal (the same strings go
through the same pure-Python arithmetic)."""

import argparse
import json
import os
import pickle
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


def test_eval_split_nnaic_with_loss_matches_jax():
    """The NNAIC branch (nnaic_decode), with the eval loss through the
    NNAIC xe_loss_fn."""
    jm, params, tm = make_pair("NNAIC", "add", seed=6)
    jdata, tdata = _loaders("NNAIC")
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1}
    want = jeu.eval_split(jm, params, jdata, dict(kw))
    got = teu.eval_split(tm, tdata, dict(kw))
    _same_result(got, want)
    assert want["loss"] > 0
    assert abs(got["loss"] - want["loss"]) <= TOL * want["loss"]
    assert any(p["caption"] for p in got["predictions"])


@pytest.mark.parametrize("kw", [
    {"beam_size": 4, "group_size": 2},
    {"sample_n": 3, "sample_n_method": "bs"},
    {"sample_n": 3, "sample_n_method": "dbs", "diversity_lambda": 0.8}],
    ids=["diverse_beam", "sample_n_bs", "sample_n_dbs"])
def test_eval_split_diverse_matches_jax(kw):
    """AIC with diverse beam search, and with sample_n captions an image:
    predictions, n_predictions (the second batch's popped image drops its
    samples too) and lang_stats with the multi-sample block."""
    jm, params, tm = make_pair("AIC", "add", seed=6)
    jdata, tdata = _loaders("AIC")
    base = {"split": "test", "num_images": -1, "language_eval": 1,
            "verbose_loss": 0, "remove_bad_endings": 1, **kw}
    want = jeu.eval_split(jm, params, jdata, dict(base))
    got = teu.eval_split(tm, tdata, dict(base))
    _same_result(got, want)
    assert got["n_predictions"] == want["n_predictions"]
    n = kw.get("sample_n", 1)
    assert len(got["n_predictions"]) == (5 * n if n > 1 else 0)
    if n > 1:
        assert "self_cider" in got["lang_stats"]
        assert "oracle_CIDEr" in got["lang_stats"]


def test_sample_n_elsewhere_prints_jax_notice(uic_cpu, capsys):
    """sample_n on a branch other than AIC is ignored, with the JAX
    package's notice."""
    _, tdata = _loaders("UIC")
    res = teu.eval_split(uic_cpu, tdata, {"split": "test", "verbose_loss": 0,
                                          "sample_n": 2}, "NAIC")
    assert "sample_n=2 is AR(AIC)-only; ignoring for branch NAIC" in (
        capsys.readouterr().out)
    assert res["n_predictions"] == [] and res["n_images"] == 5


def test_nnaic_train_cli_checkpoint_reads_in_jax(tmp_path):
    """The port's training CLI trains NNAIC (2 iterations, float32, CPU)
    and writes a model.ckpt that the JAX package's eval reads to the
    port's captions."""
    from boficap_tpu.models.boficap import build_model as jax_build_model
    from boficap_tpu_torch.convert import load_jax_checkpoint
    ck = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.train", "--cfg",
         os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
         "--train_mode", "NNAIC", "--dtype", "float32", "--batch_size", "9",
         "--save_checkpoint_every", "2", "--id", "nn", "--checkpoint_path",
         str(ck), "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "val[NNAIC]" in out.stdout
    infos = jax_state.load_infos(str(ck), "nn")
    assert infos["iter"] == 2
    opt = jax_default_config()
    opt.update(infos["opt"])
    jax_finalize(opt)
    jm = jax_build_model(opt, infos["opt"]["vocab_size"])
    z = jax.numpy.zeros((2, opt.max_length + 2), jax.numpy.int32)
    template = jm.init({"params": jax.random.PRNGKey(0)},
                       jax.numpy.zeros((2, 3, opt.att_feat_size)),
                       jax.numpy.ones((2, 3)), z, glat_p=-1.0)
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
    _same_result(got, want)
    assert abs(got["loss"] - want["loss"]) <= TOL * want["loss"]


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


@pytest.mark.parametrize("width", [0, 6, L * (L + 1) // 2 + 1],
                         ids=["default", "clamping", "lossless"])
def test_eval_split_pb_pad_matches_jax(width):
    """The PB_pad branch (decode/pb.py) at the default packed width, one
    that clamps and the lossless one (``pb_packed_width``), with
    verbose_loss on: PB_pad has no eval loss in either package."""
    jm, params, tm = make_pair("PB_pad", "add", seed=6)
    jdata, tdata = _loaders("PB_pad")
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1, "pb_packed_width": width}
    want = jeu.eval_split(jm, params, jdata, dict(kw))
    got = teu.eval_split(tm, tdata, dict(kw))
    _same_result(got, want)
    assert got["loss"] == want["loss"] == 0.0
    assert got["n_images"] == 5
    assert any(p["caption"] for p in got["predictions"])


def test_sampled_eval_split(uic_cpu):
    """A sampled eval_split runs from its seeded generator (the same seed
    gives the same captions), and top1 gives the greedy captions."""
    _, tdata = _loaders("UIC")
    base = {"split": "test", "verbose_loss": 0}
    for mode in ("SAIC", "NAIC"):
        greedy = teu.eval_split(uic_cpu, tdata, base, inference_mode=mode)
        top1 = teu.eval_split(uic_cpu, tdata, {**base, "sample_method":
                                               "top1"}, inference_mode=mode)
        assert top1["predictions"] == greedy["predictions"]
        runs = [teu.eval_split(uic_cpu, tdata,
                               {**base, "sample_method": "sample",
                                "temperature": 2.0}, inference_mode=mode)
                for _ in range(2)]
        assert runs[0]["predictions"] == runs[1]["predictions"]
        assert runs[0]["n_images"] == greedy["n_images"]


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
    from boficap_tpu_torch.models import LSTM_MODELS, LSTMCaptioner
    kinds = {}
    for cm in LSTM_MODELS:
        cfg.caption_model = cm
        m = tsetup(cfg, 20, device="cpu")
        assert isinstance(m, LSTMCaptioner) and m.tgt_vocab == 24
        kinds.setdefault(type(m).__name__, []).append(cm)
    assert kinds == {"FCModel": ["fc", "show_tell"],
                     "UpDownModel": ["updown", "topdown"],
                     "Att2in2Model": ["att2in2", "att2in"],
                     "AoANet": ["aoa"]}
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
    images), with the eval loss on (--verbose_loss 1: the JAX CLI keeps
    it to itself, so its value is taken from the JAX package's eval_split
    on the same options, checkpoint and split); then --only_lang_eval
    scores the port's cached predictions."""
    model, infos = jax_checkpoint
    extra = ("--verbose_loss", "1")
    jdir, tdir, result = _cli_pair(tmp_path, monkeypatch, capsys, model,
                                   infos, "SAIC", extra)
    _same_outputs(jdir, tdir, "cli", 6)
    argv = ["--model", model, "--infos_path", infos, "--device", "cpu",
            "--inference_mode", "SAIC", "--num_images", "-1", *extra]
    with open(infos, "rb") as f:
        jopt = jeval.build_eval_opt(jeval.parse_eval_opt(argv),
                                    pickle.load(f))
    jm, params, _ = make_pair("UIC", "add", seed=2, vocab=40)
    want = jeu.eval_split(jm, params, jds.CaptionData(jopt), dict(jopt),
                          inference_mode="SAIC")
    assert want["loss"] > 0
    assert abs(result["loss"] - want["loss"]) <= TOL * want["loss"]
    assert any(p["caption"] for p in result["predictions"])
    stats = teval.main(["--model", model, "--infos_path", infos,
                        "--device", "cpu", "--only_lang_eval", "1"])
    assert stats == result["lang_stats"]


def test_only_lang_eval_scores_cached_samples(jax_checkpoint, tmp_path,
                                             monkeypatch):
    """--only_lang_eval 1 on a cache holding sample_n captions adds the
    JAX package's multi-sample metrics to the language metrics."""
    from boficap_tpu.eval.metrics import language_eval as jax_language_eval
    from boficap_tpu.eval.multi_metrics import multi_sample_eval
    model, infos = jax_checkpoint
    monkeypatch.chdir(tmp_path)
    gts = {1: ["a dog runs", "the dog runs fast"], 2: ["a red car"]}
    preds = [{"image_id": 1, "caption": "a dog"},
             {"image_id": 2, "caption": "a car"}]
    n_preds = [{"image_id": i, "caption": c} for i, caps in
               ((1, ("a dog", "dog runs", "a dog runs")),
                (2, ("a red car", "red car", "a car"))) for c in caps]
    teu.save_cached({"id": "cli", "split": "test"},
                    {"predictions": preds, "n_predictions": n_preds,
                     "gts_words": gts})
    stats = teval.main(["--model", model, "--infos_path", infos,
                        "--device", "cpu", "--only_lang_eval", "1"])
    want = jax_language_eval(preds, gts)
    want.update(multi_sample_eval(n_preds, gts))
    assert stats == want and "div2" in stats


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
