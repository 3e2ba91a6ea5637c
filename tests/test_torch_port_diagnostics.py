"""The port's eval and training diagnostics against the JAX package's, on
the CPU: ``--dump_attention`` (the attention capture of
``models/layers.py``, ``vis/attn.npz`` and the 10 x 10 accumulator),
``--report_flops`` (``eval_utils.report_flops``: the same programs as
JAX's, the encode's matmul FLOPs exactly the analytic count and within
0.80-1.00 of XLA's cost analysis, which also counts elementwise work) and
``--profile_steps`` (a ``torch.profiler`` trace of the named training
steps, the losses unchanged).

Tolerances: attention maps within 1e-5 (ROADMAP rule (a)); the printed
accumulator and program names identical."""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import load_jax_params
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.models.boficap import build_model
from boficap_tpu_torch.tools import eval as teval
from boficap_tpu_torch.tools import train as ttrain
from tests._torch_port_util import make_feats, make_pair, to_numpy_tree
from tests.test_torch_port_eval import _run_jax_cli, jax_checkpoint  # noqa
from tests.test_train import make_cfg, setup

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = 1e-5
# make_cfg('UIC') (d 32, d_ff 64, 2 heads, 1 layer), B = 2, R = 9, 2048
# features: att_embed 2*18*2048*32 + QKV/O 4*2*18*32*32 + scores and
# context 2*(2*2*2*9*9*16) + FFN 2*(2*18*32*64)
ENCODE_FLOPS = 2_674_944


def _printed_accumulator(out):
    lines = out.splitlines()
    i = lines.index("attention 10x10 accumulator (saved full maps to "
                    "vis/attn.npz)")
    return lines[i + 1:i + 11]


def _flops_names(out):
    return sorted(re.findall(r"^flops\[(\w+)\]", out, re.M))


def test_eval_cli_dump_attention_and_flops_match_jax_cli(
        jax_checkpoint, tmp_path, monkeypatch, capsys):  # noqa: F811
    """Both CLIs, --device cpu, --dump_attention 1, on one checkpoint the
    JAX package wrote (the CLI's default SAIC): the same npz keys, every
    map within 1e-5, the same printed accumulator; with --report_flops 1
    the port's CLI prints JAX's flops lines for its programs (the
    programs are held to JAX's by test_report_flops_programs_match_jax)
    and writes them to the eval_results json."""
    model, infos = jax_checkpoint
    argv = ["--model", model, "--infos_path", infos, "--device", "cpu",
            "--num_images", "-1", "--dump_attention", "1"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jout = _run_jax_cli(argv, str(jdir))
    monkeypatch.chdir(tdir)
    teval.main(argv + ["--report_flops", "1"])
    tout = capsys.readouterr().out
    want = np.load(jdir / "vis" / "attn.npz")
    got = np.load(tdir / "vis" / "attn.npz")
    assert list(got.keys()) == list(want.keys()) and len(want.keys()) > 4
    for k in want.keys():
        assert got[k].shape == want[k].shape, k
        assert float(np.abs(got[k] - want[k]).max()) <= TOL, k
    assert _printed_accumulator(tout) == _printed_accumulator(jout)
    assert _flops_names(tout) == ["SAIC", "encode"]
    assert re.search(r"^flops\[encode\]: \d+\.\d{3} GFLOP/batch "
                     r"\(\d+\.\d{3} GFLOP/image\), bytes \d+\.\d MB$",
                     tout, re.M)
    res = json.loads((tdir / "eval_results" / "cli_test.json").read_text())
    assert set(res["flops"]) == {"encode", "SAIC"}


def test_capture_takes_the_plain_path_under_use_pallas():
    """With the attention core on, the capture still records every map
    (the kernel never forms the probabilities), equal to the maps with
    the core off, and the switch is restored after the block."""
    _, _, tm = make_pair("UIC", "add", seed=3)
    att, am = (torch.from_numpy(x) for x in make_feats(2, seed=3))
    L2 = tm.max_length + 2
    labels = torch.zeros((2, L2), dtype=torch.long)
    labels[:, :4] = torch.tensor([1, 7, 8, 9])
    pn = torch.full((2,), 3)
    pl = torch.zeros((2, L2), dtype=torch.long)
    pl[:, :3] = torch.tensor([1, 2, 1])
    syn = torch.zeros((2, L2), dtype=torch.long)
    syn[:, 1:3] = torch.tensor([5, 6])
    maps = []
    for core in (False, True):
        tm.set_attention_core(core)
        with torch.no_grad(), tm.capture_attention() as store:
            tm(att, am, labels, pn, pl, syn)
        maps.append(store)
    assert all(m.use_core for m in tm.modules() if hasattr(m, "use_core"))
    assert all(m.capture is None for m in tm.modules()
               if hasattr(m, "capture"))
    tm.set_attention_core(False)
    assert sorted(maps[0]) == sorted(maps[1]) and len(maps[0]) == 14
    for k in maps[0]:
        assert torch.equal(maps[0][k], maps[1][k]), k
        assert torch.allclose(maps[0][k].sum(-1),
                              torch.ones(()), atol=1e-5), k


def _port_pair(mode):
    """JAX's make_cfg model, its batch and params (tests/test_train.py
    ``setup``), and the port's model of the same config on those params."""
    cfg, data, jm, _, state = setup(mode)
    batch = data.get_batch("val")
    tcfg = make_config(**{k: cfg[k] for k in (
        "train_mode", "N_enc", "N_dec", "N_len", "d_model", "d_ff",
        "num_att_heads", "max_length", "att_feat_size", "max_boxes",
        "dtype")})
    tm = build_model(tcfg, data.vocab_size, device="cpu")
    load_jax_params(tm, to_numpy_tree(jax.device_get(state.params)))
    return jm, state.params, tm, batch


@pytest.mark.parametrize("mode,kw,inf,keys", [
    ("UIC", {}, "NAIC", {"encode", "NAIC"}),
    ("AIC", {}, "", {"encode", "AIC"}),
    ("AIC", {"beam_size": 3}, "", {"encode", "beam"}),
])
def test_report_flops_programs_match_jax(mode, kw, inf, keys):
    """The same program keys as JAX's report_flops for UIC->NAIC, AIC and
    AIC beam 3; every count positive and finite.  The encode's FLOPs are
    the analytic count exactly (UIC, B = 2, R = 9) and within 0.80-1.00
    of XLA's (which also counts elementwise work); decode programs are
    not compared with JAX (XLA costs a loop body once)."""
    jm, params, tm, batch = _port_pair(mode)
    kwargs = {"train_mode": mode, **kw}
    want = jeu.report_flops(jm, params, batch, dict(kwargs),
                            inference_mode=inf)
    got = teu.report_flops(tm, batch, dict(kwargs), inference_mode=inf)
    assert set(got) == set(want) == keys
    for c in got.values():
        assert c["flops"] > 0 and np.isfinite(c["flops"])
        assert c["bytes_accessed"] > 0 and c["per_image_gflops"] > 0
    enc = got["encode"]["flops"]
    assert 0.80 <= enc / want["encode"]["flops"] <= 1.00
    if mode == "UIC":
        assert batch["att_feats"].shape[:2] == (2, 9)
        assert enc == ENCODE_FLOPS
        assert got["encode"]["per_image_gflops"] == ENCODE_FLOPS / 2 / 1e9


def test_report_flops_needs_the_vocab_for_constraints():
    """As JAX's: suppress_UNK without ix_to_word raises ValueError."""
    _, _, tm = make_pair("AIC", seed=1)
    att, am = make_feats(2)
    with pytest.raises(ValueError, match="ix_to_word"):
        teu.report_flops(tm, {"att_feats": att, "att_masks": am},
                         {"train_mode": "AIC", "suppress_UNK": 1})


def _train_losses(ckpt):
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_profile_steps_writes_a_trace(tmp_path, capsys):
    """--profile_steps 2 on the training CLI: a trace under
    <checkpoint_path>/profile/ with the steps' ops and the program's XE
    spans in it, each span as often as the others, 'profiler trace
    written' printed, and the losses equal to a run without it."""
    base = ["--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
            "--id", "prof", "--device", "cpu", "--batch_size", "4",
            "--losses_log_every", "1", "--save_checkpoint_every", "100",
            "--language_eval", "0", "--max_epochs", "1"]
    runs = {}
    for flag in ("0", "2"):
        ckpt = str(tmp_path / f"p{flag}")
        ttrain.main(base + ["--checkpoint_path", ckpt, "--profile_steps",
                            flag])
        runs[flag] = ckpt
    out = capsys.readouterr().out
    assert out.count("profiler trace written") == 1
    assert not os.path.exists(os.path.join(runs["0"], "profile"))
    traces = os.listdir(os.path.join(runs["2"], "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(runs["2"], "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    spans = [sum(e.get("name") == name for e in events)
             for name in ("bfc.xe.upload", "bfc.xe.forward",
                          "bfc.xe.backward", "bfc.xe.optimizer")]
    assert spans[0] >= 1 and len(set(spans)) == 1
    assert len(_train_losses(runs["0"])) >= 2
    assert _train_losses(runs["2"]) == _train_losses(runs["0"])
