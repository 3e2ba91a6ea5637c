"""The port reads and writes the JAX package's checkpoint files without
flax: ``model.ckpt`` (flax msgpack, ``utils/flax_msgpack.py``) and
``infos_<id>.pkl`` (``train/state.py``), against flax and the JAX
package's ``train/state.py`` (CPU)."""

import copy
import os
import pickle
import struct
import types

import flax.serialization as fser
import jax
import numpy as np
import optax
import pytest
import torch

from boficap_tpu.train import state as jax_state
from boficap_tpu_torch.convert import (load_jax_checkpoint, load_jax_params,
                                       to_jax_tree)
from boficap_tpu_torch.train import state as port_state
from boficap_tpu_torch.utils import flax_msgpack as fm
from tests._torch_port_util import make_pair


@pytest.fixture(scope="module")
def pair():
    return make_pair("UIC", "add", seed=2)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(w[k]), np.asarray(g[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_reader_gives_flax_tree_bitwise(pair, tmp_path):
    """The port's reader on flax's bytes gives the tree bitwise;
    load_jax_checkpoint on the file equals load_jax_params on the tree; the
    port's writer gives flax's bytes."""
    _, params, tm = pair
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    data = fser.to_bytes(params)
    _assert_same_tree(fm.msgpack_restore(data), tree)
    assert fm.msgpack_serialize(tree) == data
    path = tmp_path / "model.ckpt"
    path.write_bytes(data)
    a = load_jax_checkpoint(str(path), _zeroed(tm))
    b = load_jax_params(_zeroed(tm), tree)
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(sa[k], v) for k, v in tm.state_dict().items())


def _zeroed(tm):
    m = copy.deepcopy(tm)
    with torch.no_grad():
        for p in m.parameters():
            p.zero_()
    return m


def test_chunked_array_reads_back(monkeypatch):
    """An array above MAX_CHUNK_SIZE (shrunk here) is a chunked map in
    flax's file; the port reads it whole and writes the same bytes."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 1000)
    rs = np.random.RandomState(0)
    tree = {"params": {"big": rs.randn(37, 29).astype(np.float32),
                       "ids": np.arange(700, dtype=np.int32),
                       "small": rs.randn(3).astype(np.float32)}}
    data = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(fm.msgpack_restore(data), tree)
    assert fm.msgpack_serialize(tree) == data


def test_scalars_bool_and_bfloat16_leaves():
    """numpy scalars (ext 3), bool and int32 arrays, Python scalars, and
    bfloat16 arrays (read as torch.bfloat16 from their bits)."""
    import jax.numpy as jnp
    bf = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    tree = {"a": np.float32(2.5), "b": np.array([True, False]),
            "c": np.int32(-7), "d": 3, "e": -1.25, "f": "x" * 40,
            "g": None, "h": bf, "i": np.zeros((0, 3), np.float32)}
    data = fser.to_bytes(tree)
    got = fm.msgpack_restore(data)
    assert got["a"] == np.float32(2.5) and got["a"].dtype == np.float32
    assert got["c"] == -7 and got["c"].dtype == np.int32
    assert got["b"].tolist() == [True, False]
    assert (got["d"], got["e"], got["f"], got["g"]) == (3, -1.25, "x" * 40,
                                                        None)
    assert got["h"].dtype == torch.bfloat16
    assert np.array_equal(got["h"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(bf).view(np.uint16))
    assert got["i"].shape == (0, 3)
    assert fm.msgpack_serialize(got) == data


def test_jax_load_params_reads_port_written_file(pair, tmp_path):
    """JAX's load_params reads the file the port's save_checkpoint writes
    (to_jax_tree of the port's model) to the same arrays."""
    _, params, tm = pair
    cfg = types.SimpleNamespace(checkpoint_path=str(tmp_path), id="pt")
    infos = {"iter": 3, "epoch": 1, "vocab": {"4": "w0"}, "opt": {"id": "pt"}}
    port_state.save_checkpoint(cfg, to_jax_tree(tm), infos, append="best")
    template = jax.tree_util.tree_map(np.zeros_like, jax.device_get(params))
    got = jax_state.load_params(str(tmp_path / "model_best.ckpt"), template)
    _assert_same_tree(got, jax.device_get(params))
    assert jax_state.load_infos(str(tmp_path), "pt", "best") == infos
    assert port_state.load_infos(str(tmp_path), "pt", "best") == infos


def _ndarray_ext(shape, name, payload, code=1):
    inner = fm.msgpack_serialize([list(shape), name, payload])
    return bytes([0xC7, len(inner)]) + struct.pack(">b", code) + inner


@pytest.mark.parametrize("case", ["truncated", "ext_code", "complex",
                                  "dtype", "size", "trailing"])
def test_reader_rejects_what_flax_does_not_write(case):
    """Truncation, ext codes other than an array's or a numpy scalar's (a
    complex is no parameter), other dtypes, a payload of the wrong size and
    trailing bytes raise ValueError."""
    good = fser.to_bytes({"w": np.arange(6, dtype=np.float32)})
    bad = {"truncated": good[:-5],
           "ext_code": b"\x81\xa1w" + _ndarray_ext((2,), "float32",
                                                   b"\0" * 8, code=9),
           "dtype": b"\x81\xa1w" + _ndarray_ext((2,), "float64",
                                                b"\0" * 16),
           "size": b"\x81\xa1w" + _ndarray_ext((3,), "float32", b"\0" * 8),
           "complex": fser.to_bytes({"w": 1 + 2j}),
           "trailing": good + b"\xc0"}[case]
    assert fm.msgpack_restore(b"\x81\xa1w" + _ndarray_ext(
        (2,), "float32", b"\0" * 8))["w"].shape == (2,)
    with pytest.raises(ValueError):
        fm.msgpack_restore(bad)


def test_writer_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float64"):
        fm.msgpack_serialize({"w": np.zeros(3)})


def test_infos_written_by_jax_read_back(pair, tmp_path):
    """An infos pickle from the JAX package's save_checkpoint, laid out as
    tools/train.py writes it (numpy loader state, OrderedDict, defaultdict),
    reads back equal."""
    import collections
    from boficap_tpu.config import default_config
    _, params, _ = pair
    opt = default_config()
    opt.id = "jx"
    opt.checkpoint_path = str(tmp_path)
    rs = np.random.RandomState(0)
    infos = {"iter": 12, "epoch": 2, "opt": dict(opt),
             "vocab": {str(i + 4): f"w{i}" for i in range(40)},
             "loader_state_dict": {
                 "train": {"index_list": rs.permutation(18),
                           "iter_counter": 4},
                 "val": {"index_list": np.arange(6), "iter_counter": 0}},
             "plateau": collections.OrderedDict(best=0.5, bad=1),
             "best_val_score": np.float64(0.75),
             "hist": collections.defaultdict(dict, {"a": {1: 2.0}})}
    state = jax_state.create_state(params, optax.sgd(0.1))
    jax_state.save_checkpoint(opt, state, infos, {})
    got = port_state.load_infos(str(tmp_path), "jx")
    assert sorted(got) == sorted(infos)
    for k in ("iter", "epoch", "opt", "vocab", "plateau", "hist"):
        assert got[k] == infos[k], k
    assert got["best_val_score"] == infos["best_val_score"]
    for split, st in infos["loader_state_dict"].items():
        g = got["loader_state_dict"][split]
        assert np.array_equal(g["index_list"], st["index_list"])
        assert g["index_list"].dtype == st["index_list"].dtype
        assert g["iter_counter"] == st["iter_counter"]


@pytest.mark.parametrize("obj", ["os_system", "jax_class", "eval"])
def test_infos_reader_refuses_code(obj, tmp_path):
    """A pickle that names a function or a class of the JAX package raises
    UnpicklingError instead of running or building it."""
    from boficap_tpu.config.config import Config as JaxConfig

    class Evil:
        def __reduce__(self):
            return (eval, ("1 + 1",))

    payload = {"os_system": lambda: pickle.dumps({"x": os.system}),
               "jax_class": lambda: pickle.dumps({"opt": JaxConfig(a=1)}),
               "eval": lambda: pickle.dumps(Evil())}[obj]()
    (tmp_path / "infos_x.pkl").write_bytes(payload)
    with pytest.raises(pickle.UnpicklingError):
        port_state.load_infos(str(tmp_path), "x")


def test_serve_http_loads_a_jax_checkpoint(pair, tmp_path):
    """serve_http --model/--infos_path builds its server from a checkpoint
    in the JAX package's format: the options and vocabulary from the
    infos, every weight from model.ckpt."""
    from boficap_tpu.config import default_config
    from boficap_tpu_torch.serve_http import build_server, parse_args
    from tests._torch_port_util import L, VOCAB
    from tests.test_model import tiny_cfg
    _, params, tm = pair
    opt = tiny_cfg("UIC")
    opt.update(max_length=L, dtype="float32", checkpoint_path=str(tmp_path),
               id="srv")
    vocab = {str(i + 4): f"w{i}" for i in range(VOCAB)}
    state = jax_state.create_state(params, optax.sgd(0.1))
    jax_state.save_checkpoint(opt, state, {"opt": dict(opt), "vocab": vocab},
                              {})
    assert default_config().keys() <= opt.keys()
    srv = build_server(parse_args([
        "--model", str(tmp_path / "model.ckpt"), "--infos_path",
        str(tmp_path / "infos_srv.pkl"), "--device", "cpu", "--warm", "0",
        "--max_regions", "5"]))
    try:
        assert srv.ix_to_word == vocab
        got = srv.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in tm.state_dict().items())
        att = np.random.RandomState(0).randn(5, 2048).astype(np.float32)
        assert isinstance(srv.submit(att).caption(timeout=120), str)
    finally:
        srv.close()
