"""Port parity, the raw-image eval path: ``models/resnet.py``,
``data/raw.py`` and ``tools/eval.py --image_folder`` against the JAX
package's, and the decodes over a 196-region memory (a 14 x 14 image
grid, past the row path's 128 keys), on the CPU.

Tolerances: the trunk's features within 1e-4 of the largest magnitude
(float32; the two packages' convolutions sum in other orders); the
resize within 1e-5 absolute on [0, 1] pixels (jax.image.resize and torch's
antialiased bilinear are the same filter, their weights rounded apart);
images, loader batches and captions identical; the decodes' tensors within
1e-5 and their tokens identical, the JAX Pallas kernels run in interpret
mode."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.data import dataset as jds
from boficap_tpu.data import raw as jraw
from boficap_tpu.decode import ar as jar
from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.models import resnet as jrn
from boficap_tpu.train import state as jax_state
from boficap_tpu_torch.data import raw as traw
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.models import resnet as trn
from boficap_tpu_torch.tools import eval as teval
from tests._torch_port_util import L, make_pair
from tests.test_model import tiny_cfg
from tests.test_torch_port_ar import pallas
from tests.test_torch_port_eval import _run_jax_cli

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT_TOL = 1e-4
LAYERS = (1, 1, 1, 1)
GRID = 196                      # 14 x 14 regions


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# models/resnet.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trunk():
    """A trunk at layers (1, 1, 1, 1) in the JAX package's parameter tree
    (``init_resnet_params``'s layout and He-init scale, drawn with numpy,
    BN statistics not the identity), and the port's trunk on the same
    weights (``state_from_jax``)."""
    rs = np.random.RandomState(3)
    shapes = jax.eval_shape(lambda: jrn.init_resnet_params(
        jax.random.PRNGKey(0), LAYERS))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if len(leaf.shape) == 4:
            return (rs.randn(*leaf.shape)
                    * np.sqrt(2.0 / np.prod(leaf.shape[:3]))).astype(
                        np.float32)
        if name.endswith("['var']"):
            return rs.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        base = 1.0 if name.endswith("['gamma']") else 0.0
        return (base + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree, trn.load_torch_resnet_state(trn.state_from_jax(tree),
                                             LAYERS)


@pytest.mark.parametrize("hw", [(64, 64), (70, 90)])
def test_resnet_features_match_jax(jax_trunk, hw):
    """fc [1, 2048] and att [1, 196, 2048] of one image: the ceil-mode
    stem pool, the stride on conv1 and the adaptive binning (layer4 maps
    of 2 x 2 and 3 x 3 pooled to 14 x 14)."""
    tree, trunk = jax_trunk
    img = np.random.RandomState(hw[1]).randn(1, *hw, 3).astype(np.float32)
    jfc, jatt = jrn.resnet_features(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(img))
    fc, att = trn.resnet_features(trunk, torch.from_numpy(img))
    assert tuple(fc.shape) == (1, 2048) and tuple(att.shape) == (1, GRID,
                                                                 2048)
    assert _rel(fc.numpy(), np.asarray(jfc)) <= FEAT_TOL
    assert _rel(att.numpy(), np.asarray(jatt)) <= FEAT_TOL


def test_load_torch_resnet_state_matches_jax():
    """A torchvision-layout state dict (numpy, BN statistics not the
    identity, the classifier and num_batches_tracked entries present) read
    by both packages' ``load_torch_resnet_state``: the same features; a
    missing entry raises."""
    rs = np.random.RandomState(5)
    names = trn.ResNetTrunk(LAYERS).state_dict()
    sd = {}
    for k, v in names.items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            sd[k] = rs.uniform(0.5, 2.0, shape).astype(np.float32)
        elif k.endswith(".weight") and len(shape) == 4:
            fan_in = int(np.prod(shape[1:]))
            sd[k] = (rs.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        else:
            sd[k] = (rs.randn(*shape) * 0.1
                     + (1.0 if k.endswith("weight") else 0.0)).astype(
                         np.float32)
    sd["fc.weight"] = rs.randn(10, 2048).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    sd["bn1.num_batches_tracked"] = np.array(7)
    img = rs.randn(1, 64, 64, 3).astype(np.float32)
    jfc, jatt = jrn.resnet_features(jrn.load_torch_resnet_state(sd, LAYERS),
                                    jnp.asarray(img))
    trunk = trn.load_torch_resnet_state(sd, LAYERS)
    fc, att = trn.resnet_features(trunk, torch.from_numpy(img))
    assert _rel(fc.numpy(), np.asarray(jfc)) <= FEAT_TOL
    assert _rel(att.numpy(), np.asarray(jatt)) <= FEAT_TOL
    del sd["layer2.0.downsample.1.running_mean"]
    with pytest.raises(KeyError, match="lacks"):
        trn.load_torch_resnet_state(sd, LAYERS)


@pytest.mark.parametrize("hw", [(640, 480), (120, 200), (300, 640)],
                         ids=["down", "up", "mixed"])
def test_resize_and_normalize_match_jax(hw):
    """The trunk extractor's input: the JAX extractor's
    ``jax.image.resize(img, (448, 448, 3), "bilinear")`` (antialiased where
    it shrinks) then the ImageNet normalization, against the port's
    ``resize_image`` and the same normalization, shrinking both axes,
    growing both and one of each."""
    img = np.random.RandomState(hw[0]).rand(*hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (448, 448, 3),
                                       "bilinear"))
    got = traw.resize_image(torch.from_numpy(img), 448).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mean, std = trn.IMAGENET_MEAN, trn.IMAGENET_STD
    np.testing.assert_allclose((got - mean) / std, (want - mean) / std,
                               rtol=0, atol=1e-5 / std.min())
    np.testing.assert_array_equal(trn.normalize_images(img[None]),
                                  jrn.normalize_images(img[None]))


# ---------------------------------------------------------------------------
# data/raw.py
# ---------------------------------------------------------------------------

def _write_images(folder, sizes=((40, 56), (60, 30), (33, 33)),
                  exts=(".png", ".ppm", ".jpg"), seed=0):
    rs = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    names = []
    for i, ((h, w), ext) in enumerate(zip(sizes, exts)):
        name = f"im{i}{ext}"
        Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(folder, name))
        names.append(name)
    return names


def test_ppm_reader_matches_pil(tmp_path):
    """``read_ppm`` on PIL's own P6 file and on one with a header comment:
    PIL's pixels bit for bit; another maxval raises."""
    rs = np.random.RandomState(1)
    pixels = rs.randint(0, 256, (17, 23, 3), np.uint8)
    path = str(tmp_path / "a.ppm")
    Image.fromarray(pixels).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(traw.read_ppm(path), want)
    np.testing.assert_array_equal(want, pixels)
    commented = str(tmp_path / "b.ppm")
    with open(commented, "wb") as f:
        f.write(b"P6\n# made by hand\n23 17\n255\n" + pixels.tobytes())
    with Image.open(commented) as im:
        np.testing.assert_array_equal(traw.read_ppm(commented),
                                      np.asarray(im.convert("RGB")))
    deep = str(tmp_path / "c.ppm")
    with open(deep, "wb") as f:
        f.write(b"P6 1 1 65535\n" + b"\0" * 6)
    with pytest.raises(ValueError, match="maxval"):
        traw.read_ppm(deep)


def test_read_image_without_pil(tmp_path, monkeypatch):
    """Where PIL does not import, .ppm goes through ``read_ppm`` and any
    other image raises ValueError; with PIL, its read."""
    names = _write_images(str(tmp_path))
    paths = [str(tmp_path / n) for n in names]
    with_pil = [traw.read_image(p) for p in paths]
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(traw.read_image(paths[1]), with_pil[1])
    with pytest.raises(ValueError, match="PIL"):
        traw.read_image(paths[0])


@pytest.mark.parametrize("coco", [False, True])
def test_dataloader_raw_patch_matches_jax(tmp_path, coco):
    """Both packages' DataLoaderRaw with the patch extractor over images
    of three sizes and formats, batch 2 (the second batch wraps), from the
    folder or a coco json: every batch entry identical."""
    folder = str(tmp_path / "imgs")
    names = _write_images(folder)
    coco_json = ""
    if coco:
        coco_json = str(tmp_path / "coco.json")
        with open(coco_json, "w") as f:
            json.dump({"images": [{"file_name": n, "id": 100 + i}
                                  for i, n in enumerate(names[::-1])]}, f)
    jl = jraw.DataLoaderRaw(folder, 2, extractor=jraw.patch_extractor(),
                            coco_json=coco_json)
    tl_ = traw.DataLoaderRaw(folder, 2, extractor=traw.patch_extractor(),
                             coco_json=coco_json)
    assert len(tl_) == len(jl) == 3
    for _ in range(2):
        want, got = jl.get_batch("test"), tl_.get_batch("test")
        assert sorted(got) == sorted(want)
        for k in ("fc_feats", "att_feats", "att_masks"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["att_feats"].shape == (2, GRID, 2048)
        for k in ("labels", "masks", "gts", "infos", "bounds"):
            assert got[k] == want[k], k
    assert got["bounds"]["wrapped"]


def test_dataloader_raw_chooses_extractor(tmp_path, monkeypatch, capsys):
    """No extractor on the CPU without torchvision: the patch extractor,
    said so; a mistyped cnn_model raises before the choice; a
    $BOFICAP_CNN_WEIGHTS that does not load raises (the trunk's error is
    not caught)."""
    folder = str(tmp_path)
    _write_images(folder)
    monkeypatch.delenv("BOFICAP_CNN_WEIGHTS", raising=False)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    loader = traw.DataLoaderRaw(folder, 2, device="cpu")
    assert "patch extractor on cpu" in capsys.readouterr().out
    img = np.random.RandomState(2).rand(30, 42, 3).astype(np.float32)
    for g, w in zip(loader.extract(img), jraw.patch_extractor()(img)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="cnn_model"):
        traw.DataLoaderRaw(folder, 2, cnn_model="resnet50", device="cpu")
    monkeypatch.setenv("BOFICAP_CNN_WEIGHTS", str(tmp_path / "none.pth"))
    with pytest.raises(RuntimeError, match="BOFICAP_CNN_WEIGHTS"):
        traw.DataLoaderRaw(folder, 2, device="cpu")


def _stub_torchvision(trunk, url, seen):
    """A ``torchvision`` whose ``models.resnet101(weights=None)`` is the
    port's trunk architecture under torchvision's attribute names (stem
    conv, BN, ReLU, ceil-mode max pool, layer1-4), recording cuDNN's TF32
    flag in ``seen`` at each stage of its forward, and whose
    ``get_model_weights`` names ``url``."""
    import types

    from torch import nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1, self.bn1 = trunk.conv1, trunk.bn1
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2d(3, 2, padding=0, ceil_mode=True)
            for i in range(1, 5):
                setattr(self, f"layer{i}", getattr(trunk, f"layer{i}"))
            for m in (self.conv1, *(getattr(self, f"layer{i}")
                                    for i in range(1, 5))):
                m.register_forward_pre_hook(lambda *_: seen.append(
                    torch.backends.cudnn.allow_tf32))

    weights = types.SimpleNamespace(
        IMAGENET1K_V1=types.SimpleNamespace(url=url))
    models = types.SimpleNamespace(
        resnet101=lambda weights=None: Net(),
        get_model_weights=lambda name: weights)
    return types.SimpleNamespace(models=models)


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_resnet_extractor_full_float32(tmp_path, monkeypatch, caller_tf32):
    """``resnet_extractor`` with no download: a stub torchvision and a
    seeded state dict written into a temporary torch hub cache.  At the
    image's own size its fc and att equal ``resnet_features`` on the same
    weights within 1e-5 relative; every stage of its forward sees cuDNN's
    TF32 off, and the caller's setting is back after it; without the file
    it raises FileNotFoundError."""
    trunk = trn.init_resnet(LAYERS, seed=7)
    url = "https://download.invalid/models/resnet101-stub.pth"
    ckpt = tmp_path / "checkpoints"
    seen = []
    monkeypatch.setitem(sys.modules, "torchvision",
                        _stub_torchvision(trn.init_resnet(LAYERS, seed=1),
                                          url, seen))
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path))
    with pytest.raises(FileNotFoundError, match="hub cache"):
        traw.resnet_extractor(device="cpu")
    ckpt.mkdir()
    torch.save(trunk.state_dict(), ckpt / "resnet101-stub.pth")
    extract = traw.resnet_extractor(device="cpu")
    img = np.random.RandomState(3).rand(70, 90, 3).astype(np.float32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller_tf32)
    fc, att = extract(img)
    assert seen == [False] * 5
    assert torch.backends.cudnn.allow_tf32 is caller_tf32
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    wfc, watt = trn.resnet_features(
        trunk, torch.from_numpy((img - mean) / std)[None])
    assert fc.shape == (2048,) and att.shape == (14, 14, 2048)
    assert _rel(fc, wfc[0].numpy()) <= 1e-5
    assert _rel(att.reshape(GRID, -1), watt[0].numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# tools/eval.py --image_folder
# ---------------------------------------------------------------------------

def test_eval_cli_image_folder_matches_jax_cli(tmp_path, monkeypatch,
                                               capsys):
    """Both CLIs, --device cpu, NAIC, on a tiny UIC checkpoint the JAX
    package wrote (att_feat_size 2048), over a folder of 3 images (patch
    features, 196 regions): the same captions, ids and file names, the
    language metrics off with the JAX message, and each image copied into
    vis/imgs from the folder (image_root defaults to it)."""
    cid = "raw"
    _, params, _ = make_pair("UIC", "add", seed=2, vocab=40)
    cfg = tiny_cfg("UIC")
    cfg.update(max_length=L, dtype="float32", input_json="synthetic",
               input_att_dir="synthetic", batch_size=4, id=cid,
               checkpoint_path=str(tmp_path / "ckpt"))
    jax_finalize(cfg)
    assert cfg.att_feat_size == 2048
    data = jds.CaptionData(cfg)
    infos = {"iter": 0, "epoch": 0, "loader_state_dict": data.state_dict(),
             "vocab": data.ix_to_word, "opt": dict(cfg),
             "best_val_score": None}
    jax_state.save_checkpoint(cfg, jax_state.create_state(params,
                                                          optax.sgd(0.1)),
                              infos, {})
    folder = str(tmp_path / "imgs")
    _write_images(folder)
    argv = ["--model", os.path.join(cfg.checkpoint_path, "model.ckpt"),
            "--infos_path", os.path.join(cfg.checkpoint_path,
                                         f"infos_{cid}.pkl"),
            "--device", "cpu", "--inference_mode", "NAIC",
            "--image_folder", folder, "--language_eval", "1",
            "--dump_path", "1"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jout = _run_jax_cli(argv, str(jdir))
    monkeypatch.chdir(tdir)
    result = teval.main(argv)
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "language_eval -> 0" in out and "images/s" in out
    assert "patch extractor" in tout and result["lang_stats"] is None
    jv = json.loads((jdir / "vis" / "vis.json").read_text())
    tv = json.loads((tdir / "vis" / "vis.json").read_text())
    assert len(tv) == 3 and any(p["caption"] for p in tv)
    for k in ("image_id", "caption", "file_name"):
        assert [p[k] for p in tv] == [p[k] for p in jv], k
    for g, w in zip(tv, jv):
        assert sorted(g) == sorted(w)
        for k in ("perplexity", "entropy"):
            assert abs(g[k] - w[k]) <= 1e-5
    # the wrapped fourth slot is copied too, before its prediction is
    # dropped (the reference's order, in both packages)
    assert (sorted(os.listdir(tdir / "vis" / "imgs"))
            == sorted(os.listdir(jdir / "vis" / "imgs"))
            == [f"img{i}.jpg" for i in range(1, 5)])


# ---------------------------------------------------------------------------
# the decodes over 196 regions (d_model 32)
# ---------------------------------------------------------------------------

B = 3
KEYS_EXACT = ("seq", "phrase_num", "phrase_length", "phrase_syn")
KEYS_CLOSE = ("tok_logprobs", "entropy")
WIDTHS = dict(d_model=32, d_ff=64)


def _feats196(seed):
    """Features of a 14 x 14 grid [B, 196, 2048], sample 1 padded to 150
    live regions, sample 2 to 3."""
    rs = np.random.RandomState(seed)
    att = rs.randn(B, GRID, 2048).astype(np.float32)
    am = np.ones((B, GRID), np.float32)
    am[1, 150:] = 0
    am[2, 3:] = 0
    return att, am


@pytest.fixture(scope="module")
def uic32():
    """A UIC pair at d_model 32, one 196-region batch, and its encodes on
    the whole-stack route: the JAX Pallas kernel (#4, interpret) and the
    port's twin, held to each other and to the JAX plain encode."""
    jm, params, tm = make_pair("UIC", "add", seed=4, **WIDTHS)
    att, am = _feats196(5)
    a, m = jnp.asarray(att), jnp.asarray(am)
    plain = jm.apply(params, a, m, deterministic=True, method="encode")
    jmem = jbf.fused_encode(jm, params, a, m, interpret=True, stacked=True)
    with torch.no_grad():
        tmem = tbf.fused_encode(tm, torch.from_numpy(att),
                                torch.from_numpy(am), stacked=True)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(plain), **TOL)
    return jm, params, tm, att, am, jmem, tmem


def _encodes(uic32, stacked):
    """The fixture's whole-stack encodes, or the per-layer route's (#1:
    the JAX Pallas kernel in interpret mode and the port's twin)."""
    jm, params, tm, att, am, jmem, tmem = uic32
    if stacked:
        return jmem, tmem
    jmem = jbf.fused_encode(jm, params, jnp.asarray(att), jnp.asarray(am),
                            interpret=True, stacked=False)
    with torch.no_grad():
        tmem = tbf.fused_encode(tm, torch.from_numpy(att),
                                torch.from_numpy(am), stacked=False)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    return jmem, tmem


def _same(got, want):
    for k in KEYS_EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in KEYS_CLOSE:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("stacked", [True, False])
def test_na_decode_at_196_regions_matches_jax(uic32, stacked):
    """``fused_encode`` and ``na_decode`` with the fused fill on the route
    ``stacked`` names: the port's twins of #4 / #5 (#1 / #2 per layer) and
    #3 against the JAX Pallas kernels in interpret mode; and the port's
    plain decode against the JAX plain decode."""
    jm, params, tm, att, am = uic32[:5]
    jmem, tmem = _encodes(uic32, stacked)
    jsrc, tsrc = jnp.asarray(am).astype(bool), torch.from_numpy(am).bool()
    want = jbf.na_decode(jm, params, jax.random.PRNGKey(0), jmem, jsrc,
                         fused_fill=True, fused_interpret=True,
                         stacked=stacked)
    got = tbf.na_decode(tm, tmem, tsrc, fused_fill=True, stacked=stacked)
    assert np.asarray(want["phrase_num"]).max() > 0
    _same(got, want)
    if stacked:
        _same(tbf.na_decode(tm, tmem, tsrc),
              jbf.na_decode(jm, params, jax.random.PRNGKey(0), jmem, jsrc))


@pytest.mark.parametrize("stacked", [True, False])
def test_sa_decode_at_196_regions_matches_jax(uic32, stacked):
    """``sa_decode`` with the fused fill at window 2 (narrow and wide
    rounds): the port's twins of #6 and #7 (#8 per layer) against the JAX
    Pallas kernels in interpret mode, every cross-attention over 196
    keys."""
    jm, params, tm, att, am = uic32[:5]
    jmem, tmem = _encodes(uic32, stacked)
    want = jbf.sa_decode(jm, params, jax.random.PRNGKey(0), jmem,
                         jnp.asarray(am).astype(bool), fused_fill=True,
                         fused_interpret=True, stacked=stacked, window=2)
    stats = {}
    got = tbf.sa_decode(tm, tmem, torch.from_numpy(am).bool(),
                        fused_fill=True, stacked=stacked, window=2,
                        stats=stats)
    assert np.asarray(want["phrase_num"]).max() > 0
    assert stats["narrow"] > 0 and stats["wide"] > 0
    _same(got, want)


def test_ar_decode_at_196_regions_matches_jax():
    """``ar_sample`` of an AIC model at d_model 32 with use_pallas on:
    every step's cross-attention (1 x 196) on the attention core's twin
    against the JAX kernel in interpret mode, and off against the JAX
    plain decode."""
    jm, params, tm = make_pair("AIC", seed=2, **WIDTHS)
    att, am = _feats196(6)
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    jsrc, tsrc = jnp.asarray(am).astype(bool), torch.from_numpy(am).bool()
    for core in (True, False):
        with pallas(tm, core):
            want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem,
                                 jsrc)
            got = tar.ar_sample(tm, tmem, tsrc)
        np.testing.assert_array_equal(got["seq"].numpy(),
                                      np.asarray(want["seq"]))
        for k in KEYS_CLOSE:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the same decodes at bf16: the margin rule (PARITY.md, "Random-init tensor
# parity" and tests/test_torch_port_sa.py BF16_MARGIN_NOISE)
# ---------------------------------------------------------------------------

# a word (or a plan slot) may differ only where the port's plain path's
# top-2 logprob margin is below this: two bf16 roundings apart, ~2**-7
# relative on logits of size ~1, compounded over the layers
BF16_MARGIN = 0.1
# bf16 memories: each package rounds its float32 sums to bf16 at its own
# boundaries, so elements differ by an ulp or two of their own size
# (2**-7 relative), relative to the largest magnitude
BF16_MEM_TOL = 3e-2
# token log-probs and entropies where the words agree: logits round at
# 2**-8 relative in each package, so a log-prob of a few nats moves by
# ~0.05; the bound leaves room for the words' context to round apart
BF16_LP_TOL = 0.5


def _margins(lp):
    top2 = lp.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


@torch.no_grad()
def _plain_na_margins(tm, mem, src):
    """The port's plain NA decode: the bounding loop's top-2 margin at
    each step (the smaller of the length and syntax heads'), [B, L], and
    the fill's at each position, [B, L]."""
    gaps, step = [], tm.bound_step_cached

    def record(*a, **kw):
        out = step(*a, **kw)
        gaps.append(torch.minimum(*(_margins(lp) for lp in out)))
        return out

    tm.bound_step_cached = record
    try:
        s = tbf.bound_plan(tm, mem, src, L, L)
    finally:
        del tm.bound_step_cached
    total = s["last"] - 1
    na_mask = (torch.arange(L)[None, None, :]
               < total[:, None, None]).expand(-1, L, L)
    lp = tm.generate(tm.decode_na(s["extend_syn"][:, 1:-1], mem, src,
                                  na_mask))
    return torch.stack(gaps, -1), _margins(lp)


@torch.no_grad()
def _plain_last_margins(tm, decode, *args, **kw):
    """Run ``decode`` with the model's plain generator recorded: every
    call's top-2 margins, [B, calls * rows] (an AR decode: one column a
    step) and the last call's alone (an SA decode: every position as it
    was decoded)."""
    gaps, generate = [], tm.generate

    def record(h):
        lp = generate(h)
        gaps.append(_margins(lp).reshape(h.shape[0], -1))
        return lp

    tm.generate = record
    try:
        decode(*args, **kw)
    finally:
        del tm.generate
    return torch.cat(gaps, -1), gaps[-1]


def _first_divergence_agree(got, want, margin):
    """A sample may differ only from a word whose margin is below
    BF16_MARGIN on (the later words and plan follow the other word); every
    other sample is identical, its log-probs and entropies within
    BF16_LP_TOL.  Returns the excused samples."""
    diff = got["seq"].numpy() != np.asarray(want["seq"])
    has = diff.any(-1)
    first = diff.argmax(-1)
    at = margin.numpy()[np.arange(len(first)), first]
    assert not (has & (at >= BF16_MARGIN)).any(), at[has]
    same = ~has
    for k in ("phrase_num", "phrase_length", "phrase_syn"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy()[same],
                                          np.asarray(want[k])[same],
                                          err_msg=k)
    for k in KEYS_CLOSE:
        np.testing.assert_allclose(got[k].float().numpy()[same],
                                   np.asarray(want[k], np.float32)[same],
                                   atol=BF16_LP_TOL, rtol=0, err_msg=k)
    return int(has.sum())


@pytest.fixture(scope="module")
def uic32_bf16():
    """The UIC pair of ``uic32`` at bf16 on its 196-region batch."""
    jm, params, tm = make_pair("UIC", "add", seed=4, dtype="bfloat16",
                               **WIDTHS)
    att, am = _feats196(5)
    return jm, params, tm, att, am


def _bf16_encodes(uic, stacked):
    """#4 (``stacked``) or #1 at bf16: the JAX Pallas kernel in interpret
    mode and the port's twin, within BF16_MEM_TOL."""
    jm, params, tm, att, am = uic
    jmem = jbf.fused_encode(jm, params, jnp.asarray(att), jnp.asarray(am),
                            interpret=True, stacked=stacked)
    with torch.no_grad():
        tmem = tbf.fused_encode(tm, torch.from_numpy(att),
                                torch.from_numpy(am), stacked=stacked)
    want = np.asarray(jmem.astype(jnp.float32))
    assert _rel(tmem.float().numpy(), want) <= BF16_MEM_TOL
    return jmem, tmem


@pytest.mark.parametrize("stacked", [True, False])
def test_na_decode_at_196_regions_bf16_matches_jax(uic32_bf16, stacked):
    """bf16 ``fused_encode`` and ``na_decode`` with the fused fill, every
    attention over 196 keys normalised before it is rounded: the port's
    twins of #4 / #5 (#1 / #2 per layer) and #3 against the JAX Pallas
    kernels in interpret mode, by the margin rule: a sample's plan may
    differ only from a slot where the port's plain bounding loop's margin
    is below BF16_MARGIN (its words are then not compared); a word only
    where the plain fill's is, at most a quarter of the words; log-probs
    and entropies where the words agree within BF16_LP_TOL."""
    jm, params, tm, att, am = uic32_bf16
    jmem, tmem = _bf16_encodes(uic32_bf16, stacked)
    jsrc, tsrc = jnp.asarray(am).astype(bool), torch.from_numpy(am).bool()
    want = jbf.na_decode(jm, params, jax.random.PRNGKey(0), jmem, jsrc,
                         fused_fill=True, fused_interpret=True,
                         stacked=stacked)
    got = tbf.na_decode(tm, tmem, tsrc, fused_fill=True, stacked=stacked)
    assert np.asarray(want["phrase_num"]).max() > 0
    plan_m, fill_m = _plain_na_margins(tm, tmem, tsrc)
    slot_diff = np.zeros((B, L), bool)
    for k in ("phrase_length", "phrase_syn"):
        slot_diff |= got[k].numpy() != np.asarray(want[k])
    plan_diff = slot_diff.any(-1)
    first = slot_diff.argmax(-1)
    at = plan_m.numpy()[np.arange(B), first]
    assert not (plan_diff & (at >= BF16_MARGIN)).any(), at[plan_diff]
    same = ~plan_diff
    diff = (got["seq"].numpy() != np.asarray(want["seq"])) & same[:, None]
    assert not (diff & (fill_m.numpy() >= BF16_MARGIN)).any()
    assert diff.sum() <= diff[same].size // 4
    keep = ~diff & same[:, None]
    for k in KEYS_CLOSE:
        np.testing.assert_allclose(
            got[k].float().numpy()[keep],
            np.asarray(want[k], np.float32)[keep], atol=BF16_LP_TOL,
            rtol=0, err_msg=k)


@pytest.mark.parametrize("stacked", [True, False])
def test_sa_decode_at_196_regions_bf16_matches_jax(uic32_bf16, stacked):
    """bf16 ``sa_decode`` with the fused fill at window 2 (narrow and wide
    rounds): the port's twins of #6 and #7 (#8 per layer) against the JAX
    Pallas kernels in interpret mode, every cross-attention over 196 keys,
    by the first-divergence margin rule against the port's plain SA
    decode's margins."""
    jm, params, tm, att, am = uic32_bf16
    jmem, tmem = _bf16_encodes(uic32_bf16, stacked)
    want = jbf.sa_decode(jm, params, jax.random.PRNGKey(0), jmem,
                         jnp.asarray(am).astype(bool), fused_fill=True,
                         fused_interpret=True, stacked=stacked, window=2)
    stats = {}
    tsrc = torch.from_numpy(am).bool()
    got = tbf.sa_decode(tm, tmem, tsrc, fused_fill=True, stacked=stacked,
                        window=2, stats=stats)
    assert np.asarray(want["phrase_num"]).max() > 0
    assert stats["narrow"] > 0 and stats["wide"] > 0
    _, margin = _plain_last_margins(tm, tbf.sa_decode, tm, tmem, tsrc,
                                    window=2)
    _first_divergence_agree(got, want, margin)


def test_ar_decode_at_196_regions_bf16_matches_jax():
    """bf16 ``ar_sample`` of an AIC model with use_pallas on: every step's
    cross-attention (1 x 196) on the attention core's twin against the JAX
    kernel in interpret mode, and off against the JAX plain decode, by
    the first-divergence margin rule against the port's plain steps'
    margins."""
    jm, params, tm = make_pair("AIC", seed=2, dtype="bfloat16", **WIDTHS)
    att, am = _feats196(6)
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    assert _rel(tmem.float().numpy(),
                np.asarray(jmem.astype(jnp.float32))) <= BF16_MEM_TOL
    jsrc, tsrc = jnp.asarray(am).astype(bool), torch.from_numpy(am).bool()
    margin, _ = _plain_last_margins(tm, tar.ar_sample, tm, tmem, tsrc)
    for core in (True, False):
        with pallas(tm, core):
            want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem,
                                 jsrc)
            got = tar.ar_sample(tm, tmem, tsrc)
        assert (np.asarray(want["seq"]) > 3).any()
        _first_divergence_agree(got, want, margin)


@pytest.mark.parametrize("Lq,Lk", [(1, 196), (211, 211)])
def test_attention_core_bf16_past_key_bound_matches_jax(Lq, Lk):
    """The attention core's twin at bf16 past 128 keys (AIC's step over a
    14 x 14 grid; PB_pad's lossless packed width) against the JAX kernel
    in interpret mode, padded keys and a fully masked sample among them:
    each element within one bf16 ulp of itself or, where the context is a
    sum that nearly cancels, of its row's largest magnitude (both packages
    round the normalised p and the context to bf16, their float32 sums in
    other orders)."""
    from boficap_tpu.ops.pallas_attention import attention_core as jcore
    from boficap_tpu_torch.ops import attention as at
    rs = np.random.RandomState(Lk)
    Bq, H, Dh = 3, 2, 64
    q, k, v = (rs.randn(Bq, H, n, Dh).astype(np.float32)
               for n in (Lq, Lk, Lk))
    mask = np.broadcast_to(
        np.arange(Lk)[None, None, :] < np.array([Lk, 150, 0])[:, None, None],
        (Bq, Lq, Lk)).copy()
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = at.attention_core(tq, tk, tv, torch.from_numpy(mask)).float()
    want = np.asarray(jcore(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) for t in (tq, tk, tv)), jnp.asarray(mask),
        interpret=True).astype(jnp.float32))

    def ulp(x):
        _, e = np.frexp(np.maximum(np.abs(x), 1e-30))
        return np.ldexp(np.ones_like(x), e - 8)

    err = np.abs(got.numpy() - want)
    row = np.abs(want).max(-1, keepdims=True)
    assert ((err <= ulp(want)) | (err <= ulp(row))).all(), err.max()


def _bf16_ulp_agree(got, want):
    """Each element within one bf16 ulp of itself or, where it is a sum
    that nearly cancels, of its row's largest magnitude (the rule of the
    attention core's test above)."""
    def ulp(x):
        _, e = np.frexp(np.maximum(np.abs(x), 1e-30))
        return np.ldexp(np.ones_like(x), e - 8)

    err = np.abs(got - want)
    row = np.abs(want).max(-1, keepdims=True)
    ok = (err <= ulp(want)) | (err <= ulp(row))
    assert ok.all(), (int((~ok).sum()), float(err.max()))



@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_attention_bf16_past_key_bound_matches_jax(kind):
    """The layer twins' attention sublayer at bf16 past 128 keys (the
    q/k/v products of ``linear_plain``, then ``attention_plain``: what #1,
    #2 and #4-#8's twins run) against ``_mha``, the attention that the JAX
    package's ``_enc_kernel`` and ``_kernel`` run, with an identity output
    projection so that JAX returns the bf16 context itself: #1's encoder
    self-attention over 196 regions and #2's cross-attention from 20 words
    over a 196-region memory, padded regions and a fully masked sample
    among them: element by element within the bf16-ulp rule, and fewer
    than 1% of the elements other than JAX's at all.  Both normalise p
    before rounding it, so only a float32 sum that lands on a bf16
    rounding boundary parts them (4 of the encoder's 37,632 elements
    here); rounding p first, the order the kernels' chunked path had,
    keeps within the ulp rule but moves a third of the elements (12,261),
    so the count is what sees the order."""
    from boficap_tpu.ops import pallas_decoder_layer as pdl
    from boficap_tpu_torch.ops import decoder_layer as dl
    D, H, Bn = 64, 4, 3
    Lq = GRID if kind == "encoder" else L
    rs = np.random.RandomState(196)
    b16 = lambda *shape: torch.from_numpy(
        rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    n_q, kv = b16(Bn, Lq, D), b16(Bn, GRID, D)
    ws = [b16(D, D) * 0.2 for _ in range(3)]
    bs = [b16(D) * 0.1 for _ in range(3)]
    live = np.array([GRID, 150, 0])
    mask = np.broadcast_to(np.arange(GRID)[None, None, :]
                           < live[:, None, None], (Bn, Lq, GRID)).copy()
    q, k, v = (dl.linear_plain(a, w, b)
               for a, w, b in zip((n_q, kv, kv), ws, bs))
    got = dl.attention_plain(q, k, v, torch.from_numpy(mask), H)
    assert got.dtype == torch.bfloat16
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    eye = jnp.eye(D, dtype=jnp.bfloat16)
    want = np.stack([np.asarray(pdl._mha(
        j(n_q[i]), j(kv[i]), j(ws[0]), j(bs[0]), j(ws[1]), j(bs[1]),
        j(ws[2]), j(bs[2]), eye, jnp.asarray(mask[i]), Lq, GRID,
        jnp.bfloat16, H)) for i in range(Bn)])
    got = got.float().numpy()
    _bf16_ulp_agree(got, want)
    assert (got != want).mean() < 0.01, int((got != want).sum())
