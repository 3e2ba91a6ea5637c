"""Eval on a folder of images: the port of the JAX package's
``data/raw.py`` (the reference's DataLoaderRaw,
captioning/data/dataloaderraw.py:24-146).  Images are read from a
directory and turned into (fc, att) features on the fly.

The reference runs a modified torchvision ResNet-101.  No pretrained CNN
weights ship with the repository, so the extractor is pluggable, as in
the JAX package:

  * ``trunk_extractor``: the port's ResNet-101 trunk (models/resnet.py),
    the reference's modified architecture, in full float32.  It loads a
    torchvision ``resnet101`` state dict from ``$BOFICAP_CNN_WEIGHTS`` (or
    the ``weights`` argument) when one is named, random He-init from a seed
    otherwise (warned: untrained features).  Each image is resized
    bilinearly to 448 x 448 (the layer4 map is then 14 x 14), normalized
    and run through the trunk, all on the loader's device;
  * ``resnet_extractor``: torchvision's ResNet when it is installed and
    its ImageNet weights are already in the local torch hub cache (the
    extractor never downloads), with the reference's output contract
    (fc = pooled features, att = the 14 x 14 grid);
  * ``patch_extractor``: 14 x 14 mean and std RGB patches tiled to 2048
    dims.  Not a trained feature extractor: it keeps the pipeline runnable
    where no trunk runs (the CPU), and its captions are only as good as the
    captioner's robustness to untrained features;
  * any callable ``image [H, W, 3] float -> (fc [D], att [G, G, D])``.

Without an extractor ``DataLoaderRaw`` takes the trunk when
``$BOFICAP_CNN_WEIGHTS`` is set, else torchvision where it loads, else
the trunk on a CUDA device and the patch extractor on the CPU (the JAX
package's choice on an accelerator and on a CPU host), and prints which.

Images are read with PIL where it imports, as the JAX package reads them;
without PIL, binary PPM (P6, maxval 255) is read with numpy
(``read_ppm``) and any other file raises.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def patch_extractor(grid: int = 14, dim: int = 2048):
    """Mean-RGB patch features (see the module docstring's caveat)."""

    def extract(img: np.ndarray):
        H, W, _ = img.shape
        gh, gw = H // grid, W // grid
        att = np.zeros((grid, grid, dim), np.float32)
        for i in range(grid):
            for j in range(grid):
                patch = img[i * gh:(i + 1) * gh, j * gw:(j + 1) * gw]
                m = patch.reshape(-1, 3).mean(0)
                s = patch.reshape(-1, 3).std(0)
                feat = np.concatenate([m, s])
                att[i, j] = np.tile(feat, dim // len(feat) + 1)[:dim]
        return att.mean((0, 1)), att

    return extract


def resize_image(img: torch.Tensor, size: int) -> torch.Tensor:
    """img [H, W, 3] float -> [size, size, 3]: the JAX package's
    ``jax.image.resize(img, (size, size, 3), "bilinear")``.  That resize
    is a triangle filter on half-pixel centres, widened by the scale when
    it shrinks an axis (antialiasing), its weights renormalised where it
    runs past the edge; torch's bilinear with ``antialias=True`` is the
    same filter (tests/test_torch_port_raw.py holds the two within 1e-5)."""
    x = img.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0)


def trunk_extractor(weights: Optional[str] = None, size: int = 448,
                    device=None, seed: int = 0):
    """ResNet-101 features (models/resnet.py) on ``device`` (None: the
    card).  ``weights``: a torch ``resnet101`` state-dict .pth (defaults to
    $BOFICAP_CNN_WEIGHTS), read with ``weights_only``; without one the
    trunk is random He-init from ``seed`` (untrained features, warned).
    Each image is resized to ``size`` x ``size`` (at 448 the layer4 map is
    14 x 14, so the att pool is exact), normalized and run through the
    trunk on the device; fc [2048] and att [14, 14, 2048] come back as
    float32 numpy, as the JAX package's extractor returns them."""
    from ..models.resnet import (IMAGENET_MEAN, IMAGENET_STD, init_resnet,
                                 load_torch_resnet_state, resnet_features)

    device = resolve_device(device)
    weights = weights or os.environ.get("BOFICAP_CNN_WEIGHTS", "")
    if weights:
        try:
            sd = torch.load(weights, map_location="cpu", weights_only=True)
            trunk = load_torch_resnet_state(sd, device=device)
        except (OSError, RuntimeError, KeyError, ValueError,
                pickle.UnpicklingError) as e:
            raise RuntimeError(
                f"BOFICAP_CNN_WEIGHTS={weights!r} could not be loaded as a "
                f"torchvision resnet101 state dict: {e}") from e
    else:
        print("ResNet-101 extractor: no $BOFICAP_CNN_WEIGHTS state dict - "
              "using RANDOM weights (untrained features)")
        trunk = init_resnet(seed=seed, device=device)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)

    @torch.no_grad()
    def extract(img: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = resize_image(x.to(device), size)
        fc, att = resnet_features(trunk, ((x - mean) / std)[None])
        return (fc[0].cpu().numpy(),
                att[0].reshape(14, 14, -1).cpu().numpy())

    return extract


def resnet_extractor(cnn_model: str = "resnet101", device=None):
    """torchvision's ResNet with the reference's myResnet contract
    (resnet_utils.py:10-26: fc = global pool, att = 14 x 14 adaptive
    grid), at the image's own size, on ``device`` (None: the card).
    ``cnn_model``: resnet101 (default) or resnet152, the reference's
    --cnn_model (tools/eval.py:28-29).  Its ImageNet weights must already
    be in the torch hub cache: the extractor raises FileNotFoundError
    rather than download them.  Its convolutions run in full float32
    (``full_float32_convs``: cuDNN's TF32 off around the forward, the
    caller's setting restored), as the trunk's do and as the JAX package
    runs this extractor on the CPU."""
    import torchvision

    from ..models.resnet import full_float32_convs

    device = resolve_device(device)
    url = torchvision.models.get_model_weights(cnn_model).IMAGENET1K_V1.url
    path = os.path.join(torch.hub.get_dir(), "checkpoints",
                        os.path.basename(url))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"torchvision {cnn_model} weights are not in "
                                f"the torch hub cache ({path})")
    cnn = getattr(torchvision.models, cnn_model)(weights=None)
    cnn.load_state_dict(torch.load(path, map_location="cpu",
                                   weights_only=True))
    cnn = cnn.to(device).eval()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    @torch.no_grad()
    def extract(img: np.ndarray):
        x = torch.from_numpy(((img - mean) / std).transpose(2, 0, 1))[None]
        with full_float32_convs():
            x = cnn.maxpool(cnn.relu(cnn.bn1(cnn.conv1(x.to(device)))))
            x = cnn.layer4(cnn.layer3(cnn.layer2(cnn.layer1(x))))
        fc = x.mean((2, 3))[0].cpu().numpy()
        att = F.adaptive_avg_pool2d(x, (14, 14))
        return fc, att[0].permute(1, 2, 0).cpu().numpy()

    return extract


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255) -> uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":              # a comment, to line end
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, width, height, maxval = fields
    if magic != b"P6" or int(maxval) != 255:
        raise ValueError(f"{path}: only binary PPM (P6) with maxval 255 is "
                         f"read without PIL, got {magic!r} maxval "
                         f"{maxval.decode()}")
    w, h = int(width), int(height)
    pixels = np.frombuffer(data, np.uint8, 3 * w * h, pos + 1)
    return pixels.reshape(h, w, 3)


def read_image(path: str) -> np.ndarray:
    """An image file -> uint8 RGB [H, W, 3]: PIL where it imports (the JAX
    package's ``Image.open(path).convert("RGB")``), else ``read_ppm`` for a
    .ppm; any other file raises without PIL."""
    try:
        from PIL import Image
    except ImportError:
        if path.lower().endswith(".ppm"):
            return read_ppm(path)
        raise ValueError(f"{path}: reading this image needs PIL (Pillow), "
                         f"which is not installed; without it only binary "
                         f"PPM (.ppm) is read") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class DataLoaderRaw:
    """get_batch over a folder of images (reference dataloaderraw.py).
    ``device``: where the chosen extractor runs (None: the card); only read
    when ``extractor`` is None."""

    def __init__(self, image_folder: str, batch_size: int = 10,
                 extractor: Optional[Callable] = None, coco_json: str = "",
                 cnn_model: str = "resnet101", device=None):
        if cnn_model not in ("resnet101", "resnet152"):
            # validated before the choice below, which would otherwise take
            # another extractor for a mistyped model name
            raise ValueError(
                f"cnn_model must be resnet101 or resnet152 (reference "
                f"tools/eval.py:28-29), got {cnn_model!r}")
        self.folder = image_folder
        self.batch_size = batch_size
        if extractor is None:
            device = resolve_device(device)
            if os.environ.get("BOFICAP_CNN_WEIGHTS"):
                # named explicitly: its load errors surface
                name, extractor = "ResNet-101 trunk", trunk_extractor(
                    device=device)
            else:
                try:
                    extractor = resnet_extractor(cnn_model, device)
                    name = f"torchvision {cnn_model}"
                except (ImportError, FileNotFoundError):
                    if device.type != "cpu":
                        name, extractor = "ResNet-101 trunk", trunk_extractor(
                            device=device)
                    else:
                        # a random-weight ResNet-101 per image on the CPU is
                        # slow for equally untrained features
                        name, extractor = "patch", patch_extractor()
            print(f"DataLoaderRaw: the {name} extractor on {device}"
                  + (" (features are NOT CNN features)" if name == "patch"
                     else ""))
        self.extract = extractor

        if coco_json:
            with open(coco_json) as f:
                info = json.load(f)
            self.files = [img["file_name"] for img in info["images"]]
            self.ids = [img["id"] for img in info["images"]]
        else:
            self.files = sorted(
                f for f in os.listdir(image_folder)
                if f.lower().endswith(IMAGE_EXTS))
            self.ids = list(range(len(self.files)))
        self.cursor = 0

    def __len__(self):
        return len(self.files)

    def reset_iterator(self, split: str = ""):
        self.cursor = 0

    def get_batch(self, split: str = "") -> dict:
        B = self.batch_size
        fc = []
        att = []
        infos = []
        wrapped = False
        for _ in range(B):
            if self.cursor >= len(self.files):
                self.cursor = 0
                wrapped = True
            fname = self.files[self.cursor]
            img = read_image(os.path.join(self.folder, fname)).astype(
                np.float32) / 255.0
            f, a = self.extract(img)
            fc.append(f)
            att.append(a.reshape(-1, a.shape[-1]))
            infos.append({"id": self.ids[self.cursor], "file_path": fname})
            self.cursor += 1
        R = max(x.shape[0] for x in att)
        D = att[0].shape[1]
        att_b = np.zeros((B, R, D), np.float32)
        am = np.zeros((B, R), np.float32)
        for i, a in enumerate(att):
            att_b[i, :a.shape[0]] = a
            am[i, :a.shape[0]] = 1
        return {"fc_feats": np.stack(fc), "att_feats": att_b,
                "att_masks": am, "labels": None, "masks": None,
                "gts": [[] for _ in range(B)], "infos": infos,
                "bounds": {"it_pos_now": self.cursor,
                           "it_max": len(self.files), "wrapped": wrapped}}
