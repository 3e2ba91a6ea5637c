"""ResNet-101 trunk of the raw-image path: the port of the JAX package's
``models/resnet.py``.

The reference extracts region-free CNN features with a modified
torchvision ResNet-101 (captioning/utils/resnet.py:6-12, wrapped by
captioning/utils/resnet_utils.py:10-26), and so does this trunk:

  * the stem's max pool is kernel 3, stride 2, padding 0, ``ceil_mode``
    (torchvision's stock trunk pads by 1 and floors);
  * stages 2-4 move the first block's stride from the 3x3 conv2 onto the
    1x1 conv1 (``Bottleneck(stride_on_conv1=True)``);
  * ``fc`` is the global mean of the layer4 map, [2048];
  * ``att`` is the layer4 map average-pooled to a 14 x 14 grid, [196, 2048],
    binned as torch's adaptive pool bins (bin i averages rows
    floor(i H / 14) .. ceil((i + 1) H / 14) - 1), as two small contractions
    with the JAX package's pooling matrices (``_adaptive_pool_matrix``).

Batch-norm is inference-only, folded as the JAX package folds it: ``x *
scale + (beta - mean * scale)``, ``scale = gamma / sqrt(var + 1e-5)``.
The modules' state-dict names are torchvision's (``conv1.weight``,
``layer3.0.downsample.1.running_var``, ...), so ``load_torch_resnet_state``
takes a torchvision ``resnet101`` state dict as it is; ``state_from_jax``
turns the JAX package's parameter tree (numpy, conv kernels HWIO) into
one (OIHW), so both packages compute the same function in the tests.
Without a state dict the trunk is random He-init from a seed
(``init_resnet``; an explicit ``torch.Generator``, so not the JAX
package's draws).

Layout: ``resnet_features`` takes and returns the JAX package's layout
(images [B, H, W, 3], ``att`` [B, 196, 2048]); inside, the trunk runs
channels-first (NCHW), PyTorch's convolution layout.

Precision: float32.  The convolutions are ``F.conv2d`` (cuDNN on the
card), as the JAX package leaves them to XLA outside any Pallas kernel.
On the card cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``); ``resnet_features`` turns that off
around its forward (``full_float32_convs``) and restores the caller's
setting after, so the features are float32 sums on every device and no
global flag changes for the decodes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# stage plan: (blocks, mid_channels); expansion 4 (ResNet-101 = 3,4,23,3)
RESNET101_LAYERS = (3, 4, 23, 3)
_STAGE_MID = (64, 128, 256, 512)
EXPANSION = 4


@contextlib.contextmanager
def full_float32_convs():
    """cuDNN's float32 convolutions in full float32 (no TF32) inside the
    block; the caller's setting is restored after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class FoldedBatchNorm(nn.Module):
    """Inference batch-norm over channels (dim 1), folded to one multiply
    and one add (torch BatchNorm2d.eval semantics, eps 1e-5); torchvision's
    state-dict names."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck; ``stride_on_conv1`` is the reference's
    stage-2..4 change (the stride moves from the 3x3 to the 1x1,
    resnet.py:10-12)."""

    def __init__(self, cin: int, mid: int, stride: int = 1,
                 stride_on_conv1: bool = False, downsample: bool = False):
        super().__init__()
        cout = mid * EXPANSION
        s1 = stride if stride_on_conv1 else 1
        s2 = 1 if stride_on_conv1 else stride
        self.conv1 = _conv(cin, mid, 1, s1)
        self.bn1 = FoldedBatchNorm(mid)
        self.conv2 = _conv(mid, mid, 3, s2, padding=1)
        self.bn2 = FoldedBatchNorm(mid)
        self.conv3 = _conv(mid, cout, 1)
        self.bn3 = FoldedBatchNorm(cout)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride),
                                         FoldedBatchNorm(cout))
                           if downsample else None)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + h)


class ResNetTrunk(nn.Module):
    """The stem (7x7/2 conv, BN, ReLU, ceil-mode 3x3/2 max pool) and four
    stages of bottlenecks: NCHW images -> the layer4 map [B, 2048, h, w]."""

    def __init__(self, layers: Sequence[int] = RESNET101_LAYERS):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = _conv(3, 64, 7, 2, padding=3)
        self.bn1 = FoldedBatchNorm(64)
        cin = 64
        for si, n_blocks in enumerate(self.layers):
            mid = _STAGE_MID[si]
            stride = 1 if si == 0 else 2
            blocks = [Bottleneck(cin, mid, stride, stride_on_conv1=si > 0,
                                 downsample=True)]
            cin = mid * EXPANSION
            blocks += [Bottleneck(cin, mid) for _ in range(n_blocks - 1)]
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        # max pool, padding 0, ceil_mode (reference resnet.py:9; JAX
        # _maxpool_ceil)
        x = F.max_pool2d(x, 3, 2, padding=0, ceil_mode=True)
        for si in range(len(self.layers)):
            x = getattr(self, f"layer{si + 1}")(x)
        return x


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] averaging weights reproducing torch
    adaptive_avg_pool1d binning: bin j spans floor(j*n/o) ..
    ceil((j+1)*n/o) - 1 inclusive."""
    m = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        a = (j * n_in) // n_out
        b = -(-((j + 1) * n_in) // n_out)
        m[a:b, j] = 1.0 / (b - a)
    return m


@torch.no_grad()
def resnet_features(trunk: ResNetTrunk, imgs: torch.Tensor,
                    att_size: int = 14) -> Tuple[torch.Tensor, torch.Tensor]:
    """imgs [B, H, W, 3] (ImageNet-normalized, float32, on the trunk's
    device) -> (fc [B, 2048], att [B, att_size*att_size, 2048]); the
    reference's myResnet.forward (resnet_utils.py:10-26) batched, in full
    float32."""
    with full_float32_convs():
        x = trunk(imgs.permute(0, 3, 1, 2))              # [B, C, h, w]
    fc = x.mean(dim=(2, 3))
    ph = torch.from_numpy(_adaptive_pool_matrix(x.shape[2], att_size))
    pw = torch.from_numpy(_adaptive_pool_matrix(x.shape[3], att_size))
    att = torch.einsum("bchw,hi,wj->bijc", x, ph.to(x.device),
                       pw.to(x.device))
    return fc, att.reshape(x.shape[0], att_size * att_size, -1)


# ---------------------------------------------------------------------------
# weights: seeded init, a torchvision state dict, the JAX package's tree
# ---------------------------------------------------------------------------

def init_resnet(layers: Sequence[int] = RESNET101_LAYERS, seed: int = 0,
                device=None) -> ResNetTrunk:
    """A random He-init trunk (normal, std sqrt(2 / fan_in) for every
    conv; BN the identity) drawn from ``torch.Generator().manual_seed(
    seed)`` on the CPU, then moved to ``device``."""
    trunk = ResNetTrunk(layers)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * math.sqrt(2.0 / fan_in))
    return trunk.to(device).eval()


def load_torch_resnet_state(sd: Mapping[str, Any],
                            layers: Sequence[int] = RESNET101_LAYERS,
                            device=None) -> ResNetTrunk:
    """torchvision ``resnet101().state_dict()`` (or the reference's
    ``resnet101.pth``) -> the trunk, on ``device``.  Takes tensors or
    ndarrays; ignores entries the trunk has no place for (the classifier
    ``fc.*``, BN's ``num_batches_tracked``); a missing entry or a shape
    that differs raises."""
    trunk = ResNetTrunk(layers)
    own = trunk.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} trunk entries, "
                       f"e.g. {missing[:3]}")
    state = {}
    for k, want in own.items():
        v = sd[k]
        v = (v.detach().float() if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v, np.float32)))
        if tuple(v.shape) != tuple(want.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, the trunk's "
                             f"{tuple(want.shape)}")
        state[k] = v
    trunk.load_state_dict(state)
    return trunk.to(device).eval()


def state_from_jax(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's ResNet parameter tree (``init_resnet_params`` /
    ``load_torch_resnet_state`` there: conv kernels HWIO, BN {gamma, beta,
    mean, var}, stages as lists of blocks), as numpy arrays -> a
    torchvision-layout state dict (conv kernels OIHW) for
    ``load_torch_resnet_state``."""
    def conv(w):
        return np.ascontiguousarray(np.asarray(w, np.float32)
                                    .transpose(3, 2, 0, 1))

    out: Dict[str, np.ndarray] = {}

    def bn(prefix, p):
        for name, key in (("weight", "gamma"), ("bias", "beta"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{prefix}.{name}"] = np.asarray(p[key], np.float32)

    out["conv1.weight"] = conv(tree["conv1"])
    bn("bn1", tree["bn1"])
    si = 1
    while f"layer{si}" in tree:
        for bi, bp in enumerate(tree[f"layer{si}"]):
            pre = f"layer{si}.{bi}"
            for j in (1, 2, 3):
                out[f"{pre}.conv{j}.weight"] = conv(bp[f"conv{j}"])
                bn(f"{pre}.bn{j}", bp[f"bn{j}"])
            if "downsample" in bp:
                out[f"{pre}.downsample.0.weight"] = conv(
                    bp["downsample"]["conv"])
                bn(f"{pre}.downsample.1", bp["downsample"]["bn"])
        si += 1
    return out


def normalize_images(imgs: np.ndarray) -> np.ndarray:
    """uint8/float [B, H, W, 3] in [0, 255] or [0, 1] -> ImageNet-normalized
    float32 (reference preprocess, dataloaderraw.py:16-19)."""
    arr = np.asarray(imgs)
    x = arr.astype(np.float32)
    # integer inputs are always 0-255 (dtype, not value, decides); the
    # value heuristic only disambiguates float inputs
    if np.issubdtype(arr.dtype, np.integer) or x.max() > 1.5:
        x = x / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD

