"""Megatron tensor parallelism of one ``Dense`` layer over the mesh's
'model' axis (the port of what XLA inserts for the JAX package's
``param_partition_specs``, its parallel/mesh.py:83-116).

``shard_params`` (``parallel/mesh.py``) keeps on each rank its slice of a
matched layer's weight and sets the layer's ``tp`` to a ``Slice``, whose
``forward`` replaces the layer's:

  * column-parallel (wq, wk, wv, ffn Dense_0; the generator): the rank's
    output features, weight rows and bias; the input enters through
    ``copy_to_model`` (Megatron's f: identity, the gradient all-reduced);
    the generator's vocabulary slices are gathered before the caller's
    ``log_softmax`` (``gather_last_dim``: all-gather, the gradient sliced);
  * row-parallel (wo, ffn Dense_1): the rank's input features; the partial
    products, summed in float32, are all-reduced (Megatron's g:
    ``reduce_from_model``, the gradient passed through), rounded to the
    compute dtype, and the whole bias added once.

With f and g in place every activation outside a parallel region, and its
gradient, is the same on every rank of the axis, so a replicated
parameter's gradient is whole on each rank and a sliced one's is its
slice's.  The kernels' weight packs refuse a sliced layer
(``ops.decoder_layer._kernel_of``): tensor parallelism runs the plain
path, as the JAX package's does.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` in the group's rank order (``dist.all_gather``;
    a CUDA tensor in a gloo group goes through the host, where gloo
    gathers)."""
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    y = x.detach().cpu() if via_host else x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return [p.to(x.device) for p in parts] if via_host else parts


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, gradient all-reduced over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastDim(torch.autograd.Function):
    """Every rank's slice of the last dimension, in rank order (slices of
    unequal widths padded to the widest for the all-gather); the gradient
    is the rank's own slice of it."""

    @staticmethod
    def forward(ctx, x, group, sizes, index):
        ctx.off = sum(sizes[:index])
        ctx.n = sizes[index]
        width = max(sizes)
        if x.shape[-1] < width:
            x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
        parts = all_gather(x, group)
        return torch.cat([p[..., :n] for p, n in zip(parts, sizes)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.off:ctx.off + ctx.n], None, None, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_last_dim(x, group, sizes: List[int], index: int):
    return _GatherLastDim.apply(x, group, sizes, index)


def split_sizes(n: int, parts: int) -> List[int]:
    """``torch.tensor_split``'s widths of ``n`` features over ``parts``."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


class Slice:
    """A ``Dense``'s tensor-parallel rule: ``mode`` 'column' or 'row',
    ``group`` the 'model' axis's process group, ``index`` the rank's place
    on it, ``sizes`` every rank's width of the sliced dimension, ``gather``
    the column outputs all-gathered (the generator)."""

    def __init__(self, mode: str, group, index: int, sizes: List[int],
                 gather: bool = False):
        self.mode, self.group, self.index = mode, group, index
        self.sizes, self.gather = sizes, gather

    def forward(self, dense, x):
        dt = dense.compute_dtype
        w = dense.weight.to(dt)
        if self.mode == "column":
            x = copy_to_model(x, self.group)
            y = torch.matmul(x.to(dt), w.t())
            if dense.bias is not None:
                y = y + dense.bias.to(dt)
            if self.gather:
                y = gather_last_dim(y, self.group, self.sizes, self.index)
            return y
        part = torch.matmul(x.to(dt).float(), w.float().t())
        y = reduce_from_model(part, self.group).to(dt)
        return y if dense.bias is None else y + dense.bias.to(dt)
