"""Device-mesh data and tensor parallelism: the port of the JAX package's
``parallel/mesh.py``.

JAX runs ONE program over a ``Mesh('data')`` (or 'data' x 'model') of
devices and lets XLA insert the collectives.  The PyTorch idiom is one
rank per device in a ``torch.distributed`` group: every rank runs the
same program on its shard.  ``Mesh`` lays the group's ranks out over named
axes, rank-major in C order (rank = data_index * model_size +
model_index), with one process group for each line of ranks along an axis
(an axis of every rank has the whole group, even a group of one; another
axis of size 1 has none, and its collectives are no-ops).

  * 'data': each rank takes its rows of the identical global batch
    (``shard_batch``); the training steps (``train/steps.py``) divide every
    token mean by the count over the axis and all-reduce the gradients;
  * 'model': Megatron tensor parallelism by the one rules table
    (``param_partition_specs``, JAX's rules read off the port's module
    paths through the weight bridge's ``flax_layout``), applied by
    ``shard_params`` (``parallel/tensor_parallel.py``).

The group comes from ``init_group``: ``gloo`` for CPU ranks, NCCL for CUDA
ranks (where NCCL is missing, it raises; no other backend is picked in
its place); ``backend`` names one explicitly (``gloo`` lets two ranks
share one card, which NCCL refuses, for a check of the collectives: gloo
copies CUDA tensors through the host, so such a run says nothing of the
speed of several GPUs).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .tensor_parallel import Slice, all_gather, split_sizes


def init_group(rank: int, world: int, init_method: str, device,
               backend: Optional[str] = None, timeout_s: float = 1800.0):
    """Join the ``world``-rank default process group as ``rank`` over
    ``init_method`` (``tcp://host:port``), bound to ``device`` (a CUDA
    rank's card is set current), then run one all-reduce: the first
    collective brings gloo's connections up while the ranks are still in
    step (the JAX trainer's warm-up psum, its tools/train.py:129-143).
    ``timeout_s`` bounds the rendezvous and every collective (ranks wait
    in one while rank 0 validates)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA group needs NCCL, which this torch "
                           "build lacks")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    warm = torch.zeros(1, device=device)
    dist.all_reduce(warm)
    return device


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _leave(ok: bool) -> None:
    """Leave the default group: after a barrier on success, so no rank
    tears its connections down under another still using them."""
    if dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()


def _spawned_rank(fn, rank, world, init_method, args):
    ok = False
    try:
        fn(rank, world, init_method, *args)
        ok = True
    finally:
        _leave(ok)


# seconds this process's rank has, after a spawned rank of ``launch``
# failed, to return or raise (a gloo collective raises at once on the
# closed connections; a NCCL one would wait out its timeout)
FAILED_RANK_GRACE_S = 60.0


def _watch(procs, first_rank: int, done: threading.Event) -> None:
    """While this process's rank runs: on a spawned rank's failure (a
    non-zero exit), kill the other spawned ranks; should this rank not
    return within ``FAILED_RANK_GRACE_S`` after that (a collective waiting
    on the dead rank), end the process."""
    while not done.wait(0.2):
        bad = [(first_rank + i + 1, p.exitcode) for i, p in enumerate(procs)
               if p.exitcode not in (None, 0)]
        if not bad:
            continue
        for p in procs:
            if p.is_alive():
                p.kill()
        if done.wait(FAILED_RANK_GRACE_S):
            return
        print(f"ranks {bad} (rank, exit code) failed and rank {first_rank} "
              f"did not return within {FAILED_RANK_GRACE_S:.0f} s: ending "
              f"the process", file=sys.stderr, flush=True)
        os._exit(1)


def launch(fn: Callable, n_local: int, *args, first_rank: int = 0,
           world: Optional[int] = None, init_method: Optional[str] = None,
           timeout_s: float = 900.0):
    """Run ``fn(rank, world, init_method, *args)`` as ranks ``first_rank``
    .. ``first_rank + n_local - 1`` of a ``world``-rank group (default
    ``n_local``) over ``init_method`` (default a free localhost port):
    the first in this process, the others in spawned processes, which are
    killed should this one's rank raise, and whose failure (a non-zero
    exit, or no exit within ``timeout_s``) raises here.  A spawned rank's
    failure while this one runs kills the others and bounds this one's
    wait (``_watch``).  ``fn`` joins the group (``init_group``); every
    rank leaves it after ``fn`` returns.  Returns this process's rank's
    value."""
    world = n_local if world is None else world
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank,
                         args=(fn, first_rank + i, world, init_method, args),
                         daemon=True)
             for i in range(1, n_local)]
    for p in procs:
        p.start()
    done = threading.Event()
    watcher = threading.Thread(target=_watch, args=(procs, first_rank, done),
                               daemon=True)
    watcher.start()
    ok = False
    try:
        out = fn(first_rank, world, init_method, *args)
        ok = True
    finally:
        done.set()
        watcher.join()
        _leave(ok)
        for p in procs:
            p.join(timeout_s if ok else 0)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(first_rank + i + 1, p.exitcode) for i, p in enumerate(procs)
           if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} (rank, exit code) failed")
    return out


class Mesh:
    """The default group's ranks laid out as ``shape`` over
    ``axis_names``; ``device`` is this rank's.  Every rank must build the
    same mesh, in the same order (each builds every axis's groups)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {tuple(shape)} needs "
                             f"{int(np.prod(shape))} ranks, the group has "
                             f"{world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = torch.device(device)
        grid = np.arange(world).reshape(tuple(shape))
        self.coord = dict(zip(self.axis_names,
                              (int(c) for c in np.argwhere(grid == rank)[0])))
        self._groups: Dict[str, Any] = {}
        for ax, name in enumerate(self.axis_names):
            if self.shape[name] == world:
                self._groups[name] = dist.group.WORLD
                continue
            if self.shape[name] == 1:
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, self.shape[name])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[name] = g

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None where
        the axis has one rank of several)."""
        return self._groups.get(axis)


def make_mesh(n_devices: Optional[int] = None, axis_names=("data",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """The mesh over the group's ranks (``init_group`` first): by default
    every rank on the first axis and 1 on the others, as JAX's
    ``make_mesh``; ``shape`` lays them out otherwise.  ``n_devices``, where
    given, must be the group's size; ``device`` defaults to the current
    card on CUDA ranks (``init_group`` sets it), else the CPU."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh wants {n_devices} devices; the group "
                         f"has {world} ranks, one a device")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(shape, axis_names, device)


def batch_sharding(mesh: Mesh):
    """(this rank's index on 'data', the axis's size): its rows of a
    batch are the index-th of that many equal parts."""
    return mesh.index("data"), mesh.size("data")


def _rows(n: int, mesh: Mesh) -> slice:
    i, k = batch_sharding(mesh)
    if n % k:
        raise ValueError(f"the 'data' axis of {k} ranks does not divide a "
                         f"batch of {n} rows")
    return slice(i * n // k, (i + 1) * n // k)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of the identical global batch: every array or
    tensor leaf split along its first dimension (PB_pad's caption rows
    too, which are image-major); other values (gts lists, infos, bounds)
    pass through whole."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
            out[k] = v[_rows(v.shape[0], mesh)]
        else:
            out[k] = v
    return out


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every 'data' rank's rows of ``x``, in rank order (the global
    batch's); no gradient."""
    group = mesh.group("data")
    if group is None:
        return x
    return torch.cat(all_gather(x, group))


def replicate_state(model, mesh: Mesh):
    """Every rank's parameters made the first rank's (one broadcast each
    over the whole group), so the replicas start equal whatever each rank
    initialised."""
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p.data, src=0)
    return model


def pad_batch_to(batch: Dict[str, Any], multiple: int):
    """Pad the image dimension to a multiple of ``multiple`` by wrapping
    rows round-robin (``v[-pad:]`` would under-pad whenever pad > b, e.g.
    b = 3 -> 8 needs 5 extra rows from a 3-row batch); non-array values
    pass through."""
    b = None
    for v in batch.values():
        if hasattr(v, "shape"):
            b = v.shape[0]
            break
    pad = (-b) % multiple
    if pad == 0:
        return batch
    idx = np.arange(pad) % b
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v[torch.as_tensor(idx)]])
        elif hasattr(v, "shape"):
            out[k] = np.concatenate([v, np.asarray(v)[idx]], axis=0)
        else:
            out[k] = v
    return out


def _spec(name: str, ndim: int):
    """JAX's rule (its parallel/mesh.py:101-116) on a flax path
    ``params/.../leaf``: the 'model' placement of each dimension of the
    flax leaf (kernels are [in, out])."""
    if ndim == 2:
        if any(f"/{k}/" in name or name.endswith(f"/{k}/kernel")
               for k in ("wq", "wk", "wv")):
            return (None, "model")
        if "/wo/" in name:
            return ("model", None)
        if "/ffn/Dense_0/" in name:
            return (None, "model")
        if "/ffn/Dense_1/" in name:
            return ("model", None)
        if "generator" in name and name.endswith("kernel"):
            return (None, "model")
        if "embedding" in name:
            return (None, None)
    return ()


def param_partition_specs(model) -> Dict[str, tuple]:
    """The tensor-parallel rules table: port parameter name -> the
    placement of each dimension of its flax leaf over 'model', the JAX
    package's ``param_partition_specs`` leaf for leaf:

      * attention wq / wk / wv and the FFN's Dense_0: (None, 'model'),
        column-parallel (output features);
      * attention wo and the FFN's Dense_1: ('model', None), row-parallel
        (input features);
      * the generator's kernel: (None, 'model'), vocabulary-sharded;
      * embeddings (None, None), everything else () : replicated.

    The biases of column-parallel layers are replicated in the table, as
    in JAX; ``shard_params`` slices them with their kernels (the layout
    the sliced product needs)."""
    from ..convert import flax_layout
    params = dict(model.named_parameters())
    return {n: _spec("/".join(("params",) + path), params[n].dim())
            for n, (path, _) in flax_layout(model).items()}


def shard_params(model, mesh: Mesh):
    """Apply ``param_partition_specs`` in place over the mesh's 'model'
    axis: each matched ``Dense`` keeps its rank's slice (column: weight
    rows and bias; row: weight columns) and takes its ``tp`` rule, and
    each attention its H / tp heads.  No 'model' axis, or one rank on it:
    everything stays replicated.  Build the optimizer after this call (the
    sliced weights are new parameters).  Heads or FFN widths the axis does
    not divide raise ``ValueError``; the generator's vocabulary may split
    unevenly."""
    from ..models.layers import Dense, Generator, MultiHeadAttention
    from ..models.layers import PositionwiseFFN
    tp = mesh.size("model")
    if tp == 1:
        return model
    group, index = mesh.group("model"), mesh.index("model")
    mods = dict(model.named_modules())
    for name, spec in param_partition_specs(model).items():
        if "model" not in spec:
            continue
        mod_name = name.rsplit(".", 1)[0]
        dense = mods[mod_name]
        parent = mods[mod_name.rsplit(".", 1)[0]] if "." in mod_name else model
        if not isinstance(dense, Dense) or not isinstance(
                parent, (MultiHeadAttention, PositionwiseFFN, Generator)):
            raise ValueError(f"{name}: the tensor-parallel rules match only "
                             f"attention, FFN and generator layers")
        if (isinstance(parent, MultiHeadAttention) and parent.tp_size == 1
                and parent.num_heads % tp):
            raise ValueError(f"{mod_name}: {parent.num_heads} heads over "
                             f"{tp} model ranks")
        column = spec == (None, "model")
        n = dense.weight.shape[0 if column else 1]
        if not isinstance(parent, Generator) and n % tp:
            raise ValueError(f"{name}: width {n} over {tp} model ranks")
        sizes = split_sizes(n, tp)
        lo = sum(sizes[:index])
        sl = slice(lo, lo + sizes[index])
        with torch.no_grad():
            w = dense.weight[sl] if column else dense.weight[:, sl]
            dense.weight = torch.nn.Parameter(w.clone())
            dense.weight.tp_group = group
            if column and dense.bias is not None:
                dense.bias = torch.nn.Parameter(dense.bias[sl].clone())
                dense.bias.tp_group = group
        dense.tp = Slice("column" if column else "row", group, index, sizes,
                         gather=isinstance(parent, Generator))
        if isinstance(parent, MultiHeadAttention) and parent.tp_size == 1:
            parent.num_heads //= tp
            parent.d_model //= tp
            parent.tp_size = tp
    if hasattr(model, "invalidate_packed"):
        model.invalidate_packed()
    return model


def gather_params(model) -> Dict[str, torch.Tensor]:
    """The whole parameters of a ``shard_params`` model, by name: each
    sliced weight (and column bias) all-gathered over 'model' in rank
    order, the rest as they are."""
    from ..models.layers import Dense
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            rule = mod.tp if isinstance(mod, Dense) else None
            if rule is None or (leaf == "bias" and rule.mode == "row"):
                out[name] = p.detach().clone()
                continue
            dim = 0 if rule.mode == "column" else 1
            x = p.detach().movedim(dim, -1) if p.dim() == 2 else p.detach()
            full = _gather_sizes(x, rule)
            out[name] = full.movedim(-1, dim) if p.dim() == 2 else full
    return out


def _gather_sizes(x, rule) -> torch.Tensor:
    width = max(rule.sizes)
    if x.shape[-1] < width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    parts = all_gather(x, rule.group)
    return torch.cat([p[..., :n] for p, n in zip(parts, rule.sizes)], -1)


def all_reduce_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``tensors`` summed over ``group`` through one flat buffer per dtype
    (new tensors; ``group`` None returns them as they are)."""
    if group is None or not tensors:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out
