"""Entry points of the port for a harness (the JAX package's
``__graft_entry__.py``):

``entry(device=None)``  -> (fn, example_args): the teacher-forced UIC
                           loss of the tiny ``_tiny_cfg`` model on its
                           first synthetic train batch.
``dryrun_multichip(n)`` -> one full XE training step (gradients and the
                           update) over an n-rank (data x model) mesh,
                           then a data-sharded, tensor-parallel NA decode
                           held token for token to the single-device
                           decode on the gathered parameters.

Both run on ``cuda`` unless the caller names the CPU.  On the CPU
``dryrun_multichip`` spawns n gloo ranks; on the card each rank takes a
GPU of its own over NCCL.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from .config import make_config
from .convert import fill_random, flax_layout
from .data.dataset import CaptionData
from .decode import bound_fill as bf
from .device import resolve_device
from .losses import uic_loss
from .models.boficap import build_model
from .parallel.mesh import (gather_params, gather_rows, init_group, launch,
                            make_mesh, shard_batch, shard_params)
from .train import optim as optim_mod
from .train import steps as steps_mod


def _tiny_cfg(n_devices: int = 1):
    """JAX ``_tiny_cfg``: UIC, d 64, 2 + 2 layers, 4 heads, float32."""
    return make_config(train_mode="UIC", input_json="synthetic",
                       input_att_dir="synthetic",
                       batch_size=max(2 * n_devices, 2), max_boxes=12,
                       N_enc=2, N_dec=2, N_len=1, d_model=64, d_ff=128,
                       num_att_heads=4, noamopt=True, id="graft",
                       dtype="float32")


def _setup(cfg, device):
    """(loader, model seeded from 0, its first train batch)."""
    data = CaptionData(cfg)
    model = fill_random(build_model(cfg, data.vocab_size, device), 0)
    return data, model, data.get_batch("train")


def entry(device=None):
    """The teacher-forced UIC loss (``fn(model, att_feats, att_masks,
    labels, phrase_num, phrase_length, phrase_syn) -> loss``) and its
    example arguments, on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    cfg = _tiny_cfg()
    _, model, batch = _setup(cfg, device)
    tb = steps_mod.to_device(batch, device)
    f = steps_mod._flat(tb)

    @torch.no_grad()
    def fn(model, att_feats, att_masks, labels, phrase_num, phrase_length,
           phrase_syn):
        out = model(att_feats, att_masks, labels, phrase_num, phrase_length,
                    phrase_syn, glat_p=None)
        return uic_loss(out["sa_len_logprob"], out["sa_syn_logprob"],
                        out["sa_logprob"], out["na_len_logprob"],
                        out["na_syn_logprob"], out["na_logprob"],
                        phrase_num, phrase_length, phrase_syn,
                        labels)["loss"]

    return fn, (model, tb["att_feats"], tb["att_masks"], f["labels"],
                f["phrase_num"], f["phrase_length"], f["phrase_syn"])


def _dryrun_rank(rank, world, init_method, device_type, threads):
    if device_type == "cuda":
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(threads)
    init_group(rank, world, init_method, device, timeout_s=300)
    tp = 2 if world % 2 == 0 and world >= 4 else 1
    dp = world // tp
    mesh = make_mesh(axis_names=("data", "model"), shape=(dp, tp),
                     device=device)
    cfg = _tiny_cfg(dp)
    _, model, batch = _setup(cfg, device)
    single = copy.deepcopy(model)
    shard_params(model, mesh)
    layout = flax_layout(model)
    opt = optim_mod.Optimizer(optim_mod.build_optimizer(cfg, layout), model,
                              layout)
    step = steps_mod.make_xe_step(model, opt, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(rank)
    tb = steps_mod.to_device(batch, device)
    loss = float(step(tb, gen, None)["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"dryrun step loss {loss}")

    def decode(m, att, am):
        mem = m.encode(att, am)
        return bf.na_decode(m, mem, am.bool(), max_steps=4)["seq"]

    with torch.no_grad():
        local = shard_batch(tb, mesh)
        seq = gather_rows(decode(model, local["att_feats"],
                                 local["att_masks"]), mesh)
        single.load_state_dict(gather_params(model))
        want = decode(single, tb["att_feats"], tb["att_masks"])
    if not torch.equal(seq, want):
        raise RuntimeError("the tensor-parallel NA decode differs from the "
                           "single-device decode on the gathered params")
    return {"dp": dp, "tp": tp, "loss": loss,
            "seq_shape": tuple(seq.shape)} if rank == 0 else None


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, Any]:
    """One XE step (grad + update) on a dp x tp mesh of ``n_devices``
    ranks (tp = 2 where n is even and at least 4, the batch over 'data',
    the Megatron rules over 'model'), then the data-sharded,
    tensor-parallel NA decode, token-identical to the single-device decode
    on the gathered parameters (else ``RuntimeError``).  ``device``:
    ``cuda`` (default; rank r on GPU r, over NCCL, which takes one GPU a
    rank: ``ValueError`` past the count) or ``cpu`` (gloo).  Returns rank
    0's {dp, tp, loss, seq_shape} and prints it."""
    dev = resolve_device(device)
    n_gpu = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and n_devices > n_gpu:
        raise ValueError(f"NCCL takes one GPU a rank: {n_devices} ranks, "
                         f"{n_gpu} GPUs")
    threads = max(1, torch.get_num_threads() // n_devices)
    out = launch(_dryrun_rank, n_devices, dev.type, threads)
    print(f"dryrun_multichip({n_devices}): dp={out['dp']} tp={out['tp']} "
          f"loss={out['loss']:.4f} decode_seq={out['seq_shape']} "
          f"tp-sharded decode token-identical to single-device")
    return out


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)))
    dryrun_multichip(max(torch.cuda.device_count(), 1))
