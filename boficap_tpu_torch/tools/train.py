"""Training CLI of the port: the JAX package's ``tools/train.py``, with the
same flags and files, on the card:

    python -m boficap_tpu_torch.tools.train --cfg configs/uic_sd.yml \\
        --id uic_sd                      # on cuda
    python -m boficap_tpu_torch.tools.train \\
        --cfg configs/synthetic_smoke.yml --id smoke --device cpu  # CPU

State machine of reference tools/train.py:29-374: seeded init
(``convert.fill_random``), infos / histories resume with the loader's
position (``--start_from``), the encoder warm start (``--init_from``), the
per-epoch schedules (lr decay or noam, scheduled sampling, glancing,
drop-worst, and the RL stage's ``self_critical_after`` /
``structure_after``), linear warm-up, the iteration log and
``metrics.jsonl``, periodic validation through ``eval_split`` (its
decoders on the card's kernels, on the weights just written; the modes by
train_mode), the best score (CIDEr, else -loss), ``reduce_on_plateau``,
and ``model.ckpt``, ``model_best.ckpt``, ``optimizer.ckpt``,
``infos_<id>.pkl`` and ``histories_<id>.pkl`` in the JAX package's
formats, so either package resumes or evaluates the other's run.

The RL stage (JAX tools/train.py:253-362): from the epoch
``structure_after`` the structure-loss step (``train/steps.py``
``make_rl_step``: sampled decodes on the kernels, CIDEr-D on the host by
the native scorer, the re-score and update), from ``self_critical_after``
classic SCST (AIC and auto only: a phrase train_mode keeps XE and says so,
as the JAX package does); the scorer is initialised from
``cached_tokens`` on the first RL epoch, and the step is rebuilt when the
stage moves from SCST to the structure loss.  The RL metrics (``reward``,
``<branch>_struc_loss``, ``lm_loss``, ``rl_kl``) go to ``metrics.jsonl``.

The first batch: the JAX trainer draws one train batch to initialise the
model (its tools/train.py:182) before it restores the loader
(:210), and a fresh loader's ``load_state_dict(None)`` keeps that draw, so
a fresh JAX run trains first on batch 2.  The port draws and drops one
batch at the same point, so its loader positions and epoch wraps (which
the RL stage keys off) are the JAX package's; on a resume the saved
position wins.  The original PyTorch reference trains first on batch 1;
the port follows the JAX package, the reference it is held against.

Not ported (``NotImplementedError`` at parse time, naming the ROADMAP
item, section 1): the mesh and multihost (item 11) and
``--profile_steps`` (item 4's leftover).  NNAIC (``--cfg
configs/nnaic.yml``) and PB_pad (``--cfg configs/pb.yml``: the batches
carry the packed layouts, the validation decodes ``decode/pb.py``) train
and validate as the other train modes do.  PB_pad has no RL sampler, as
in the JAX package: its RL epochs sample no branch.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from collections import defaultdict

import numpy as np
import torch

from ..config import parse_opt
from ..convert import fill_random, flax_layout, to_jax_tree
from ..data.dataset import CaptionData
from ..device import resolve_device
from ..eval.eval_utils import eval_split
from ..models import setup as models_setup
from ..rewards import init_scorer
from ..train import optim as optim_mod
from ..train import steps as steps_mod
from ..train.state import (encoder_only_init, load_histories, load_infos,
                           load_params, resume_state, save_checkpoint)


def log_metrics(path: str, record) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({k: float(v) if isinstance(
            v, (int, float, np.floating, torch.Tensor)) else v
            for k, v in record.items()}) + "\n")


def val_modes(train_mode: str):
    """The inference modes a validation runs (JAX tools/train.py:406-412)."""
    if train_mode in ("AIC", "auto", "NAIC", "SAIC", "NNAIC", "PB_pad"):
        return [""]
    if train_mode in ("UIC_s", "UIC_u"):
        return ["AIC", "SAIC", "NAIC"]
    return ["SAIC", "NAIC"]


def train(opt):
    device = resolve_device(opt.get("device") or None)
    np.random.seed(opt.seed)
    # the dropout / glancing stream, on the model's device
    gen = torch.Generator(device=device).manual_seed(int(opt.seed))

    loader = CaptionData(opt)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length

    infos = {"iter": 0, "epoch": 0, "loader_state_dict": None,
             "vocab": loader.ix_to_word, "opt": dict(opt)}
    histories = defaultdict(dict)
    if opt.get("start_from") is not None and os.path.isfile(
            os.path.join(opt.start_from, f"infos_{opt.id}.pkl")):
        infos = load_infos(opt.start_from, opt.id)
        saved = infos.get("opt", {})
        for check in ("caption_model", "rnn_size", "num_layers"):
            if saved.get(check) != opt.get(check):
                raise ValueError(f"command line argument and saved model "
                                 f"disagree on {check}")
        histories.update(load_histories(opt.start_from, opt.id))
    infos["vocab"] = loader.ix_to_word

    model = fill_random(models_setup(opt, loader.vocab_size, device),
                        opt.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {model.train_mode}, params: {n_params / 1e6:.1f}M, "
          f"device: {device}")
    if opt.get("init_from"):
        encoder_only_init(model, load_params(opt.init_from))
        print(f"warm-started encoder from {opt.init_from}")

    layout = flax_layout(model)
    optimizer = optim_mod.Optimizer(optim_mod.build_optimizer(opt, layout),
                                    model, layout)
    resume_state(opt, model, optimizer)

    iteration = infos["iter"]
    epoch = infos["epoch"]
    # JAX's order: one train batch drawn before the loader is restored (see
    # the module docstring); a saved position replaces it
    loader.get_batch("train")
    loader.load_state_dict(infos.get("loader_state_dict"))
    best_val_score = (infos.get("best_val_score") if opt.load_best_score
                      else None)
    plateau = optim_mod.PlateauTracker(opt.reduce_on_plateau_factor,
                                       opt.reduce_on_plateau_patience)
    if infos.get("plateau"):
        plateau.load_state_dict(infos["plateau"])

    xe_step = steps_mod.make_xe_step(
        model, optimizer, label_smoothing=opt.label_smoothing,
        debug_checks=bool(opt.get("debug_checks", False)),
        grad_accum=int(opt.get("grad_accum", 1) or 1))
    rl_sample = rl_step = None
    rl_step_kind = None          # "scst" | "struc"; rebuilt on change
    warned_sc_ignored = False
    os.makedirs(opt.checkpoint_path, exist_ok=True)
    metrics_log = os.path.join(opt.checkpoint_path, "metrics.jsonl")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save(append=""):
        save_checkpoint(opt, to_jax_tree(model), infos, append=append,
                        optimizer=optimizer.state_tree(),
                        histories=dict(histories))

    def update_infos():
        infos.update(iter=iteration, epoch=epoch,
                     loader_state_dict=loader.state_dict(),
                     best_val_score=best_val_score,
                     plateau=plateau.state_dict(),
                     opt=dict(opt))

    def rl_batch(data):
        """One RL step on a loader batch: sample on the card, score on the
        host, update."""
        tb = steps_mod.to_device(data, device)
        att, am = tb["att_feats"], tb["att_masks"]
        samples = rl_sample(att, am, gen)
        classic = sc_flag and not struc_flag
        scores = steps_mod.rl_host_scores(samples, data["gts"], opt,
                                          classic_scst=classic)
        scores = {k: torch.as_tensor(v, device=device)
                  for k, v in scores.items()}
        if classic:
            return rl_step(att, am, samples, scores["scst_reward"])
        gt = None
        if opt.get("structure_loss_weight", 1.0) < 1.0:
            # the (1-w)*lm_loss XE term needs the gt batch (reference
            # loss_wrapper.py:169/220-222)
            gt = {k: tb[k] for k in steps_mod.LABEL_KEYS if k in tb}
        return rl_step(att, am, samples, scores, gt=gt, rng=gen)

    epoch_done = True
    sc_flag = struc_flag = drop_worst_flag = False
    glat_p, ss_prob = -1.0, 0.0
    try:
        while True:
            if opt.max_epochs != -1 and epoch >= opt.max_epochs:
                break
            if epoch_done:
                if not opt.noamopt and not opt.reduce_on_plateau:
                    optimizer.set_lr(optim_mod.epoch_lr(opt, epoch))
                glat_p = optim_mod.glat_rate(opt, epoch)
                ss_prob = optim_mod.scheduled_sampling_prob(opt, epoch)
                sc_flag = (opt.self_critical_after != -1
                           and epoch >= opt.self_critical_after)
                struc_flag = (opt.structure_after != -1
                              and epoch >= opt.structure_after)
                drop_worst_flag = (opt.drop_worst_after != -1
                                   and epoch >= opt.drop_worst_after)
                if (sc_flag and not struc_flag
                        and model.train_mode not in ("AIC", "auto")):
                    # the reference implements classic SCST only in its AIC
                    # branch; every phrase train_mode ignores the flag and
                    # keeps XE (loss_wrapper.py:40-82 against :83+)
                    if not warned_sc_ignored:
                        print(f"WARNING: self_critical_after set but "
                              f"train_mode={model.train_mode} has no classic "
                              f"SCST path (the reference implements sc_flag "
                              f"only for AIC); continuing with XE: use "
                              f"structure_after for the RL stage")
                        warned_sc_ignored = True
                    sc_flag = False
                if sc_flag or struc_flag:
                    # built on the first RL epoch, the step rebuilt when
                    # the schedule moves from classic SCST into the
                    # structure stage (self_critical_after < structure_after)
                    needed = "struc" if struc_flag else "scst"
                    if rl_sample is None:
                        init_scorer(opt.cached_tokens)
                        rl_sample = steps_mod.make_rl_sample(
                            model, sample_method=opt.train_sample_method,
                            temperature=opt.temperature,
                            sample_n=opt.train_sample_n)
                    if rl_step_kind != needed:
                        make = (steps_mod.make_rl_step if needed == "struc"
                                else steps_mod.make_scst_step)
                        rl_step = make(model, optimizer, opt)
                        rl_step_kind = needed
                epoch_done = False
            if (opt.use_warmup and iteration < opt.noamopt_warmup
                    and not opt.noamopt):
                optimizer.set_lr(opt.learning_rate * (iteration + 1)
                                 / opt.noamopt_warmup)

            t_read = time.time()
            data = loader.get_batch("train")
            read_time = time.time() - t_read

            t_step = time.time()
            if sc_flag or struc_flag:
                metrics = rl_batch(data)
            else:
                metrics = steps_mod.run_xe_step(
                    xe_step, data, gen, glat_p=glat_p,
                    drop_worst=(opt.drop_worst_rate if drop_worst_flag
                                else 0.0),
                    ss_prob=ss_prob, device=device)
            sync()
            step_time = time.time() - t_step

            iteration += 1
            if data["bounds"]["wrapped"]:
                epoch += 1
                epoch_done = True

            if iteration % opt.losses_log_every == 0:
                rec = {"iter": iteration, "epoch": epoch,
                       "read_s": read_time, "step_s": step_time}
                rec.update({k: float(v) for k, v in metrics.items()})
                log_metrics(metrics_log, rec)
                histories["loss_history"][iteration] = rec["loss"]
                print(f"iter {iteration} (epoch {epoch}) loss "
                      f"{rec['loss']:.4f} step {step_time:.3f}s read "
                      f"{read_time:.3f}s", flush=True)

            # periodic validation + checkpoint (train.py:297-363)
            if ((iteration % opt.save_checkpoint_every == 0
                 and not opt.save_every_epoch)
                    or (epoch_done and opt.save_every_epoch)):
                eval_kwargs = {"split": "val",
                               "num_images": opt.val_images_use,
                               "language_eval": opt.language_eval,
                               "train_mode": opt.train_mode, "id": opt.id,
                               "verbose": False,
                               "use_cuda_fill": opt.get("use_cuda_fill",
                                                        "auto")}
                results = {}
                for im in val_modes(opt.train_mode):
                    results[im or opt.train_mode] = eval_split(
                        model, loader, eval_kwargs, inference_mode=im)
                primary = list(results.values())[-1]
                if opt.language_eval and primary["lang_stats"]:
                    current_score = primary["lang_stats"]["CIDEr"]
                else:
                    current_score = -primary["loss"]
                if opt.reduce_on_plateau:
                    optimizer.set_lr(opt.learning_rate
                                     * plateau.update(current_score))
                for name, r in results.items():
                    print(f"val[{name}]: loss {r['loss']:.4f} images/s "
                          f"{r['images_per_s']:.2f} lang {r['lang_stats']}",
                          flush=True)
                histories["val_result_history"][iteration] = {
                    k: (r["lang_stats"], r["images_per_s"])
                    for k, r in results.items()}
                # decide the new best before the periodic save (the
                # reference updates best_val_score first, train.py:343-357)
                is_best = (best_val_score is None
                           or current_score > best_val_score)
                if is_best:
                    best_val_score = current_score
                update_infos()
                save()
                if opt.save_history_ckpt:
                    save(str(iteration))
                if is_best:
                    save("best")
                    print(f"new best val score {best_val_score:.4f}",
                          flush=True)
    except (RuntimeError, KeyboardInterrupt):
        # crash-save (train.py:365-370)
        print("Save ckpt on exception ...")
        update_infos()
        try:
            save()
            print("Save ckpt done.")
        except RuntimeError as e:
            print(f"crash-save failed: {e}")
        print(traceback.format_exc())
        raise

    update_infos()
    save()
    return model, optimizer, infos


def main(argv=None):
    return train(parse_opt(argv))


if __name__ == "__main__":
    main()
