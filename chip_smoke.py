"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line:

  1. probe    the card (nvidia-smi name and power limit, capability), nvcc;
              builds the kernels from boficap_tpu_torch/csrc and times it.
  2. kernels  each kernel against its plain PyTorch version at the serving
              shapes (B = 64, full uic_sd width, all six layers for the
              stacks), float32 and bfloat16, with fully masked rows, padded
              regions; the head (#3) through its padded pack at an NA
              fill's and a narrow SA round's rows, with planted argmax ties
              (within a chunk, across chunks, at the last real column) and
              bitwise batch independence; and the product of #1, #2 and
              #4-#8 alone (tensor cores at bf16, FFMA at float32) at each of
              its 17 serving shapes, with bitwise batch independence.
  3. decode   fused_encode + na_decode on both kernel routes (whole-stack
              encoder and decoder kernels, per-layer kernels) against the
              plain path, float32, uic_sd at full width with random
              weights from a seed.
  4. serve    the NA main path: a CaptionServer(route='fused') on the card
              (the default compute dtype, bfloat16: the whole-stack
              kernels) answers single requests, a burst of 64 and
              short-region requests; each kernel's launch count is read
              around this run.  Then route='auto' at bf16 and float32: each
              bucket warmed at construction, the kernel and plain programs
              timed (each bucket's choice, both ms and the repeats' spread
              printed; plain kept only where it wins by more than the
              spread), every answer equal to a direct decode by the
              program kept.
  5. sa_decode  sa_decode on both kernel routes (whole-stack window
              kernels, per-layer window kernel) against the plain path,
              float32, with narrow and wide rounds.
  6. bf16_decode  na_decode and sa_decode at the default dtype (bfloat16,
              the whole-stack route) against the plain path at bfloat16;
              and na_decode at B = 256, the per-layer route (#1, #2),
              with their launch counts read around it.
  7. sa_serve the SA main path: CaptionServer(mode="SAIC",
              route='fused') at the default dtype (bfloat16: the
              whole-stack kernels), the same requests, launch counts read
              around this run; then route='auto' at both dtypes, as in
              phase serve.
  8. attention  the attention core (#9) against its plain version at the
              shapes of the AR step's cross-attention, its self-attention
              (views of the first 1, 11 and 21 rows of a 21-row cache, a
              mask of sample stride 0), the bounding step (a query
              broadcast over the batch), beam search (B*K = 192), an
              encoder self-attention (rank-2 mask over 36 rows) and a
              rank-3 mask, float32 and bfloat16, with fully masked rows and
              padded regions: the path attention_path gives (the decode
              steps' cases must take the row path) and every other path of
              the dtype, forced (row and tile at bf16; row, ffma and
              ffma_long at float32).
  9. ar_decode  configs/transformer.yml at full width, float32, B = 64:
              ar_sample and ar_beam_search (K = 3) with use_pallas on (#9
              on every step's self- and cross-attention) against off (the
              plain attend); uic_s_ar_decode on a configs/uic_s_ori.yml
              model and the NA decode on uic_sd, both ways; then the AR
              decode at the default bfloat16 against its plain path.
 10. aic_serve  the AR main path: CaptionServer(mode="AIC") at the default
              dtype with use_pallas on, the same requests (AIC has one
              program, as in the JAX server); #9 launches 2 x 6 x steps x
              batches, the encoder-stack kernel at least once.
 11. eval     the evaluation path at full uic_sd width: the bf16 model
              (random weights, plans nudged) written as the JAX package's
              model.ckpt + infos_<id>.pkl by the port's writer and read
              back bitwise; eval_split at B = 64 over a 960-image
              synthetic corpus of the full vocabulary (a 192-image test
              split, three batches) on the loaded model and on a float32
              model loaded from the same file, NAIC and SAIC, the kernels
              (use_cuda_fill auto) against the plain path on the card,
              every batch's decode by the margin rule; AIC on
              transformer.yml (bf16, float32) greedy and beam 3,
              use_pallas on against off; images/s of each; each route's
              launch counts
              read around its run; then `python -m
              boficap_tpu_torch.tools.eval` in a subprocess (SAIC, NAIC)
              on a checkpoint at uic_sd's widths over the CLI's own
              synthetic corpus.
 12. train    XE training of uic_sd at full width: one float32 step with
              dropout off on the card against the same step on the CPU
              (loss to 1e-5 relative, every gradient leaf to 1e-4 of its
              largest magnitude); 30 bf16 steps with dropout 0.1 and a
              constant Adam rate of 5e-4 on one repeated batch of 10 x 5
              synthetic captions (every loss finite, the last five below
              0.8 x the first five), and 13 float32 steps: step ms (median
              of 10 after 3 warm-up), peak memory, CUDA kernels a step and
              the device-busy share of a profiled step; no kernel launched
              by a step; the trained model's packs rebuilt, and eval_split
              (NAIC, SAIC) on its kernels against the plain path by the
              bf16 margin rule, with the eval loss and the launch counts,
              and the float32 model after its 13 steps the same by the
              float32 rule (each differing sample with its margin), and
              its XE step at ss_prob 0.5 on the card against the CPU (the
              coins drawn once on the host and given to both loops through
              bound_fill._ss_coins; the loops' outputs equal, some phrase
              from the model's plan; loss and leaves as the step at 0, a
              leaf beyond GRAD_TOL held to a float64 CPU step that
              re-scores the CPU loop's outputs, as phase rl's step), and
              the same step on the seeded weights with the stop shift;
              AR on trained weights (uic_sd has no AR decoder): an AIC
              model (configs/transformer.yml at full width, float32,
              dropout off, 150 Adam steps on a learnable corpus of 640
              images whose caption rows end with EOS, 5 or 6 words) and a
              bf16 copy of it, eval_split AIC greedy and beam 3 with #9 on
              against off by each dtype's margin rule, the share of greedy
              rows ended (EOS) before L (failing at 0), at bf16 the samples
              beam search excuses and their gaps;
              remat: one step with remat 1 against three with remat 0
              at both dtypes, dropout 0.1, one seed (the loss and each
              gradient leaf bitwise where the repeats are, else within
              their spread; the generator's state after it equal), then
              the bf16 step's ms (median of 10 after 3 warm-up) and peak
              memory over what is resident with remat 0 and 1 at 10 x 5
              and 64 x 5 captions, with remat 1 at 256 x 5 and remat 0
              there where the line through the smaller batches' peaks
              stays under the free memory (remat 1's peak below remat
              0's at 64 x 5); then the training CLI in a subprocess (a
              validation and a checkpoint, a --start_from resume) and
              the eval CLI on its model_best.ckpt.
 13. rl       the RL stage (configs/uic_sd_nscl.yml: 10 images x 5 samples,
              new_self_critical, a constant Adam rate of 5e-6) on phase
              train's trained bf16 model: the sampler's kernel launches
              (#4, #5, #6, and #7 when a sampled SA phrase is wider than
              the window) and none in the step's autograd; the top1
              sampled NA and SA decodes on the kernels equal the greedy
              kernel decodes at float32; then the same model's plans
              shaped (the length head's 10-word bias raised until about a
              fifth of the images open with such a phrase, no stop shift):
              the bf16 sampler launches #7 too, its log-probs within 0.05
              of the re-score, top1 equals greedy at float32, and the
              biases are put back; the sampler's token log-probs
              against rl_rescore's plain values (float32 within 1e-4, bf16
              within 0.05 nats, a limit between the sound reading and a
              control's, the same sampler with its stacks' outputs moved
              by 8 bf16 ulps, which must exceed it; both printed); 20,000
              draws a method (sample, gumbel, top3, top0.9 at temperature
              0.7) from a CUDA generator against the closed form by a
              chi-square test; one float32 structure-loss step on the
              card against the CPU on the trained model's samples and
              their CIDEr-D scores (the loss to 1e-5 relative, every
              gradient leaf to 1e-4 of its largest magnitude, the ReLU
              sides aligned; a loss or leaf beyond that is held to a
              float64 step on the CPU, the card within 4x the CPU's own
              distance from it), and on the seeded weights with seeded
              scores to the CPU alone; 3 + 10 RL steps at bf16
              and at float32 (every loss finite, the parameters moved, the
              packs rebuilt after each step): step ms split into sampler,
              host scoring and update, samples/s, peak memory, host syncs
              a step, CUDA kernels and the device-busy share of a
              profiled step; the native and Python scorers' ms with their
              scores equal; one SCST step of configs/transformer.yml with
              use_pallas on (#9 launched by the sampler); the training CLI
              resumed from phase train's checkpoint with structure_after
              0 (the RL keys in metrics.jsonl).
 14. prepro   captions the port alone preprocessed: a seeded
              Karpathy-format corpus (200 images x 5 captions from a fixed
              word list) through boficap_tpu_torch.prepro in memory (the
              heuristic cutter) into a LabelStore; 5 bf16 XE steps of
              uic_sd at full width over it (every loss finite); eval_split
              NAIC on its 64 test images, the kernels against the plain
              path by the bf16 margin rule; whether h5py imports, and with
              it the prepro_labels CLI's files read back equal to the
              store (without it write_prepro raises ImportError).
 15. decoders  the remaining decoders on the card.  NNAIC
              (configs/nnaic.yml at full width, random weights, the length
              head's bias centred so the B = 64 lengths spread over 0..19,
              0 and 19 among them): fused_encode + nnaic_decode on the
              kernels against the plain path, float32 (#1, #2, #3; the rule
              at 1e-3) and bfloat16 (#4, #5, #3; the rule at 0.1), the
              length identical by the same rule, launch counts and ms of
              each; eval_split NNAIC at both dtypes, kernels against plain;
              one float32 XE step on the card against the CPU (loss to
              1e-5 relative, every gradient leaf to 1e-4 of its largest
              magnitude, the ReLU sides aligned) and 10 bf16 steps whose
              losses stay finite and whose word loss falls.  The diverse AR decoders on
              configs/transformer.yml (float32, B = 64) with use_pallas on
              (#9) against off by the margin rule: ar_diverse_beam_search
              (beam 4, groups 2), ar_old_beam_search (K 3, G 1, and K 4,
              G 2 with decoding_constraint's exact -inf: the row
              buffers' -inf entries equal, the rest within
              1e-3, unaug_p within 1e-5 relative) and ar_diverse_sample
              (dgreedy, 3 groups), #9's launches (2 x 6 x 20 a group) and ms
              on and off; eval_split with sample_n 3 by bs, dbs and
              sample, the multi-sample metrics in lang_stats.
 16. pb       PB_pad (configs/pb.yml at full width, random weights from
              the seed, the length head's bias centred so the B = 64 plans
              hold 2-6 phrases): fused_encode + pb_decode with use_pallas
              on (#9 on every attention of the predictor and the packed
              decoder; #1 at float32, #4 at bf16) against the plain path,
              float32 and bfloat16, at the default packed width 44 and the
              lossless 211, by the first-divergence rule (the samples share
              one packed layout); #9's launches (2 a predictor layer a
              round, 2 N_dec a fill), the encode's, the rounds and host
              syncs; the
              predictor and the packed decoder with #9 against plain on
              the same layout; each decode's ms (kernels and plain) on a
              line of its own with the card.  #9 alone at Lq = Lk = 129,
              211, 256 and at 211 x 36, both dtypes, against its twin,
              with its path, ms, bound, plain and SDPA ms, and each other
              path of the dtype forced where it fits (at float32 the ffma
              block beside ffma_long).  One
              float32 PB XE step card vs CPU on a 10 x 5 batch and 10 bf16
              steps whose loss falls; eval_split through model.ckpt at the
              lossless width on the kernels against plain; the model as a
              reference model.pth through the convert CLI, loaded bitwise
              and evaluated to its source's captions.
 17. raw      the raw-image eval path over 196 regions (a 14 x 14 grid):
              64 binary PPM images of seeded noise, sides 300-640, in a
              temp folder; the ResNet-101 trunk (random He-init from the
              seed, float32) through DataLoaderRaw on the card with cuDNN's
              TF32 switched on around it (every convolution must see it
              off, and it must come back on), the first two images' fc and
              att against the same trunk on the CPU within 1e-4 relative,
              the features' scale (random He-init features are large:
              reported as they are), ms an image; #1, #2, #4, #5, #8, #6
              and #7 at B = 64 over 196 regions against their twins,
              float32 and bf16, with padded regions and a fully masked
              sample (#5 20 times back to back, bitwise equal), and #9 at
              1 x 196, each held to TOL, printed beside it with the same
              kernel's reading at 36 regions (at bf16 past 128 keys the
              chunked tile kernel normalises p before it rounds it, as
              its twin and the reference do; #9 there also differs from
              its twin in at most CORE_LONG_SHARE of the elements); the eval CLI (tools.eval main, in process) over the
              folder through model.ckpt: NAIC and SAIC on uic_sd at bf16
              (the whole-stack route: #4, #5, #6, #7, #3) and at float32
              (per layer: #1, #2, #8, #3), AIC on transformer.yml at bf16
              with use_pallas on (#4, #9), each on the kernels against the
              plain path on the card by the margin rules, each route's
              launch counts read around its run; the module in a process
              of its own (NAIC, the images copied to vis/imgs).
 18. times    each kernel's time beside its plain version's, one PyTorch
              library call's (a yardstick the port never calls) and the
              least time the card could take (bound); decode times,
              launches and host syncs per decode; #9's host cost a call,
              AR and NA decode times with use_pallas on and off, an AR
              breakdown; each product of #1, #2 and the narrow window
              round, at bf16 and float32, against its bound and
              torch.matmul, with its tile; #1's, #2's, #6's and #7's bf16
              and #8's float32 device time split into products, attention
              (by path) and refnorm, with launches a call (7, 12 and 11 a
              layer; no FFMA product and every attention on the tile path
              at bf16, six FFMA products at float32); #3's split into
              head_partial and head_combine at both dtypes; the attention
              block alone at each caller's shape (path, ms, byte bound,
              SDPA) and on each path at 1, 2, 4 and 8 query rows, and at
              bf16 the AR step's self-attention at the AR cell's batch
              (B = 16384, 1, 11 and 21 keys: ms, byte bound); one
              refnorm at 512 and 2304 rows against its byte bound; host µs
              of a layer, a stack and a window-stack call at bf16 and
              float32; #1, #2, #4-#8 and #9 over 196 regions (ms, bound,
              plain, SDPA + matmul; #9's path and its other paths forced),
              #1's, #2's, #5's and #8's float32 device time over 196
              regions split as above (every attention past 128 keys on
              ffma_long), the attention block alone past 128 keys (211 x
              211, 196 x 196, 20 x 196, 8 x 196, 1 x 196: path, ms,
              bound, plain, SDPA, each other path forced where it fits),
              the trunk's ms an image and the raw
              eval's images/s, kernels against plain; the head gate: #3
              against the plain head (model.generate, argmax, token
              log-prob, entropy) at B * L = 20-1280 rows, bf16 and
              float32, ms and device ms; fails unless the crossover is 0
              (#3 the faster at every count: the fills run it ungated).
 19. lstm     the LSTM captioners at full width (configs/fc.yml,
              updown.yml, a2i2.yml, aoa.yml; random weights from the seed,
              the logit scaled up so the words depend on the image), B =
              64.  AoANet with use_pallas on (#9 on the refiner's six
              self-attentions and every step's decoder attention) against
              off, float32 and bfloat16: the encode's error, ar_sample
              greedy and ar_beam_search (K = 3) by the margin rule, #9
              launched N_enc + L times a decode.  Every model at float32 on
              the card against the CPU on the same weights: greedy and
              beam 3 by the margin rule (seq identity reported), one XE
              step with dropout off on a 10 x 5 batch (the loss to 1e-5
              relative, every gradient leaf to 1e-4 of its largest
              magnitude, the ReLU sides aligned).  bf16: 10 AoANet XE steps
              whose loss falls, one classic SCST step (aoa_sc.yml: the
              sampler on #9, the update on no kernel) and one
              structure-loss step (updown/updown_nsc.yml on UpDown).  The
              AoANet checkpoint written and read back bitwise; eval_split
              AIC greedy at B = 64 with #9 against plain at float32; the
              AIC server on AoANet (#9 N_enc + L times a batch) and on
              UpDown (no kernel), 80 requests each against a direct decode.
              Each model's decode ms at both dtypes (AoANet with #9 off and
              on), XE step ms and peak memory, AoANet's busy share.

 20. mesh     the mesh (parallel/mesh.py), on graft_entry's tiny UIC at
              float32 with dropout off and plain SGD: one XE step in a
              one-rank NCCL group, bitwise the step without a mesh; a
              two-rank gloo group whose ranks share the card (gloo copies
              CUDA tensors through the host, so nothing here measures
              several GPUs): the step with the batch over 'data', and with
              the weights over 'model' (tp 2), with and without
              drop-worst, against the single-process step (loss within
              1e-4 relative, parameters within rtol 2e-4 / atol 2e-5, the
              CPU tests' tolerances), and the NA decode at B = 64 with the
              weights over 'model', token for token the single-device
              decode; then CaptionServer(mesh=[card, card],
              route='fused') at bf16 on uic_sd (two replicas sharing one
              copy of the weights, each bucket split between them): every
              answer equal to the server without a mesh, #4, #5 and #3
              launched (their counts in the kernels line).
 21. diagnostics  the eval CLI in process with --dump_attention 1
              --report_flops 1 (NAIC, 10 images) on a float32 checkpoint
              at uic_sd's widths, on the card and with --device cpu: the
              maps' keys, every map within 1e-5, the printed accumulator
              and the FLOP counts equal; the training CLI with
              --profile_steps 2 on the card: a trace under profile/ with
              CUDA kernel events.
 22. kernel_parts  the kernel-parts tool's two kernels (the ports of
              scripts/bench_kernel_parts.py): #10, the window layer with
              parts switched off, in each of the tool's seven variants,
              and #11, its head-block-diagonal variant (one softmax max a
              row across heads), at W = 8 and 16, on window_inputs at B =
              64 and full width, float32 and bfloat16, each against its
              plain twin (TOL), #10 with every part bitwise #8; each
              call's kernel launches by kind (torch.profiler) held to
              ops.window_parts' table, with each kind's device ms, the
              call's device ms and the gap between; then the tool's main path
              (`python -m boficap_tpu_torch.tools.bench_kernel_parts`, in
              process, at both dtypes: the variants' six-layer stacks, #11
              against #8 at W = 8 and 16) with the launch counts zeroed
              before and read after; #10's and #11's ms beside #8's,
              their twins', #8's yardstick (eager torch.matmul + SDPA) and
              #8's bound.

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed phase raises: the script exits
non-zero and prints no result.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

B, R, L = 64, 36, 20          # serving batch, regions, max_length
D = 512                       # uic_sd width
DEV = "cuda"
VOCAB = 9487                  # words; + 4 control ids = 9491 classes
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rate of each compute type; float32 runs on the FFMA units
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances, relative to the largest magnitude of the plain result:
# float32 differs only by summation order (~1e-6); bfloat16 values may
# round one ulp (2**-8 relative) apart where a float32 sum lies near a
# rounding boundary, and that propagates through the layer
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# #9 at bf16 past KEY_MAX keys against its twin, which normalises p before
# it rounds it, as the reference does: at most this share of the elements
# may differ at all.  In the same order only a float32 sum that lands on a
# rounding boundary parts them (a few in 10**4; one such element puts the
# largest-magnitude error at 211 x 211 at 1.45e-3, so a bound on it could
# not tell the orders apart); rounding p first moves about a third of
# them (the CPU twins' test, tests/test_torch_port_raw.py)
CORE_LONG_SHARE = 0.01
# na_decode token rule: seq may differ only where the plain path's top-2
# logprob margin is below this (float32 kernel vs cuBLAS noise is ~1e-5)
MARGIN_NOISE = 1e-3
LOGPROB_TOL = 1e-3
# the same rule in bfloat16 (tests/test_torch_port_sa.py BF16_MARGIN_NOISE:
# two bf16 roundings apart, ~2**-7 relative on logits of size ~1,
# compounded over the layers); at most a quarter of the samples excused
BF16_MARGIN_NOISE = 0.1

REPLACES = {
    "attention_core": "boficap_tpu/ops/pallas_attention.py:33",
    "encoder_layer": "boficap_tpu/ops/pallas_decoder_layer.py:500",
    "decoder_layer": "boficap_tpu/ops/pallas_decoder_layer.py:124",
    "greedy_head": "boficap_tpu/ops/pallas_decoder_layer.py:671",
    "encoder_stack": "boficap_tpu/ops/pallas_stack.py:415",
    "decoder_stack": "boficap_tpu/ops/pallas_stack.py:258",
    "window_layer": "boficap_tpu/ops/pallas_decoder_layer.py:283",
    "window_stack": "boficap_tpu/ops/pallas_stack.py:551",
    "window_wide_stack": "boficap_tpu/ops/pallas_stack.py:712",
}
SOURCES = {name: f"boficap_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["encoder_stack"] = "boficap_tpu_torch/csrc/encoder_layer.cu"
SOURCES["decoder_stack"] = "boficap_tpu_torch/csrc/decoder_layer.cu"
SOURCES["window_wide_stack"] = "boficap_tpu_torch/csrc/window_stack.cu"
# the kernels each main path (bfloat16, B <= 128: the whole-stack route)
# must launch
NA_KERNELS = ("encoder_stack", "decoder_stack", "greedy_head")
SA_KERNELS = ("encoder_stack", "window_stack", "window_wide_stack",
              "greedy_head")
AIC_KERNELS = ("encoder_stack", "attention_core")
W_NARROW = 8                  # sa_decode's default window
# the products of #1 (B*R = 2304 rows), #2 (B*L = 1280 rows; the memory's
# 2304 for wkv2) and a narrow SA round's window layer (#6, #8: B*W = 512
# rows; #7's wide round has #2's shapes), each with its epilogue: (name, M,
# K, N, relu, residual).  They run on the tensor cores at bf16
# (csrc/wgmma_gemm.cuh), on FFMA at float32 (csrc/ffma_gemm.cuh)
PRODUCTS = (
    ("enc.wqkv", B * R, D, 3 * D, False, False),
    ("enc.wo", B * R, D, D, False, True),
    ("enc.w1", B * R, D, 4 * D, True, False),
    ("enc.w2", B * R, 4 * D, D, False, True),
    ("dec.wqkv", B * L, D, 3 * D, False, False),
    ("dec.wo", B * L, D, D, False, True),
    ("dec.wq2", B * L, D, D, False, False),
    ("dec.wkv2", B * R, D, 2 * D, False, False),
    ("dec.wo2", B * L, D, D, False, True),
    ("dec.w1", B * L, D, 4 * D, True, False),
    ("dec.w2", B * L, 4 * D, D, False, True),
    ("win.wqkv", B * W_NARROW, D, 3 * D, False, False),
    ("win.wo", B * W_NARROW, D, D, False, True),
    ("win.wq2", B * W_NARROW, D, D, False, False),
    ("win.wo2", B * W_NARROW, D, D, False, True),
    ("win.w1", B * W_NARROW, D, 4 * D, True, False),
    ("win.w2", B * W_NARROW, 4 * D, D, False, True),
)
B_WIDE = 256                  # a batch past the whole-stack route (B > 128)
K_BEAM = 3                    # beam width of the beam-search check
LONG = 10                     # a phrase longer than the window: a wide round
STOP_SHIFT = 6.0              # against random weights' early "stop" (shift_stop)
NL = 6                        # uic_sd encoder and decoder layers
STACK_REPEATS = 20            # #5 calls back to back, held bitwise equal


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item() / scale


def differ_share(got, want) -> float:
    """The share of the elements of ``got`` other than ``want``'s."""
    return (got.float() != want.float()).float().mean().item()


def core_long_check(got, want, Lq: int, Lk: int, dtype) -> dict:
    """#9 at bf16 past KEY_MAX keys: fail where more than CORE_LONG_SHARE
    of the elements differ from the normalise-then-round twin."""
    from boficap_tpu_torch.ops import attention as at
    if dtype != torch.bfloat16 or Lk <= at.KEY_MAX:
        return {}
    share = differ_share(got, want)
    if share > CORE_LONG_SHARE:
        fail(f"attention_core {Lq}x{Lk} bfloat16: {share} of the elements "
             f"differ from the normalise-then-round twin, above "
             f"{CORE_LONG_SHARE}")
    return {"differ_share": share, "differ_share_max": CORE_LONG_SHARE}


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# ---------------------------------------------------------------------------
# model and inputs
# ---------------------------------------------------------------------------

def build(dtype=None, config: str = "uic_sd.yml", vocab=None):
    """A shipped config (uic_sd by default) at full width over ``vocab``
    words (None: VOCAB), random weights from SEED; ``dtype`` overrides the
    config's compute dtype (None: the default, bfloat16)."""
    from boficap_tpu_torch.config import load_config
    from boficap_tpu_torch.convert import init_params
    cfg = load_config(os.path.join(HERE, "configs", config))
    if dtype is not None:
        cfg.dtype = dtype
    model = init_params(cfg, vocab or VOCAB, seed=SEED, device=DEV).eval()
    if not model.n_lp or model.train_mode == "PB_pad":
        # an AR model: no length predictor; PB_pad's: shape_pb_plans
        return model
    # Random weights plan empty captions (the length head's argmax is
    # "stop" for every image), which would leave the fill and the head
    # nothing to decide.  Nudge the length head toward 1-3 word phrases and
    # the syntax head toward the VP/NP/CP ids, with seeded noise, so plans
    # are non-empty and vary between images.
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        nudge = torch.tensor([-1.0] + [1.5] * 3 + [0.0] * 16)
        model.len_head2.bias += (nudge + 0.3 * torch.randn(20, generator=g)
                                 ).to(DEV)
        model.syn_head2.bias += torch.tensor(
            [0.0] * 4 + [2.0] * 3 + [0.0] * 3).to(DEV)
    model.invalidate_packed()
    return model


@torch.no_grad()
def shift_stop(models) -> None:
    """Random weights plan SA captions that mostly stop at once: shift the
    length head's "stop" bias down and the syntax head's VP/NP/CP biases
    up by STOP_SHIFT in every model, so plans run to several phrases."""
    for m in models:
        m.len_head2.bias[0] -= STOP_SHIFT
        m.syn_head2.bias[4:7] += STOP_SHIFT
        m.invalidate_packed()


@torch.no_grad()
def shape_plans(models, share: float = 0.8, feats=None, long: int = LONG):
    """Plans never hold a phrase wider than the narrow window: raise the
    bias of LONG-word phrases in every model until ``share`` of the images
    take it as the argmax of their first SA round (read on the first
    model: the raise passes that quantile of the argmax gap).  Such a
    round is wider than the window, so SA decodes run both the narrow and
    the wide kernels.  ``feats``: the (att, am) to read the plans on
    (None: ``features(B, seed=9)``); ``long``: the phrase length raised
    (LONG).  Returns its shift."""
    from boficap_tpu_torch.constants import LEN, PAD
    model = models[0]
    att, am = feats if feats is not None else features(B, seed=9)
    att, am = att.to(DEV), am.to(DEV)
    mem = model.encode(att, am)
    n = att.shape[0]
    ids = torch.full((n, L + 2), PAD, dtype=torch.long, device=DEV)
    ids[:, 0] = LEN
    len_lp, _ = model.bound_step_cached(
        model.bound_cache(mem, False), ids,
        torch.ones(n, dtype=torch.long, device=DEV), am.bool(),
        use_syn=False)
    others = len_lp.clone()
    others[:, long] = -math.inf
    gap = others.max(-1).values - len_lp[:, long]
    long_shift = torch.quantile(gap.float(), share).item() + 1e-3
    for m in models:
        m.len_head2.bias[long] += long_shift
        m.invalidate_packed()
    return long_shift


@torch.no_grad()
def unforce_long(models, long_shift: float) -> None:
    """Take back shape_plans' raise of the LONG-word phrases (shift_stop's
    shift stays), so timed SA decodes run the rounds an unforced plan
    gives."""
    for m in models:
        m.len_head2.bias[LONG] -= long_shift
        m.invalidate_packed()


def features(n: int, seed: int):
    """Region features [n, R, 2048] and masks [n, R] (some padded)."""
    g = torch.Generator().manual_seed(seed)
    att = torch.randn((n, R, 2048), generator=g)
    n_live = torch.randint(10, R + 1, (n,), generator=g)
    am = (torch.arange(R)[None, :] < n_live[:, None]).float()
    return att, am


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def layer_inputs(dtype, seed: int, regions: int = R):
    g = torch.Generator().manual_seed(seed)
    dev = DEV
    x_enc = torch.randn((B, regions, D), generator=g).to(dev, dtype)
    n_live = torch.randint(1, regions + 1, (B,), generator=g)
    n_live[0] = 0                                      # fully masked sample
    src = (torch.arange(regions)[None, :] < n_live[:, None]).to(dev)
    x_dec = torch.randn((B, L, D), generator=g).to(dev, dtype)
    mem = torch.randn((B, regions, D), generator=g).to(dev, dtype)
    total = torch.randint(0, L + 1, (B,), generator=g)
    total[1] = 0                                       # empty plan
    tgt = (torch.arange(L)[None, None, :] < total[:, None, None]).expand(
        B, L, L).contiguous().to(dev)
    h = torch.randn((B, L, D), generator=g).to(dev, dtype)
    return x_enc, src, x_dec, mem, tgt, h


def check_kernels(model, regions: int = R, head: bool = True):
    """#1, #2, #4 and #5 (and, with ``head``, #3) against their plain
    twins at B = 64 over ``regions`` regions, float32 and bfloat16; #5
    called STACK_REPEATS times back to back, bitwise equal."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    res = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = TOL[dtype_name]
        enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
        dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
        hpack = dl.pack_head_weights(model.generator.proj, dtype)
        x_enc, src, x_dec, mem, tgt, h = layer_inputs(dtype, 1, regions)
        H = model.num_heads

        got = dl.fused_encoder_layer(x_enc, src, enc_w, H)
        want = dl.encoder_layer_plain(x_enc, src, enc_w, H)
        torch.cuda.synchronize()
        e_enc = rel_err(got, want)
        a_enc = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or e_enc > tol:
            fail(f"encoder_layer {dtype_name}: rel err {e_enc} > {tol}")

        got = dl.fused_decoder_layer(x_dec, mem, tgt, src, dec_w, H)
        want = dl.decoder_layer_plain(x_dec, mem, tgt, src, dec_w, H)
        torch.cuda.synchronize()
        e_dec = rel_err(got, want)
        a_dec = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or e_dec > tol:
            fail(f"decoder_layer {dtype_name}: rel err {e_dec} > {tol}")

        # the whole stacks, every layer of the model
        stacks = {}
        enc = st.pack_encoder_stack(model.encoder, dtype)
        dec = st.pack_decoder_stack(model._decoder("NA"), dtype)
        for name, got, want in (
                ("encoder_stack",
                 st.fused_encoder_stack_forward(x_enc, src, enc.stack,
                                                enc.final_norm, H),
                 st.encoder_stack_plain(x_enc, src, enc.stack,
                                        enc.final_norm, H)),
                ("decoder_stack",
                 st.fused_decoder_stack_forward(x_dec, mem, tgt, src,
                                                dec.stack, dec.final_norm, H),
                 st.decoder_stack_plain(x_dec, mem, tgt, src, dec.stack,
                                        dec.final_norm, H))):
            torch.cuda.synchronize()
            e = rel_err(got, want)
            if not torch.isfinite(got.float()).all() or e > tol:
                fail(f"{name} {dtype_name}: rel err {e} > {tol}")
            stacks[name] = {"rel_err": e, "max_abs_err":
                            (got.float() - want.float()).abs().max().item()}
        # #5's launch chain: calls back to back give the same bits (a race
        # between its chained launches would not)
        again = [st.fused_decoder_stack_forward(x_dec, mem, tgt, src,
                                                dec.stack, dec.final_norm, H)
                 for _ in range(STACK_REPEATS)]
        torch.cuda.synchronize()
        first = again[0]
        differ = [i for i, o in enumerate(again) if not torch.equal(o, first)]
        if differ:
            fail(f"decoder_stack {dtype_name}: calls {differ} of "
                 f"{STACK_REPEATS} back to back differ from the first")
        stacks["decoder_stack"]["repeats_bitwise_equal"] = STACK_REPEATS

        res[dtype_name] = {
            "encoder_layer": {"rel_err": e_enc, "max_abs_err": a_enc},
            "decoder_layer": {"rel_err": e_dec, "max_abs_err": a_dec},
            **stacks,
        }
        if head:
            # the head at an NA fill's rows (B * L) and a narrow SA
            # round's (B * W)
            heads = {f"n{B * T}": check_head(h[:, :T].contiguous(), hpack,
                                             dtype_name)
                     for T in (L, W_NARROW)}
            res[dtype_name]["greedy_head"] = {
                "max_abs_err": max(v["max_abs_err"]
                                   for v in heads.values()), **heads}
    return res


def check_head(h, pack, dtype_name: str) -> dict:
    """#3 through the padded pack (W [D, Vp], b [Vp], V) against its plain
    twin on h [B, T, D]: float32 ids equal; bf16 ids apart only where the
    plain logits' top-2 gap is within one bf16 ulp (a one-ulp rounding
    apart); tok, entropy and the PAD column's logprob within the tolerance;
    the first 37 rows' ids and tok bitwise those of a head of 37 rows; and
    planted ties, each set of columns identical and dominant, resolved to
    the lower index: within one 128-wide chunk and across chunks (1000,
    1003, 5000), within one chunk alone (2050, 2100), and at the last real
    column (600, V - 1)."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    hw, hb, V = pack
    ids, tok, ent, lpp = dl.fused_greedy_head(h, *pack, pad_id=0)
    pids, ptok, pent, plpp = dl.greedy_head_plain(h, *pack, pad_id=0)
    torch.cuda.synchronize()
    diff = ids != pids
    rows = h.shape[0] * h.shape[1]
    if dtype_name == "float32":
        if diff.any():
            fail(f"greedy_head float32 N={rows}: {int(diff.sum())} ids "
                 f"differ")
    else:
        acc = torch.matmul(h.float(), hw[:, :V].float())
        logits = (acc.to(h.dtype) + hb[:V]).float()
        top2 = logits.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        loose = gap <= bf16_ulp(top2[..., 0])
        if (diff & ~loose).any():
            fail(f"greedy_head bfloat16 N={rows}: ids differ above one ulp")
    a_head = max((tok - ptok).abs().max().item(),
                 (ent - pent).abs().max().item(),
                 (lpp - plpp).abs().max().item())
    head_tol = TOL[dtype_name] * max(ptok.abs().max().item(), 1.0)
    if a_head > head_tol:
        fail(f"greedy_head {dtype_name} N={rows}: tok/ent/lp_pad err "
             f"{a_head}")
    n = min(37, rows)
    part = dl.fused_greedy_head(h.reshape(rows, 1, -1)[:n], *pack, pad_id=0)
    torch.cuda.synchronize()
    for got, full in zip(part[:2], (ids, tok)):
        if not torch.equal(got.reshape(-1), full.reshape(-1)[:n]):
            fail(f"greedy_head {dtype_name}: the first {n} rows differ from "
                 f"a head of {n} rows (not batch-independent)")
    for cols in ((1000, 1003, 5000), (2050, 2100), (600, V - 1)):
        hw_t, hb_t = hw.clone(), hb.clone()
        for c in cols[1:]:
            hw_t[:, c] = hw_t[:, cols[0]]
        hb_t[list(cols)] = 40.0
        tids = dl.fused_greedy_head(h, hw_t, hb_t, V, pad_id=0)[0]
        torch.cuda.synchronize()
        if not (tids == cols[0]).all():
            fail(f"greedy_head {dtype_name}: tie {cols} not resolved to the "
                 f"lower index: {tids.unique().tolist()}")
    return {"max_abs_err": a_head, "ids_differ": int(diff.sum()),
            "batch_independent": True, "ties": "lower index"}


def product_operands(M: int, K: int, N: int, relu: bool, residual: bool,
                     seed: int = 31, dtype=torch.bfloat16):
    """Operands of one product in ``dtype``: a [M, K], w [K, N] scaled as a
    layer's, bias [N], res [M, N] or None; (a, w, b, relu, res)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((M, K), generator=g).to(DEV, dtype)
    w = (torch.randn((K, N), generator=g) / math.sqrt(K)).to(DEV, dtype)
    b = (0.1 * torch.randn((N,), generator=g)).to(DEV, dtype)
    res = (torch.randn((M, N), generator=g).to(DEV, dtype)
           if residual else None)
    return a, w, b, relu, res


def check_products(dtype):
    """The layer and window kernels' product (fused_linear: the
    tensor-core path of #1, #2 and #4-#8 at bf16, the FFMA path at float32)
    against linear_plain at each serving shape, and bitwise batch
    independence: its first 37 rows and its first row, computed as products
    of 37 and of 1 rows (other tiles), equal the full product's."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    dtype_name = "float32" if dtype == torch.float32 else "bfloat16"
    tol = TOL[dtype_name]
    res = {}
    for name, M, K, N, relu, residual in PRODUCTS:
        a, w, b, relu, r = product_operands(M, K, N, relu, residual,
                                            dtype=dtype)
        got = dl.fused_linear(a, w, b, relu, r)
        want = dl.linear_plain(a, w, b, relu, r)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        if not torch.isfinite(got.float()).all() or e > tol:
            fail(f"product {name} {dtype_name} {M}x{K}x{N}: rel err {e} > "
                 f"{tol}")
        for rows in (37, 1):
            part = dl.fused_linear(a[:rows], w, b, relu,
                                   None if r is None else r[:rows])
            torch.cuda.synchronize()
            if not torch.equal(part, got[:rows]):
                fail(f"product {name} {dtype_name}: the first {rows} rows "
                     f"differ from a product of {rows} rows (not "
                     f"batch-independent)")
        bm, bn, blocks = dl.product_tile(M, N, dtype)
        res[name] = {"m_k_n": [M, K, N], "tile": [bm, bn], "blocks": blocks,
                     "rel_err": e, "max_abs_err":
                         (got.float() - want.float()).abs().max().item(),
                     "batch_independent": True}
    return res


def window_inputs(dtype, W: int, seed: int, wide: bool = False,
                  regions: int = R):
    """Operands of the window kernels at the serving shapes: x_win
    [B, W, D], caches [NL, B, L, D], cross K/V [NL, B, regions, D], window
    starts
    (eight clipped at L - W), tgt [B, W, L + W] (narrow) or [B, L, L]
    (wide) with an empty plan (sample 1: every row masked) and rows past
    the slot (masked), src [B, R] with padded regions."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(DEV, dtype)

    x = rnd(B, W, D)
    kc, vc = rnd(NL, B, L, D), rnd(NL, B, L, D)
    k2, v2 = rnd(NL, B, regions, D), rnd(NL, B, regions, D)
    w_start = torch.randint(0, L - W + 1, (B,), generator=g)
    w_start[:8] = L - W
    n_keys = W if wide else L + W
    tgt = torch.rand((B, W, n_keys), generator=g) < 0.6
    live = torch.randint(0, W + 1, (B,), generator=g)
    tgt &= (torch.arange(W)[None, :] < live[:, None])[:, :, None]
    tgt[1] = False
    n_live = torch.randint(1, regions + 1, (B,), generator=g)
    if regions != R:
        n_live[2] = 0          # past phase 2's inputs: a fully masked sample
    src = torch.arange(regions)[None, :] < n_live[:, None]
    return (x, kc, vc, k2, v2, w_start.to(DEV, torch.int32),
            tgt.to(DEV), src.to(DEV))


def check_window_kernels(model, regions: int = R):
    """#8, #6 and #7 against their plain twins, float32 and bfloat16: a
    narrow window (W = 8) and the wide round (W = L), their
    cross-attentions over ``regions`` regions."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    res = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = TOL[dtype_name]
        pack = st.pack_window_weights(model._decoder("SA"), dtype)
        errs = {}

        def agree(name, got, want):
            for gt, wt in zip(got, want):
                e = rel_err(gt, wt)
                if not torch.isfinite(gt.float()).all() or e > tol:
                    fail(f"{name} {dtype_name}: rel err {e} > {tol}")
            errs[name] = {
                "rel_err": max(rel_err(gt, wt) for gt, wt in zip(got, want)),
                "max_abs_err": max((gt.float() - wt.float()).abs().max().item()
                                   for gt, wt in zip(got, want))}

        for W in (W_NARROW, L):
            x, kc, vc, k2, v2, ws, tgt, src = window_inputs(dtype, W, 11,
                                                          regions=regions)
            args = (x, kc[0], vc[0], k2[0], v2[0], tgt, src, pack.layers[0],
                    H)
            got = dl.fused_window_decoder_layer(*args)
            want = dl.window_layer_plain(*args)
            torch.cuda.synchronize()
            agree(f"window_layer_w{W}", got, want)

        # narrow round: caches updated in place; rows outside each window
        # bit-identical, in-window rows the fresh K/V
        x, kc, vc, k2, v2, ws, tgt, src = window_inputs(dtype, W_NARROW, 12,
                                                     regions=regions)
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        h, _, _ = st.fused_window_decoder_stack(
            x, ws, kc_k, vc_k, k2, v2, tgt, src, pack.stack, pack.final_norm,
            H)
        hp, _, _ = st.window_stack_plain(
            x, ws, kc_p, vc_p, k2, v2, tgt, src, pack.stack, pack.final_norm,
            H)
        torch.cuda.synchronize()
        pos = torch.arange(L, device=DEV)[None, :]
        inside = ((pos >= ws.long()[:, None])
                  & (pos < ws.long()[:, None] + W_NARROW))
        for got, old in ((kc_k, kc), (vc_k, vc)):
            if not torch.equal(got[:, ~inside], old[:, ~inside]):
                fail(f"window_stack {dtype_name}: a cache row outside the "
                     f"window changed")
        agree("window_stack", (h, kc_k[:, inside], vc_k[:, inside]),
              (hp, kc_p[:, inside], vc_p[:, inside]))

        x, _, _, k2, v2, _, tgt, src = window_inputs(dtype, L, 13, wide=True,
                                                   regions=regions)
        got = st.fused_window_wide_stack(x, k2, v2, tgt, src, pack.stack,
                                         pack.final_norm, H)
        want = st.window_wide_stack_plain(x, k2, v2, tgt, src, pack.stack,
                                          pack.final_norm, H)
        torch.cuda.synchronize()
        agree("window_wide_stack", got, want)
        errs["window_layer"] = max(
            (errs.pop(f"window_layer_w{W}") for W in (W_NARROW, L)),
            key=lambda e: e["max_abs_err"])
        res[dtype_name] = errs
    return res


# ---------------------------------------------------------------------------
# phase 3: na_decode on the kernels against the plain path
# ---------------------------------------------------------------------------

@torch.no_grad()
def plain_margins(model, memory, src):
    """Top-2 logprob margin of the plain path's fill, [B, L]."""
    from boficap_tpu_torch.decode.bound_fill import bound_plan
    s = bound_plan(model, memory, src, L, L)
    total = s["last"] - 1
    ar = torch.arange(L, device=memory.device)
    na_mask = (ar[None, None, :] < total[:, None, None]).expand(-1, L, L)
    lp = model.generate(model.decode_na(s["extend_syn"][:, 1:-1], memory,
                                        src, na_mask))
    top2 = lp.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


@torch.no_grad()
def plain_plan_margins(model, memory, src):
    """The plain bounding loop's top-2 logprob margin at each step, the
    smaller of the length and the syntax head's, [B, L]: step i fills plan
    slot i."""
    from boficap_tpu_torch.decode.bound_fill import bound_plan
    gaps = []
    step = model.bound_step_cached

    def record(*a, **kw):
        out = step(*a, **kw)
        top2 = [lp.float().topk(2, dim=-1).values for lp in out]
        gaps.append(torch.minimum(*(t[..., 0] - t[..., 1] for t in top2)))
        return out

    model.bound_step_cached = record
    try:
        bound_plan(model, memory, src, L, L)
    finally:
        del model.bound_step_cached
    return torch.stack(gaps, -1)


def na_agree(got, want, margin, what: str, noise: float = MARGIN_NOISE,
             lp_tol=LOGPROB_TOL, plan_margin=None) -> dict:
    """The NA rule: phrase plan identical; seq identical except where the
    plain path's top-2 margin is below ``noise``; tok_logprobs (where seq
    agrees) and entropy within ``lp_tol`` (None: reported only).

    With ``plan_margin`` (``plain_plan_margins``; the bf16 checks, whose
    encoder memory rounds apart from the plain path's), the margin rule
    covers the plan too: a sample's plan may differ if the plain bounding
    loop's margin at its first differing slot is below ``noise``; such a
    sample decodes another plan, and its seq is not compared."""
    plan_diff = torch.zeros_like(got["phrase_num"], dtype=torch.bool)
    for k in ("phrase_length", "phrase_syn"):
        plan_diff |= (got[k] != want[k]).any(-1)
    plan_diff |= got["phrase_num"] != want["phrase_num"]
    if plan_diff.any():
        if plan_margin is None:
            fail(f"{what}: the phrase plan differs")
        first = ((got["phrase_length"] != want["phrase_length"])
                 | (got["phrase_syn"] != want["phrase_syn"])).int().argmax(-1)
        at = plan_margin.gather(1, first[:, None])[:, 0]
        if (plan_diff & (at >= noise)).any():
            fail(f"{what}: the phrase plan differs above the noise margin "
                 f"{noise}")
    same = ~plan_diff
    diff = (got["seq"] != want["seq"]) & same[:, None]
    if (diff & (margin >= noise)).any():
        fail(f"{what}: seq differs above the noise margin {noise}")
    e_tok = (got["tok_logprobs"] - want["tok_logprobs"])[
        ~diff & same[:, None]].abs().max()
    e_ent = (got["entropy"] - want["entropy"])[same].abs().max()
    if lp_tol is not None and max(e_tok.item(), e_ent.item()) > lp_tol:
        fail(f"{what}: tok/entropy err {e_tok.item()} {e_ent.item()}")
    out = {"seq_differs_below_margin": int(diff.sum()),
           "tok_logprob_err": e_tok.item(), "entropy_err": e_ent.item()}
    if plan_margin is not None:
        out["plan_excused_samples"] = int(plan_diff.sum())
    return out


@torch.no_grad()
def check_decode(model):
    """float32: the whole-stack route (#4/#5) and the per-layer route
    (#1/#2) each against the plain path and against each other.  Returns
    the result and the per-layer route's launch counts (the run that reads
    #1 and #2)."""
    from boficap_tpu_torch.decode.bound_fill import fused_encode, na_decode
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    att, am = features(B, seed=2)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    mem_p = model.encode(att, am)
    out_p = na_decode(model, mem_p, src, fused_fill=False)
    margin = plain_margins(model, mem_p, src)
    res = {"tokens": int((out_p["seq"] > 3).sum()),
           "planned_words": int(out_p["phrase_length"].sum()),
           "margin_noise": MARGIN_NOISE}
    outs = {}
    for stacked in (True, False):
        route = "stacked" if stacked else "per_layer"
        torch.cuda.synchronize()
        reset_launch_counts()
        mem_k = fused_encode(model, att, am, stacked=stacked)
        out_k = na_decode(model, mem_k, src, fused_fill=True,
                          stacked=stacked)
        torch.cuda.synchronize()
        counts = launch_counts()
        kinds = ("stack",) if stacked else ("layer",)
        if any(counts[f"{part}_{k}"] == 0 for part in ("encoder", "decoder")
               for k in kinds):
            fail(f"na_decode {route}: its kernels never launched: {counts}")
        res[route] = {"memory_rel_err": rel_err(mem_k, mem_p),
                      **na_agree(out_k, out_p, margin, f"na_decode {route}")}
        outs[route] = out_k
    res["routes"] = na_agree(outs["stacked"], outs["per_layer"], margin,
                             "na_decode routes")
    return res, counts


# ---------------------------------------------------------------------------
# phase 5: sa_decode on both kernel routes against the plain path
# ---------------------------------------------------------------------------

@torch.no_grad()
def plain_sa(model, memory, src, **kw):
    """The plain sa_decode and each position's top-2 logprob margin [B, L].
    The margins come from the last round's logprob: a decoded position's
    logits never change after its round (its keys are final and its mask
    stays), so the last round holds every position's as decoded."""
    from boficap_tpu_torch.decode.bound_fill import sa_decode
    last = {}
    generate = model.generate

    def record(h):
        last["lp"] = generate(h)
        return last["lp"]

    model.generate = record
    try:
        out = sa_decode(model, memory, src, fused_fill=False, **kw)
    finally:
        del model.generate
    top2 = last["lp"].topk(2, dim=-1).values
    return out, top2[..., 0] - top2[..., 1]


def sa_agree(got, want, margin, what: str, noise: float = MARGIN_NOISE,
             lp_tol=LOGPROB_TOL) -> int:
    """The SA rule: phrase plan and seq identical, except in a sample whose
    first differing word lies where the plain path's top-2 margin is below
    ``noise`` (the words and plan after it follow the other word, so they
    are excused); tok_logprobs and entropy within ``lp_tol`` in every other
    sample (None: not compared).  Returns the count of excused samples."""
    diff = got["seq"] != want["seq"]
    has = diff.any(-1)
    first = diff.int().argmax(-1)
    loose = has & (margin.gather(1, first[:, None])[:, 0] < noise)
    if (has & ~loose).any():
        fail(f"{what}: seq differs above the noise margin {noise}")
    same = ~has
    for k in ("phrase_num", "phrase_length", "phrase_syn"):
        if not torch.equal(got[k][same], want[k][same]):
            fail(f"{what}: {k} differs")
    for k in ("tok_logprobs", "entropy"):
        e = (got[k][same] - want[k][same]).abs().max().item()
        if lp_tol is not None and e > lp_tol:
            fail(f"{what}: {k} err {e} > {lp_tol}")
    return int(loose.sum())


@torch.no_grad()
def check_sa_decode(model):
    """float32: the whole-stack route (#6/#7) and the per-layer route (#8)
    each against the plain path and against each other.  Returns the
    result and the per-layer route's launch counts (the run that reads
    #8)."""
    from boficap_tpu_torch.decode.bound_fill import fused_encode, sa_decode
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    att, am = features(B, seed=6)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    plain_stats = {}
    want, margin = plain_sa(model, model.encode(att, am), src,
                            stats=plain_stats)
    mem = fused_encode(model, att, am)
    # each round's longest new phrase; a round is narrow if it fits the
    # window.  The default window if both kinds of round occur there; else
    # the narrowest round's width (the wider rounds go wide); if every
    # round is as wide, that width (all narrow) and one less (all wide)
    widest = want["phrase_length"][:, :plain_stats["rounds"]].max(0).values
    lo, hi = int(widest.min()), int(widest.max())
    if lo <= W_NARROW < hi:
        windows = [W_NARROW]
    elif lo < hi:
        windows = [max(lo, 1)]
    elif lo > 1:
        windows = [lo, lo - 1]
    else:
        fail(f"sa_decode: every round's phrases are {lo} wide; no window "
             f"splits narrow from wide rounds")
    res = {"windows": windows, "round_widths": widest.tolist(),
           "tokens": int((want["seq"] > 3).sum()),
           "planned_words": int(want["phrase_length"].sum()),
           "margin_noise": MARGIN_NOISE}
    outs, counts = {}, None
    for stacked in (True, False):
        route = "stacked" if stacked else "per_layer"
        torch.cuda.synchronize()
        reset_launch_counts()
        rounds = {"rounds": 0, "narrow": 0, "wide": 0, "host_syncs": 0}
        excused = 0
        for window in windows:
            stats = {}
            out = sa_decode(model, mem, src, fused_fill=True, stacked=stacked,
                            window=window, stats=stats)
            excused += sa_agree(out, want, margin,
                                f"sa_decode {route} window {window}")
            rounds = {k: rounds[k] + stats[k] for k in rounds}
            outs[route, window] = out
        torch.cuda.synchronize()
        if not stacked:
            counts = launch_counts()
        if rounds["narrow"] == 0 or rounds["wide"] == 0:
            fail(f"sa_decode {route}: rounds {rounds} at windows {windows} "
                 f"(round widths {widest.tolist()}); narrow and wide must "
                 f"both occur")
        res[route] = {**rounds, "excused_samples": excused}
    res["routes_excused_samples"] = sum(
        sa_agree(outs["stacked", w], outs["per_layer", w], margin,
                 "sa_decode routes") for w in windows)
    if counts["window_layer"] == 0:
        fail("sa_decode: the per-layer route never launched window_layer")
    return res, counts


@torch.no_grad()
def check_bf16_decodes(model):
    """bfloat16, the default dtype: na_decode and sa_decode on the route
    the server takes (the whole-stack kernels) against the plain path in
    bfloat16, by the margin rule at BF16_MARGIN_NOISE: the phrase plan
    identical except where the plain bounding loop's margin is below it
    (NA; the SA rule excuses a sample from its first sub-margin word), seq
    identical except below the margin, and differing words at no more than
    a quarter of the positions decoded in the same context (NA: every
    position of a sample with the same plan; SA: a sample's positions up
    to its first differing word, after which its context differs);
    logprobs reported."""
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    att, am = features(B, seed=7)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    mem_p = model.encode(att, am)
    mem_k = fused_encode(model, att, am)
    out_p = na_decode(model, mem_p, src)
    out_k = na_decode(model, mem_k, src, fused_fill=True)
    na = na_agree(out_k, out_p, plain_margins(model, mem_p, src),
                  "bf16 na_decode", BF16_MARGIN_NOISE, None,
                  plain_plan_margins(model, mem_p, src))
    if (na["seq_differs_below_margin"] > out_p["seq"].numel() // 4
            or na["plan_excused_samples"] > B // 4):
        fail(f"bf16 na_decode: {na} differs at over a quarter of positions "
             f"or samples")
    want, margin = plain_sa(model, mem_p, src)
    stats = {}
    got = sa_decode(model, mem_k, src, fused_fill=True, stats=stats)
    excused = sa_agree(got, want, margin, "bf16 sa_decode", BF16_MARGIN_NOISE,
                       None)
    diff = got["seq"] != want["seq"]
    same = ~diff.any(-1)
    shared = int(torch.where(same, L, diff.int().argmax(-1) + 1).sum())
    if excused > shared // 4:
        fail(f"bf16 sa_decode: {excused} words differ in {shared} positions "
             f"of a shared context")
    return {"memory_rel_err": rel_err(mem_k, mem_p),
            "margin_noise": BF16_MARGIN_NOISE, "na_decode": na,
            "na_decode_b256_per_layer": check_bf16_per_layer(model),
            "sa_decode": {**stats, "excused_samples": excused,
                          "shared_context_positions": shared,
                          "tokens": int((want["seq"] > 3).sum()),
                          "tok_logprob_err": (got["tok_logprobs"][same]
                                              - want["tok_logprobs"][same]
                                              ).abs().max().item()}}


@torch.no_grad()
def check_bf16_per_layer(model):
    """bfloat16 at B = 256, past the whole-stack route: fused_encode and
    na_decode run #1 and #2 themselves (their tensor-core products), held
    against the plain path in bfloat16 by the margin rule, with #1's and
    #2's launches read around the kernel run."""
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     use_stacked)
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    if use_stacked(model, B_WIDE):
        fail(f"B = {B_WIDE} takes the whole-stack route")
    att, am = features(B_WIDE, seed=8)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    mem_p = model.encode(att, am)
    out_p = na_decode(model, mem_p, src)
    torch.cuda.synchronize()
    reset_launch_counts()
    mem_k = fused_encode(model, att, am)
    out_k = na_decode(model, mem_k, src, fused_fill=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["encoder_layer"] == 0 or counts["decoder_layer"] == 0:
        fail(f"bf16 na_decode B = {B_WIDE}: #1/#2 never launched: {counts}")
    na = na_agree(out_k, out_p, plain_margins(model, mem_p, src),
                  f"bf16 na_decode B = {B_WIDE}", BF16_MARGIN_NOISE, None,
                  plain_plan_margins(model, mem_p, src))
    if (na["seq_differs_below_margin"] > out_p["seq"].numel() // 4
            or na["plan_excused_samples"] > B_WIDE // 4):
        fail(f"bf16 na_decode B = {B_WIDE}: {na} differs at over a quarter "
             f"of positions or samples")
    return {"batch": B_WIDE, "memory_rel_err": rel_err(mem_k, mem_p),
            "tokens": int((out_p["seq"] > 3).sum()), "launches": counts,
            **na}


# ---------------------------------------------------------------------------
# phase 8: the attention core against its plain version
# ---------------------------------------------------------------------------

def attention_cases(dtype, seed: int = 21, regions: int = R):
    """#9's operands as MultiHeadAttention.attend hands them over (views of
    [B, L, H, Dh] projections, masks expanded over the query rows), by
    case: (q, k, v, mask).  Padded regions, and a fully masked sample or
    row in each case but the AR step's self-attention (ar_self_cases),
    where every key written is visible."""
    g = torch.Generator().manual_seed(seed)
    H = 8
    Dh = D // H

    def heads(n, rows):
        return torch.randn((n, rows, H, Dh), generator=g).to(DEV, dtype)

    def padded(n, keys):
        live = torch.randint(1, keys + 1, (n,), generator=g)
        live[0] = 0                                     # fully masked
        return (torch.arange(keys)[None, :] < live[:, None]).to(DEV)

    def rows2(mask, Lq):
        return mask[:, None, :].expand(mask.shape[0], Lq, mask.shape[1])

    q1 = torch.randn((1, 1, H, Dh), generator=g).to(DEV, dtype)
    prefix = torch.randint(0, L + 3, (B,), generator=g)
    r3 = torch.rand((B, L, L), generator=g) < 0.6
    r3[3, 5] = False                                    # a fully masked row
    BK = B * K_BEAM
    cases = {
        # the AR step's cross-attention: one query row over 36 regions
        "ar_cross": (heads(B, 1), heads(B, regions), heads(B, regions),
                     rows2(padded(B, regions), 1)),
        # the bounding step's self-attention: the [LEN] query broadcast over
        # the batch (sample stride 0), keys < prefix visible
        "bound_self": (q1.expand(B, 1, H, Dh), heads(B, L + 2),
                       heads(B, L + 2),
                       (torch.arange(L + 2)[None, None, :]
                        < prefix[:, None, None]).to(DEV)),
        # the beam's cross-attention over B*K rows
        "beam_cross": (heads(BK, 1), heads(BK, R), heads(BK, R),
                       rows2(padded(BK, R), 1)),
        # an encoder self-attention (plain encode under use_pallas)
        "encoder_self": (heads(B, R), heads(B, R), heads(B, R),
                         rows2(padded(B, R), R)),
        # a rank-3 mask (the plain NA fill under use_pallas)
        "rank3": (heads(B, L), heads(B, L), heads(B, L), r3.to(DEV)),
    }
    return {**{name: (q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), m)
               for name, (q, k, v, m) in cases.items()},
            **ar_self_cases(dtype, B, g)}


# the KV-cached AR step's self-attention: the keys 0..pos of an L + 1 row
# cache at its first, middle and last step
AR_SELF_KEYS = (1, L // 2 + 1, L + 1)
# the batch of the benchmark's AR cell (transformer.ar_offline_b16384)
AR_CELL_B = 16384


def ar_self_cases(dtype, n: int, g) -> dict:
    """#9's operands on the KV-cached AR step's self-attention as
    Decoder.step and DecoderLayer.step hand them over, n samples, by key
    count k of AR_SELF_KEYS (case ``ar_self_{k}``): one query row; K and V
    the views [:, :k] of [n, L + 1, H, Dh] caches (the sample stride the
    whole cache's), transposed; the mask keep[None, :k] of an all-True
    [L + 1] row, expanded over the samples and the row (strides 0)."""
    H, Dh = 8, D // 8

    def heads(rows):
        return torch.randn((n, rows, H, Dh), generator=g).to(
            DEV, dtype).transpose(1, 2)

    ks, vs = heads(L + 1), heads(L + 1)
    keep = torch.ones(L + 1, dtype=torch.bool, device=DEV)
    return {f"ar_self_{k}": (heads(1), ks[:, :, :k], vs[:, :, :k],
                             keep[None, :k].expand(n, k)[:, None, :]
                             .expand(n, 1, k))
            for k in AR_SELF_KEYS}


# the cases of a decode step (one query row): they take the row path
ROW_CASES = ("ar_cross", "bound_self", "beam_cross",
             *(f"ar_self_{k}" for k in AR_SELF_KEYS))


def dtype_paths(dtype):
    """The attention block's paths at ``dtype`` (ops.attention.PATHS)."""
    return (("row", "tile") if dtype == torch.bfloat16 else
            ("row", "ffma", "ffma_long"))


def other_paths_ms(q, k, v, m, dtype) -> dict:
    """#9's device ms on each path of the dtype but attention_path's,
    forced, where the wrapper takes it (the row path past its key bound and
    a block past the shared memory are refused before any launch)."""
    from boficap_tpu_torch.ops import attention as at
    path = at.attention_path(q.shape[2], k.shape[2], dtype)
    out = {}
    for p in dtype_paths(dtype):
        if p == path:
            continue
        try:
            at.check_operands(q, k, v, m, p)
        except ValueError:
            continue
        out[p] = device_ms(lambda p=p: at.attention_core(q, k, v, m, path=p))
    return out


def check_attention():
    """#9 against its plain twin on every case, float32 and bfloat16: the
    path attention_path gives (the decode steps' cases: the row path), and
    each other path the dtype has (row and tile at bf16, row, ffma and
    ffma_long at float32), forced, each within TOL."""
    from boficap_tpu_torch.ops import attention as at
    res = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = TOL[dtype_name]
        res[dtype_name] = {}
        paths = dtype_paths(dtype)
        for name, (q, k, v, m) in attention_cases(dtype).items():
            path = at.attention_path(q.shape[2], k.shape[2], dtype)
            if name in ROW_CASES and path != "row":
                fail(f"attention_core {name} {dtype_name}: path {path}, "
                     f"not the row path")
            want = at.attention_core_plain(q, k, v, m)
            errs = {}
            for forced in (None, *paths):
                got = at.attention_core(q, k, v, m, path=forced)
                torch.cuda.synchronize()
                e = rel_err(got, want)
                if not torch.isfinite(got.float()).all() or e > tol:
                    fail(f"attention_core {name} {dtype_name} path "
                         f"{forced or path}: rel err {e} > {tol}")
                errs[forced or "auto"] = {
                    "rel_err": e, "max_abs_err": (got.float() - want.float())
                    .abs().max().item()}
            res[dtype_name][name] = {
                "shape_q_k": [list(q.shape), list(k.shape)],
                "q_strides": list(q.stride()),
                "mask_strides": list(m.stride()),
                "path": path, "by_path": errs, **errs["auto"]}
    return res


# ---------------------------------------------------------------------------
# phase 9: the AR decodes with use_pallas on against off
# ---------------------------------------------------------------------------

@torch.no_grad()
def plain_ar(model, decode, *args, **kw):
    """A decode with the model as it is, and each AR step's top-2 logprob
    margin [B, steps] (recorded at the generator: no decode option is used
    here, so that is the distribution each step picks from)."""
    gaps = []
    generate = model.generate

    def record(h):
        lp = generate(h)
        top2 = lp.topk(2, dim=-1).values
        # [B, 1] a step: a transformer's h is [B, 1, D], an LSTM's [B, D]
        gaps.append((top2[..., 0] - top2[..., 1]).reshape(h.shape[0], -1))
        return lp

    model.generate = record
    try:
        out = decode(model, *args, **kw)
    finally:
        del model.generate
    return out, torch.cat(gaps, -1)


def ar_agree(got, want, margin, what: str, noise: float = MARGIN_NOISE,
             lp_tol=LOGPROB_TOL, plan: bool = False,
             keys=("tok_logprobs", "entropy")) -> dict:
    """The AR rule (the SA rule without rounds): seq identical, except in a
    sample whose first differing word lies where the plain run's top-2
    margin is below ``noise`` (the later words follow the other word);
    ``keys`` (tok_logprobs and entropy) within ``lp_tol`` in every other
    sample (None: reported only).  ``plan``: the phrase plan identical in
    every sample."""
    if plan:
        for k in ("phrase_num", "phrase_length", "phrase_syn"):
            if not torch.equal(got[k], want[k]):
                fail(f"{what}: {k} differs")
    diff = got["seq"] != want["seq"]
    has = diff.any(-1)
    first = diff.int().argmax(-1)
    loose = has & (margin.gather(1, first[:, None])[:, 0] < noise)
    if (has & ~loose).any():
        fail(f"{what}: seq differs above the noise margin {noise}")
    same = ~has
    errs = {k: (got[k][same] - want[k][same]).abs().max().item()
            for k in keys}
    if lp_tol is not None and max(errs.values()) > lp_tol:
        fail(f"{what}: tok/entropy err {errs} > {lp_tol}")
    return {"excused_samples": int(loose.sum()),
            "tokens": int((want["seq"] > 3).sum()),
            "rows": int(want["seq"].shape[0]),
            "ended_rows": int((want["seq"] == 2).any(-1).sum()),
            **{f"{k}_err": v for k, v in errs.items()}}


@torch.no_grad()
def beam_margins(model, memory, src, K: int):
    """ar_beam_search with the model as it is, and per sample the smallest
    gap between neighbouring entries of any top-K selection it made (the
    candidates and the done-pool merges; NEG_INF fillers left out)."""
    from boficap_tpu_torch.decode import ar
    return topk_margins(lambda: ar.ar_beam_search(model, memory, src,
                                                  beam_size=K),
                        memory.shape[0], memory.device)


@torch.no_grad()
def topk_margins(decode, n: int, device=DEV):
    """decode()'s outputs and, for each of its ``n`` samples, the smallest
    gap between neighbouring entries of any top-K selection it made (every
    beam search's candidates and done-pool merges; NEG_INF and -inf
    entries left out), on ``device`` (the decode's)."""
    from boficap_tpu_torch.decode import ar
    from boficap_tpu_torch.decode.sampling import NEG_INF
    top_k = ar._top_k
    mins = torch.full((n,), math.inf, device=device)

    def record(x, k):
        vals, idx = top_k(x, min(k + 1, x.shape[-1]))
        gap = torch.where(vals[..., 1:] > NEG_INF / 2,
                          vals[..., :-1] - vals[..., 1:], math.inf)
        mins.copy_(torch.minimum(mins, gap.min(-1).values))
        return vals[..., :k], idx[..., :k]

    ar._top_k = record
    try:
        out = decode()
    finally:
        ar._top_k = top_k
    return out, mins


def beam_agree(got, want, mins, what: str, noise: float = MARGIN_NOISE,
               lp_tol=LOGPROB_TOL, keys=("scores", "tok_logprobs")) -> dict:
    """Beams identical, and ``keys`` (scores, token log-probs) within
    ``lp_tol`` (None: reported only), except in a sample whose selections
    had a gap below ``noise``."""
    diff = (got["seq"] != want["seq"]).flatten(1).any(-1)
    loose = diff & (mins < noise)
    if (diff & ~loose).any():
        fail(f"{what}: beams differ above the noise margin {noise}")
    same = ~diff
    errs = {k: (got[k][same] - want[k][same]).abs().max().item()
            for k in keys}
    if lp_tol is not None and max(errs.values()) > lp_tol:
        fail(f"{what}: score/logprob err {errs}")
    return {"excused_samples": int(loose.sum()),
            **{f"{k}_err": v for k, v in errs.items()}}


@torch.no_grad()
def with_core(model, enabled: bool, fn):
    """fn() with the model's attention-core routing set, then reset off."""
    model.set_attention_core(enabled)
    try:
        return fn()
    finally:
        model.set_attention_core(False)


@torch.no_grad()
def counted(fn):
    """fn()'s result and the launch counts of its run."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


@torch.no_grad()
def check_ar_decodes(aic, uic_s, uic_sd):
    """float32, B = 64: each AR decode and the NA decode with use_pallas on
    (#9) against off (the plain attend), on the same encoder memory."""
    from boficap_tpu_torch.decode.ar import ar_beam_search, ar_sample
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     uic_s_ar_decode)
    att, am = features(B, seed=17)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    NLd = aic.N_dec
    res = {"margin_noise": MARGIN_NOISE}

    mem = fused_encode(aic, att, am)
    want, margin = plain_ar(aic, ar_sample, mem, src)
    got, c = counted(lambda: with_core(aic, True,
                                       lambda: ar_sample(aic, mem, src)))
    if c["attention_core"] != 2 * NLd * L:
        fail(f"ar_sample: attention_core launched {c['attention_core']} "
             f"times, not 2 x {NLd} layers x {L} steps")
    res["ar_sample"] = {**ar_agree(got, want, margin, "ar_sample"),
                        "attention_core_launches": c["attention_core"]}

    want, mins = beam_margins(aic, mem, src, K_BEAM)
    got, c = counted(lambda: with_core(aic, True, lambda: ar_beam_search(
        aic, mem, src, beam_size=K_BEAM)))
    if c["attention_core"] != 2 * NLd * L:
        fail(f"ar_beam_search: attention_core launched {c['attention_core']}")
    res["ar_beam_search"] = {"beam_size": K_BEAM,
                             **beam_agree(got, want, mins, "ar_beam_search"),
                             "attention_core_launches": c["attention_core"]}

    mem = fused_encode(uic_s, att, am)
    want, margin = plain_ar(uic_s, uic_s_ar_decode, mem, src)
    got, c = counted(lambda: with_core(uic_s, True, lambda: uic_s_ar_decode(
        uic_s, mem, src)))
    if c["attention_core"] != 2 * L + 2 * uic_s.N_dec * L:
        fail(f"uic_s_ar_decode: attention_core launched "
             f"{c['attention_core']}, not 2 x {L} bounding + "
             f"2 x {uic_s.N_dec} x {L} AR")
    res["uic_s_ar_decode"] = {
        **ar_agree(got, want, margin, "uic_s_ar_decode", plan=True),
        "planned_words": int(want["phrase_length"].sum()),
        "attention_core_launches": c["attention_core"]}

    mem = fused_encode(uic_sd, att, am)
    want = na_decode(uic_sd, mem, src, fused_fill=True)
    got, c = counted(lambda: with_core(uic_sd, True, lambda: na_decode(
        uic_sd, mem, src, fused_fill=True)))
    if c["attention_core"] != 2 * L:
        fail(f"na_decode: attention_core launched {c['attention_core']}, "
             f"not 2 x {L} bounding steps")
    res["na_decode"] = {**na_agree(got, want, plain_margins(uic_sd, mem, src),
                                   "na_decode use_pallas"),
                        "attention_core_launches": c["attention_core"]}
    return res


@torch.no_grad()
def check_bf16_ar(aic16):
    """bfloat16, the default dtype: the AR decode as the server runs it
    (the encoder-stack kernel, #9 on) against the plain path (plain encode
    and attend) in bfloat16, by the AR rule at BF16_MARGIN_NOISE, with at
    most a quarter of the shared-context positions excused."""
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import fused_encode
    att, am = features(B, seed=18)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    want, margin = plain_ar(aic16, ar_sample, aic16.encode(att, am), src)
    got = with_core(aic16, True, lambda: ar_sample(
        aic16, fused_encode(aic16, att, am), src))
    res = ar_agree(got, want, margin, "bf16 ar_sample", BF16_MARGIN_NOISE,
                   None)
    diff = got["seq"] != want["seq"]
    shared = int(torch.where(diff.any(-1), diff.int().argmax(-1) + 1,
                             L).sum())
    if res["excused_samples"] > shared // 4:
        fail(f"bf16 ar_sample: {res} in {shared} shared-context positions")
    return {"margin_noise": BF16_MARGIN_NOISE,
            "shared_context_positions": shared, **res}


# ---------------------------------------------------------------------------
# phases 4 and 6: serving (the main paths)
# ---------------------------------------------------------------------------

@torch.no_grad()
def replay_batches(model, mode: str, att, am, outs, routes=None):
    """Each request's seq from a direct decode of the same features in the
    batch the server formed: one worker takes requests in order, so the
    batches are consecutive runs whose sizes the results report; each batch
    is padded as the server pads it, and decoded by the program the server
    kept for its bucket (``routes``, CaptionServer.routes: the kernel
    program, fused_encode and the fused fill, or the plain one, the
    model's encode and the plain fill; None: the kernel program).  (A
    batch's rows are decoded independently, but the SA rounds' narrow/wide
    choice is the batch's.)"""
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    from boficap_tpu_torch.serve import _buckets
    buckets = _buckets(B)
    want, i = [], 0
    for n in batch_sizes(outs):
        bucket = next(b for b in buckets if b >= n)
        fused = routes is None or routes[bucket]["route"] == "fused"
        a = torch.zeros((bucket, R, att.shape[-1]))
        m = torch.zeros((bucket, R))
        a[:n], m[:n] = att[i:i + n], am[i:i + n]
        m[n:, 0] = 1.0
        a, m = a.to(DEV), m.to(DEV)
        memory = fused_encode(model, a, m) if fused else model.encode(a, m)
        if mode == "AIC":
            out = ar_sample(model, memory, m.bool())
        else:
            decode = na_decode if mode == "NAIC" else sa_decode
            out = decode(model, memory, m.bool(), fused_fill=fused)
        want.append(out["seq"][:n].cpu())
        i += n
    return torch.cat(want)


def batch_sizes(outs):
    """The server's batches, in order, from the sizes its results report."""
    sizes, i = [], 0
    while i < len(outs):
        sizes.append(outs[i]["batch"])
        i += sizes[-1]
    return sizes


def serve_requests():
    """Eight single requests, a burst of 64 and eight short-region ones
    (features with their padding as the server pads them)."""
    n_single, n_burst, n_short = 8, 64, 8
    n = n_single + n_burst + n_short
    att, am = features(n, seed=3)
    short = [10 + 3 * i for i in range(n_short)]       # 10 .. 31 regions
    for j, k in enumerate(short):
        i = n_single + n_burst + j
        att[i, k:] = 0.0
        am[i] = (torch.arange(R) < k).float()
    return att, am, n_single, n_burst, short


@torch.no_grad()
def check_serve(model, mode: str, kernels, route: str = "fused"):
    """The requests of serve_requests through CaptionServer(route=route),
    each answer against a direct decode of the program its bucket kept,
    the kernels' launches read around the requests alone.  route='fused'
    (the main path) must launch ``kernels``; under 'auto' the server warms
    every bucket at construction, timing both programs, keeps the plain
    one only where it wins by more than the repeats' spread, and the
    result holds each bucket's choice, both times and the spread
    (``routes``)."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.serve import CaptionServer
    att, am, n_single, n_burst, short = serve_requests()
    n = att.shape[0]
    ix_to_word = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}
    t_warm = time.perf_counter()
    srv = CaptionServer(model, ix_to_word, mode=mode, max_batch=B,
                        max_wait_ms=5.0, max_regions=R, route=route,
                        warm=route == "auto", device=DEV)
    warm_s = time.perf_counter() - t_warm
    try:
        torch.cuda.synchronize()
        reset_launch_counts()                       # the main path starts
        t0 = time.perf_counter()
        outs = [srv.submit(att[i].numpy(), am[i].numpy()).wait(timeout=300)
                for i in range(n_single)]
        tb = time.perf_counter()
        futs = [srv.submit(att[i].numpy(), am[i].numpy())
                for i in range(n_single, n_single + n_burst)]
        outs += [f.wait(timeout=300) for f in futs]
        burst_s = time.perf_counter() - tb
        futs = [srv.submit(att[i, :k].numpy())
                for i, k in zip(range(n_single + n_burst, n), short)]
        outs += [f.wait(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        counts = launch_counts()                    # ... and ends
        stats = srv.stats()
    finally:
        srv.close()
    if not all(isinstance(o["caption"], str) for o in outs):
        fail(f"serve {mode}: a request got no string caption")
    got = torch.stack([torch.as_tensor(o["seq"]) for o in outs])
    routes = dict(srv.routes)
    mism = (got != replay_batches(model, mode, att, am, outs, routes)
            ).any(-1)
    if mism.any():
        fail(f"serve {mode} {route}: {int(mism.sum())} requests' seq differ "
             f"from a direct decode of the same features by the program "
             f"kept")
    if route == "fused":
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"serve {mode}: {missing} never launched on the main "
                 f"path: {counts}")
    if route == "auto" and mode != "AIC":
        timed = [b for b, r in routes.items()
                 if r["fused_ms"] is None or r["unfused_ms"] is None]
        if timed or len(routes) != len(srv.buckets):
            fail(f"serve {mode} auto: buckets {timed} of {routes} were not "
                 f"timed on both programs")
        wrong = [b for b, r in routes.items()
                 if (r["route"] == "unfused") != (
                     r["unfused_ms"] < r["fused_ms"] - r["spread_ms"])]
        if wrong:
            fail(f"serve {mode} auto: buckets {wrong} of {routes} broke the "
                 f"rule (plain only where it wins by more than the spread)")
    return {"mode": mode, "dtype": str(model.dtype).split(".")[-1],
            "route": route, "routes": routes, "warm_s": warm_s,
            "requests": n, "launches": counts,
            "batch_sizes": batch_sizes(outs),
            "requests_per_s": n / wall, "burst64_requests_per_s":
                n_burst / burst_s,
            "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
            "captions_nonempty": sum(bool(o["caption"]) for o in outs),
            "example": outs[0]["caption"][:80]}


# ---------------------------------------------------------------------------
# phase 11: evaluation (checkpoint files, eval_split, the eval CLI)
# ---------------------------------------------------------------------------

EVAL_IMAGES = 960             # synthetic corpus: a test split of 192 = 3 x B
EVAL_MODES = ("NAIC", "SAIC")
# the kernels each eval route must launch: the bf16 model takes the
# whole-stack kernels at B = 64, the float32 one the per-layer kernels;
# AIC runs with use_pallas on (the attention core)
EVAL_KERNELS = {("NAIC", "bfloat16"): NA_KERNELS,
                ("SAIC", "bfloat16"): SA_KERNELS,
                ("AIC", "bfloat16"): AIC_KERNELS,
                ("NAIC", "float32"): ("encoder_layer", "decoder_layer",
                                      "greedy_head"),
                ("SAIC", "float32"): ("encoder_layer", "window_layer",
                                      "greedy_head"),
                ("AIC", "float32"): ("encoder_layer", "attention_core")}
CLI_DECODE_LINE = r"decode_time [0-9.]+s \(compile [0-9.]+s\), images/s " \
                  r"([0-9.]+|nan)"


def eval_opt(config: str, **fields):
    """A shipped config as the eval reads it (the port's full option
    defaults, finalized), over the in-memory synthetic corpus."""
    from boficap_tpu_torch.config import (default_config, finalize,
                                          load_yaml_with_base)
    opt = default_config()
    opt.update(load_yaml_with_base(os.path.join(HERE, "configs", config)))
    opt.update(input_json="synthetic", input_att_dir="synthetic",
               data_prefetch=0, **fields)
    return finalize(opt)


def eval_loader(opt):
    """B = 64 over a 960-image synthetic corpus of the full vocabulary."""
    from boficap_tpu_torch.data.dataset import CaptionData, LabelStore
    labels = LabelStore.synthetic(n_images=EVAL_IMAGES, vocab_size=VOCAB,
                                  L=L, seed=0)
    return CaptionData(opt, labels=labels)


def write_checkpoint(model, opt, loader, path: str) -> dict:
    """model.ckpt and infos_<id>.pkl as tools/train.py lays them out,
    written by the port (the card has no JAX to write them with)."""
    import types
    from boficap_tpu_torch.convert import to_jax_tree
    from boficap_tpu_torch.train.state import save_checkpoint
    infos = {"iter": 0, "epoch": 0, "loader_state_dict": loader.state_dict(),
             "vocab": loader.ix_to_word, "opt": dict(opt),
             "best_val_score": None,
             "plateau": {"best": None, "num_bad": 0}}
    t0 = time.perf_counter()
    save_checkpoint(types.SimpleNamespace(checkpoint_path=path, id=opt.id),
                    to_jax_tree(model), infos)
    return {"infos": infos, "write_s": time.perf_counter() - t0}


@torch.no_grad()
def round_trip(model, opt, loader, path: str):
    """The full-width model through the port's writer and reader: every
    parameter bitwise, the infos equal."""
    from boficap_tpu_torch.convert import load_jax_checkpoint
    from boficap_tpu_torch.models import setup
    from boficap_tpu_torch.train.state import load_infos
    w = write_checkpoint(model, opt, loader, path)
    ckpt = os.path.join(path, "model.ckpt")
    loaded = setup(opt, loader.vocab_size, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_jax_checkpoint(ckpt, loaded)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = dict(model.named_parameters())
    got = dict(loaded.named_parameters())
    if sorted(got) != sorted(want):
        fail("checkpoint round trip: the parameter names differ")
    differ = [n for n in want if not torch.equal(got[n], want[n])]
    if differ:
        fail(f"checkpoint round trip: {len(differ)} parameters differ, "
             f"e.g. {differ[:3]}")
    infos = load_infos(path, opt.id)
    if (infos["opt"] != w["infos"]["opt"]
            or infos["vocab"] != w["infos"]["vocab"]):
        fail("checkpoint round trip: the infos differ")
    return loaded.eval(), {
        "file_bytes": os.path.getsize(ckpt), "parameters": len(want),
        "elements": sum(p.numel() for p in want.values()),
        "write_s": w["write_s"], "read_s": read_s, "bitwise": True}


def recording(make, log, models=None):
    """``eval_utils.make_decoders`` wrapped: each decode call's (memory,
    src_mask, outputs) appended to ``log``, and each model it is made for
    to ``models``."""
    def make_recording(m, kwargs):
        if models is not None:
            models.append(m)
        dec = make(m, kwargs)

        def wrap(f):
            def g(memory, src_mask):
                out = f(memory, src_mask)
                log.append((memory, src_mask, out))
                return out
            return g
        return {k: v if k in ("encode", "sample_n") else wrap(v)
                for k, v in dec.items()}
    return make_recording


@torch.no_grad()
def run_eval(model, loader, mode: str, flag: str, kw: dict):
    """eval_split with use_cuda_fill=flag; returns its result, each decode
    call's (memory, src_mask, outputs) and the launch counts of the run."""
    from boficap_tpu_torch.eval import eval_utils
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    log = []
    make = eval_utils.make_decoders
    eval_utils.make_decoders = recording(make, log)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()                       # the eval path starts
        res = eval_utils.eval_split(model, loader,
                                    {**kw, "use_cuda_fill": flag}, mode)
        torch.cuda.synchronize()
        counts = launch_counts()                    # ... and ends
    finally:
        eval_utils.make_decoders = make
    return res, log, counts


def shared_context(got, want) -> int:
    """Decoded positions whose context both runs share: a whole row where
    seq agrees, else up to the first differing word."""
    diff = got["seq"] != want["seq"]
    return int(torch.where(diff.any(-1), diff.int().argmax(-1) + 1,
                           got["seq"].shape[-1]).sum())


def eval_pair(model, loader, mode: str, dtype_name: str, kw: dict,
              kernels, agree, core: bool = False) -> dict:
    """eval_split on the plain path (use_cuda_fill=0, on the card) and on
    the kernels (auto; with ``core``, use_pallas on: the attention core);
    ``agree(out_k, out_p, memory_p, src)`` holds each batch's decode
    outputs by the margin rule."""
    plain, log_p, counts_p = run_eval(model, loader, mode, "0", kw)
    if any(counts_p.values()):
        fail(f"eval {mode} {dtype_name} plain: kernels launched: {counts_p}")
    kern, log_k, counts = with_core(model, core, lambda: run_eval(
        model, loader, mode, "auto", kw))
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        fail(f"eval {mode} {dtype_name}: {missing} never launched on the "
             f"eval path: {counts}")
    if len(log_k) != len(log_p) or not log_k:
        fail(f"eval {mode} {dtype_name}: {len(log_k)} kernel decodes, "
             f"{len(log_p)} plain")
    batches = [agree(out_k, out_p, mem_p, src)
               for (_, src, out_k), (mem_p, _, out_p) in zip(log_k, log_p)]
    for r in (kern, plain):
        if not all(isinstance(p["caption"], str) for p in r["predictions"]):
            fail(f"eval {mode} {dtype_name}: a caption is not a string")
        if not math.isfinite(r["images_per_s"]):
            fail(f"eval {mode} {dtype_name}: images_per_s "
                 f"{r['images_per_s']}")
    same = sum(a["caption"] == b["caption"] for a, b in
               zip(kern["predictions"], plain["predictions"]))
    return {"images": kern["n_images"], "decodes": len(log_k),
            "images_per_s": kern["images_per_s"],
            "plain_images_per_s": plain["images_per_s"],
            "decode_time_s": kern["decode_time"],
            "plain_decode_time_s": plain["decode_time"],
            "first_batch_s": kern["compile_time"],
            "captions_equal": same, "launches": counts,
            "captions_nonempty": sum(bool(p["caption"])
                                     for p in kern["predictions"]),
            "lang_stats_keys": sorted(kern["lang_stats"]),
            "CIDEr": kern["lang_stats"]["CIDEr"],
            "plain_CIDEr": plain["lang_stats"]["CIDEr"],
            "batches": batches,
            **({"loss": kern["loss"], "plain_loss": plain["loss"]}
               if kw.get("verbose_loss") else {})}


def differing_samples(got, want, margin) -> list:
    """Each sample whose seq differs from the plain path's: its first
    differing position and the plain path's top-2 margin there."""
    diff = got["seq"] != want["seq"]
    first = diff.int().argmax(-1)
    return [{"sample": r, "position": int(first[r]),
             "margin": float(margin[r, first[r]])}
            for r in diff.any(-1).nonzero()[:, 0].tolist()]


def na_eval_agree(model, bf16: bool):
    def agree(got, want, memory, src):
        if not bf16:
            margin = plain_margins(model, memory, src)
            return {**na_agree(got, want, margin, "eval NAIC float32"),
                    "differing_samples": differing_samples(got, want,
                                                           margin)}
        res = na_agree(got, want, plain_margins(model, memory, src),
                       "eval NAIC bf16", BF16_MARGIN_NOISE, None,
                       plain_plan_margins(model, memory, src))
        if (res["seq_differs_below_margin"] > want["seq"].numel() // 4
                or res["plan_excused_samples"] > want["seq"].shape[0] // 4):
            fail(f"eval NAIC bf16: {res} differs at over a quarter of "
                 f"positions or samples")
        return res
    return agree


def sa_eval_agree(model, bf16: bool):
    def agree(got, want, memory, src):
        _, margin = plain_sa(model, memory, src)
        noise, tol = ((BF16_MARGIN_NOISE, None) if bf16
                      else (MARGIN_NOISE, LOGPROB_TOL))
        excused = sa_agree(got, want, margin, "eval SAIC", noise, tol)
        shared = shared_context(got, want)
        if bf16 and excused > shared // 4:
            fail(f"eval SAIC bf16: {excused} words differ in {shared} "
                 f"positions of a shared context")
        return {"excused_samples": excused,
                "shared_context_positions": shared,
                **({} if bf16 else {"differing_samples": differing_samples(
                    got, want, margin)})}
    return agree


def ar_eval_agree(model, bf16: bool):
    from boficap_tpu_torch.decode.ar import ar_sample

    def agree(got, want, memory, src):
        _, margin = plain_ar(model, ar_sample, memory, src)
        if not bf16:
            return ar_agree(got, want, margin, "eval AIC float32")
        res = ar_agree(got, want, margin, "eval AIC bf16", BF16_MARGIN_NOISE,
                       None)
        shared = shared_context(got, want)
        if res["excused_samples"] > shared // 4:
            fail(f"eval AIC bf16: {res} in {shared} shared-context "
                 f"positions")
        return {"shared_context_positions": shared, **res}
    return agree


def beam_eval_agree(model, bf16: bool):
    """beam_agree; at bf16 at BF16_MARGIN_NOISE with no cap on the samples
    it excuses: there most samples' selections have a gap below it (the
    done pool merges many ended beams of near-equal score), and a beam of
    such a sample may differ (49 of 64 samples at full uic_sd width on an
    H100, random weights); the top beam's differences and score error are
    reported, and, at both dtypes, the excused samples' smallest gaps and
    the done pools' ended beams (EOS before the last step) and the pools
    holding ended beams of two lengths."""
    def agree(got, want, memory, src):
        _, mins = beam_margins(model, memory, src, K_BEAM)
        diff = (got["seq"] != want["seq"]).flatten(1).any(-1)
        noise = BF16_MARGIN_NOISE if bf16 else MARGIN_NOISE
        gaps = sorted(mins[diff & (mins < noise)].tolist())
        ends = torch.where((want["seq"] == 2).any(-1),
                           (want["seq"] == 2).int().argmax(-1), L)
        pools = {"excused_gaps": gaps,
                 "ended_beams": int((ends < L - 1).sum()),
                 "beams": int(ends.numel()),
                 "two_length_pools": int((ends.min(-1).values
                                          != ends.max(-1).values).sum())}
        if not bf16:
            return {**beam_agree(got, want, mins, "eval AIC beam float32"),
                    **pools}
        res = beam_agree(got, want, mins, "eval AIC beam bf16",
                         BF16_MARGIN_NOISE, None)
        top = (got["seq"][:, 0] != want["seq"][:, 0]).any(-1)
        return {**res, "top_beam_differs": int(top.sum()),
                "top_score_err": (got["scores"][:, 0] - want["scores"][:, 0]
                                  ).abs().max().item(), **pools}
    return agree


def eval_cli(path: str) -> dict:
    """``python -m boficap_tpu_torch.tools.eval`` in a process of its own,
    from an empty working directory, on a checkpoint at uic_sd's layer
    widths over the CLI's own synthetic corpus (40 words), SAIC then NAIC:
    exit 0, the decode_time line, vis/vis.json with a caption per test
    image."""
    import re
    from boficap_tpu_torch.data.dataset import CaptionData
    opt = eval_opt("uic_sd.yml", id="smokecli")
    loader = CaptionData(opt)
    model = build(None, vocab=loader.vocab_size)
    write_checkpoint(model, opt, loader, path)
    n_test = len(loader.split_ix["test"])
    out = {"vocab": loader.vocab_size, "test_images": n_test}
    for mode in ("SAIC", "NAIC"):
        cwd = os.path.join(path, f"cli_{mode}")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "boficap_tpu_torch.tools.eval",
             "--model", os.path.join(path, "model.ckpt"),
             "--infos_path", os.path.join(path, "infos_smokecli.pkl"),
             "--inference_mode", mode, "--language_eval", "1",
             "--num_images", "-1"],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"eval CLI {mode}: exit {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        line = re.search(CLI_DECODE_LINE, run.stdout)
        if line is None:
            fail(f"eval CLI {mode}: no decode_time line in {run.stdout!r}")
        with open(os.path.join(cwd, "vis", "vis.json")) as f:
            vis = json.load(f)
        if len(vis) != n_test or not all(isinstance(p["caption"], str)
                                         for p in vis):
            fail(f"eval CLI {mode}: vis.json holds {len(vis)} entries for "
                 f"{n_test} test images")
        out[mode] = {"exit": 0, "wall_s": wall, "decode_line": line.group(0),
                     "captions": len(vis),
                     "captions_nonempty": sum(bool(p["caption"])
                                              for p in vis),
                     "example": vis[0]["caption"][:80]}
    return out


def check_eval(model16, aic16, aic):
    """Phase eval: the full-width bf16 uic_sd model (random weights, plans
    nudged) through the port's checkpoint writer and reader, bitwise; then
    eval_split at B = 64 on the loaded model and on a float32 model loaded
    from the same file, NAIC and SAIC, kernels against the plain path on
    the card; AIC (transformer.yml, bf16 and float32) greedy and beam,
    use_pallas on against off; and the eval CLI in a subprocess."""
    import tempfile
    from boficap_tpu_torch.convert import load_jax_checkpoint
    from boficap_tpu_torch.models import setup
    res = {"margin_noise": {"float32": MARGIN_NOISE,
                            "bfloat16": BF16_MARGIN_NOISE}}
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 0}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="boficap_eval_") as tmp:
        opt = eval_opt("uic_sd.yml", id="smoke", batch_size=B)
        loader = eval_loader(opt)
        ck = os.path.join(tmp, "uic_sd")
        loaded, res["round_trip"] = round_trip(model16, opt, loader, ck)
        opt32 = eval_opt("uic_sd.yml", id="smoke", batch_size=B,
                         dtype="float32")
        model32 = load_jax_checkpoint(os.path.join(ck, "model.ckpt"),
                                      setup(opt32, VOCAB, DEV)).eval()
        for dtype_name, model in (("bfloat16", loaded), ("float32", model32)):
            bf16 = dtype_name == "bfloat16"
            for mode in EVAL_MODES:
                agree = (na_eval_agree if mode == "NAIC"
                         else sa_eval_agree)(model, bf16)
                r = eval_pair(model, loader, mode, dtype_name, kw,
                              EVAL_KERNELS[mode, dtype_name], agree)
                res[f"{mode}_{dtype_name}"] = r
                if bf16:
                    for k, v in r["launches"].items():
                        launches[k] = launches.get(k, 0) + v
        del loaded, model32
        aopt = eval_opt("transformer.yml", id="smoke_aic", batch_size=B)
        aloader = eval_loader(aopt)
        for (dtype_name, model), beam in itertools.product(
                (("bfloat16", aic16), ("float32", aic)), (1, K_BEAM)):
            bf16 = dtype_name == "bfloat16"
            agree = (ar_eval_agree if beam == 1
                     else beam_eval_agree)(model, bf16)
            name = "AIC" + ("" if beam == 1 else f"_beam{beam}")
            r = eval_pair(model, aloader, "", dtype_name,
                          {**kw, "num_images": B, "beam_size": beam},
                          EVAL_KERNELS["AIC", dtype_name], agree, core=True)
            res[f"{name}_{dtype_name}"] = r
            if bf16:
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        res["cli"] = eval_cli(os.path.join(tmp, "cli"))
    return res, launches


# ---------------------------------------------------------------------------
# phase train: the XE step on the card, training, validation on the kernels
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30              # bf16 steps on one repeated batch
TRAIN_LR = 5e-4               # constant Adam rate of the training check
TRAIN_DROP = 0.8              # mean of the last 5 losses below this x first 5
TRAIN_IMAGES = 640            # synthetic corpus: a test split of 128 = 2 x B
# gradients: each leaf to GRAD_TOL of its largest magnitude; a leaf whose
# gradient is zero in exact arithmetic (a key projection's bias: softmax
# ignores a shift common to every key) carries only rounding noise and is
# held to ZERO_GRAD of the largest gradient instead
GRAD_TOL, ZERO_GRAD = 1e-4, 1e-6
# a ReLU input within float32 rounding of zero may fall on the other side
# on the card than on the CPU, and then a whole row's term of a weight's
# gradient moves (the phase reports the worst leaf of a run without the
# alignment: unaligned_grad_worst_rel_err): the card's checked run takes
# the CPU's value at each such input (the gradient still flows through its
# own), and each must lie within RELU_GAP of it
RELU_GAP = 1e-4


def train_opt(**fields):
    """uic_sd as the trainer reads it, over the synthetic corpus, a constant
    Adam rate (no noam, no decay)."""
    return eval_opt("uic_sd.yml", id="smoketrain", noamopt=False,
                    learning_rate=TRAIN_LR, learning_rate_decay_start=-1,
                    **fields)


def train_batch(opt):
    """One train batch of 10 images x 5 captions over the full vocabulary."""
    from boficap_tpu_torch.data.dataset import CaptionData, LabelStore
    labels = LabelStore.synthetic(n_images=TRAIN_IMAGES, vocab_size=VOCAB,
                                  L=L, seed=1)
    loader = CaptionData(opt, labels=labels)
    return loader, loader.get_batch("train")


def relu_inputs(model):
    """The Dense modules whose outputs feed a ReLU: att_embed, every FFN's
    first product, the length and syntax heads' first products."""
    return [(n, m) for n, m in model.named_modules()
            if n in ("att_embed", "len_head1", "syn_head1")
            or n.endswith(".ffn.Dense_0")]


def relu_hooks(model, record=None, align=None):
    """Forward hooks on ``relu_inputs(model)``: with ``record`` (a dict)
    keep every ReLU input, by module, grad mode and call (the calls under
    no_grad, a scheduled-sampling loop's, counted apart from the
    differentiable pass's); with ``align`` (such a dict) make each ReLU
    input that falls on the other side of zero take the recorded value,
    and count them.  Returns (handles, stats)."""
    calls, stats = {}, {"flipped": 0, "max_gap": 0.0}
    if record is None and not align:
        return [], stats

    def hook(name):
        def fn(mod, inp, out):
            mode = (name, torch.is_grad_enabled())
            key = mode + (calls.setdefault(mode, 0),)
            calls[mode] += 1
            if record is not None:
                record[key] = out.detach().cpu()
                return None
            ref = align[key].to(out.device)
            flip = (out > 0) != (ref > 0)
            n = int(flip.sum())
            if not n:
                return None
            stats["flipped"] += n
            stats["max_gap"] = max(stats["max_gap"], float(
                (out.detach() - ref).abs()[flip].max()))
            # the CPU's value where the side differs; the gradient flows
            # through this run's own product
            return out + ((ref - out) * flip).detach()
        return fn

    return ([m.register_forward_hook(hook(n)) for n, m in
             relu_inputs(model)], stats)


def to_float64(model) -> None:
    """Make ``model`` compute in float64 (its parameters stay float32:
    every product casts them): the witness of a float32 step."""
    model.dtype = torch.float64
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64


def xe_grads(opt, batch, device, record=None, align=None,
             ss_prob: float = 0.0, state=None, float64: bool = False):
    """One XE step's loss and gradients of uic_sd from the seeded weights
    (or ``state``) on ``device``, at ``ss_prob``.  ``record`` (a dict)
    keeps every ReLU input, by module and call; ``align`` (such a dict)
    makes each ReLU input that falls on the other side of zero take the
    recorded value, and counts them; ``float64`` computes in float64."""
    from boficap_tpu_torch.convert import init_params
    from boficap_tpu_torch.train import steps
    model = init_params(opt, VOCAB, seed=SEED, device=device)
    if state is not None:
        model.load_state_dict(state)
    if float64:
        to_float64(model)
    handles, stats = relu_hooks(model, record, align)
    try:
        loss, _ = steps.xe_loss_fn(model, steps.to_device(batch, device),
                                   torch.Generator(device=device),
                                   ss_prob=ss_prob)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    return (float(loss.detach()), [n for n, _ in model.named_parameters()],
            [None if g is None else g.detach().cpu() for g in grads], stats)


def check_cross_device(batch, opt=None, ss_prob: float = 0.0,
                       state=None, witness: bool = False) -> dict:
    """float32, dropout off: one XE step of uic_sd (or of ``opt``'s model)
    on the card against the CPU, the ReLU sides aligned (RELU_GAP).  At
    ``ss_prob`` > 0 (on the weights ``state``), the scheduled-sampling
    coins are drawn once on the host and given to both devices
    (fixed_coins): the card's loop outputs must equal the CPU's, and some
    phrase must come from the model's plan.  With ``witness``, a gradient
    leaf beyond GRAD_TOL (and a loss beyond 1e-5) is held to a float64
    step on the CPU (compare_grads) that re-scores the CPU loop's outputs
    with the CPU's ReLU sides."""
    opt = opt or train_opt(dtype="float32", dropout=0.0, drop_prob_lm=0.0)
    kw = dict(ss_prob=ss_prob, state=state)
    relu, loops = {}, []
    coins = contextlib.nullcontext
    if ss_prob > 0:
        rows = batch["labels"].shape[0] * batch["labels"].shape[1]
        g = torch.Generator().manual_seed(SS_SEED)
        use = torch.rand((L + 2, rows), generator=g) < ss_prob
        bos = torch.rand((L + 2, rows), generator=g) < 0.5
        coins = functools.partial(fixed_coins, use, bos, loops)
    with coins():
        t0 = time.perf_counter()
        lc, names, gc, _ = xe_grads(opt, batch, "cpu", record=relu, **kw)
        cpu_s = time.perf_counter() - t0
        _, _, raw, _ = xe_grads(opt, batch, DEV, **kw)
        lg, _, gg, stats = xe_grads(opt, batch, DEV, align=relu, **kw)
    out = {}
    if ss_prob > 0:
        cpu_loop, card_loop = loops[0], loops[2]
        differ = [k for k in cpu_loop
                  if not torch.equal(cpu_loop[k], card_loop[k])]
        if differ:
            fail(f"train ss: the card's scheduled-sampling loop differs "
                 f"from the CPU's at {differ}")
        plan = cpu_loop["plan_len"]
        took = use[:plan.shape[1]].T & (plan > 0)
        gt = ~use[:plan.shape[1]].T & (plan > 0)
        out = {"ss_prob": ss_prob, "rows": rows,
               "model_phrases": int(took[:, 1:].sum()),
               "gt_phrases": int(gt[:, 1:].sum())}
        if not out["model_phrases"]:
            fail("train ss: no phrase came from the model's plan")
    out.update(loss_card=lg, loss_cpu=lc, loss_rel_err=abs(lg - lc) / abs(lc))
    g64 = None
    if witness:
        t0 = time.perf_counter()
        with coins() as fc:
            if fc is not None:
                fc.replay = loops[0]
            l64, _, g64, s64 = xe_grads(opt, batch, "cpu", align=relu,
                                        float64=True, **kw)
        out.update(loss_float64=l64, witness_s=time.perf_counter() - t0,
                   witness_relu_flipped=s64["flipped"],
                   witness_relu_flip_max_gap=s64["max_gap"],
                   loss_card_float64=abs(lg - l64) / abs(l64),
                   loss_cpu_float64=abs(lc - l64) / abs(l64))
    if abs(lg - lc) > 1e-5 * abs(lc) and (
            g64 is None or abs(lg - l64) > WITNESS_K * abs(lc - l64)):
        fail(f"train: card loss {lg} != CPU loss {lc} ({out})")
    return {**out, **compare_grads("train", names, gg, gc, raw, relu, stats,
                                   witness=g64),
            "cpu_step_s": cpu_s}


# scheduled sampling in the card-vs-CPU step: ss_prob, and the seed of the
# coins drawn once on the host for both devices
SS_PROB = 0.5
SS_SEED = 7


@contextlib.contextmanager
def fixed_coins(use, bos, loops):
    """ss_sa_loop's draws replaced by the tables ``use`` and ``bos`` [L +
    2, rows] (bound_fill._ss_coins, row ``step``), on the loop's device,
    and each loop's outputs appended to ``loops`` on the host.  Yields a
    namespace whose ``replay``, once set to such outputs, stands in for
    the loop: it is not run, and its outputs are ``replay``'s on the
    loop's device."""
    from boficap_tpu_torch.decode import bound_fill as bf
    draw, loop = bf._ss_coins, bf.ss_sa_loop
    ns = types.SimpleNamespace(replay=None)

    def recording(*args, **kwargs):
        if ns.replay is not None:
            dev = args[3].device                   # labels
            return {k: v.to(dev) for k, v in ns.replay.items()}
        out = loop(*args, **kwargs)
        loops.append({k: v.cpu() for k, v in out.items()})
        return out

    bf._ss_coins = lambda step, n, ss_prob, rng, device: (
        use[step].to(device), bos[step].to(device))
    bf.ss_sa_loop = recording
    try:
        yield ns
    finally:
        bf._ss_coins, bf.ss_sa_loop = draw, loop


def compare_grads(what: str, names, got, want, raw, relu, stats,
                  witness=None) -> dict:
    """The card's gradients ``got`` (ReLU sides aligned) against the CPU's
    ``want``: each leaf within GRAD_TOL of its largest magnitude, a leaf of
    structurally zero gradient within ZERO_GRAD of the largest gradient;
    ``raw`` (the card's unaligned run) is reported only.  With ``witness``
    (the float64 gradients), a leaf beyond GRAD_TOL passes if the card is
    within WITNESS_K times the CPU's distance from the witness, and fails
    if not: then the witness sides with the CPU."""
    if stats["max_gap"] > RELU_GAP:
        fail(f"{what}: a ReLU input differs by {stats['max_gap']} across "
             f"zero between the card and the CPU")
    gmax = max(g.abs().max().item() for g in want if g is not None)
    if not gmax > 0:
        fail(f"{what}: every gradient is zero")
    worst, unaligned, zero, witnessed = 0.0, 0.0, [], {}
    ratio = (0.0, None)
    for i, (n, a, b, r) in enumerate(zip(names, got, want, raw)):
        if (a is None) != (b is None):
            fail(f"{what}: gradient of {n} missing on one device")
        if b is None:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if scale <= ZERO_GRAD * gmax:
            zero.append(n)
            if a.abs().max().item() > ZERO_GRAD * gmax:
                fail(f"{what}: {n}'s zero gradient is not zero on the card")
            continue
        if witness is not None:
            w = witness[i]
            card = (a.double() - w.double()).abs().max().item() / scale
            cpu = (b.double() - w.double()).abs().max().item() / scale
            if card > ratio[0] * max(cpu, 1e-300):
                ratio = (card / max(cpu, 1e-300), n)
            if err > GRAD_TOL * scale:
                witnessed[n] = {"card_cpu": err / scale, "card_float64": card,
                                "cpu_float64": cpu}
                if card > WITNESS_K * cpu:
                    fail(f"{what}: gradient of {n} differs by {err / scale} "
                         f"of its largest magnitude, and the card is {card} "
                         f"off the float64 witness, the CPU {cpu}")
        elif err > GRAD_TOL * scale:
            fail(f"{what}: gradient of {n} differs by {err / scale} of its "
                 f"largest magnitude")
        worst = max(worst, err / scale)
        unaligned = max(unaligned, (r - b).abs().max().item() / scale)
    out = {"grad_leaves": len(names), "grad_worst_rel_err": worst,
           "zero_grad_leaves": len(zero),
           "relu_inputs": sum(t.numel() for t in relu.values()),
           "relu_flipped": stats["flipped"],
           "relu_flip_max_gap": stats["max_gap"],
           "unaligned_grad_worst_rel_err": unaligned}
    if witness is not None:
        out.update(witness_k=WITNESS_K, witnessed_leaves=witnessed,
                   witness_worst_card_over_cpu=ratio)
    return out


def timed_steps(step, batch, gen, n: int, warm: int = 3):
    """The losses of ``warm + n`` steps and the ms of the last n, each timed
    between torch.cuda.synchronize() calls."""
    losses, ms = [], []
    for i in range(warm + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        if i >= warm:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return losses, ms


def pack_digest(model) -> float:
    """A digest of the NA decoder stack's packed weights."""
    return float(model.packed_decoder("NA").stack["wqkv"].float().sum())


def trainer(opt, vocab: int = VOCAB):
    """uic_sd at ``opt``'s dtype on the card over ``vocab`` words, seeded,
    with its optimizer and XE step."""
    from boficap_tpu_torch.convert import flax_layout, init_params
    from boficap_tpu_torch.train import optim, steps
    model = init_params(opt, vocab, seed=SEED, device=DEV)
    layout = flax_layout(model)
    opt_ = optim.Optimizer(optim.build_optimizer(opt, layout), model, layout)
    return model, steps.make_xe_step(model, opt_)


def train_cli(path: str) -> dict:
    """``python -m boficap_tpu_torch.tools.train`` in a process of its own
    at uic_sd's widths over the CLI's synthetic corpus: a few iterations
    with one validation and one checkpoint, then ``--start_from`` for a
    few more, then the eval CLI on its model_best.ckpt."""
    import re
    from boficap_tpu_torch.train.state import load_infos
    ck = os.path.join(path, "ckpt")
    base = [sys.executable, "-m", "boficap_tpu_torch.tools.train",
            "--cfg", os.path.join(HERE, "configs", "uic_sd.yml"),
            "--id", "smokecli", "--checkpoint_path", ck,
            "--input_json", "synthetic", "--input_att_dir", "synthetic",
            "--val_images_use", "6", "--save_checkpoint_every", "3",
            "--losses_log_every", "1"]
    env = dict(os.environ, PYTHONPATH=HERE)
    out = {}
    for name, extra in (("train", ["--max_epochs", "2"]),
                        ("resume", ["--max_epochs", "3", "--start_from",
                                    ck])):
        t0 = time.perf_counter()
        run = subprocess.run(base + extra, cwd=path, env=env,
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            fail(f"train CLI {name}: exit {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        infos = load_infos(ck, "smokecli")
        out[name] = {"exit": 0, "wall_s": time.perf_counter() - t0,
                     "iter": infos["iter"], "epoch": infos["epoch"],
                     "validations": run.stdout.count("val[NAIC]"),
                     "last_loss_line": [ln for ln in run.stdout.splitlines()
                                        if ln.startswith("iter ")][-1:]}
        if name == "train" and "val[SAIC]" not in run.stdout:
            fail(f"train CLI: no validation in {run.stdout[-2000:]!r}")
        if name == "resume" and (infos["iter"] <= out["train"]["iter"]
                                 or "mismatch" in run.stdout):
            fail(f"train CLI resume: iter {infos['iter']} after "
                 f"{out['train']['iter']}, {run.stdout[-2000:]!r}")
    files = sorted(os.listdir(ck))
    for want in ("model.ckpt", "model_best.ckpt", "optimizer.ckpt",
                 "infos_smokecli.pkl", "histories_smokecli.pkl"):
        if want not in files:
            fail(f"train CLI: {want} not written ({files})")
    cwd = os.path.join(path, "eval")
    os.makedirs(cwd)
    run = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.eval", "--model",
         os.path.join(ck, "model_best.ckpt"), "--infos_path",
         os.path.join(ck, "infos_smokecli_best.pkl"), "--inference_mode",
         "NAIC", "--language_eval", "1", "--num_images", "-1",
         "--verbose_loss", "1"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600)
    if run.returncode != 0 or not re.search(CLI_DECODE_LINE, run.stdout):
        fail(f"eval CLI on the trained checkpoint: exit {run.returncode}: "
             f"{run.stderr[-2000:]}")
    out["eval_cli"] = {"exit": 0, "decode_line": re.search(
        CLI_DECODE_LINE, run.stdout).group(0)}
    out["files"] = files
    return out


def check_train(tmp: str) -> tuple:
    """Phase train (see the module docstring), its CLI runs under ``tmp``;
    returns (result, the kernel launches of the trained model's validation
    on the kernels, the trained bf16 model, its train batch)."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    res = {"grad_tol": GRAD_TOL, "zero_grad": ZERO_GRAD}
    opt16 = train_opt(dropout=0.1)
    loader, batch = train_batch(opt16)
    res["batch"] = {k: list(batch[k].shape) for k in ("att_feats", "labels")}
    res["cross_device_float32"] = check_cross_device(batch)
    # at ss_prob SS_PROB: on the seeded weights, build's nudged heads with
    # the stop shift, so that the model's plans run on (without it nearly
    # every plan stops at the first phrase); on the trained float32 model
    # below, as trained, with the float64 witness
    t_part = time.perf_counter()
    seeded = build("float32")
    shift_stop([seeded])
    res["cross_device_float32_ss"] = check_cross_device(
        batch, ss_prob=SS_PROB, state=seeded.state_dict())
    res["cross_device_float32_ss"]["part_s"] = time.perf_counter() - t_part
    del seeded

    from boficap_tpu_torch.train import steps
    tb = steps.to_device(batch, DEV)
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1}
    eval_loader_ = train_batch(eval_opt("uic_sd.yml", id="smoketrain",
                                        batch_size=B))[0]
    for dtype_name in ("float32", "bfloat16"):
        model = step = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, step = trainer(train_opt(dropout=0.1, dtype=dtype_name))
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        if dtype_name == "bfloat16":
            digest0, pack0 = pack_digest(model), model.packed_decoder("NA")
        reset_launch_counts()
        n = TRAIN_STEPS - 3 if dtype_name == "bfloat16" else 10
        losses, ms = timed_steps(step, tb, gen, n)
        if any(launch_counts().values()):
            fail(f"train {dtype_name}: the training step launched kernels: "
                 f"{launch_counts()}")
        r = {"step_ms_median_of_10": sorted(ms[:10])[5], "step_ms": ms[:10],
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "losses": losses,
             "profile_step": profile_decode(lambda: step(tb, gen))}
        r["profile_step"].pop("top_kernels")
        if not all(math.isfinite(x) for x in losses):
            fail(f"train {dtype_name}: a loss is not finite: {losses}")
        res[f"steps_{dtype_name}"] = r
        if dtype_name == "float32":
            # the float32 trained model on its kernels, by the float32 rule
            vals, _ = trained_eval(model.eval(), "float32", eval_loader_, kw)
            res.update({f"val_{mode}_float32": v for mode, v in vals.items()})
            t_part = time.perf_counter()
            res["cross_device_float32_ss_trained"] = check_cross_device(
                batch, ss_prob=SS_PROB, state=model.state_dict(),
                witness=True)
            res["cross_device_float32_ss_trained"]["part_s"] = (
                time.perf_counter() - t_part)
    print(f"train: {json.dumps(res)}", file=sys.stderr, flush=True)
    losses = res["steps_bfloat16"]["losses"][:TRAIN_STEPS]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    res["loss_first5_mean"], res["loss_last5_mean"] = first, last
    if not last < TRAIN_DROP * first:
        fail(f"train: the loss went {first} -> {last} in {TRAIN_STEPS} "
             f"steps (want below {TRAIN_DROP} x)")

    model.eval()
    digest1, pack1 = pack_digest(model), model.packed_decoder("NA")
    if pack1 is pack0 or digest1 == digest0:
        fail("train: the kernel packs were not rebuilt after the steps")
    res["packs_rebuilt"] = {"new_object": pack1 is not pack0,
                            "digest_before": digest0, "digest_after": digest1}
    vals, launches = trained_eval(model, "bfloat16", eval_loader_, kw)
    res.update({f"val_{mode}": v for mode, v in vals.items()})
    res["aic"], aic_launches = check_trained_aic(kw)
    launches = {k: launches.get(k, 0) + aic_launches.get(k, 0)
                for k in set(launches) | set(aic_launches)}
    res["remat"] = check_remat(tb)
    res["cli"] = train_cli(tmp)
    res["phase_s"] = time.perf_counter() - t_phase
    return res, launches, model, batch


def trained_eval(model, dtype_name: str, loader, kw) -> tuple:
    """eval_split NAIC and SAIC of a trained model on its kernels against
    the plain path, by ``dtype_name``'s margin rule (float32: the tight
    one, each differing sample reported with its margin), the eval losses
    within 1e-6; returns (result by mode, the launch counts summed)."""
    bf16 = dtype_name == "bfloat16"
    out, launches = {}, {}
    for mode in EVAL_MODES:
        agree = (na_eval_agree if mode == "NAIC" else sa_eval_agree)(
            model, bf16)
        # the trained model plans phrases of at most 5 words (the corpus'),
        # within the narrow window: no SA round here is wide, so #7 is not
        # asked for; phase rl runs it on this model's plans, shaped so that
        # some open with a LONG-word phrase (check_rl_wide)
        kernels = [k for k in EVAL_KERNELS[mode, dtype_name]
                   if k != "window_wide_stack"]
        r = eval_pair(model, loader, mode, dtype_name, kw, kernels, agree)
        out[mode] = r
        if abs(r["loss"] - r["plain_loss"]) > 1e-6 * abs(r["plain_loss"]):
            fail(f"train {dtype_name}: eval loss {r['loss']} on the kernel "
                 f"route, {r['plain_loss']} on the plain one")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return out, launches

# the trained AR model of phase train: a UIC model (uic_sd) has no AR
# decoder (DECODER_ROLES), so AIC greedy and beam search on trained weights
# take configs/transformer.yml at full width, trained here on the learnable
# corpus of tools/make_synth_corpus.py, each label row ending with EOS (the
# collate pins EOS at the frame's last slot, so a model trained on rows
# without it learns to emit PAD, which ends the caption's text but not the
# decode's row: the loops end a row on EOS only)
AR_IMAGES = 640               # 512 train, 64 val, 64 test: one batch of B
AR_BATCH = 32                 # images a float32 XE step, one caption each
AR_STEPS = 150                # its steps (Adam at TRAIN_LR, dropout off)
AR_SHORT = 4                  # a last slot word below this: a 5-word caption


def ar_corpus(seed: int):
    """tools/make_synth_corpus.py's corpus in memory (build: its slot
    words, phrase-free), AR_IMAGES images of one caption each over the
    full vocabulary, the word after the caption EOS; an image whose last
    slot word is among the first AR_SHORT of its slot drops it, so
    captions run 5 or 6 words.  Returns (LabelStore, ArrayFeatures)."""
    from boficap_tpu_torch.data.dataset import LabelStore
    from boficap_tpu_torch.tools import make_synth_corpus as synth
    (labels, start, end, *_), images, att = synth.build(
        AR_IMAGES, cpi=1, L=L, seed=seed, short=AR_SHORT, eos=True)
    ix_to_word = {str(i + 4): f"w{i}" for i in range(VOCAB)}
    return (LabelStore(images, ix_to_word, labels, start, end),
            synth.ArrayFeatures(att))


def train_aic() -> tuple:
    """configs/transformer.yml at full width, float32, dropout off, AR_STEPS
    XE steps on ar_corpus's train split; returns (the trained model, a B =
    64 eval loader over the corpus, the training's figures)."""
    from boficap_tpu_torch.data.dataset import CaptionData
    from boficap_tpu_torch.train import steps
    opt = eval_opt("transformer.yml", id="smokear", noamopt=False,
                   learning_rate=TRAIN_LR, learning_rate_decay_start=-1,
                   dtype="float32", dropout=0.0, drop_prob_lm=0.0,
                   batch_size=AR_BATCH, seq_per_img=1)
    store, feats = ar_corpus(SEED)
    loader = CaptionData(opt, labels=store, features=feats)
    model, step = trainer(opt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AR_STEPS):
        m = step(steps.to_device(loader.get_batch("train"), DEV), gen)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses):
        fail(f"train aic: a loss is not finite: {losses}")
    eval_loader_ = CaptionData(eval_opt("transformer.yml", id="smokear",
                                        batch_size=B, seq_per_img=1),
                               labels=store, features=feats)
    return model.eval(), eval_loader_, {
        "config": "transformer.yml", "images": AR_IMAGES,
        "steps": AR_STEPS, "batch_images": AR_BATCH, "train_s": train_s,
        "losses_first5": losses[:5], "losses_last5": losses[-5:]}


def distinct_decodes(r: dict) -> list:
    """eval_pair's per-decode entries of distinct batches: a one-batch
    eval_split decodes its batch a second time, last, for its rate."""
    return r["batches"][:math.ceil(r["images"] / B)]


def trained_ar_eval(model, dtype_name: str, loader, kw) -> tuple:
    """eval_split AIC greedy and beam K_BEAM of the trained AIC model with
    #9 on (use_pallas) against off, by ``dtype_name``'s margin rule; the
    share of greedy rows that end (EOS) before L, which must not be 0.
    Returns (result, the launch counts summed)."""
    bf16 = dtype_name == "bfloat16"
    out, launches = {}, {}
    for name, beam, agree in (("greedy", 1, ar_eval_agree(model, bf16)),
                              ("beam3", K_BEAM, beam_eval_agree(model, bf16))):
        r = eval_pair(model, loader, "AIC", dtype_name,
                      {**kw, "beam_size": beam},
                      EVAL_KERNELS["AIC", dtype_name], agree, core=True)
        out[name] = r
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    greedy, beam = (distinct_decodes(out[k]) for k in ("greedy", "beam3"))
    rows = sum(b["rows"] for b in greedy)
    ended = sum(b["ended_rows"] for b in greedy)
    out["ar_rows"], out["ar_rows_ended_share"] = rows, ended / rows
    if not ended:
        fail(f"train aic {dtype_name}: no AR row ended before L "
             f"({rows} rows)")
    excused = sorted(g for b in beam for g in b["excused_gaps"])
    out["beam3_samples"] = sum(b["beams"] for b in beam) // K_BEAM
    out["beam3_excused_samples"] = len(excused)
    out["beam3_excused_gap_quantiles"] = (
        [excused[int(q * (len(excused) - 1))] for q in (0, 0.25, 0.5, 0.75,
                                                        1)]
        if excused else [])
    return out, launches


def check_trained_aic(kw) -> tuple:
    """The trained AIC model (train_aic) on its kernels against the plain
    path, float32 and a bf16 copy of the same weights (trained_ar_eval);
    returns (result, the launch counts summed)."""
    from boficap_tpu_torch.convert import init_params
    t_part = time.perf_counter()
    model32, loader, res = train_aic()
    model16 = init_params(eval_opt("transformer.yml"), VOCAB, seed=SEED,
                          device=DEV).eval()
    model16.load_state_dict(model32.state_dict())
    launches = {}
    for dtype_name, model in (("float32", model32), ("bfloat16", model16)):
        r, counts = trained_ar_eval(model, dtype_name, loader, kw)
        res[f"val_AIC_{dtype_name}"] = r
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    res["part_s"] = time.perf_counter() - t_part
    return res, launches


# the remat part of phase train: uic_sd's XE step with remat 0 and 1
REMAT_REPEATS = 3             # remat 0 runs, for the spread of the atomics
REMAT_IMAGES = (10, 64)       # batches (x 5 captions) timed at both settings
REMAT_BIG = 256               # ... and with remat 1 alone


def remat_grads(model, tb) -> tuple:
    """One XE step's loss and gradients (as the training step takes them:
    every attention plain) from a generator seeded SEED; returns (the
    loss and the gradient leaves, the generator's state after the
    backward)."""
    from boficap_tpu_torch.train import steps
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = list(model.parameters())
    with model.plain_attention():
        loss, _ = steps.xe_loss_fn(model, tb, gen)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return ([loss.detach()] + [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)],
            gen.get_state())


def remat_equal(dtype_name: str, tb) -> dict:
    """remat 1 against REMAT_REPEATS runs of remat 0, dropout 0.1, the
    same weights and generator seed: the loss and each gradient leaf
    bitwise equal where the repeats are bitwise equal among themselves,
    else no farther from the nearest repeat than the repeats' spread (the
    largest distance between two of them: atomics in the embedding
    backward); the generator's state after the backward equal."""
    from boficap_tpu_torch.convert import init_params
    runs = []
    for remat in [0] * REMAT_REPEATS + [1]:
        opt = train_opt(dropout=0.1, dtype=dtype_name, remat=remat)
        model = init_params(opt, VOCAB, seed=SEED, device=DEV)
        if model.encoder.remat != bool(remat):
            fail(f"remat {dtype_name}: the model's remat is not {remat}")
        names = ["loss"] + [n for n, _ in model.named_parameters()]
        runs.append(remat_grads(model, tb))
        del model
    reps, (got, state) = runs[:-1], runs[-1]
    if any(not torch.equal(state, s) for _, s in reps):
        fail(f"remat {dtype_name}: the generator's state after the step "
             f"differs from remat 0's")
    bitwise, spread_leaves = 0, {}
    for i, name in enumerate(names):
        leaves = [r[i] for r, _ in reps]
        spread = max((a - b).abs().max().item()
                     for a, b in itertools.combinations(leaves, 2))
        err = min((got[i] - a).abs().max().item() for a in leaves)
        if err > spread:
            fail(f"remat {dtype_name}: {name} is {err} from the nearest "
                 f"remat 0 run, whose spread is {spread}")
        if spread == 0:
            bitwise += 1
        else:
            spread_leaves[name] = {"err": err, "spread": spread}
    if "loss" in spread_leaves:
        fail(f"remat {dtype_name}: the remat 0 losses differ among "
             f"themselves: {spread_leaves['loss']}")
    return {"loss": got[0].item(), "loss_bitwise": True,
            "generator_state_equal": True, "leaves": len(names),
            "bitwise_leaves": bitwise,
            "leaves_within_repeat_spread": spread_leaves}


def remat_step(images: int, remat: int) -> dict:
    """The bf16 XE step of uic_sd (dropout 0.1) on ``images`` x 5
    captions with ``remat``: ms, the median of 10 after 3 warm-ups, and
    the peak memory of the steps over what was resident before them."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.train import steps
    opt = train_opt(dropout=0.1, batch_size=images, remat=remat)
    tb = steps.to_device(train_batch(opt)[1], DEV)
    if tb["att_feats"].shape[0] != images:
        fail(f"remat: a batch of {tb['att_feats'].shape[0]} images, not "
             f"{images}")
    model, step = trainer(opt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, ms = timed_steps(step, tb, gen, 10)
    peak = torch.cuda.max_memory_allocated()
    if any(launch_counts().values()):
        fail(f"remat: the training step launched kernels: {launch_counts()}")
    if not all(map(math.isfinite, losses)):
        fail(f"remat {images} x 5, remat {remat}: losses {losses}")
    return {"step_ms_median": sorted(ms)[len(ms) // 2], "step_ms": ms,
            "peak_memory_bytes": peak, "resident_bytes": resident,
            "step_peak_bytes": peak - resident}


def check_remat(tb) -> dict:
    """The remat part of phase train: ``remat_equal`` at both dtypes on
    the 10 x 5 batch ``tb``; then the bf16 step's ms and peak memory with
    remat 0 and 1 at REMAT_IMAGES x 5 and with remat 1 at REMAT_BIG x 5,
    and with remat 0 there too where the line through the two smaller
    batches' peaks stays under the card's free memory.  remat 1's peak
    must lie below remat 0's at the larger of REMAT_IMAGES."""
    t0 = time.perf_counter()
    res = {f"equal_{dt}": remat_equal(dt, tb)
           for dt in ("float32", "bfloat16")}
    steps_ = {}
    for images in REMAT_IMAGES:
        for remat in (0, 1):
            torch.cuda.empty_cache()
            steps_[f"{images}x5_remat{remat}"] = remat_step(images, remat)
    torch.cuda.empty_cache()
    steps_[f"{REMAT_BIG}x5_remat1"] = remat_step(REMAT_BIG, 1)
    lo, hi = (steps_[f"{n}x5_remat0"]["step_peak_bytes"]
              for n in REMAT_IMAGES)
    projected = hi + (hi - lo) * (REMAT_BIG - REMAT_IMAGES[1]) / (
        REMAT_IMAGES[1] - REMAT_IMAGES[0])
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    res["remat0_big_projection"] = {"step_peak_bytes": projected,
                                    "free_bytes": free,
                                    "runs": projected < free}
    if projected < free:
        steps_[f"{REMAT_BIG}x5_remat0"] = remat_step(REMAT_BIG, 0)
    res["steps_bfloat16"] = steps_
    n = REMAT_IMAGES[1]
    a, b = (steps_[f"{n}x5_remat{r}"]["step_peak_bytes"] for r in (0, 1))
    if not b < a:
        fail(f"remat: the {n} x 5 step's peak with remat 1 ({b} B) is not "
             f"below remat 0's ({a} B)")
    res["part_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase rl: the structure-loss stage on the card
# ---------------------------------------------------------------------------

RL_STEPS = 10                 # timed RL steps at each dtype, after 3 warm-up
RL_DRAWS = 20_000             # draws of the sampling-law check
RL_P_MIN = 1e-4               # its chi-square bound on the p-value
RL_T = 0.7                    # its temperature
RESCORE_TOL = 1e-4            # float32: sampler tok_logprobs vs re-score
# bf16: the sampler's token log-probs against the re-score, held to
# RESCORE_BF16 nats, a limit set between two readings on the card: the
# sound sampler's largest gap, and that of a control, the same sampler with
# each stack output (the generator's input) moved by CONTROL_ULPS bf16 ulps
# of a random sign (a stack that rounds that much worse); both are printed
# and the control must exceed the limit, so that the check sees such a fault
RESCORE_BF16 = 0.05
CONTROL_ULPS = 8
# the float32 step: a gradient leaf that differs from the CPU's by more than
# GRAD_TOL is held to a float64 step on the CPU (the witness): the card's
# distance from it within WITNESS_K times the CPU float32's own
WITNESS_K = 4.0
# the kernels the bf16 sampler must launch (B = 10 images, 50 samples: the
# whole-stack route): the encoder stack, the NA fill, the narrow SA round
RL_KERNELS = ("encoder_stack", "decoder_stack", "window_stack")


def rl_opt(**fields):
    """configs/uic_sd_nscl.yml (the flagship's structure-loss stage:
    batch 10, train_sample_n 5, new_self_critical, a constant Adam rate of
    5e-6) over the synthetic corpus."""
    return eval_opt("uic_sd_nscl.yml", id="smokerl", **fields)


def rl_model(opt, state):
    """uic_sd at ``opt``'s dtype on the card holding ``state`` (the trained
    model's parameters), with its sampler and RL step."""
    from boficap_tpu_torch.convert import flax_layout, init_params
    from boficap_tpu_torch.train import optim, steps
    model = init_params(opt, VOCAB, seed=SEED, device=DEV).eval()
    model.load_state_dict(state)
    layout = flax_layout(model)
    o = optim.Optimizer(optim.build_optimizer(opt, layout), model, layout)
    sampler = steps.make_rl_sample(model, opt.train_sample_method,
                                   opt.temperature, opt.train_sample_n)
    return model, sampler, steps.make_rl_step(model, o, opt)


def written(d):
    """The positions a phrase sampler wrote a token log-prob at."""
    pos = torch.arange(d["seq"].shape[1], device=d["seq"].device)
    return pos[None, :] < d["phrase_length"].sum(-1)[:, None]


def rl_step_once(sampler, step, tb, gts, opt, gen):
    """One RL step: sample on the card, score on the host, update.  Returns
    (metrics, samples, ms of the sampler, the host scoring, the update)."""
    from boficap_tpu_torch.train import steps
    att, am = tb["att_feats"], tb["att_masks"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = sampler(att, am, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores = steps.rl_host_scores(samples, gts, opt)
    t2 = time.perf_counter()
    m = step(att, am, samples, {k: torch.as_tensor(v, device=DEV)
                                for k, v in scores.items()}, rng=gen)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return m, samples, [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]


def count_syncs(fn) -> int:
    """The host syncs fn() makes, counted by CUDA's sync debug mode (one
    warning a synchronizing call)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


@torch.no_grad()
def rescore_gap(model, tb, samples, n) -> dict:
    """The sampler's tok_logprobs against rl_rescore's plain values at the
    drawn words (where the sampler wrote them), per branch."""
    from boficap_tpu_torch.train import steps
    lps = steps.rl_rescore(model, tb["att_feats"], tb["att_masks"], samples,
                           n)
    out = {}
    for key in ("sa", "na"):
        d = samples[key]
        got = torch.gather(lps[f"{key}_logprob"], -1, d["seq"][..., None])
        m = written(d)
        out[key] = {"positions": int(m.sum()), "max_abs_err": (
            got[..., 0] - d["tok_logprobs"])[m].abs().max().item()}
    return out


@torch.no_grad()
def control_gap(model, sampler, tb, n, ulps: int) -> dict:
    """rescore_gap of the control: ``sampler`` with every input of the
    generator (a stack's output) moved by ``ulps`` bf16 ulps of its value,
    the sign drawn per element from a seeded generator."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)

    def moved(mod, inp):
        x = inp[0]
        sign = torch.randint(0, 2, x.shape, generator=g, device=x.device)
        return ((x.float() + ulps * bf16_ulp(x) * (2 * sign - 1))
                .to(x.dtype),)

    handle = model.generator.proj.register_forward_pre_hook(moved)
    try:
        samples = sampler(tb["att_feats"], tb["att_masks"],
                          torch.Generator(device=DEV).manual_seed(SEED))
    finally:
        handle.remove()
    return rescore_gap(model, tb, samples, n)


def rl_grads(opt, state, samples, scores, device, record=None, align=None,
             float64: bool = False):
    """One structure-loss step's loss and gradients (rl_loss_fn) of the
    model holding ``state`` on ``device``, on fixed samples and scores;
    ``record`` / ``align`` as relu_hooks; ``float64`` computes in float64
    (the parameters stay float32: every product casts them).  Returns
    (loss, names, gradients, stats)."""
    from boficap_tpu_torch.convert import init_params
    from boficap_tpu_torch.train import steps
    model = init_params(opt, VOCAB, seed=SEED, device=device)
    model.load_state_dict(state)
    if float64:
        to_float64(model)
    tb = {k: v.to(device) for k, v in samples["batch"].items()}
    sm = {k: {n: t.to(device) for n, t in d.items()}
          for k, d in samples["samples"].items()}
    sc = {k: torch.as_tensor(v, device=device) for k, v in scores.items()}
    handles, stats = relu_hooks(model, record, align)
    try:
        loss, _ = steps.rl_loss_fn(model, tb["att_feats"], tb["att_masks"],
                                   sm, sc, opt)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    return (float(loss.detach()), [n for n, _ in model.named_parameters()],
            [None if g is None else g.detach().cpu() for g in grads], stats)


def fixed_samples(tb, samples) -> dict:
    """The batch's features and a sampler's SA and NA samples, on the
    host: what rl_grads takes on either device."""
    return {"batch": {k: tb[k].cpu() for k in ("att_feats", "att_masks")},
            "samples": {k: {f: samples[k][f].cpu() for f in
                            ("seq", "phrase_length", "phrase_syn")}
                        for k in ("sa", "na")}}


def check_rl_cross_device(opt32, state, samples, scores,
                          witness: bool = True) -> dict:
    """float32: one structure-loss step of the model holding ``state`` on
    the card against the CPU, on the same samples and scores, the ReLU
    sides aligned (RELU_GAP): the loss to 1e-5 relative, each gradient
    leaf as compare_grads; with ``witness``, a leaf beyond GRAD_TOL is held
    to the float64 step on the CPU (its ReLU sides the CPU's too), and so
    is a loss beyond 1e-5: the leave-one-out advantages sum to zero over
    an image's samples, so the loss is a cancelling sum."""
    relu = {}
    lc, names, gc, _ = rl_grads(opt32, state, samples, scores, "cpu",
                                record=relu)
    _, _, raw, _ = rl_grads(opt32, state, samples, scores, DEV)
    lg, _, gg, stats = rl_grads(opt32, state, samples, scores, DEV,
                                align=relu)
    out = {"loss_card": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc)}
    g64 = None
    if witness:
        t0 = time.perf_counter()
        l64, _, g64, s64 = rl_grads(opt32, state, samples, scores, "cpu",
                                    align=relu, float64=True)
        out.update(loss_float64=l64, witness_s=time.perf_counter() - t0,
                   witness_relu_flipped=s64["flipped"],
                   witness_relu_flip_max_gap=s64["max_gap"],
                   loss_card_float64=abs(lg - l64) / abs(l64),
                   loss_cpu_float64=abs(lc - l64) / abs(l64))
    if abs(lg - lc) > 1e-5 * abs(lc) and (
            g64 is None or abs(lg - l64) > WITNESS_K * abs(lc - l64)):
        fail(f"rl: card loss {lg} != CPU loss {lc} ({out})")
    return {**out, **compare_grads("rl", names, gg, gc, raw, relu, stats,
                                   witness=g64)}


# check_rl_wide's shaping: the share of the trained model's images whose
# float32 first SA round takes LONG words as its argmax (shape_plans: the
# quantile of the argmax gap that the raise passes); the bf16 sampler draws
# its lengths from the raised head, and more of its samples open with a
# LONG-word phrase (printed: samples_opening_long)
WIDE_SHARE = 0.2


@torch.no_grad()
def check_rl_wide(m16, sampler16, m32, tb, n) -> tuple:
    """The trained model's plans shaped (shape_plans at WIDE_SHARE, read on
    the float32 model; no stop shift: a trained model's plans run on): the
    bf16 sampler launches the wide round's
    kernel (#7) with RL_KERNELS, its log-probs lie within RESCORE_BF16 of
    the re-score, and the float32 top1 decodes equal the greedy ones; then
    the length heads' biases are put back as they were.  Returns (result,
    the bf16 sampler's launch counts)."""
    t_part = time.perf_counter()
    att, am = tb["att_feats"], tb["att_masks"]
    models = (m32, m16)
    saved = [m.len_head2.bias.detach().clone() for m in models]
    shift = shape_plans(models, share=WIDE_SHARE, feats=(att, am))
    try:
        samples, launches = counted(lambda: sampler16(
            att, am, torch.Generator(device=DEV).manual_seed(SEED)))
        pl = samples["sa"]["phrase_length"]
        need = RL_KERNELS + ("window_wide_stack",)
        if not (pl.max() > W_NARROW) or any(not launches[k] for k in need):
            fail(f"rl wide: the shaped bf16 sampler planned no phrase wider "
                 f"than {W_NARROW} or never launched {need}: {launches}")
        gap = rescore_gap(m16, tb, samples, n)
        for k, r in gap.items():
            if r["max_abs_err"] > RESCORE_BF16:
                fail(f"rl wide: bf16 {k} sampler log-probs "
                     f"{r['max_abs_err']} off the re-score, above "
                     f"{RESCORE_BF16}")
        top1 = check_top1(m32, tb)
    finally:
        for m, b in zip(models, saved):
            m.len_head2.bias.copy_(b)
            m.invalidate_packed()
    return {"long_bias_shift": shift, "long": LONG,
            "long_argmax_share": WIDE_SHARE,
            "samples_opening_long": int((pl[:, 0] == LONG).sum()),
            "samples": int(pl.shape[0]),
            "wide_phrases": int((pl > W_NARROW).sum()),
            "launches": launches, "rescore_bf16": gap,
            "top1_equals_greedy_float32": top1,
            "part_s": time.perf_counter() - t_part}, launches


@torch.no_grad()
def check_top1(model32, tb) -> dict:
    """float32, on the kernels: the top1 sampled NA and SA decodes equal
    the greedy kernel decodes (plans and tokens; token log-probs within
    RESCORE_TOL: the plain generator against the head kernel #3)."""
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    src = tb["att_masks"].bool()
    mem = fused_encode(model32, tb["att_feats"], tb["att_masks"])
    out = {}
    for name, dec in (("na", na_decode), ("sa", sa_decode)):
        greedy = dec(model32, mem, src, fused_fill=True)
        top1 = dec(model32, mem, src, fused_fill=True, sample_method="top1",
                   generator=torch.Generator(device=DEV).manual_seed(SEED))
        for k in ("phrase_num", "phrase_length", "phrase_syn", "seq"):
            if not torch.equal(top1[k], greedy[k]):
                fail(f"rl: top1 {name} decode's {k} differs from greedy")
        err = (top1["tok_logprobs"] - greedy["tok_logprobs"]).abs().max()
        if err.item() > RESCORE_TOL:
            fail(f"rl: top1 {name} token log-probs differ by {err.item()}")
        out[name] = {"words": int(greedy["phrase_length"].sum()),
                     "tok_logprob_err": err.item()}
    return out


def check_sampling_law() -> dict:
    """RL_DRAWS draws from one fixed row with a CUDA generator against the
    closed form of each method at temperature RL_T (chi-square, fixed
    seed)."""
    from scipy import stats as sstats
    from boficap_tpu_torch.decode import sampling
    lp = torch.log(torch.tensor([0.3, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05]))
    out = {}
    for method in ("sample", "gumbel", "top3", "top0.9"):
        # the draw is over these log-probs: gumbel's argmax((lp + g) / T)
        # is argmax(lp + g)
        src = lp if method == "gumbel" else lp / RL_T
        if method.startswith("top"):
            num = float(method[3:])
            src = (sampling.top_p_filter(src, num) if num < 1
                   else sampling.top_k_filter(src, int(num)))
        want = torch.softmax(src.double(), -1)
        ids, _ = sampling.sample_next_word(
            lp.to(DEV).expand(RL_DRAWS, -1), method, RL_T,
            torch.Generator(device=DEV).manual_seed(SEED + 11))
        counts = torch.bincount(ids.cpu(), minlength=lp.numel()).double()
        live = want > 1e-9
        if counts[~live].sum() > 0:
            fail(f"rl: {method} drew a word of zero probability")
        p = sstats.chisquare(counts[live].numpy(),
                             (RL_DRAWS * want[live] / want[live].sum())
                             .numpy()).pvalue
        if not p > RL_P_MIN:
            fail(f"rl: {method}'s draws fail the chi-square test (p {p})")
        out[method] = {"p_value": p, "counts": counts.long().tolist()}
    return out


def host_scoring(samples, gts, opt) -> dict:
    """rl_host_scores by the native scorer and by the Python one on the
    same samples: the ms of each (median of 5) and the scores equal."""
    import numpy as np
    from boficap_tpu_torch.rewards import init_scorer
    from boficap_tpu_torch.train import steps
    out, scores = {}, {}
    for name, native in (("native", True), ("python", False)):
        init_scorer("corpus", use_native=native)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            scores[name] = steps.rl_host_scores(samples, gts, opt)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms_median_of_5"] = sorted(ms)[2]
    init_scorer("corpus")
    for k in scores["native"]:
        if not np.allclose(scores["native"][k], scores["python"][k],
                           rtol=1e-5, atol=1e-6):
            fail(f"rl: native and Python scores differ for {k}")
    out["scores_equal"] = True
    out["mean_score"] = {k: float(v.mean())
                         for k, v in scores["native"].items()}
    return out


@torch.no_grad()
def sampler_branches(model, tb, n, gen) -> dict:
    """The bf16 sampler's parts timed alone (ms, the mean of 5 between CUDA
    events): the encode, the SA and the NA decode of the B x n samples."""
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    att, am = tb["att_feats"], tb["att_masks"]
    mem = fused_encode(model, att, am)
    mem_n = mem.repeat_interleave(n, 0)
    src_n = am.bool().repeat_interleave(n, 0)
    kw = dict(sample_method="sample", generator=gen, fused_fill=True)
    parts = {"encode": lambda: fused_encode(model, att, am),
             "sa": lambda: sa_decode(model, mem_n, src_n, **kw),
             "na": lambda: na_decode(model, mem_n, src_n, **kw)}
    return {k: timed(fn, reps=5, warm=1) for k, fn in parts.items()}


def rl_cli(path: str) -> dict:
    """The training CLI in a process of its own, resumed from phase train's
    CLI checkpoint with structure_after 0 for one more epoch of the CLI's
    corpus (its RL iterations), on the kernels: the files and the RL keys
    in metrics.jsonl."""
    from boficap_tpu_torch.train.state import load_infos
    ck = os.path.join(path, "ckpt")
    before = load_infos(ck, "smokecli")
    cmd = [sys.executable, "-m", "boficap_tpu_torch.tools.train",
           "--cfg", os.path.join(HERE, "configs", "uic_sd.yml"),
           "--id", "smokecli", "--checkpoint_path", ck,
           "--input_json", "synthetic", "--input_att_dir", "synthetic",
           "--val_images_use", "6", "--save_checkpoint_every", "1000",
           "--losses_log_every", "1", "--start_from", ck,
           "--structure_after", "0", "--structure_loss_type",
           "new_self_critical", "--train_sample_n", "5",
           "--max_epochs", str(before["epoch"] + 1)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=path, env=dict(os.environ, PYTHONPATH=HERE),
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        fail(f"rl CLI: exit {run.returncode}: {run.stderr[-2000:]}")
    after = load_infos(ck, "smokecli")
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    rl = [r for r in recs if r["iter"] > before["iter"]]
    keys = {"reward", "sa_struc_loss", "na_struc_loss", "loss"}
    if not rl or any(not keys <= set(r) for r in rl):
        fail(f"rl CLI: no RL metrics after iter {before['iter']}: {rl}")
    if not all(math.isfinite(r["loss"]) for r in rl):
        fail(f"rl CLI: a loss is not finite: {rl}")
    return {"exit": 0, "wall_s": time.perf_counter() - t0,
            "iter_before": before["iter"], "iter_after": after["iter"],
            "rl_iterations": len(rl), "metrics": rl,
            "files": sorted(os.listdir(ck))}


def check_aic_scst() -> tuple:
    """configs/transformer.yml at full width (bf16, random weights) with
    use_pallas on: the SCST sampler (a sampled and a greedy AR decode) on
    the encoder stack and the attention core (#9), the classic SCST reward
    on the host, one make_scst_step update that launches no kernel.
    Returns (result, the sampler's launch counts)."""
    from boficap_tpu_torch.convert import flax_layout
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.rewards import init_scorer
    from boficap_tpu_torch.train import optim, steps
    opt = eval_opt("transformer.yml", id="smokeaic", train_sample_n=5,
                   batch_size=10, seq_per_img=5)
    aic = build(None, "transformer.yml")
    aic.set_attention_core(True)
    loader, batch = train_batch(opt)
    tb = steps.to_device(batch, DEV)
    layout = flax_layout(aic)
    o = optim.Optimizer(optim.build_optimizer(opt, layout), aic, layout)
    sampler = steps.make_rl_sample(aic, "sample", 1.0, 5)
    init_scorer("corpus")
    samples, counts = counted(lambda: sampler(
        tb["att_feats"], tb["att_masks"],
        torch.Generator(device=DEV).manual_seed(SEED)))
    for k in AIC_KERNELS:
        if not counts[k]:
            fail(f"rl aic: the SCST sampler never launched {k}: {counts}")
    rewards = steps.rl_host_scores(samples, batch["gts"], opt,
                                   classic_scst=True)["scst_reward"]
    reset_launch_counts()
    m = steps.make_scst_step(aic, o, opt)(
        tb["att_feats"], tb["att_masks"], samples,
        torch.as_tensor(rewards, device=DEV))
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        fail(f"rl aic: the SCST step launched kernels: {launch_counts()}")
    if not math.isfinite(float(m["loss"])):
        fail(f"rl aic: the SCST loss is not finite: {m}")
    return {"sampler_launches": {k: counts[k] for k in AIC_KERNELS},
            "loss": float(m["loss"]), "reward": float(m["reward"]),
            "samples": list(samples["sample"]["seq"].shape)}, counts


def check_rl(model16, batch, tmp: str) -> tuple:
    """Phase rl (see the module docstring): the trained bf16 model of phase
    train through the structure-loss stage of configs/uic_sd_nscl.yml;
    returns (result, the kernel launches of the bf16 sampler's run and the
    AIC SCST sampler's)."""
    import numpy as np
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.rewards import init_scorer
    from boficap_tpu_torch.train import steps
    t_phase = time.perf_counter()
    opt16, opt32 = rl_opt(), rl_opt(dtype="float32")
    n = opt16.train_sample_n
    tb = steps.to_device(batch, DEV)
    gts = batch["gts"]
    state = {k: v.detach().clone() for k, v in model16.state_dict().items()}
    init_scorer("corpus")
    res = {"config": "uic_sd_nscl.yml",
           "images": int(tb["att_feats"].shape[0]), "train_sample_n": n,
           "structure_loss_type": opt16.structure_loss_type,
           "learning_rate": opt16.learning_rate}

    # the kernels in the bf16 sampler, none in the step
    m16, sampler16, step16 = rl_model(opt16, state)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    samples, launches = counted(lambda: sampler16(
        tb["att_feats"], tb["att_masks"], gen))
    wide = bool((samples["sa"]["phrase_length"].max() > W_NARROW).item())
    need = RL_KERNELS + (("window_wide_stack",) if wide else ())
    if any(not launches[k] for k in need):
        fail(f"rl: the bf16 sampler never launched {need}: {launches}")
    res["sampler_launches"] = launches
    res["sa_wide_round"] = wide
    res["planned_words"] = {k: int(samples[k]["phrase_length"].sum())
                            for k in ("sa", "na")}
    if not min(res["planned_words"].values()):
        fail(f"rl: the trained model planned no words: {res}")
    sound = rescore_gap(m16, tb, samples, n)
    control = control_gap(m16, sampler16, tb, n, CONTROL_ULPS)
    res["rescore_bf16"] = {"limit": RESCORE_BF16, "sound": sound,
                           "control_ulps": CONTROL_ULPS, "control": control}
    for k in sound:
        if sound[k]["max_abs_err"] > RESCORE_BF16:
            fail(f"rl: bf16 {k} sampler log-probs {sound[k]['max_abs_err']} "
                 f"off the re-score, above {RESCORE_BF16}")
        if not control[k]["max_abs_err"] > RESCORE_BF16:
            fail(f"rl: the bf16 {k} control ({CONTROL_ULPS} ulps) is only "
                 f"{control[k]['max_abs_err']} off the re-score: the limit "
                 f"{RESCORE_BF16} would not see it")
    res["host_scoring"] = host_scoring(samples, gts, opt16)
    print(f"rl: {json.dumps(res)}", file=sys.stderr, flush=True)

    # float32: top1 against greedy, the sampler against the re-score, the
    # step on the card against the CPU
    m32, sampler32, step32 = rl_model(opt32, state)
    res["top1_equals_greedy_float32"] = check_top1(m32, tb)
    res["wide"], wide_launches = check_rl_wide(m16, sampler16, m32, tb, n)
    s32 = sampler32(tb["att_feats"], tb["att_masks"],
                    torch.Generator(device=DEV).manual_seed(SEED))
    res["rescore_float32"] = rescore_gap(m32, tb, s32, n)
    for k, r in res["rescore_float32"].items():
        if r["max_abs_err"] > RESCORE_TOL:
            fail(f"rl: float32 {k} sampler log-probs {r['max_abs_err']} off "
                 f"the re-score")
    # the card against the CPU on the trained model's float32 samples and
    # their CIDEr-D scores, a leaf beyond GRAD_TOL held to the float64
    # witness
    scores32 = steps.rl_host_scores(s32, gts, opt32)
    res["cross_device_float32"] = {
        "weights": "trained", "scores": "CIDEr-D of the samples",
        **check_rl_cross_device(opt32, state, fixed_samples(tb, s32),
                                scores32)}
    # and on the seeded weights (heads nudged so that the plans are not
    # empty) with seeded scores (their samples score near zero, which
    # would leave no advantage and no gradient to compare), held to the
    # CPU float32 step without the witness
    seeded = {k: v.detach().clone()
              for k, v in build("float32").state_dict().items()}
    _, sampler_s, _ = rl_model(opt32, seeded)
    s_s = sampler_s(tb["att_feats"], tb["att_masks"],
                    torch.Generator(device=DEV).manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 3)
    scores_s = {k: torch.rand((len(gts), n), generator=g).numpy()
                for k in ("sa", "na")}
    planned = {k: int(s_s[k]["phrase_length"].sum()) for k in ("sa", "na")}
    if not min(planned.values()):
        fail(f"rl: the seeded model planned no words: {planned}")
    res["cross_device_float32_seeded"] = {
        "weights": "seeded, heads nudged", "scores": "seeded uniform",
        "planned_words": planned,
        **check_rl_cross_device(opt32, seeded, fixed_samples(tb, s_s),
                                scores_s, witness=False)}
    del sampler_s, s_s
    res["sampling_law"] = check_sampling_law()
    print(f"rl: {json.dumps(res)}", file=sys.stderr, flush=True)

    # steps: 3 warm-up + RL_STEPS at each dtype; the packs rebuilt after
    # each, every loss finite, the parameters moved
    for name, model, sampler, step in (("bfloat16", m16, sampler16, step16),
                                       ("float32", m32, sampler32, step32)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p0 = [p.detach().clone() for p in model.parameters()]
        losses, parts, digests = [], [], [pack_digest(model)]
        for i in range(3 + RL_STEPS):
            pack = model.packed_decoder("NA")
            mt, _, ms = rl_step_once(sampler, step, tb, gts, opt16, gen)
            losses.append(float(mt["loss"]))
            parts.append(ms)
            digests.append(pack_digest(model))
            if model.packed_decoder("NA") is pack or \
                    digests[-1] == digests[-2]:
                fail(f"rl {name}: the packs were not rebuilt after step {i}")
        moved = max((p - q).abs().max().item()
                    for p, q in zip(model.parameters(), p0))
        if not all(math.isfinite(x) for x in losses) or moved == 0:
            fail(f"rl {name}: losses {losses}, parameters moved {moved}")
        timed_parts = np.array(parts[3:])
        totals = timed_parts.sum(1)
        r = {"losses": losses, "max_param_change": moved,
             "step_ms_median_of_10": float(np.median(totals)),
             "step_ms": totals.tolist(),
             "sampler_ms_median": float(np.median(timed_parts[:, 0])),
             "host_scoring_ms_median": float(np.median(timed_parts[:, 1])),
             "update_ms_median": float(np.median(timed_parts[:, 2])),
             "samples_per_s": 2 * n * len(gts) / (
                 float(np.median(timed_parts[:, 0])) / 1e3),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "pack_digests": digests[:4],
             "host_syncs_per_step": count_syncs(lambda: rl_step_once(
                 sampler, step, tb, gts, opt16, gen)),
             "profile_step": profile_decode(lambda: rl_step_once(
                 sampler, step, tb, gts, opt16, gen))}
        r["profile_step"].pop("top_kernels")
        res[f"steps_{name}"] = r
    res["sampler_parts_ms_bf16"] = sampler_branches(m16, tb, n, gen)
    print(f"rl: {json.dumps(res)}", file=sys.stderr, flush=True)

    # zero launches inside the step's autograd
    samples = sampler16(tb["att_feats"], tb["att_masks"], gen)
    scores = steps.rl_host_scores(samples, gts, opt16)
    reset_launch_counts()
    step16(tb["att_feats"], tb["att_masks"], samples,
           {k: torch.as_tensor(v, device=DEV) for k, v in scores.items()},
           rng=gen)
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        fail(f"rl: the RL step launched kernels: {launch_counts()}")
    res["step_launches"] = 0
    del m16, m32, sampler16, sampler32, step16, step32
    torch.cuda.empty_cache()
    res["aic_scst"], aic_launches = check_aic_scst()
    res["cli"] = rl_cli(tmp)
    res["phase_s"] = time.perf_counter() - t_phase
    return res, {k: v + aic_launches[k] + wide_launches[k]
                 for k, v in launches.items()}


# ---------------------------------------------------------------------------
# phase prepro: captions the port alone preprocessed, trained and evaluated
# ---------------------------------------------------------------------------

PREPRO_IMAGES = 200           # Karpathy-format images, 5 captions each
PREPRO_TEST = 64              # of them the test split: one eval batch of B
PREPRO_STEPS = 5              # bf16 XE steps over the preprocessed store
# the captions' words: nouns, adjectives, verbs in -ing and the function
# words the heuristic cutter breaks before
PREPRO_WORDS = (
    "a an the two three man woman boy girl dog cat horse bus train plate "
    "pizza table street park field beach kitchen bench tree car kite "
    "red small young large white black wooden "
    "riding sitting standing holding eating walking playing flying "
    "is are of on in with near under at by and while").split()


def prepro_corpus(seed: int) -> dict:
    """A dataset_coco.json of PREPRO_IMAGES images x 5 captions of 6-16
    words drawn from PREPRO_WORDS; the last PREPRO_TEST images are the
    test split."""
    import random
    rng = random.Random(seed)
    images = []
    for i in range(PREPRO_IMAGES):
        sents = []
        for _ in range(5):
            toks = [rng.choice(PREPRO_WORDS)
                    for _ in range(rng.randint(6, 16))]
            sents.append({"raw": " ".join(toks), "tokens": toks})
        split = "test" if i >= PREPRO_IMAGES - PREPRO_TEST else "train"
        images.append({"cocoid": i, "filepath": "train2014",
                       "filename": f"img{i}.jpg", "split": split,
                       "sentences": sents})
    return {"images": images}


def check_prepro(tmp: str) -> tuple:
    """Phase prepro: a seeded Karpathy-format corpus through the port's
    preprocessing in memory (the heuristic cutter) into a LabelStore, no
    file and no h5py; PREPRO_STEPS bf16 XE steps of uic_sd at full width
    over it on the card (every loss finite; the model's vocabulary is the
    store's); eval_split NAIC on the kernels against the plain path by the
    bf16 margin rule.  Whether h5py imports: with it, the prepro_labels
    CLI writes the files and LabelStore.from_files reads back the store;
    without it, write_prepro raises ImportError."""
    from boficap_tpu_torch.data.dataset import CaptionData, LabelStore
    from boficap_tpu_torch.prepro import labels as pl
    from boficap_tpu_torch.train import steps
    t_phase = time.perf_counter()
    data = prepro_corpus(SEED + 61)
    t0 = time.perf_counter()
    prep = pl.prepro_captions(json.loads(json.dumps(data["images"])), L, 0,
                              "heuristic")
    store = pl.label_store(prep)
    res = {"images": PREPRO_IMAGES, "captions": int(prep.labels.shape[0]),
           "vocab_size": store.vocab_size, "prepro_s": time.perf_counter()
           - t0, "phrases_mean": float(prep.phrase_num.mean()),
           "phrase_length_max": int(prep.phrase_length.max())}
    opt = train_opt(dropout=0.1)
    loader = CaptionData(opt, labels=store)
    model, step = trainer(opt, store.vocab_size)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    losses = []
    for _ in range(PREPRO_STEPS):
        m = step(steps.to_device(loader.get_batch("train"), DEV), gen)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"prepro: a loss is not finite: {losses}")
    res["dtype"], res["losses"] = str(model.dtype).split(".")[-1], losses
    model.eval()
    eval_loader_ = CaptionData(
        eval_opt("uic_sd.yml", id="smokeprepro", batch_size=B), labels=store)
    kw = {"split": "test", "num_images": -1, "language_eval": 1}
    res["eval_NAIC"] = eval_pair(model, eval_loader_, "NAIC", "bfloat16",
                                 kw, NA_KERNELS, na_eval_agree(model, True))
    try:
        import h5py  # noqa: F401
        res["h5py"] = True
    except ImportError:
        res["h5py"] = False
    src = os.path.join(tmp, "dataset_prepro.json")
    with open(src, "w") as f:
        json.dump(data, f)
    out = os.path.join(tmp, "prepro_out")
    os.makedirs(out)
    if res["h5py"]:
        run = subprocess.run(
            [sys.executable, "-m", "boficap_tpu_torch.tools.prepro_labels",
             "--input_json", src, "--output_json",
             os.path.join(out, "talk.json"), "--output_h5",
             os.path.join(out, "talk"), "--max_length", str(L),
             "--word_count_threshold", "0", "--cutter", "heuristic"],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=120)
        if run.returncode != 0:
            fail(f"prepro: the prepro_labels CLI exited {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        back = LabelStore.from_files(os.path.join(out, "talk.json"),
                                     os.path.join(out, "talk_label.h5"),
                                     True)
        for k in ("labels", "label_start_ix", "label_end_ix", "phrase_num",
                  "phrase_length", "phrase_syn"):
            if not (getattr(back, k) == getattr(store, k)).all():
                fail(f"prepro: the CLI's {k} differs from the store's")
        if back.ix_to_word != store.ix_to_word or back.images != \
                store.images:
            fail("prepro: the CLI's json differs from the store's")
        res["cli"] = "files read back equal to the in-memory store"
    else:
        try:
            pl.write_prepro(prep, os.path.join(out, "talk.json"),
                            os.path.join(out, "talk_label.h5"))
            fail("prepro: write_prepro wrote without h5py")
        except ImportError as e:
            res["cli"] = f"write_prepro without h5py: ImportError: {e}"
        if os.listdir(out):
            fail(f"prepro: write_prepro left {os.listdir(out)}")
    res["phase_s"] = time.perf_counter() - t_phase
    return res, res["eval_NAIC"]["launches"]


# ---------------------------------------------------------------------------
# phase decoders: NNAIC on the kernels, the diverse AR decoders
# ---------------------------------------------------------------------------

# the kernels NNAIC's decode runs at B = 64: float32 takes the per-layer
# route, bfloat16 the whole stacks
NNAIC_KERNELS = {"float32": ("encoder_layer", "decoder_layer", "greedy_head"),
                 "bfloat16": NA_KERNELS}
NNAIC_STEPS = 10              # bf16 XE steps on one repeated batch
LEN_RAISE = 0.25              # the margin a planted length 0 / L - 1 wins by
MULTI_KEYS = ("allspice", "allspice_approx", "div1", "div2", "mBLEU_4",
              "oracle_CIDEr", "oracle_Bleu_4", "oracle_ROUGE_L", "self_cider")


def nnaic_opt(**fields):
    """configs/nnaic.yml over the synthetic corpus, a constant Adam rate."""
    return eval_opt("nnaic.yml", id="smokennaic", noamopt=False,
                    learning_rate=TRAIN_LR, learning_rate_decay_start=-1,
                    **fields)


@torch.no_grad()
def spread_lengths(models, att, am) -> dict:
    """Random weights predict one length for almost every image.  Centre
    the length head's bias on the first model's mean logits over these
    images, so each image's own deviation picks its length; then, where no
    image takes length 0 (or L - 1), raise that class until the image
    nearest it takes it by LEN_RAISE (the L - 1 raise spares the images at
    0).  The same bias goes to every model."""
    logits = models[0].nnaic_logits(models[0].encode(att, am))
    nudge = -logits.mean(0)
    for c in (0, L - 1):
        z = logits + nudge
        top = z.argmax(-1)
        if (top == c).any():
            continue
        others = z.clone()
        others[:, c] = -math.inf
        gap = others.max(-1).values - z[:, c]
        gap[top == 0] = math.inf
        nudge[c] += gap.min() + LEN_RAISE
    for m in models:
        m.nn_len_l2.bias += nudge.to(m.nn_len_l2.bias.device)
        m.invalidate_packed()
    return {"bias_nudge": nudge.tolist(),
            "logit_spread": (logits - logits.mean(0)).std().item()}


@torch.no_grad()
def plain_nnaic(model, memory, src):
    """nnaic_decode on the plain path, each image's top-2 margin of the
    length logits [B] and each position's top-2 log-prob margin of the
    fill [B, L]."""
    from boficap_tpu_torch.constants import BOS
    from boficap_tpu_torch.decode.bound_fill import nnaic_decode
    out = nnaic_decode(model, memory, src)
    top2 = model.nnaic_logits(memory).topk(2, -1).values
    keep = torch.arange(L, device=DEV)[None, :] < out["length"][:, None]
    tgt = torch.full((memory.shape[0], L), BOS, device=DEV)
    lp = model.generate(model.decode_a(tgt, memory, src, keep[:, None, :]))
    fill = lp.topk(2, -1).values
    return out, top2[:, 0] - top2[:, 1], fill[..., 0] - fill[..., 1]


def nnaic_agree(got, want, len_margin, margin, what: str,
                noise: float = MARGIN_NOISE, lp_tol=LOGPROB_TOL) -> dict:
    """The NNAIC rule: length identical, except in an image whose plain
    length logits' top-2 margin is below ``noise`` (it then decodes another
    length, and its seq is not compared); seq identical except where the
    plain fill's top-2 margin is below ``noise``; tok_logprobs (where seq
    agrees, PAD past the length included) and entropy within ``lp_tol``
    (None: reported only)."""
    len_diff = got["length"] != want["length"]
    if (len_diff & (len_margin >= noise)).any():
        fail(f"{what}: length differs above the noise margin {noise}")
    same = ~len_diff
    diff = (got["seq"] != want["seq"]) & same[:, None]
    if (diff & (margin >= noise)).any():
        fail(f"{what}: seq differs above the noise margin {noise}")
    e_tok = (got["tok_logprobs"] - want["tok_logprobs"])[
        ~diff & same[:, None]].abs().max().item()
    e_ent = (got["entropy"] - want["entropy"])[same].abs().max().item()
    if lp_tol is not None and not max(e_tok, e_ent) <= lp_tol:
        fail(f"{what}: tok/entropy err {e_tok} {e_ent}")
    return {"length_excused_samples": int(len_diff.sum()),
            "seq_differs_below_margin": int(diff.sum()),
            "tok_logprob_err": e_tok, "entropy_err": e_ent}


@torch.no_grad()
def check_nnaic_decode(model, dtype_name: str, att, am) -> dict:
    """fused_encode + nnaic_decode on the kernels against the plain path at
    the model's dtype, by the NNAIC rule (1e-3 at float32, BF16_MARGIN_NOISE
    at bf16); the kernels' launches around the kernel decode; both decodes'
    ms (CUDA events, the mean of 3)."""
    from boficap_tpu_torch.decode.bound_fill import fused_encode, nnaic_decode
    src = am.bool()
    want, len_margin, margin = plain_nnaic(model, model.encode(att, am), src)

    def kernels():
        return nnaic_decode(model, fused_encode(model, att, am), src,
                            fused_fill=True)

    got, launches = counted(kernels)
    missing = [k for k in NNAIC_KERNELS[dtype_name] if not launches[k]]
    if missing:
        fail(f"nnaic {dtype_name}: {missing} never launched: {launches}")
    bf16 = dtype_name == "bfloat16"
    res = nnaic_agree(got, want, len_margin, margin, f"nnaic {dtype_name}",
                      *((BF16_MARGIN_NOISE, None) if bf16 else ()))
    if bf16 and (res["length_excused_samples"] > B // 4
                 or res["seq_differs_below_margin"] > B * L // 4):
        fail(f"nnaic bf16: {res} differs at over a quarter of the samples "
             f"or positions")
    lengths = want["length"]
    if not ((lengths == 0).any() and (lengths == L - 1).any()):
        fail(f"nnaic {dtype_name}: no length 0 or {L - 1}: {lengths}")
    return {**res, "launches": launches,
            "lengths_histogram": torch.bincount(lengths, minlength=L)
            .tolist(),
            "length_margin_min": len_margin.min().item(),
            "ms": timed(kernels, reps=3, warm=0),
            "plain_ms": timed(lambda: nnaic_decode(
                model, model.encode(att, am), src), reps=3, warm=0)}


def check_nnaic_train(loader_batch) -> dict:
    """One NNAIC float32 XE step on the card against the CPU (the loss to
    1e-5 relative, every gradient leaf to 1e-4 of its largest magnitude,
    the ReLU sides aligned), and NNAIC_STEPS bf16 steps with dropout 0.1 on
    one repeated batch: every loss finite, and the word loss's mean over
    the last three below the first three's.  The length term is reported
    only: the length head gets no gradient (the reference's), and its
    dropout draws move the predicted lengths from step to step."""
    from boficap_tpu_torch.train import steps
    res = {"cross_device_float32": check_cross_device(
        loader_batch, nnaic_opt(dtype="float32", dropout=0.0,
                                drop_prob_lm=0.0))}
    model, step = trainer(nnaic_opt(dropout=0.1))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    tb = steps.to_device(loader_batch, DEV)
    rows = []
    for _ in range(NNAIC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(tb, gen)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     **{k: float(m[k]) for k in ("loss", "word_loss",
                                                 "length_loss")}})
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        fail(f"nnaic train: a loss is not finite: {losses}")
    words = [r["word_loss"] for r in rows]
    if not sum(words[-3:]) < sum(words[:3]):
        fail(f"nnaic train: the word loss did not fall: {words}")
    res["steps_bfloat16"] = {"steps": rows, "step_ms_median": sorted(
        r["ms"] for r in rows[3:])[3]}
    return res


def nnaic_eval_agree(model, bf16: bool):
    def agree(got, want, memory, src):
        _, len_margin, margin = plain_nnaic(model, memory, src)
        return nnaic_agree(got, want, len_margin, margin, "eval NNAIC",
                           *((BF16_MARGIN_NOISE, None) if bf16 else ()))
    return agree


@torch.no_grad()
def sampled_margins(decode):
    """decode()'s outputs and each AR step's top-2 margin of the log-probs
    it picked from (after every constraint and penalty), the steps of the
    calls concatenated [B, calls x L]."""
    from boficap_tpu_torch.decode import ar
    gaps = []
    pick = ar.sample_next_word

    def record(lp, *a, **kw):
        top2 = lp.topk(2, -1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        return pick(lp, *a, **kw)

    ar.sample_next_word = record
    try:
        out = decode()
    finally:
        ar.sample_next_word = pick
    return out, torch.stack(gaps, -1)


def old_beam_agree(got, want, mins, what: str) -> dict:
    """beam_agree on seq and scores; in the samples it holds, the row
    buffers' -inf at the same places and their finite entries within
    LOGPROB_TOL, unaug_p within 1e-5 of its magnitude (a sum of L x V
    log-probs)."""
    res = beam_agree(got, want, mins, what, keys=("scores",))
    same = ~(got["seq"] != want["seq"]).flatten(1).any(-1)
    errs = {}
    for k in ("row_logprobs", "unaug_p"):
        a, b = got[k][same], want[k][same]
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            fail(f"{what}: the {k} -inf entries differ")
        fin = torch.isfinite(b)
        if not torch.isfinite(a[fin]).all():
            fail(f"{what}: {k} is not finite where the plain run's is")
        d = (a[fin] - b[fin]).abs()
        if k == "unaug_p":
            d = d / b[fin].abs().clamp_min(1.0)
        errs[k] = d.max().item() if d.numel() else 0.0
    e_row, e_un = errs["row_logprobs"], errs["unaug_p"]
    if not (e_row <= LOGPROB_TOL and e_un <= 1e-5):
        fail(f"{what}: row err {e_row}, unaug_p rel err {e_un}")
    return {**res, "row_logprob_err": e_row, "unaug_p_rel_err": e_un,
            "neg_inf_entries": int(torch.isneginf(want["row_logprobs"])
                                   .sum())}


@torch.no_grad()
def check_diverse(aic, att, am) -> dict:
    """float32, B = 64: each diverse decode with use_pallas on (#9 on
    every step's self- and cross-attention) against off, on one encoder
    memory, by the margin rule; #9's launches (2 x N_dec x L a group) and
    each decode's
    ms with the core on and off (CUDA events, the mean of 3)."""
    from boficap_tpu_torch.decode import ar
    from boficap_tpu_torch.decode.bound_fill import fused_encode
    src = am.bool()
    mem = fused_encode(aic, att, am)
    res = {"margin_noise": MARGIN_NOISE}
    cases = {
        "diverse_beam_k4_g2": (
            lambda: ar.ar_diverse_beam_search(aic, mem, src, beam_size=4,
                                              group_size=2), 2),
        "old_beam_k3_g1": (lambda: ar.ar_old_beam_search(
            aic, mem, src, beam_size=3), 1),
        "old_beam_k4_g2": (lambda: ar.ar_old_beam_search(
            aic, mem, src, beam_size=4, group_size=2,
            decoding_constraint=True), 2),
        "diverse_sample_dgreedy_g3": (lambda: ar.ar_diverse_sample(
            aic, mem, src, group_size=3), 3)}
    for name, (decode, G) in cases.items():
        sample = name.startswith("diverse_sample")
        want, margin = (sampled_margins if sample else
                        lambda f: topk_margins(f, B))(decode)
        got, c = counted(lambda: with_core(aic, True, decode))
        want_launches = 2 * aic.N_dec * L * G
        if c["attention_core"] != want_launches:
            fail(f"{name}: attention_core launched {c['attention_core']} "
                 f"times, not 2 x {aic.N_dec} layers x {L} steps x {G} "
                 f"groups")
        if sample:
            flat = {k: want[k].flatten(1) for k in want}
            r = ar_agree({k: got[k].flatten(1) for k in got}, flat, margin,
                         name, keys=("tok_logprobs",))
        elif name.startswith("old"):
            r = old_beam_agree(got, want, margin, name)
        else:
            r = beam_agree(got, want, margin, name)
        res[name] = {**r, "attention_core_launches": c["attention_core"],
                     "ms": timed(lambda: with_core(aic, True, decode),
                                 reps=3, warm=0),
                     "plain_ms": timed(decode, reps=3, warm=0)}
    return res


def check_sample_n_eval(aic) -> dict:
    """eval_split on transformer.yml (float32, B = 64, one batch) with
    use_pallas on and sample_n 3 by 'bs', 'dbs' and 'sample': 3 captions
    an image in n_predictions, the multi-sample keys in lang_stats, #9
    launched; the eval's wall s."""
    from boficap_tpu_torch.eval.eval_utils import eval_split
    loader = eval_loader(eval_opt("transformer.yml", id="smoke_n",
                                  batch_size=B))
    out = {}
    for method in ("bs", "dbs", "sample"):
        kw = {"split": "test", "num_images": B, "language_eval": 1,
              "verbose_loss": 0, "sample_n": 3, "sample_n_method": method}
        t0 = time.perf_counter()
        r, c = counted(lambda: with_core(aic, True, lambda: eval_split(
            aic, loader, kw, "")))
        wall = time.perf_counter() - t0
        missing = [k for k in MULTI_KEYS if k not in r["lang_stats"]]
        if missing or len(r["n_predictions"]) != 3 * r["n_images"]:
            fail(f"eval sample_n {method}: missing {missing}, "
                 f"{len(r['n_predictions'])} captions for {r['n_images']}")
        if not c["attention_core"]:
            fail(f"eval sample_n {method}: attention_core never launched")
        out[method] = {"images": r["n_images"],
                       "n_captions": len(r["n_predictions"]),
                       "distinct_captions": len({p["caption"] for p in
                                                 r["n_predictions"]}),
                       "wall_s": wall, "images_per_s": r["images_per_s"],
                       "attention_core_launches": c["attention_core"],
                       **{k: r["lang_stats"][k] for k in MULTI_KEYS}}
    return out


def check_decoders(aic) -> tuple:
    """Phase decoders (see the module docstring); returns (result, the
    kernel launches of its decodes on the kernels)."""
    t_phase = time.perf_counter()
    models = {"float32": build("float32", "nnaic.yml"),
              "bfloat16": build(None, "nnaic.yml")}
    att, am = features(B, seed=31)
    att, am = att.to(DEV), am.to(DEV)
    res = {"config": "nnaic.yml",
           "spread": spread_lengths(list(models.values()), att, am)}
    launches = {}
    for dtype_name, model in models.items():
        r = check_nnaic_decode(model, dtype_name, att, am)
        res[f"nnaic_{dtype_name}"] = r
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    loader = eval_loader(eval_opt("nnaic.yml", id="smoke_nnaic",
                                  batch_size=B))
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 0}
    for dtype_name, model in models.items():
        r = eval_pair(model, loader, "", dtype_name, kw,
                      NNAIC_KERNELS[dtype_name],
                      nnaic_eval_agree(model, dtype_name == "bfloat16"))
        res[f"eval_nnaic_{dtype_name}"] = r
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    del models
    res["train"] = check_nnaic_train(train_batch(nnaic_opt())[1])
    datt, dam = features(B, seed=33)
    res["diverse"] = check_diverse(aic, datt.to(DEV), dam.to(DEV))
    for name, r in res["diverse"].items():
        if isinstance(r, dict):
            launches["attention_core"] = (launches.get("attention_core", 0)
                                          + r["attention_core_launches"])
    res["sample_n_eval"] = check_sample_n_eval(aic)
    res["phase_s"] = time.perf_counter() - t_phase
    return res, launches


# ---------------------------------------------------------------------------
# phase pb: PB_pad (configs/pb.yml at full width) on the card
# ---------------------------------------------------------------------------

# pb.yml's default packed width, 2 (L + 2), and the lossless one, L (L + 1)
# / 2 + 1: no batch's plans pass it, so no sample is clamped
PB_WIDTHS = (2 * (L + 2), L * (L + 1) // 2 + 1)
# the encode's kernel at B = 64: the stack (#4) at bf16, the layer (#1) at
# float32
PB_ENCODE = {"float32": "encoder_layer", "bfloat16": "encoder_stack"}
# the length head favours 3-7 word phrases, so the plans of 20 words hold
# 2-6 phrases
PB_FAVOURED, PB_FAVOUR = range(3, 8), 2.0
# #9 alone past the row path's 128 keys: (Lq, Lk), the packed decoder's
# self-attention at 211 and its cross-attention over the regions among them
PB_ATTENTION = ((129, 129), (211, 211), (256, 256), (211, R))
PB_STEPS = 10                 # bf16 XE steps on one repeated batch


def pb_opt(**fields):
    """configs/pb.yml over the synthetic corpus, a constant Adam rate."""
    return eval_opt("pb.yml", id="smokepb", noamopt=False,
                    learning_rate=TRAIN_LR, learning_rate_decay_start=-1,
                    **fields)


def pb_start(n: int):
    """The decode's first round: bos-framed words, phrase lengths (the bos
    phrase) and phrase counts of ``n`` samples."""
    from boficap_tpu_torch.constants import BOS
    seq = torch.zeros((n, L + 2), dtype=torch.long, device=DEV)
    seq[:, 0] = BOS
    pl = torch.zeros_like(seq)
    pl[:, 0] = 1
    return seq, torch.ones(n, dtype=torch.long, device=DEV), pl


@torch.no_grad()
def shape_pb_plans(models, att, am) -> dict:
    """Random weights predict one phrase length for almost every image.
    Centre the length head's bias on the first model's mean log-probs of
    the first round's prediction over these images and raise the
    PB_FAVOURED lengths by PB_FAVOUR, so each image's own deviation picks
    among them.  The same bias goes to every model."""
    m = models[0]
    seq, pn, pl = pb_start(att.shape[0])
    lp = m.pb_length_predict(seq, pn, pl, m.encode(att, am), am.bool())[:, 0]
    nudge = -lp.mean(0)
    nudge[list(PB_FAVOURED)] += PB_FAVOUR
    for model in models:
        model.len_head2.bias += nudge.to(model.len_head2.bias.dtype)
        model.invalidate_packed()
    return {"bias_nudge": nudge.tolist(),
            "logprob_spread": (lp - lp.mean(0)).std().item()}


@torch.no_grad()
def plain_pb(model, memory, src, W: int):
    """pb_decode on the plain path, and the top-2 log-prob margins of its
    decisions: the length head's at each sample's decision slot, [rounds,
    B], and the head window's at each row, [fills, B, WG]."""
    from boficap_tpu_torch.decode import pb
    lens, words = [], []
    predict, generate = model.pb_length_predict, model.generate

    def rec_predict(seq, pn, pl, *a, **kw):
        lp = predict(seq, pn, pl, *a, **kw)
        top2 = lp[torch.arange(lp.shape[0], device=DEV), pn - 1].topk(
            2, -1).values
        lens.append(top2[:, 0] - top2[:, 1])
        return lp

    def rec_generate(h):
        lp = generate(h)
        top2 = lp.float().topk(2, -1).values
        words.append(top2[..., 0] - top2[..., 1])
        return lp

    model.pb_length_predict, model.generate = rec_predict, rec_generate
    try:
        out = pb.pb_decode(model, memory, src, packed_width=W)
    finally:
        del model.pb_length_predict, model.generate
    return out, torch.stack(lens), torch.stack(words)


def pb_agree(got, want, len_m, word_m, W: int, what: str,
             noise: float = MARGIN_NOISE, lp_tol=LOGPROB_TOL) -> dict:
    """The first-divergence rule (PARITY.md) for PB_pad, whose samples
    share one packed layout (a sample's phrase length moves its batchmates'
    positions): the decisions are identical up to the first round in which
    any sample's differs, and each sample that differs there differs at a
    decision (its phrase length, else its first differing word of that
    round's phrase) where the plain path's top-2 margin is below
    ``noise``.  Past that round the layouts differ and nothing is
    compared.  The token log-probs and entropies of the words decided
    before it within ``lp_tol`` (None: reported only)."""
    pl_w = want["phrase_length"]
    ends = pl_w.cumsum(1)
    starts = ends - pl_w
    len_diff = got["phrase_length"] != pl_w
    seq_diff = got["seq"] != want["seq"]
    k_len = torch.where(len_diff.any(1), len_diff.int().argmax(1), L)
    p_word = torch.where(seq_diff.any(1), seq_diff.int().argmax(1), L)
    k_word = torch.where(seq_diff.any(1),
                         (ends <= p_word[:, None]).sum(1), L)
    first = torch.minimum(k_len, k_word)
    R = int(first.min())
    margins = []
    if R < L:
        col_max = pl_w.max(0).values
        q0 = int(col_max[:R].sum())
        WG = min(L + 1, W)
        q0c = min(max(q0, 0), W - WG)
        for b in torch.nonzero(first == R)[:, 0].tolist():
            if k_len[b] == R:
                at = (len_m[R, b].item() if R < len_m.shape[0]
                      else math.inf)
                kind = "length"
            else:
                idx = q0 - q0c + int(p_word[b] - starts[b, R])
                at = (word_m[R, b, idx].item() if R < word_m.shape[0]
                      else math.inf)
                kind = "word"
            margins.append({"sample": b, "decision": kind, "margin": at})
            if not at < noise:
                fail(f"{what}: sample {b}'s {kind} at round {R} differs "
                     f"with the plain margin {at} >= {noise}")
    before = (torch.arange(L, device=DEV)[None, :] < starts[:, R:R + 1]
              if R < L else torch.ones_like(seq_diff))
    e_tok = (got["tok_logprobs"] - want["tok_logprobs"]).abs()[before]
    e_ent = (got["entropy"] - want["entropy"]).abs()[before]
    e_tok = e_tok.max().item() if e_tok.numel() else 0.0
    e_ent = e_ent.max().item() if e_ent.numel() else 0.0
    if lp_tol is not None and not max(e_tok, e_ent) <= lp_tol:
        fail(f"{what}: tok/entropy err {e_tok} {e_ent}")
    return {"first_divergent_round": None if R == L else R,
            "plain_rounds": len_m.shape[0],
            "samples_differing": int((first < L).sum()),
            "divergent_decisions": margins,
            "tok_logprob_err": e_tok, "entropy_err": e_ent}


@torch.no_grad()
def pb_forward_err(model, memory, src, want, W: int) -> dict:
    """The predictor's log-probs and the packed decoder's hidden states
    over the plain decode's final plan and layout (the same inputs), with
    the attention core (#9) against the plain attend: rel err each."""
    from boficap_tpu_torch.decode import pb
    n = want["seq"].shape[0]
    seq, pn, pl = pb_start(n)
    seq[:, 1:-1] = want["seq"]
    pl[:, 1:-1] = want["phrase_length"]
    pn = pn + want["phrase_num"]
    ids, slot, mask, _ = pb.packed_layout(seq, pl, L + 1, W)

    def run():
        return (model.pb_length_predict(seq, pn, pl, memory, src),
                model.pb_decode(ids, slot, seq, pl, memory, src, mask,
                                return_hidden=True))

    plain = run()
    core = with_core(model, True, run)
    return {"length_logprob_rel_err": rel_err(core[0], plain[0]),
            "hidden_rel_err": rel_err(core[1], plain[1])}


@torch.no_grad()
def check_pb_decode(model, dtype_name: str, att, am, W: int) -> dict:
    """fused_encode + pb_decode with use_pallas on (#9 on every attention
    of the predictor and the packed decoder) against the plain path at the
    model's dtype and packed width ``W``, by the first-divergence rule
    (MARGIN_NOISE and LOGPROB_TOL at float32, BF16_MARGIN_NOISE at bf16,
    where at most a quarter of the samples may diverge at the first
    divergent round); #9's launches, 2 a predictor layer a round and 2
    N_dec a fill, and the encode's kernel; rounds and host syncs; the
    forward with and without #9 on the plain decode's layout; both
    decodes' ms (CUDA events, the mean of 3)."""
    from boficap_tpu_torch.decode import bound_fill as bf
    from boficap_tpu_torch.decode import pb
    src = am.bool()
    memory = model.encode(att, am)
    want, len_m, word_m = plain_pb(model, memory, src, W)
    stats = {}

    def kernels(st=None):
        return pb.pb_decode(model, bf.fused_encode(model, att, am), src,
                            packed_width=W, stats=st)

    got, launches = with_core(model, True,
                              lambda: counted(lambda: kernels(stats)))
    what = f"pb {dtype_name} W={W}"
    if stats["host_syncs"] != stats["rounds"]:
        fail(f"{what}: {stats}")
    want_core = (2 * model.n_lp * stats["rounds"]
                 + 2 * model.N_dec * stats["fills"])
    if launches["attention_core"] != want_core:
        fail(f"{what}: attention_core launched "
             f"{launches['attention_core']} times, not {want_core} "
             f"({stats})")
    enc = PB_ENCODE[dtype_name]
    want_enc = 1 if enc == "encoder_stack" else model.N_enc
    others = {k: v for k, v in launches.items()
              if v and k not in ("attention_core", enc)}
    if launches[enc] != want_enc or others:
        fail(f"{what}: encode launches {launches}, not {want_enc} of {enc}")
    bf16 = dtype_name == "bfloat16"
    res = pb_agree(got, want, len_m, word_m, W, what,
                   *((BF16_MARGIN_NOISE, None) if bf16 else ()))
    if bf16 and len(res["divergent_decisions"]) > B // 4:
        fail(f"{what}: {len(res['divergent_decisions'])} samples diverge "
             f"at round {res['first_divergent_round']}")
    fwd = pb_forward_err(model, memory, src, want, W)
    tol = TOL[dtype_name]
    if not max(fwd.values()) <= tol:
        fail(f"{what}: forward with #9 against plain {fwd} > {tol}")
    return {**res, "forward_with_core": fwd, "stats": stats,
            "launches": launches, "attention_core_expected": want_core,
            "phrase_num_histogram": torch.bincount(
                want["phrase_num"], minlength=L + 1).tolist(),
            "packed_width_used": int(want["phrase_length"].max(0).values
                                     .sum()),
            "ms": with_core(model, True, lambda: timed(kernels, 3, 0)),
            "plain_ms": timed(lambda: pb.pb_decode(
                model, model.encode(att, am), src, packed_width=W), 3, 0)}


@torch.no_grad()
def check_pb_attention() -> dict:
    """#9 alone past 128 keys, B = 64, H = 8, Dh = 64: the path
    attention_path gives (tile at bf16: two passes over chunks of 128 keys;
    ffma_long at float32) and that path forced, against the plain twin
    within TOL (at bf16 past 128 keys also in all but at most
    CORE_LONG_SHARE of the elements), a fully masked sample and row among the
    operands; the row path forced past its key bound (at.row_key_max)
    raises ValueError.
    Device ms of the kernel, of each other path of the dtype forced where
    it fits (``by_path_ms``: at float32 the ffma block, the path these
    shapes took before ffma_long), the plain twin and SDPA (the
    yardstick), and the bound."""
    from boficap_tpu_torch.ops import attention as at
    g = torch.Generator().manual_seed(41)
    H, Dh = 8, D // 8
    out = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for Lq, Lk in PB_ATTENTION:
            def heads(rows):
                return torch.randn((B, rows, H, Dh), generator=g).to(
                    DEV, dtype).transpose(1, 2)
            q, k, v = heads(Lq), heads(Lk), heads(Lk)
            live = torch.randint(1, Lk + 1, (B,), generator=g)
            live[0] = 0
            m = (torch.arange(Lk)[None, None, :] < live[:, None, None]
                 ).expand(B, Lq, Lk).contiguous()
            m[1, 0] = False
            m = m.to(DEV)
            path = at.attention_path(Lq, Lk, dtype)
            want = at.attention_core_plain(q, k, v, m)
            errs = {}
            for forced in (None, path):
                got = at.attention_core(q, k, v, m, path=forced)
                torch.cuda.synchronize()
                e = rel_err(got, want)
                if not torch.isfinite(got.float()).all() or e > TOL[
                        dtype_name]:
                    fail(f"attention_core {Lq}x{Lk} {dtype_name} path "
                         f"{forced or path}: rel err {e}")
                errs[forced or "auto"] = {
                    "rel_err": e, "max_abs_err": (got.float() - want.float())
                    .abs().max().item(),
                    **core_long_check(got, want, Lq, Lk, dtype)}
            if Lk > at.row_key_max(dtype):
                try:
                    at.attention_core(q, k, v, m, path="row")
                    fail(f"attention_core {Lq}x{Lk}: the row path took "
                         f"{Lk} keys")
                except ValueError:
                    pass
            bound, by = attention_bound(q, k, v, m, dtype_name)
            out[f"{dtype_name}_{Lq}x{Lk}"] = {
                "path": path, **errs["auto"], "by_path": errs,
                "tolerance_rel": TOL[dtype_name],
                "shared_bytes": at.shared_bytes(Lq, Lk, Dh, dtype),
                "ms": device_ms(lambda: at.attention_core(q, k, v, m)),
                "by_path_ms": other_paths_ms(q, k, v, m, dtype),
                "plain_ms": device_ms(lambda: at.attention_core_plain(
                    q, k, v, m)),
                "library_ms": device_ms(lambda: library_attention(q, k, v,
                                                                  m)),
                "bound_ms": bound, "bound_by": by}
    return out


def check_pb_train() -> dict:
    """One PB_pad float32 XE step on the card against the CPU on a 10 x 5
    batch with its packed layouts (the loss to 1e-5 relative, every
    gradient leaf to 1e-4 of its largest magnitude, the ReLU sides
    aligned), and PB_STEPS bf16 steps with dropout 0.1 on that batch:
    every loss finite, the mean of the last three below the first three's."""
    from boficap_tpu_torch.train import steps
    _, batch = train_batch(pb_opt())
    res = {"batch_captions": int(batch["labels"].shape[0]
                                 * batch["labels"].shape[1]),
           "packed_width": int(batch["pb_ids"].shape[1]),
           "cross_device_float32": check_cross_device(
               batch, pb_opt(dtype="float32", dropout=0.0,
                             drop_prob_lm=0.0))}
    model, step = trainer(pb_opt(dropout=0.1))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    tb = steps.to_device(batch, DEV)
    rows = []
    for _ in range(PB_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(tb, gen)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     **{k: float(m[k]) for k in ("loss", "phrase_loss",
                                                 "length_loss")}})
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        fail(f"pb train: a loss is not finite: {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"pb train: the loss did not fall: {losses}")
    res["steps_bfloat16"] = {"steps": rows, "step_ms_median": sorted(
        r["ms"] for r in rows[3:])[3]}
    return res


def pb_eval_agree(model, W: int):
    def agree(got, want, memory, src):
        _, len_m, word_m = plain_pb(model, memory, src, W)
        return pb_agree(got, want, len_m, word_m, W, "eval PB_pad float32")
    return agree


@torch.no_grad()
def check_pb_eval_convert(model32, tmp: str) -> tuple:
    """The float32 model through model.ckpt (the port's writer and reader,
    bitwise), then eval_split at B = 64 and the lossless packed width on
    the kernels (#1 and #9) against the plain path, by the first-divergence
    rule.  Then the model as the original reference's model.pth (its key
    schema, written by torch.save) through the port's convert CLI in a
    subprocess: the converted model.ckpt loads bitwise, and its eval_split
    on the kernels gives the captions of the model it came from.  Returns
    (result, the kernel eval's launches)."""
    from boficap_tpu_torch.convert import load_jax_checkpoint, to_jax_tree
    from boficap_tpu_torch.eval import eval_utils
    from boficap_tpu_torch.models import setup
    from tests._torch_port_refschema import reference_state_dict
    W = PB_WIDTHS[1]
    opt = pb_opt(batch_size=B, dtype="float32")
    loader = eval_loader(opt)
    loaded, rt = round_trip(model32, opt, loader, os.path.join(tmp, "pb"))
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 0, "pb_packed_width": W}
    res = {"round_trip": rt, "eval_float32": eval_pair(
        loaded, loader, "", "float32", kw, ("encoder_layer",
                                            "attention_core"),
        pb_eval_agree(loaded, W), core=True)}
    launches = res["eval_float32"]["launches"]

    sd = reference_state_dict(to_jax_tree(model32), "PB_pad")
    pth = os.path.join(tmp, "model.pth")
    torch.save(sd, pth)
    vocab_json = os.path.join(tmp, "vocab.json")
    with open(vocab_json, "w") as f:
        json.dump({"ix_to_word": loader.ix_to_word}, f)
    out_dir = os.path.join(tmp, "converted")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.convert", "--torch",
         pth, "--train_mode", "PB_pad", "--input_json", vocab_json,
         "--out_dir", out_dir, "--id", "converted"],
        cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
        text=True, timeout=600)
    if run.returncode != 0:
        fail(f"convert CLI: exit {run.returncode}: {run.stderr[-2000:]}")
    cli_s = time.perf_counter() - t0
    conv = load_jax_checkpoint(os.path.join(out_dir, "model.ckpt"),
                               setup(opt, VOCAB, DEV)).eval()
    differ = [n for (n, a), (_, b) in zip(conv.named_parameters(),
                                          model32.named_parameters())
              if not torch.equal(a, b)]
    if differ:
        fail(f"convert: {len(differ)} parameters differ, e.g. {differ[:3]}")
    conv.set_attention_core(True)
    try:
        got = eval_utils.eval_split(conv, loader,
                                    {**kw, "use_cuda_fill": "auto"})
    finally:
        conv.set_attention_core(False)
    orig = with_core(loaded, True, lambda: eval_utils.eval_split(
        loaded, loader, {**kw, "use_cuda_fill": "auto"}))
    caps = [p["caption"] for p in got["predictions"]]
    if caps != [p["caption"] for p in orig["predictions"]]:
        fail("convert: the converted model's captions differ from its "
             "source's")
    res["convert"] = {"reference_keys": len(sd), "cli_s": cli_s,
                      "ckpt_bytes": os.path.getsize(
                          os.path.join(out_dir, "model.ckpt")),
                      "parameters_bitwise": True,
                      "captions": len(caps), "captions_equal": len(caps),
                      "captions_nonempty": sum(bool(c) for c in caps),
                      "example": caps[0][:80]}
    return res, launches


def check_pb(smi: str) -> tuple:
    """Phase pb (see the module docstring); returns (result, the kernel
    launches of its decodes on the kernels and its eval, the #9 rows past
    the key bound)."""
    t_phase = time.perf_counter()
    models = {"float32": build("float32", "pb.yml"),
              "bfloat16": build(None, "pb.yml")}
    att, am = features(B, seed=37)
    att, am = att.to(DEV), am.to(DEV)
    res = {"config": "pb.yml",
           "plans": shape_pb_plans(list(models.values()), att, am)}
    launches, times = {}, {}
    for dtype_name, model in models.items():
        for W in PB_WIDTHS:
            r = check_pb_decode(model, dtype_name, att, am, W)
            res[f"decode_{dtype_name}_w{W}"] = r
            times[f"{dtype_name}_w{W}"] = {"ms": r["ms"],
                                           "plain_ms": r["plain_ms"],
                                           "rounds": r["stats"]["rounds"]}
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    emit({"phase": "pb_decode_ms", "card": smi, "B": B, **times})
    res["attention_past_key_bound"] = check_pb_attention()
    res["train"] = check_pb_train()
    with tempfile.TemporaryDirectory(prefix="boficap_pb_") as tmp:
        ev, ev_launches = check_pb_eval_convert(models["float32"], tmp)
    res.update(ev)
    for k, v in ev_launches.items():
        launches[k] = launches.get(k, 0) + v
    res["phase_s"] = time.perf_counter() - t_phase
    return res, launches


# ---------------------------------------------------------------------------
# phase 17: the LSTM captioners
# ---------------------------------------------------------------------------

LSTM_CONFIGS = {"fc": "fc.yml", "updown": "updown.yml",
                "att2in2": "a2i2.yml", "aoa": "aoa.yml"}
LSTM_LOGIT_SCALE = 8.0        # a random model's words barely depend on it
LSTM_STEPS = 10               # bf16 XE steps of AoANet on one batch


def lstm_build(name: str, dtype=None, device=None):
    """An LSTM captioner at its config's full width over VOCAB words,
    random weights from SEED; ``dtype`` overrides the compute dtype
    (None: the default, bfloat16).  The logit is scaled up, the bias
    noised, the other control ids lowered and EOS raised, so the greedy
    words depend on the image and some captions end early (the same
    change on every device)."""
    from boficap_tpu_torch.config import load_config
    from boficap_tpu_torch.convert import init_params
    device = device or DEV
    cfg = load_config(os.path.join(HERE, "configs", LSTM_CONFIGS[name]))
    if dtype is not None:
        cfg.dtype = dtype
    model = init_params(cfg, VOCAB, seed=SEED, device=device).eval()
    g = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        model.logit.weight.mul_(LSTM_LOGIT_SCALE)
        bias = 0.5 * torch.randn(model.tgt_vocab, generator=g)
        bias[[0, 1, 3]] -= 6.0
        bias[2] += 1.0
        model.logit.bias.add_(bias.to(device))
    return model


def lstm_opt(name: str, config: str = None, **fields):
    """An LSTM config as the trainer reads it, over the synthetic corpus,
    a constant Adam rate."""
    return eval_opt(config or LSTM_CONFIGS[name], id=f"smoke{name}",
                    noamopt=False, learning_rate=TRAIN_LR,
                    learning_rate_decay_start=-1, **fields)


def encode_decode(model, att, am, decode, **kw):
    """The main path's encode (the server's: ``fused_encode``, the
    model's own encode for an LSTM) and ``decode``."""
    from boficap_tpu_torch.decode.bound_fill import fused_encode
    return decode(model, fused_encode(model, att, am), am.bool(), **kw)


@torch.no_grad()
def check_aoa_core(aoa, dtype_name: str, att, am) -> dict:
    """AoANet with use_pallas on (#9 on the refiner's self-attentions and
    every step's decoder attention) against off, on the same features:
    the encode's output, ar_sample greedy and ar_beam_search K_BEAM by the
    margin rule (float32 at MARGIN_NOISE with the token log-probs within
    LOGPROB_TOL; bf16 at BF16_MARGIN_NOISE, at most a quarter of the
    shared-context positions excused); #9's launches: N_enc an encode
    and one a step."""
    from boficap_tpu_torch.decode.ar import ar_beam_search, ar_sample
    src = am.bool()
    bf16 = dtype_name == "bfloat16"
    noise, tol = ((BF16_MARGIN_NOISE, None) if bf16
                  else (MARGIN_NOISE, LOGPROB_TOL))
    want_launches = aoa.N_enc + L
    mem = aoa.encode(att, am)
    mem_core, c = counted(lambda: with_core(aoa, True,
                                            lambda: aoa.encode(att, am)))
    if c["attention_core"] != aoa.N_enc:
        fail(f"lstm aoa {dtype_name}: the encode launched #9 "
             f"{c['attention_core']} times, not N_enc {aoa.N_enc}")
    res = {"encode_max_abs_err": (mem_core.float() - mem.float()).abs()
           .max().item(), "encode_rel_err": rel_err(mem_core, mem)}
    if res["encode_rel_err"] > TOL[dtype_name]:
        fail(f"lstm aoa {dtype_name}: encode with #9 off by "
             f"{res['encode_rel_err']}")

    want, margin = plain_ar(aoa, ar_sample, mem, src)
    got, c = counted(lambda: with_core(aoa, True, lambda: encode_decode(
        aoa, att, am, ar_sample)))
    if c["attention_core"] != want_launches:
        fail(f"lstm aoa {dtype_name} greedy: #9 launched "
             f"{c['attention_core']} times, not {aoa.N_enc} + {L}")
    greedy = ar_agree(got, want, margin, f"lstm aoa greedy {dtype_name}",
                      noise, tol)
    shared = shared_context(got, want)
    if bf16 and greedy["excused_samples"] > shared // 4:
        fail(f"lstm aoa greedy bf16: {greedy} in {shared} positions")
    res["ar_sample"] = {**greedy, "shared_context_positions": shared,
                        "seq_identical_samples": int(
                            (got["seq"] == want["seq"]).all(-1).sum()),
                        "attention_core_launches": c["attention_core"]}

    want, mins = beam_margins(aoa, mem, src, K_BEAM)
    got, c = counted(lambda: with_core(aoa, True, lambda: encode_decode(
        aoa, att, am, ar_beam_search, beam_size=K_BEAM)))
    if c["attention_core"] != want_launches:
        fail(f"lstm aoa {dtype_name} beam: #9 launched "
             f"{c['attention_core']} times, not {aoa.N_enc} + {L}")
    res["ar_beam_search"] = {
        "beam_size": K_BEAM, **beam_agree(got, want, mins,
                                          f"lstm aoa beam {dtype_name}",
                                          noise, tol),
        "top_beam_differs": int((got["seq"][:, 0] != want["seq"][:, 0])
                                .any(-1).sum()),
        "attention_core_launches": c["attention_core"]}
    res["attention_core_expected"] = want_launches
    return res


@torch.no_grad()
def lstm_card_cpu_decodes(name: str, cpu, card, att, am) -> dict:
    """float32, the same weights on the card and the CPU: greedy and beam
    K_BEAM seq identical, by the margin rule (the card's rounding against
    the CPU's, MARGIN_NOISE), the token log-probs within LOGPROB_TOL."""
    from boficap_tpu_torch.decode.ar import ar_beam_search, ar_sample
    a, m = att.cpu(), am.cpu()
    mem = cpu.encode(a, m)
    want, margin = plain_ar(cpu, ar_sample, mem, m.bool())
    got = {k: v.cpu() for k, v in encode_decode(card, att, am,
                                                ar_sample).items()}
    res = {"greedy": {**ar_agree(got, want, margin.cpu(),
                                 f"lstm {name} card vs cpu greedy"),
                      "seq_identical": bool(torch.equal(got["seq"],
                                                        want["seq"]))}}
    want, mins = beam_margins(cpu, mem, m.bool(), K_BEAM)
    got = {k: v.cpu() for k, v in encode_decode(
        card, att, am, ar_beam_search, beam_size=K_BEAM).items()}
    res["beam"] = {**beam_agree(got, want, mins.cpu(),
                                f"lstm {name} card vs cpu beam"),
                   "seq_identical": bool(torch.equal(got["seq"],
                                                     want["seq"]))}
    return res


def lstm_xe_grads(model, batch, record=None, align=None):
    """One deterministic XE step's loss and gradients (no dropout: AoANet's
    refiner drops at a fixed 0.1 under a generator), the ReLU inputs
    recorded or aligned as ``relu_hooks`` does."""
    from boficap_tpu_torch.train import steps
    dev = next(model.parameters()).device
    handles, stats = relu_hooks(model, record, align)
    try:
        loss, _ = steps.xe_loss_fn(model, steps.to_device(batch, dev), None)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    return (float(loss.detach()), [n for n, _ in model.named_parameters()],
            [None if g is None else g.detach().cpu() for g in grads], stats)


def lstm_cross_device(name: str, cpu, card, batch) -> dict:
    """float32, dropout off: one XE step on the card against the CPU (the
    loss to 1e-5 relative, every gradient leaf to GRAD_TOL of its largest
    magnitude, the ReLU sides aligned)."""
    relu = {}
    lc, names, gc, _ = lstm_xe_grads(cpu, batch, record=relu)
    _, _, raw, _ = lstm_xe_grads(card, batch)
    lg, _, gg, stats = lstm_xe_grads(card, batch, align=relu)
    if abs(lg - lc) > 1e-5 * abs(lc):
        fail(f"lstm {name}: card loss {lg} != CPU loss {lc}")
    return {"loss_card": lg, "loss_cpu": lc,
            "loss_rel_err": abs(lg - lc) / abs(lc),
            **compare_grads(f"lstm {name}", names, gg, gc, raw, relu,
                            stats)}


def lstm_trainer(model, opt):
    from boficap_tpu_torch.convert import flax_layout
    from boficap_tpu_torch.train import optim, steps
    layout = flax_layout(model)
    o = optim.Optimizer(optim.build_optimizer(opt, layout), model, layout)
    return o, steps.make_xe_step(model, o)


def check_lstm_train(aoa16, updown16) -> dict:
    """bf16: LSTM_STEPS XE steps of AoANet (use_pallas on, dropout at the
    config's rate, a constant Adam rate) on one repeated 10 x 5 batch, the
    loss falling and no kernel launched; one classic SCST step of
    aoa_sc.yml (the sampler on #9: N_enc + 2 x L launches; the update
    none) and one structure-loss step of updown/updown_nsc.yml (no kernel
    anywhere); then each model's XE step ms (median of 10 after 3
    warm-ups) and peak memory."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.rewards import init_scorer
    from boficap_tpu_torch.train import steps
    opt = lstm_opt("aoa")
    _, batch = train_batch(opt)
    tb = steps.to_device(batch, DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    aoa16.set_attention_core(True)
    o, step = lstm_trainer(aoa16, opt)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = [float(step(tb, gen)["loss"]) for _ in range(LSTM_STEPS)]
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        fail(f"lstm train: the XE steps launched kernels: {launch_counts()}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"lstm train: a loss is not finite: {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"lstm train: the loss did not fall: {losses}")
    res = {"xe_bfloat16_aoa": {"losses": losses, "launches": 0}}

    init_scorer("corpus")
    sc_opt = lstm_opt("aoa", "aoa_sc.yml", self_critical_after=0,
                      train_sample_n=5)
    sampler = steps.make_rl_sample(aoa16, "sample", 1.0, 5)
    samples, c = counted(lambda: sampler(tb["att_feats"], tb["att_masks"],
                                         gen))
    want = aoa16.N_enc + 2 * L
    if c["attention_core"] != want:
        fail(f"lstm scst: the sampler launched #9 {c['attention_core']} "
             f"times, not {aoa16.N_enc} + 2 x {L}")
    rewards = steps.rl_host_scores(samples, batch["gts"], sc_opt,
                                   classic_scst=True)["scst_reward"]
    reset_launch_counts()
    m = steps.make_scst_step(aoa16, o, sc_opt)(
        tb["att_feats"], tb["att_masks"], samples,
        torch.as_tensor(rewards, device=DEV))
    torch.cuda.synchronize()
    if any(launch_counts().values()) or not math.isfinite(float(m["loss"])):
        fail(f"lstm scst: step launches {launch_counts()}, loss {m}")
    res["scst_aoa"] = {"sampler_launches": c["attention_core"],
                       "step_launches": 0, "loss": float(m["loss"]),
                       "reward": float(m["reward"])}

    nsc_opt = lstm_opt("updown", "updown/updown_nsc.yml", structure_after=0,
                       train_sample_n=5)
    uo, _ = lstm_trainer(updown16, nsc_opt)
    sampler = steps.make_rl_sample(updown16, "sample", 1.0, 5)
    samples, c = counted(lambda: sampler(tb["att_feats"], tb["att_masks"],
                                         gen))
    scores = {k: torch.as_tensor(v, device=DEV) for k, v in
              steps.rl_host_scores(samples, batch["gts"], nsc_opt).items()}
    reset_launch_counts()
    m = steps.make_rl_step(updown16, uo, nsc_opt)(
        tb["att_feats"], tb["att_masks"], samples, scores, rng=gen)
    torch.cuda.synchronize()
    if (any(c.values()) or any(launch_counts().values())
            or not math.isfinite(float(m["loss"]))):
        fail(f"lstm structure loss: sampler {c}, step {launch_counts()}, "
             f"loss {m}")
    res["structure_loss_updown"] = {
        "loss": float(m["loss"]), "reward": float(m["reward"]),
        "sampler_launches": 0, "step_launches": 0}
    aoa16.set_attention_core(False)
    return res


def lstm_step_times(models16) -> dict:
    """Each model's bf16 XE step (dropout at the config's rate) on a 10 x 5
    batch: ms, the median of 10 after 3 warm-ups; the peak memory of the
    steps over what was resident before them (the phase's other models)."""
    from boficap_tpu_torch.train import steps
    out = {}
    for name, model in models16.items():
        opt = lstm_opt(name)
        _, batch = train_batch(opt)
        tb = steps.to_device(batch, DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        _, step = lstm_trainer(model, opt)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(step, tb, gen, 10)
        peak = torch.cuda.max_memory_allocated()
        out[name] = {"step_ms_median": sorted(ms)[len(ms) // 2],
                     "step_ms": ms, "peak_memory_bytes": peak,
                     "resident_bytes": resident,
                     "step_peak_bytes": peak - resident,
                     "losses_finite": all(map(math.isfinite, losses))}
    return out


def check_lstm_eval_serve(aoa32, aoa16, updown16, tmp: str) -> tuple:
    """The bf16 AoANet through the port's checkpoint writer and reader
    (bitwise); eval_split AIC greedy at B = 64 on the float32 AoANet with
    use_pallas on against off (the margin rule; the captions counted
    equal); CaptionServer(mode="AIC") on the bf16 AoANet (use_pallas on:
    #9 N_enc + L times a batch) and UpDown (no kernel), 80 requests
    each, every answer a direct decode of its batch.  Returns
    (result, the AoANet server's launch counts)."""
    opt = lstm_opt("aoa", batch_size=B)
    loader = eval_loader(opt)
    _, rt = round_trip(aoa16, opt, loader, os.path.join(tmp, "aoa"))
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1, "beam_size": 1}
    res = {"checkpoint": rt, "eval_aic_float32": eval_pair(
        aoa32, eval_loader(lstm_opt("aoa", batch_size=B, dtype="float32")),
        "", "float32", kw, ("attention_core",), ar_eval_agree(aoa32, False),
        core=True)}
    aoa16.set_attention_core(True)
    try:
        served = check_serve(aoa16, "AIC", ("attention_core",))
    finally:
        aoa16.set_attention_core(False)
    n_batches = len(served["batch_sizes"])
    want = (aoa16.N_enc + L) * n_batches
    if served["launches"]["attention_core"] != want:
        fail(f"lstm serve aoa: #9 launched "
             f"{served['launches']['attention_core']} times, not "
             f"({aoa16.N_enc} + {L}) x {n_batches} batches")
    res["serve_aoa"] = {**served, "attention_core_expected": want}
    res["serve_updown"] = check_serve(updown16, "AIC", ())
    if any(res["serve_updown"]["launches"].values()):
        fail(f"lstm serve updown: kernels launched "
             f"{res['serve_updown']['launches']}")
    return res, served["launches"]


def lstm_decode_times(models, att, am) -> dict:
    """Each model's B = 64 greedy decode (encode + ar_sample), the mean of
    3 after a warm-up by CUDA events, at both dtypes; AoANet with
    use_pallas off and on; AoANet's device-busy share in one profiled bf16
    decode with #9."""
    from boficap_tpu_torch.decode.ar import ar_sample
    out = {}
    for (name, dtype_name), model in models.items():
        for core in ((False, True) if name == "aoa" else (False,)):
            key = f"{name}_{dtype_name}" + ("_core" if core else "")
            out[key] = with_core(model, core, lambda: timed(
                lambda: encode_decode(model, att, am, ar_sample), reps=3,
                warm=1))
    aoa = models[("aoa", "bfloat16")]
    out["aoa_bfloat16_core_profile"] = with_core(
        aoa, True, lambda: profile_decode(
            lambda: encode_decode(aoa, att, am, ar_sample)))
    return out


def check_lstm(smi: str) -> tuple:
    """Phase lstm (see the module docstring).  Returns (result, #9's
    launches on the AoANet server's run)."""
    t_phase = time.perf_counter()
    att, am = features(B, seed=23)
    att, am = att.to(DEV), am.to(DEV)
    models = {(n, d): lstm_build(n, None if d == "bfloat16" else d)
              for n in LSTM_CONFIGS for d in ("float32", "bfloat16")}
    res = {"card": smi, "configs": LSTM_CONFIGS,
           "aoa_core": {d: check_aoa_core(models[("aoa", d)], d, att, am)
                        for d in ("float32", "bfloat16")}}
    # every model on the card against the CPU, the weights carried across
    from boficap_tpu_torch.convert import load_jax_params, to_jax_tree
    res["card_vs_cpu_float32"] = {}
    for name in LSTM_CONFIGS:
        card = models[(name, "float32")]
        cpu = lstm_build(name, "float32", "cpu")
        load_jax_params(card, to_jax_tree(cpu))
        _, batch = train_batch(lstm_opt(name, dtype="float32"))
        res["card_vs_cpu_float32"][name] = {
            **lstm_card_cpu_decodes(name, cpu, card, att, am),
            "xe_step": lstm_cross_device(name, cpu, card, batch)}
        del cpu
    res["train"] = check_lstm_train(models[("aoa", "bfloat16")],
                                    models[("updown", "bfloat16")])
    # the training moved the bf16 weights: fresh ones for what follows
    for name in ("aoa", "updown"):
        models[(name, "bfloat16")] = lstm_build(name)
    with tempfile.TemporaryDirectory(prefix="boficap_lstm_") as tmp:
        ev, launches = check_lstm_eval_serve(
            models[("aoa", "float32")], models[("aoa", "bfloat16")],
            models[("updown", "bfloat16")], tmp)
    res.update(ev)
    res["xe_step_bfloat16"] = lstm_step_times(
        {n: lstm_build(n) for n in LSTM_CONFIGS})
    res["decode_ms"] = lstm_decode_times(models, att, am)
    res["phase_s"] = time.perf_counter() - t_phase
    return res, launches


# ---------------------------------------------------------------------------
# phase raw: a folder of images through the ResNet-101 trunk and the eval
# CLI, the layer and stack kernels past 128 keys
# ---------------------------------------------------------------------------

GRID = 196                    # a 14 x 14 image grid: the raw path's regions
RAW_SIDES = (300, 640)        # each image side drawn from this range
RAW_CPU_IMAGES = 2            # images of the trunk's card-vs-CPU check
# the trunk's features, card against CPU on the same weights, both in full
# float32 (no TF32): relative to the largest magnitude, sums in other
# orders through 104 layers
TRUNK_TOL = 1e-4
# the layer and stack kernels (and #9) whose attentions see the 196 keys
GRID_KERNELS = ("attention_core", "encoder_layer", "decoder_layer",
                "encoder_stack", "decoder_stack", "window_layer",
                "window_stack", "window_wide_stack")
# the phrase length raised in the raw CLI's model: the random trunk's
# features differ little between images, and every image took the same
# SA plan (at LONG = 10, two wide rounds and no narrow one on the H100); a
# first phrase of 15 words is a wide round, and any second phrase, clamped
# to the 5 positions left, a narrow one
RAW_LONG = 15
# the eval CLI's runs over the folder: (mode, dtype, model)
RAW_RUNS = (("NAIC", "bfloat16", "uic_sd"), ("SAIC", "bfloat16", "uic_sd"),
            ("NAIC", "float32", "uic_sd"), ("SAIC", "float32", "uic_sd"),
            ("AIC", "bfloat16", "aic"))


def write_raw_images(folder: str, n: int, seed: int) -> list:
    """n binary PPM images (P6, maxval 255) of seeded noise, each side drawn
    from RAW_SIDES: the raw path's input, readable without PIL."""
    g = torch.Generator().manual_seed(seed)
    os.makedirs(folder)
    names = []
    for i in range(n):
        h, w = torch.randint(RAW_SIDES[0], RAW_SIDES[1] + 1, (2,),
                             generator=g).tolist()
        pixels = torch.randint(0, 256, (h, w, 3), generator=g,
                               dtype=torch.uint8)
        names.append(f"img{i:03d}.ppm")
        with open(os.path.join(folder, names[-1]), "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode() + pixels.numpy().tobytes())
    return names


@torch.no_grad()
def check_trunk(folder: str, names: list) -> tuple:
    """The ResNet-101 trunk (random He-init from SEED, float32) on the
    card through DataLoaderRaw over the folder, with cuDNN's TF32 switched
    on around it: every convolution must see TF32 off and the setting must
    come back on; the first RAW_CPU_IMAGES images' features against the
    same trunk on the CPU; the features' scale; ms an image.  Returns the
    result and the batch's (att, am) on the card."""
    from boficap_tpu_torch.data.raw import (DataLoaderRaw, read_image,
                                            resize_image, trunk_extractor)
    from boficap_tpu_torch.models.resnet import (IMAGENET_MEAN,
                                                 IMAGENET_STD, init_resnet,
                                                 resnet_features)
    seen = []

    def conv_tf32(module, args):
        if isinstance(module, torch.nn.Conv2d):
            seen.append(torch.backends.cudnn.allow_tf32)

    prev = torch.backends.cudnn.allow_tf32
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        conv_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        loader = DataLoaderRaw(folder, B, extractor=trunk_extractor(
            device=DEV, seed=SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = loader.get_batch("test")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        after = torch.backends.cudnn.allow_tf32
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = prev
    if not seen or any(seen) or not after:
        fail(f"raw trunk: TF32 inside the forward {sorted(set(seen))}, "
             f"after it {after} (the caller's True must come back)")
    fc, att = batch["fc_feats"], batch["att_feats"]
    if att.shape != (B, GRID, 2048) or not batch["att_masks"].all():
        fail(f"raw trunk: att {att.shape}, masks {batch['att_masks'].sum()}")
    cpu = init_resnet(seed=SEED, device="cpu")
    mean, std = torch.from_numpy(IMAGENET_MEAN), torch.from_numpy(IMAGENET_STD)
    errs = []
    for i in range(RAW_CPU_IMAGES):
        img = torch.from_numpy(read_image(os.path.join(folder, names[i]))
                               .astype("float32") / 255.0)
        x = (resize_image(img, 448) - mean) / std
        cfc, catt = resnet_features(cpu, x[None])
        e = {"fc": rel_err(torch.from_numpy(fc[i]), cfc[0]),
             "att": rel_err(torch.from_numpy(att[i]), catt[0])}
        if max(e.values()) > TRUNK_TOL:
            fail(f"raw trunk: image {i} card vs CPU rel err {e} > "
                 f"{TRUNK_TOL}")
        errs.append(e)
    del cpu
    card = init_resnet(seed=SEED, device=DEV)
    x = torch.randn((1, 448, 448, 3), device=DEV)
    res = {
        "images": len(names), "sides": list(RAW_SIDES),
        "tf32": {"caller_set": True, "inside_forward": sorted(set(seen)),
                 "restored": after,
                 "global_for_the_decodes": prev},
        "card_vs_cpu_rel_err": errs, "tolerance_rel": TRUNK_TOL,
        "feature_scale": {"att_max_abs": float(abs(att).max()),
                          "att_mean_abs": float(abs(att).mean()),
                          "fc_max_abs": float(abs(fc).max())},
        "extract_ms_per_image": extract_s / B * 1e3,
        "forward_ms_b1": timed(lambda: resnet_features(card, x), reps=10)}
    del card
    return res, (torch.from_numpy(att).to(DEV),
                 torch.from_numpy(batch["att_masks"]).to(DEV))


@torch.no_grad()
def check_grid_kernels(model, short=None) -> dict:
    """#1, #2, #4, #5 (check_kernels) and #8, #6, #7
    (check_window_kernels) over GRID regions at B = 64, float32 and
    bfloat16, padded regions and a fully masked sample among them, #5
    called STACK_REPEATS times bitwise equal; #9 at the AR step's
    cross-attention over GRID keys (the row path's wide score rows at
    bf16, ffma_long at float32).  Each
    is held to TOL, the tolerance the same kernel meets at R regions,
    printed beside it with that reading (``short``: phase kernels' errors
    by dtype and kernel, #9's its ar_cross case)."""
    from boficap_tpu_torch.ops import attention as at
    errs = check_kernels(model, GRID, head=False)
    werrs = check_window_kernels(model, GRID)
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        q, k, v, m = attention_cases(dtype, regions=GRID)["ar_cross"]
        got = at.attention_core(q, k, v, m)
        want = at.attention_core_plain(q, k, v, m)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        if not torch.isfinite(got.float()).all() or e > TOL[dtype_name]:
            fail(f"attention_core {dtype_name} 1 x {GRID}: rel err {e}")
        errs[dtype_name].update(werrs[dtype_name])
        errs[dtype_name]["attention_core"] = {
            "path": at.attention_path(1, GRID, dtype), "rel_err": e,
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            **core_long_check(got, want, 1, GRID, dtype)}
        for name in GRID_KERNELS:
            row = errs[dtype_name][name]
            row["tolerance_rel"] = TOL[dtype_name]
            if short is not None:
                row[f"rel_err_at_{R}_keys"] = short[dtype_name][name][
                    "rel_err"]
    return errs


def raw_yaml(path: str, **fields) -> str:
    """A flat YAML of ``fields`` for the eval CLI's --cfg."""
    with open(path, "w") as f:
        for k, v in fields.items():
            f.write(f"{k}: {v}\n")
    return path


@torch.no_grad()
def raw_cli_run(argv: list, cwd: str) -> dict:
    """``boficap_tpu_torch.tools.eval.main(argv)`` in ``cwd``, its output
    captured, each decode call recorded (``recording``) and the launch
    counts read around the run."""
    import contextlib
    import io
    from boficap_tpu_torch.eval import eval_utils
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.tools import eval as teval
    log, models = [], []
    make = eval_utils.make_decoders
    eval_utils.make_decoders = recording(make, log, models)
    here = os.getcwd()
    os.makedirs(cwd)
    os.chdir(cwd)
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        reset_launch_counts()                       # the CLI's run starts
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = teval.main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()                    # ... and ends
        wall = time.perf_counter() - t0
    finally:
        os.chdir(here)
        eval_utils.make_decoders = make
    return {"result": result, "log": log, "model": models[0],
            "counts": counts, "stdout": out.getvalue(), "wall_s": wall}


def raw_cli(folder: str, tmp: str, feats, aic16) -> tuple:
    """The eval CLI over the folder on the card through model.ckpt: the
    uic_sd model (bf16, random weights, its plans shaped on the folder's
    trunk features) NAIC and SAIC at bf16 (the whole-stack route) and, the
    same file read at float32, on the per-layer route; AIC on
    transformer.yml at bf16 with use_pallas on.  Each run on the kernels
    (use_cuda_fill auto) against the plain path on the card
    (use_cuda_fill 0, use_pallas off) by the margin rules, each route's
    kernels launched; then the module in a process of its own."""
    import re
    from boficap_tpu_torch.data.raw import IMAGE_EXTS
    uic = build()
    shift_stop([uic])
    long_shift = shape_plans([uic], feats=feats, long=RAW_LONG)
    ckpts = {}
    for key, config, model in (("uic_sd", "uic_sd.yml", uic),
                               ("aic", "transformer.yml", aic16)):
        opt = eval_opt(config, id=f"raw_{key}", batch_size=B)
        ck = os.path.join(tmp, key)
        write_checkpoint(model, opt, eval_loader(opt), ck)
        ckpts[key] = [os.path.join(ck, "model.ckpt"),
                      os.path.join(ck, f"infos_raw_{key}.pkl")]
    del uic
    res = {"long_bias_shift": long_shift, "margin_noise": {
        "float32": MARGIN_NOISE, "bfloat16": BF16_MARGIN_NOISE}}
    launches = {}
    for mode, dtype_name, key in RAW_RUNS:
        bf16 = dtype_name == "bfloat16"
        runs = {}
        for route in ("plain", "kernels"):
            core = key == "aic" and route == "kernels"
            yml = raw_yaml(os.path.join(tmp, f"{key}_{mode}_{dtype_name}_"
                                             f"{route}.yml"),
                           dtype=dtype_name, use_pallas=core,
                           use_cuda_fill=0 if route == "plain" else "auto")
            argv = ["--model", ckpts[key][0], "--infos_path", ckpts[key][1],
                    "--cfg", yml, "--image_folder", folder,
                    "--device", DEV, "--inference_mode", mode,
                    "--num_images", "-1",
                    "--language_eval", "1", "--dump_images", "0"]
            runs[route] = raw_cli_run(argv, os.path.join(
                tmp, f"cli_{key}_{mode}_{dtype_name}_{route}"))
        plain, kern = runs["plain"], runs["kernels"]
        what = f"raw CLI {mode} {dtype_name}"
        if any(plain["counts"].values()):
            fail(f"{what} plain: kernels launched: {plain['counts']}")
        missing = [k for k in EVAL_KERNELS[mode, dtype_name]
                   if kern["counts"][k] == 0]
        if missing:
            fail(f"{what}: {missing} never launched: {kern['counts']}")
        for r in (plain, kern):
            if f"ResNet-101 trunk extractor on {DEV}" not in r["stdout"]:
                fail(f"{what}: the loader did not take the trunk on the "
                     f"card: {r['stdout'][:500]}")
            if "language_eval -> 0" not in r["stdout"]:
                fail(f"{what}: no language_eval notice")
            preds = r["result"]["predictions"]
            if (len(preds) != B
                    or not all(isinstance(p["caption"], str) for p in preds)
                    or not math.isfinite(r["result"]["images_per_s"])):
                fail(f"{what}: {len(preds)} predictions, images/s "
                     f"{r['result']['images_per_s']}")
        if len(kern["log"]) != len(plain["log"]) or not kern["log"]:
            fail(f"{what}: {len(kern['log'])} kernel decodes, "
                 f"{len(plain['log'])} plain")
        if any(m.shape[1] != GRID for m, _, _ in plain["log"]):
            fail(f"{what}: a memory is not {GRID} regions")
        agree = {"NAIC": na_eval_agree, "SAIC": sa_eval_agree,
                 "AIC": ar_eval_agree}[mode](plain["model"], bf16)
        batches = [agree(out_k, out_p, mem_p, src) for (_, src, out_k),
                   (mem_p, _, out_p) in zip(kern["log"], plain["log"])]
        same = sum(a["caption"] == b["caption"] for a, b in zip(
            kern["result"]["predictions"], plain["result"]["predictions"]))
        res[f"{mode}_{dtype_name}"] = {
            "route": "use_pallas" if key == "aic" else (
                "stacked" if bf16 else "per_layer"),
            "images_per_s": kern["result"]["images_per_s"],
            "plain_images_per_s": plain["result"]["images_per_s"],
            "wall_s": kern["wall_s"], "plain_wall_s": plain["wall_s"],
            "launches": kern["counts"], "captions_equal": same,
            "captions_nonempty": sum(bool(p["caption"]) for p in
                                     kern["result"]["predictions"]),
            "example": kern["result"]["predictions"][0]["caption"][:80],
            "batches": batches}
        for k, v in kern["counts"].items():
            launches[k] = launches.get(k, 0) + v
        del runs, plain, kern
    # the module as a user runs it, in a process of its own (bf16, the
    # checkpoint's dtype; the images copied to vis/imgs from the folder)
    cwd = os.path.join(tmp, "cli_process")
    os.makedirs(cwd)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.eval",
         "--model", ckpts["uic_sd"][0], "--infos_path", ckpts["uic_sd"][1],
         "--image_folder", folder, "--device", DEV,
         "--inference_mode", "NAIC", "--num_images", "-1", "--dump_path",
         "1"],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"raw CLI process: exit {run.returncode}: {run.stderr[-2000:]}")
    line = re.search(CLI_DECODE_LINE, run.stdout)
    with open(os.path.join(cwd, "vis", "vis.json")) as f:
        vis = json.load(f)
    names = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith(IMAGE_EXTS))
    if (line is None or [p["file_name"] for p in vis] != names
            or len(os.listdir(os.path.join(cwd, "vis", "imgs"))) != B):
        fail(f"raw CLI process: decode line {line}, {len(vis)} captions, "
             f"stdout {run.stdout[-1000:]!r}")
    res["process"] = {"exit": 0, "wall_s": wall,
                      "decode_line": line.group(0), "captions": len(vis),
                      "images_copied": B}
    return res, launches


def check_raw(model, aic16, smi: str, short=None) -> tuple:
    """Phase raw: 64 images of mixed sizes through the trunk (card vs CPU,
    TF32 off), the layer and stack kernels over 196 regions against their
    twins (``short``: as check_grid_kernels), and the eval CLI over the
    folder on every route."""
    t_phase = time.perf_counter()
    res = {"card": smi, "regions": GRID, "tolerance_rel": TOL}
    with tempfile.TemporaryDirectory(prefix="boficap_raw_") as tmp:
        folder = os.path.join(tmp, "images")
        names = write_raw_images(folder, B, SEED + 41)
        res["trunk"], feats = check_trunk(folder, names)
        res["kernels"] = check_grid_kernels(model, short)
        res["cli"], launches = raw_cli(folder, tmp, feats, aic16)
    res["phase_s"] = time.perf_counter() - t_phase
    return res, launches


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------

def timed(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """A call's device time, the mean of ``reps`` calls each timed alone:
    the card spins (torch.cuda._sleep) while the host enqueues the call
    between two events, so the events read the card's time, not the host's
    time to launch it (which exceeds a small kernel's, and a multi-op
    yardstick's).  One call at a time: a whole run of a stack's yardstick
    (~180 ops a call) would overflow the launch queue (~1024 entries) and
    leave the host launching inside the timed window.  Where the card
    reached the first event before the host had enqueued the call (the
    spin too short: a slow enqueue, a garbage collection), the reps run
    again with a spin 4 times longer, up to twice; ``device_ms.retries``
    counts those runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    for attempt in range(3):
        events, outran = [], False
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            # cover twice the host's enqueue time at up to 2 GHz
            torch.cuda._sleep(int(2 * host_s * 2e9) + 100_000)
            start.record()
            fn()
            outran = outran or start.query()
            stop.record()
            events.append((start, stop))
        torch.cuda.synchronize()
        if not outran or attempt == 2:
            break
        device_ms.retries += 1
        host_s *= 4
    return sum(a.elapsed_time(b) for a, b in events) / reps


device_ms.retries = 0


def sdpa(q, k, v, m, H):
    """F.scaled_dot_product_attention on [B, L, D] activations, a bool
    mask ([B, Lk] or [B, Lq, Lk]) as a -1e9 bias, as the port masks."""
    import torch.nn.functional as F
    Bn, Lq, D = q.shape
    Dh = D // H

    def heads(t):
        return t.reshape(Bn, t.shape[1], H, Dh).transpose(1, 2)

    bias = torch.zeros(m.shape, dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~m, -1e9)
    bias = bias[:, None, None, :] if m.dim() == 2 else bias[:, None]
    o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                       attn_mask=bias)
    return o.transpose(1, 2).reshape(Bn, Lq, D)


def library_layer(x, mask, w, H, cross=None):
    """Yardstick only: an eager layer with torch.matmul and
    F.scaled_dot_product_attention (masks as a -1e9 bias, as the port)."""
    from boficap_tpu_torch.ops.decoder_layer import refnorm_plain
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = (torch.matmul(n0, w["wqkv"]) + w["bqkv"]).split(D, -1)
    x = x + torch.matmul(sdpa(q, k, v, mask, H), w["wo"]) + w["bo"]
    if cross is not None:
        mem, src = cross
        n1 = refnorm_plain(x, w["s1"], w["b1"])
        q2 = torch.matmul(n1, w["wq2"]) + w["bq2"]
        k2, v2 = (torch.matmul(mem, w["wkv2"]) + w["bkv2"]).split(D, -1)
        x = x + torch.matmul(sdpa(q2, k2, v2, src, H), w["wo2"]) + w["bo2"]
        s, b = w["s2"], w["b2"]
    else:
        s, b = w["s1"], w["b1"]
    n = refnorm_plain(x, s, b)
    f = torch.relu(torch.matmul(n, w["w1"]) + w["bf1"])
    return x + torch.matmul(f, w["w2"]) + w["bf2"]


def library_stack(x, mask, pack, H, cross=None):
    """Yardstick only: library_layer over a stack's layers, then the final
    norm."""
    from boficap_tpu_torch.ops.decoder_layer import refnorm_plain
    for w in pack.layers:
        x = library_layer(x, mask, w, H, cross)
    return refnorm_plain(x, *pack.final_norm)


def library_window_layer(x, kc, vc, k2, v2, tgt, src, w, H):
    """Yardstick only: an eager window layer, torch.matmul products and
    SDPA over the cache ++ window keys (kc None: the window's alone)."""
    from boficap_tpu_torch.ops.decoder_layer import refnorm_plain
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = (torch.matmul(n0, w["wqkv"]) + w["bqkv"]).split(D, -1)
    keys, vals = ((k, v) if kc is None else
                  (torch.cat([kc, k], 1), torch.cat([vc, v], 1)))
    x = x + torch.matmul(sdpa(q, keys, vals, tgt, H), w["wo"]) + w["bo"]
    n1 = refnorm_plain(x, w["s1"], w["b1"])
    q2 = torch.matmul(n1, w["wq2"]) + w["bq2"]
    x = x + torch.matmul(sdpa(q2, k2, v2, src, H), w["wo2"]) + w["bo2"]
    n2 = refnorm_plain(x, w["s2"], w["b2"])
    f = torch.relu(torch.matmul(n2, w["w1"]) + w["bf1"])
    return x + torch.matmul(f, w["w2"]) + w["bf2"], k, v


def library_window_stack(x, ws, kc, vc, k2, v2, tgt, src, stacked, norm, H):
    """Yardstick only: library_window_layer over the layers, each layer's
    fresh K/V written into its cache with index_copy_ (ws None: the wide
    round, the fresh K/V returned as the caches)."""
    from boficap_tpu_torch.ops.decoder_layer import refnorm_plain
    Bn, W, D = x.shape
    if ws is not None:
        rows = ((torch.arange(Bn, device=x.device) * L + ws.long())[:, None]
                + torch.arange(W, device=x.device)[None, :]).reshape(-1)
    ks, vs = [], []
    for i in range(k2.shape[0]):
        w = {k: t[i] for k, t in stacked.items()}
        x, k, v = library_window_layer(
            x, None if ws is None else kc[i], None if ws is None else vc[i],
            k2[i], v2[i], tgt, src, w, H)
        if ws is None:
            ks.append(k)
            vs.append(v)
        else:
            kc[i].view(-1, D).index_copy_(0, rows, k.reshape(-1, D))
            vc[i].view(-1, D).index_copy_(0, rows, v.reshape(-1, D))
    h = refnorm_plain(x, *norm)
    return (h, torch.stack(ks), torch.stack(vs)) if ws is None else (h, kc,
                                                                      vc)


def library_attention(q, k, v, m):
    """Yardstick only: F.scaled_dot_product_attention on the same views,
    the bool mask (True = attend) broadcast over the heads."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None])


def library_head(h, weight_vd, b):
    import torch.nn.functional as F
    lp = torch.log_softmax(F.linear(h, weight_vd, b).float(), dim=-1)
    ids = lp.argmax(-1)
    tok = lp.gather(-1, ids[..., None])[..., 0]
    ent = -(lp.exp() * lp).sum(-1)
    return ids, tok, ent, lp[..., 0]


def bounds(dtype_name: str, esize: int, R: int = R,
           w_narrow: int = W_NARROW):
    """Least time (ms) for each kernel's work at the serving shapes (over
    ``R`` regions; the narrow window ``w_narrow`` wide), and which of bytes
    or operations bounds it."""
    F, H, V = 4 * D, 8, VOCAB + 4
    Dh = D // H
    peak = PEAK_FLOPS[dtype_name]
    norm_b = 4 * 2 * D
    me, ml = B * R, B * L
    enc_f = (2 * me * D * 3 * D + 2 * me * D * D + 4 * me * D * F
             + 4 * B * H * R * R * Dh)
    enc_b = (esize * (2 * me * D + 4 * D * D + 2 * D * F + 4 * D + F)
             + 2 * norm_b + B * R)
    dec_f = (2 * ml * D * 3 * D + 3 * 2 * ml * D * D + 2 * me * D * 2 * D
             + 4 * ml * D * F + 4 * B * H * L * L * Dh
             + 4 * B * H * L * R * Dh)
    dec_b = (esize * (2 * ml * D + me * D + 8 * D * D + 2 * D * F + 8 * D + F)
             + 3 * norm_b + B * L * L + B * R)
    head_f = 2 * ml * D * V
    head_b = esize * (ml * D + D * V + V) + ml * (8 + 3 * 4)
    # the stacks: NL layers' work; x in and out once, every layer's weights
    # and the final norm's read once, the memory and the masks read once
    enc_w = esize * (4 * D * D + 2 * D * F + 4 * D + F) + 2 * norm_b
    encs_b = esize * 2 * me * D + NL * enc_w + norm_b + B * R
    dec_w = esize * (8 * D * D + 2 * D * F + 8 * D + F) + 3 * norm_b
    decs_b = (esize * (2 * ml * D + me * D) + NL * dec_w + norm_b
              + B * L * L + B * R)

    def window(W, n_cache):
        """One window layer on B * W rows with n_cache cache keys: its
        operations, and the bytes of its weights."""
        m = B * W
        f = (2 * m * D * 3 * D + 3 * 2 * m * D * D + 4 * m * D * F
             + 4 * B * H * W * (n_cache + W) * Dh + 4 * B * H * W * R * Dh)
        return f, esize * (6 * D * D + 2 * D * F + 7 * D + F) + 3 * norm_b

    mw, ml_ = B * w_narrow, B * L
    masks_n = B * w_narrow * (L + w_narrow) + B * R
    # #8, narrow: x in; out, k_new, v_new out; cache and cross K/V read
    wl_f, wl_w = window(w_narrow, L)
    wl_b = wl_w + esize * (4 * mw * D + 2 * B * L * D + 2 * B * R * D) + masks_n
    # #6: x in, h out, per layer the caches read and only the window's rows
    # written (the rest stay in place), the cross K/V read; w_start int32
    ws_b = (NL * wl_w + esize * (2 * mw * D + NL * (2 * B * L * D + 2 * mw * D
                                                    + 2 * B * R * D))
            + masks_n + 4 * B)
    # #7: x in, h out, per layer the fresh K/V written as the caches and
    # the cross K/V read; no cache keys
    ww_f, ww_w = window(L, 0)
    ww_b = (NL * ww_w + esize * (2 * ml_ * D + NL * (2 * ml_ * D
                                                     + 2 * B * R * D))
            + B * L * L + B * R)
    # #9 at the AR step's cross-attention: q and out [B, H, 1, Dh], k and v
    # [B, H, R, Dh], the mask [B, 1, R]
    att_f = 4 * B * H * R * Dh
    att_b = esize * (2 * B * D + 2 * B * R * D) + B * R
    out = {}
    for name, f, b in (("attention_core", att_f, att_b),
                       ("encoder_layer", enc_f, enc_b),
                       ("decoder_layer", dec_f, dec_b),
                       ("greedy_head", head_f, head_b),
                       ("encoder_stack", NL * enc_f, encs_b),
                       ("decoder_stack", NL * dec_f, decs_b),
                       ("window_layer", wl_f, wl_b),
                       ("window_stack", NL * wl_f, ws_b),
                       ("window_wide_stack", NL * ww_f, ww_b)):
        t_ops, t_bytes = f / peak * 1e3, b / HBM_BYTES_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "gflop": f / 1e9, "mbytes": b / 1e6}
    return out


@torch.no_grad()
def kernel_table(model, dtype, regions: int = R) -> dict:
    """Each kernel's calls at B = 64 over ``regions`` regions, by name:
    (the kernel, its plain twin, its library yardstick); ``model`` gives
    the weights (float32), cast to ``dtype``."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
    dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
    head = dl.pack_head_weights(model.generator.proj, dtype)
    wvd = model.generator.proj.weight.detach().to(dtype)
    hbv = model.generator.proj.bias.detach().to(dtype)
    x_enc, src, x_dec, mem, tgt, h = layer_inputs(dtype, 4, regions)
    enc = st.pack_encoder_stack(model.encoder, dtype)
    dec = st.pack_decoder_stack(model._decoder("NA"), dtype)
    pack = st.pack_window_weights(model._decoder("SA"), dtype)
    w0, ws_, fn = pack.layers[0], pack.stack, pack.final_norm
    xn, wkc, wvc, wk2, wv2, wst, tgn, srn = window_inputs(
        dtype, W_NARROW, 14, regions=regions)
    xw, _, _, _, _, _, tgw, srw = window_inputs(dtype, L, 15, wide=True,
                                                regions=regions)
    aq, ak, av, amk = attention_cases(dtype, regions=regions)["ar_cross"]
    return {
        "attention_core": (
            lambda: at.attention_core(aq, ak, av, amk),
            lambda: at.attention_core_plain(aq, ak, av, amk),
            lambda: library_attention(aq, ak, av, amk)),
        "encoder_layer": (
            lambda: dl.fused_encoder_layer(x_enc, src, enc_w, H),
            lambda: dl.encoder_layer_plain(x_enc, src, enc_w, H),
            lambda: library_layer(x_enc, src, enc_w, H)),
        "decoder_layer": (
            lambda: dl.fused_decoder_layer(x_dec, mem, tgt, src, dec_w,
                                           H),
            lambda: dl.decoder_layer_plain(x_dec, mem, tgt, src, dec_w,
                                           H),
            lambda: library_layer(x_dec, tgt, dec_w, H,
                                  cross=(mem, src))),
        "greedy_head": (
            lambda: dl.fused_greedy_head(h, *head),
            lambda: dl.greedy_head_plain(h, *head),
            lambda: library_head(h, wvd, hbv)),
        "encoder_stack": (
            lambda: st.fused_encoder_stack_forward(
                x_enc, src, enc.stack, enc.final_norm, H),
            lambda: st.encoder_stack_plain(
                x_enc, src, enc.stack, enc.final_norm, H),
            lambda: library_stack(x_enc, src, enc, H)),
        "decoder_stack": (
            lambda: st.fused_decoder_stack_forward(
                x_dec, mem, tgt, src, dec.stack, dec.final_norm, H),
            lambda: st.decoder_stack_plain(
                x_dec, mem, tgt, src, dec.stack, dec.final_norm, H),
            lambda: library_stack(x_dec, tgt, dec, H, cross=(mem, src))),
        "window_layer": (
            lambda: dl.fused_window_decoder_layer(
                xn, wkc[0], wvc[0], wk2[0], wv2[0], tgn, srn, w0, H),
            lambda: dl.window_layer_plain(
                xn, wkc[0], wvc[0], wk2[0], wv2[0], tgn, srn, w0, H),
            lambda: library_window_layer(
                xn, wkc[0], wvc[0], wk2[0], wv2[0], tgn, srn, w0, H)),
        "window_stack": (
            lambda: st.fused_window_decoder_stack(
                xn, wst, wkc, wvc, wk2, wv2, tgn, srn, ws_, fn, H),
            lambda: st.window_stack_plain(
                xn, wst, wkc, wvc, wk2, wv2, tgn, srn, ws_, fn, H),
            lambda: library_window_stack(
                xn, wst, wkc, wvc, wk2, wv2, tgn, srn, ws_, fn, H)),
        "window_wide_stack": (
            lambda: st.fused_window_wide_stack(
                xw, wk2, wv2, tgw, srw, ws_, fn, H),
            lambda: st.window_wide_stack_plain(
                xw, wk2, wv2, tgw, srw, ws_, fn, H),
            lambda: library_window_stack(
                xw, None, None, None, wk2, wv2, tgw, srw, ws_, fn, H)),
    }


def time_table(table: dict, bnd: dict) -> dict:
    """device_ms of each entry of ``kernel_table``: kernel, plain, library,
    then the kernel again (the two kernel readings bracket the others on
    the same card), beside its bound."""
    out = {}
    for name, (kern, plain, lib) in table.items():
        k1 = device_ms(kern)
        p = device_ms(plain)
        lb = device_ms(lib)
        k2 = device_ms(kern)
        out[name] = {"ms": min(k1, k2), "ms_first": k1, "ms_last": k2,
                     "plain_ms": p, "library_ms": lb, **bnd[name]}
    return out


@torch.no_grad()
def measure(model, model16):
    """Times at B = 64; ``model`` is float32, ``model16`` the default
    (bfloat16) model of the main paths."""
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     use_stacked)
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    res = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        res[dtype_name] = time_table(
            kernel_table(model, dtype),
            bounds(dtype_name, 4 if dtype_name == "float32" else 2))
    # one full NA decode at B = 64 in each dtype, on the route each takes
    # (bfloat16: the whole-stack kernels; float32: the per-layer ones)
    att, am = features(B, seed=5)
    att, am = att.to(DEV), am.to(DEV)
    res["na"] = {}
    for name, m in (("bfloat16", model16), ("float32", model)):
        def once(fused, m=m):
            mem_ = fused_encode(m, att, am) if fused else m.encode(att, am)
            return na_decode(m, mem_, am.bool(), fused_fill=fused)["seq"]

        torch.cuda.synchronize()
        reset_launch_counts()
        once(True)
        torch.cuda.synchronize()
        counts = launch_counts()
        dk1 = timed(lambda: once(True), reps=5, warm=1)
        dp = timed(lambda: once(False), reps=5, warm=1)
        dk2 = timed(lambda: once(True), reps=5, warm=1)
        res["na"][name] = {
            "route": "stacked" if use_stacked(m, B) else "per_layer",
            "na_decode_b64_ms": {"kernel_path": min(dk1, dk2),
                                 "plain_path": dp},
            "launches_per_decode": counts,
            "breakdown_b64": breakdown(m, att, am)}
    res["na"]["profile_b64_bf16"] = profile_decode(
        lambda: na_decode(model16, fused_encode(model16, att, am), am.bool(),
                          fused_fill=True)["seq"])
    res["sa"] = measure_sa(model, model16, att, am)
    return res


def grid_attentions(regions: int = GRID) -> dict:
    """(Lq, Lk) of each attention of the GRID_KERNELS over ``regions``
    regions, by kernel and role."""
    narrow = {"self": (W_NARROW, L + W_NARROW), "cross": (W_NARROW, regions)}
    decoder = {"self": (L, L), "cross": (L, regions)}
    return {"attention_core": {"cross": (1, regions)},
            "encoder_layer": {"self": (regions, regions)},
            "encoder_stack": {"self": (regions, regions)},
            "decoder_layer": decoder, "decoder_stack": decoder,
            "window_layer": narrow, "window_stack": narrow,
            "window_wide_stack": decoder}


@torch.no_grad()
def measure_grid(model) -> dict:
    """GRID_KERNELS over a 196-region memory at B = 64 (#9 at the AR
    step's cross-attention, 1 x 196), each beside its bound, its plain
    twin and its library yardstick, float32 and bfloat16, with the path of
    each of its attentions (``attention_paths``); #9 also on each other
    path of the dtype, forced where it fits (``by_path_ms``)."""
    from boficap_tpu_torch.ops import attention as at
    out = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        table = kernel_table(model, dtype, GRID)
        out[dtype_name] = rows = time_table(
            {name: table[name] for name in GRID_KERNELS},
            bounds(dtype_name, 4 if dtype_name == "float32" else 2, GRID))
        for name, roles in grid_attentions().items():
            rows[name]["attention_paths"] = {
                role: at.attention_path(Lq, Lk, dtype)
                for role, (Lq, Lk) in roles.items()}
        q, k, v, m = attention_cases(dtype, regions=GRID)["ar_cross"]
        rows["attention_core"]["path"] = at.attention_path(1, GRID, dtype)
        rows["attention_core"]["by_path_ms"] = other_paths_ms(q, k, v, m,
                                                              dtype)
    return out


@torch.no_grad()
def measure_products(dtype):
    """Each product of #1, #2 and the narrow window round alone
    (fused_linear: the tensor-core path at bf16, the FFMA path at float32)
    at its serving shape: device ms against its bound (2MNK / 989 TFLOP/s
    at bf16 or 67 at float32, or the bytes of A, W, bias, C and the
    residual once over 3.35 TB/s), the plain twin's ms, torch.matmul(a, w)
    + b as the library yardstick (an eager cuBLAS product, float32 without
    TF32; no rounding before the bias and no epilogue), the tile and the
    block count."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    dtype_name = "float32" if dtype == torch.float32 else "bfloat16"
    esize = 4 if dtype == torch.float32 else 2
    out = {}
    for name, M, K, N, relu, residual in PRODUCTS:
        a, w, b, relu, r = product_operands(M, K, N, relu, residual,
                                            dtype=dtype)
        k1 = device_ms(lambda: dl.fused_linear(a, w, b, relu, r))
        p = device_ms(lambda: dl.linear_plain(a, w, b, relu, r))
        lb = device_ms(lambda: torch.matmul(a, w) + b)
        k2 = device_ms(lambda: dl.fused_linear(a, w, b, relu, r))
        flops = 2 * M * N * K
        nbytes = esize * (M * K + K * N + N + M * N * (2 if residual else 1))
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        bm, bn, blocks = dl.product_tile(M, N, dtype)
        ms = min(k1, k2)
        bound = max(t_ops, t_bytes)
        out[name] = {"m_k_n": [M, K, N], "ms": ms, "ms_first": k1,
                     "ms_last": k2, "plain_ms": p, "library_ms": lb,
                     "bound_ms": bound, "bound_by": "operations"
                     if t_ops >= t_bytes else "bytes",
                     "share_of_bound": bound / ms, "tflops": flops / ms / 1e9,
                     "tile": [bm, bn], "blocks": blocks}
    return out


def distinct_bytes(t) -> int:
    """The bytes of a view's distinct elements (a broadcast dimension, of
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def attention_bound(q, k, v, m, dtype_name: str):
    """Least time (ms) of one attention call: q, k, v and the mask read
    once, the output written once, over 3.35 TB/s; 4 Lq Lk Dh operations a
    (sample, head) over the dtype's peak.  (ms, 'bytes' | 'operations')."""
    Bn, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    nbytes = (distinct_bytes(q) + distinct_bytes(k) + distinct_bytes(v)
              + distinct_bytes(m) + Bn * H * Lq * Dh * q.element_size())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 4 * Bn * H * Lq * Lk * Dh / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# the attention block past 128 keys: PB_pad's lossless packed width; a
# 14 x 14 grid's encoder self-attention, decoder and narrow-round
# cross-attention, and AIC's step over it
LONG_ATTENTION = ((211, 211), (196, 196), (20, 196), (8, 196), (1, 196))


@torch.no_grad()
def measure_attention_paths():
    """The attention block alone (through attention_core) at each caller's
    shape, B = 64, both dtypes: the attention core's cases and the layer
    kernels' attentions (the encoder's 36 x 36; the decoder's and the wide
    window round's 20 x 20 and 20 x 36; the narrow round's 8 x 28, its
    cache and window read as one source, and 8 x 36), each with the path it
    takes, ms, byte bound and share, and SDPA as the yardstick; and past 128
    keys (LONG_ATTENTION) the same with the plain twin's ms and each other
    path of the dtype forced where it fits.  Then the row path's edge: Lq =
    1, 2, 4 and 8 over 36 keys on the row path and the tile (bf16) or ffma
    (float32) block, forced (LQ_ROW is the largest Lq at which the row path
    wins).  At bf16 besides, the AR step's self-attention at the AR cell's
    batch (ar_self_cases at AR_CELL_B): ms, byte bound and share."""
    from boficap_tpu_torch.ops import attention as at
    g = torch.Generator().manual_seed(23)
    H, Dh = 8, D // 8

    def operands(dtype, Lq, Lk):
        def heads(rows):
            return torch.randn((B, rows, H, Dh), generator=g).to(
                DEV, dtype).transpose(1, 2)
        live = torch.randint(1, Lk + 1, (B,), generator=g)
        m = (torch.arange(Lk)[None, :] < live[:, None]).to(DEV)
        return heads(Lq), heads(Lk), heads(Lk), m[:, None, :].expand(B, Lq, Lk)

    out = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        cases = attention_cases(dtype)
        for name, Lq, Lk in (("decoder_self", L, L), ("decoder_cross", L, R),
                             ("narrow_self", W_NARROW, L + W_NARROW),
                             ("narrow_cross", W_NARROW, R)):
            cases[name] = operands(dtype, Lq, Lk)
        res = out[dtype_name] = {}
        for name, (q, k, v, m) in cases.items():
            ms = device_ms(lambda: at.attention_core(q, k, v, m))
            bound, by = attention_bound(q, k, v, m, dtype_name)
            res[name] = {
                "lq_lk_b": [q.shape[2], k.shape[2], q.shape[0]],
                "path": at.attention_path(q.shape[2], k.shape[2], dtype),
                "ms": ms, "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms,
                "sdpa_ms": device_ms(lambda: library_attention(q, k, v, m))}
        if dtype == torch.bfloat16:
            # the AR cell's batch and dtype: its step's self-attention
            for name, (q, k, v, m) in ar_self_cases(dtype, AR_CELL_B,
                                                    g).items():
                ms = device_ms(lambda: at.attention_core(q, k, v, m))
                bound, by = attention_bound(q, k, v, m, dtype_name)
                res[f"{name}_b{AR_CELL_B}"] = {
                    "lq_lk_b": [1, k.shape[2], AR_CELL_B],
                    "path": at.attention_path(1, k.shape[2], dtype),
                    "ms": ms, "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms}
            del q, k, v, m
        for Lq, Lk in LONG_ATTENTION:
            q, k, v, m = operands(dtype, Lq, Lk)
            bound, by = attention_bound(q, k, v, m, dtype_name)
            ms = device_ms(lambda: at.attention_core(q, k, v, m))
            res[f"long_{Lq}x{Lk}"] = {
                "lq_lk_b": [Lq, Lk, B],
                "path": at.attention_path(Lq, Lk, dtype),
                "ms": ms, "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms,
                "by_path_ms": other_paths_ms(q, k, v, m, dtype),
                "plain_ms": device_ms(
                    lambda: at.attention_core_plain(q, k, v, m)),
                "sdpa_ms": device_ms(lambda: library_attention(q, k, v, m))}
        paths = ("row", "tile" if dtype == torch.bfloat16 else "ffma")
        sweep = res["lq_row_sweep"] = {}
        for Lq in (1, 2, 4, 8):
            q, k, v, m = operands(dtype, Lq, R)
            sweep[f"lq{Lq}"] = {p: device_ms(
                lambda p=p: at.attention_core(q, k, v, m, path=p))
                for p in paths}
    return out


@torch.no_grad()
def measure_refnorm():
    """One RefLayerNorm launch alone (fused_refnorm) at a narrow window
    round's 512 rows and the encoder's 2304, D = 512, both dtypes: ms
    against its byte bound (x read and y written once, float32 scale and
    bias read once, over 3.35 TB/s), the plain twin's ms, and
    F.layer_norm's as a yardstick (a biased variance with eps inside the
    square root: not the same function)."""
    import torch.nn.functional as F
    from boficap_tpu_torch.ops import decoder_layer as dl
    g = torch.Generator().manual_seed(29)
    out = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        res = out[dtype_name] = {}
        for rows in (B * W_NARROW, B * R):
            x = torch.randn((rows, D), generator=g).to(DEV, dtype)
            scale = (1 + 0.1 * torch.randn((D,), generator=g)).to(DEV)
            bias = (0.1 * torch.randn((D,), generator=g)).to(DEV)
            ms = device_ms(lambda: dl.fused_refnorm(x, scale, bias))
            bound = (2 * rows * D * x.element_size() + 2 * D * 4) \
                / HBM_BYTES_S * 1e3
            res[f"rows{rows}"] = {
                "ms": ms, "bound_ms": bound, "bound_by": "bytes",
                "share_of_bound": bound / ms,
                "plain_ms": device_ms(lambda: dl.refnorm_plain(x, scale,
                                                               bias)),
                "layer_norm_ms": device_ms(lambda: F.layer_norm(
                    x, (D,), scale.to(dtype), bias.to(dtype), 1e-6))}
    return out


def profile_split(fn, parts, reps: int = 10, tries: int = 5):
    """torch.profiler over ``reps`` calls of fn: device ms and launches a
    call summed by the first of ``parts`` (label: kernel-name substring)
    each kernel's name holds, the rest as 'other'.  The profiler may miss
    the first launches of a window, so ``reps`` calls run in a warm-up
    cycle before the ``reps`` recorded ones, a kernel's launches a call
    are its recorded count over ``reps``, rounded, and its ms a call the
    mean of its recorded launches times that; a window with no kernel
    recorded, or with a kernel whose count is not a whole number of calls
    (the profiler lost launches of one), is taken again, up to ``tries``
    times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        cycles = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: cycles.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        split = {k: 0.0 for k in (*parts, "other")}
        launches = {k: 0 for k in split}
        whole = True
        for row in (cycles[-1] if cycles else []):
            dev_us = getattr(row, "self_device_time_total",
                             getattr(row, "self_cuda_time_total", 0.0))
            if not dev_us or not row.count or not str(
                    getattr(row, "device_type", "")).endswith("CUDA"):
                continue
            part = next((k for k, v in parts.items() if v in row.key),
                        "other")
            n = round(row.count / reps)
            whole = whole and row.count == n * reps
            split[part] += dev_us / 1e3 / row.count * n
            launches[part] += n
        if any(launches.values()) and whole:
            break
    return {**{f"{k}_ms": v for k, v in split.items()},
            "launches": launches}


@torch.no_grad()
def layer_split(model, dtype, reps: int = 10, regions: int = R):
    """Where the device time of a layer, stack or round goes, by building
    block a call: the tensor-core products, the FFMA products, attention by
    kernel (tile: 'attention', and past 128 keys 'attention_tile_long';
    ffma, ffma_long; row), refnorm, and other (the wrappers' final norm in
    torch), with launches a call, held to ``want`` by kind, each attention
    on the path attention_path gives it over ``regions`` regions.  bf16:
    #1, #2 (a layer), #5 (the NA decoder stack, ``decoder_launches``) and
    #6, #7 (a round of six layers), every product on the tensor cores.
    float32: #1, #2, #8 (one window layer) and #5, every product on FFMA.
    Each entry also has device_ms (``device_ms``: the call alone) and
    gap_ms, device_ms less the sum of its kernels' own times: the dead time
    between dependent launches (less any overlap of chained ones)."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    xn, kc, vc, k2, v2, ws, tgn, srn = window_inputs(dtype, W_NARROW, 14,
                                                      regions=regions)
    pack = st.pack_window_weights(model._decoder("SA"), dtype)
    dec = st.pack_decoder_stack(model._decoder("NA"), dtype)
    enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
    dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
    x_enc, src, x_dec, mem, tgt, _ = layer_inputs(dtype, 4, regions)
    calls = {
        "encoder_layer": lambda: dl.fused_encoder_layer(x_enc, src, enc_w,
                                                        H),
        "decoder_layer": lambda: dl.fused_decoder_layer(
            x_dec, mem, tgt, src, dec_w, H),
        "decoder_stack": lambda: st.fused_decoder_stack_forward(
            x_dec, mem, tgt, src, dec.stack, dec.final_norm, H)}
    if dtype == torch.float32:
        calls["window_layer"] = lambda: dl.fused_window_decoder_layer(
            xn, kc[0], vc[0], k2[0], v2[0], tgn, srn, pack.layers[0], H)
    else:
        xw, _, _, _, _, _, tgw, srw = window_inputs(dtype, L, 15, wide=True,
                                                    regions=regions)
        calls.update({
            "window_stack": lambda: st.fused_window_decoder_stack(
                xn, ws, kc, vc, k2, v2, tgn, srn, pack.stack,
                pack.final_norm, H),
            "window_wide_stack": lambda: st.fused_window_wide_stack(
                xw, k2, v2, tgw, srw, pack.stack, pack.final_norm, H)})
    parts = {"products": "gemm_tc_kernel", "ffma_products": "ffma_gemm_kernel",
             "attention": "attention_tile_kernel",
             "attention_tile_long": "attention_tile_long_kernel",
             "attention_ffma": "attention_ffma_kernel",
             "attention_ffma_long": "attention_ffma_long_kernel",
             "attention_row": "attention_row_kernel",
             "refnorm": "refnorm_kernel"}
    prod = "products" if dtype == torch.bfloat16 else "ffma_products"

    def attention_part(Lq, Lk):
        path = at.attention_path(Lq, Lk, dtype)
        if path == "tile":
            return "attention" if Lk <= at.KEY_MAX else "attention_tile_long"
        return f"attention_{path}"

    def kinds(products, refnorm, roles, layers=1):
        """Launches by kind: ``layers`` attentions of each role."""
        want = {prod: products, "refnorm": refnorm}
        for Lq, Lk in roles.values():
            part = attention_part(Lq, Lk)
            want[part] = want.get(part, 0) + layers
        return want

    # the port's launches a call by kind: an encoder layer 7, a window
    # layer 11, a decoder layer and stack as decoder_launches says
    roles = grid_attentions(regions)
    layer, stack = dl.decoder_launches(), dl.decoder_launches(NL)
    want = {"encoder_layer": kinds(4, 2, roles["encoder_layer"]),
            "decoder_layer": kinds(layer["products"], layer["refnorm"],
                                   roles["decoder_layer"]),
            "decoder_stack": kinds(stack["products"], stack["refnorm"],
                                   roles["decoder_stack"], NL),
            "window_layer": kinds(6, 3, roles["window_layer"]),
            "window_stack": kinds(6 * NL, 3 * NL, roles["window_stack"], NL),
            "window_wide_stack": kinds(6 * NL, 3 * NL,
                                       roles["window_wide_stack"], NL)}
    out = {}
    for name, fn in calls.items():
        out[name] = split = profile_split(fn, parts, reps)
        launches = split["launches"]
        got = {k: launches[k] for k in parts if launches[k]}
        if got != {k: v for k, v in want[name].items() if v}:
            fail(f"layer_split {name} {dtype} over {regions} regions: "
                 f"{launches} (want {want[name]} launches of the port's "
                 f"kernels)")
        split["want"] = want[name]
        split["device_ms"] = device_ms(fn)
        split["gap_ms"] = split["device_ms"] - sum(
            split[f"{k}_ms"] for k in (*parts, "other"))
    return out


@torch.no_grad()
def head_split(model, reps: int = 10):
    """#3's device time at B * L = 1280 rows, both dtypes, split into
    head_partial (the product with the head epilogue: tensor cores at
    bf16, FFMA at float32) and head_combine, with launches a call."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    out = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        pack = dl.pack_head_weights(model.generator.proj, dtype)
        h = layer_inputs(dtype, 4)[-1]
        out[dtype_name] = split = profile_split(
            lambda: dl.fused_greedy_head(h, *pack),
            {"head_partial": "HeadEpi", "head_combine": "head_combine"},
            reps)
        if split["launches"]["head_partial"] != 1 or \
                split["launches"]["head_combine"] != 1:
            fail(f"head_split {dtype_name}: {split['launches']}")
    return out


# the fills' rows (B * L, L = 20) at which #3 is timed against the plain
# head: B = 1 .. 64
HEAD_GATE_ROWS = (20, 40, 80, 160, 320, 640, 1280)


@torch.no_grad()
def measure_head_gate(model, model16) -> dict:
    """#3 against the plain head that the fills run below the gate
    (model.generate, the argmax, the token log-prob and entropy:
    decode/bound_fill.py's branch) at each of HEAD_GATE_ROWS rows, bf16
    and float32: the ms of a call in a run of back-to-back calls (the
    host's launches included, as a decode pays them) and its device ms;
    the ids must agree wherever the plain head's top-2 margin is above
    the dtype's noise.  The crossover: the fewest rows from which #3 is
    the faster at every larger count (0 where it is faster at every
    count, None where the plain head is the faster at the most rows).
    The fills run #3 on every greedy fill, with no gate, so a crossover
    above 0 fails: the gate comes back only when a measurement needs it."""
    from boficap_tpu_torch.decode import bound_fill as bf
    from boficap_tpu_torch.decode.sampling import sample_next_word
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.constants import PAD
    g = torch.Generator().manual_seed(SEED + 71)
    out = {}
    for dtype_name, m in (("bfloat16", model16), ("float32", model)):
        pack = m.packed_head()

        def plain(h):
            lp = m.generate(h)
            ids, _ = sample_next_word(lp, "greedy")
            return (ids, *bf._tok_entropy(lp, ids)), lp

        rows_out = {}
        for rows in HEAD_GATE_ROWS:
            h = torch.randn((rows // L, L, D), generator=g).to(DEV, m.dtype)
            ids_k = dl.fused_greedy_head(h, *pack, pad_id=PAD)[0]
            (ids_p, _, _), lp = plain(h)
            top2 = lp.float().topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            noise = (BF16_MARGIN_NOISE if m.dtype == torch.bfloat16
                     else MARGIN_NOISE)
            if ((ids_k != ids_p) & (margin > noise)).any():
                fail(f"head_gate {dtype_name} {rows}: #3's ids differ from "
                     f"the plain head's above the margin {noise}")
            rows_out[rows] = {
                "ms": timed(lambda: dl.fused_greedy_head(h, *pack,
                                                         pad_id=PAD)),
                "plain_ms": timed(lambda: plain(h)),
                "device_ms": device_ms(lambda: dl.fused_greedy_head(
                    h, *pack, pad_id=PAD)),
                "plain_device_ms": device_ms(lambda: plain(h))}
        cross = 0
        for rows in HEAD_GATE_ROWS:
            if rows_out[rows]["ms"] >= rows_out[rows]["plain_ms"]:
                cross = None                    # plain wins here
            elif cross is None:
                cross = rows
        out[dtype_name] = {"rows": rows_out, "crossover_rows": cross}
        if cross != 0:
            fail(f"head_gate {dtype_name}: crossover {cross} rows, the "
                 f"plain head wins below it; the fills run #3 ungated")
    return out


@torch.no_grad()
def host_costs(model):
    """Host µs of one fused_encoder_layer, one fused_encoder_stack_forward
    and one fused_window_decoder_stack (a narrow round) call at B = 64 in
    bf16 (tensor-core products: their A maps encoded per call, W maps from
    the cache) and in float32 (the FFMA route, the same launches): the
    difference is what the tensor maps cost the host."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    out = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
        enc = st.pack_encoder_stack(model.encoder, dtype)
        win = st.pack_window_weights(model._decoder("SA"), dtype)
        x_enc, src, *_ = layer_inputs(dtype, 4)
        xn, kc, vc, k2, v2, ws, tgn, srn = window_inputs(dtype, W_NARROW, 14)
        out[dtype_name] = {
            "fused_encoder_layer": host_us(
                lambda: dl.fused_encoder_layer(x_enc, src, enc_w, H), 30),
            "fused_encoder_stack_forward": host_us(
                lambda: st.fused_encoder_stack_forward(
                    x_enc, src, enc.stack, enc.final_norm, H), 30),
            "fused_window_decoder_stack": host_us(
                lambda: st.fused_window_decoder_stack(
                    xn, ws, kc, vc, k2, v2, tgn, srn, win.stack,
                    win.final_norm, H), 30)}
    out["bf16_minus_float32"] = {
        k: out["bfloat16"][k] - out["float32"][k] for k in out["float32"]}
    return out


def count_syncs(fn) -> int:
    """The host-device synchronizations one call of fn makes, counted by
    torch's sync debug mode (one warning each)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def host_us(fn, n: int = 200) -> float:
    """Host time to enqueue one call of fn, in microseconds: the median of
    ``n`` calls, each timed alone with the card drained before it, so no
    call waits on a full launch queue (a stack's ~50 launches a call would
    fill it within a run of calls)."""
    fn()
    t = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(t)[n // 2]


@torch.no_grad()
def measure_ar(aic, aic16, model16):
    """The AR path at B = 64: #9's host cost a call against the plain
    attend's, the AR decode (fused encode + ar_sample) at bfloat16 and
    float32 with use_pallas on and off, the bf16 NA decode both ways, and
    the bf16 AR decode's breakdown and kernel count both ways."""
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import fused_encode, na_decode
    from boficap_tpu_torch.ops import attention as at
    res = {}
    att, am = features(B, seed=19)
    att, am = att.to(DEV), am.to(DEV)
    src = am.bool()
    # one cross-attention of the bf16 AR step: the layer's attend (with
    # its output projection) on each route, and #9's wrapper alone
    mha = aic16.decoder0.layer0.src_attn
    mem = fused_encode(aic16, att, am)
    q1 = mha.project_q(mem[:, :1])
    kc, vc = mha.project_kv(mem)
    aq, ak, av, amk = attention_cases(torch.bfloat16)["ar_cross"]
    host = {"attention_core_wrapper": host_us(
        lambda: at.attention_core(aq, ak, av, amk))}
    for name, on in (("attend_core", True), ("attend_plain", False)):
        mha.use_core = on
        host[name] = host_us(lambda: mha.attend(q1, kc, vc, src))
    mha.use_core = False
    res["host_us_per_call_bf16"] = host

    def ar_once(m, on):
        m.set_attention_core(on)
        try:
            return ar_sample(m, fused_encode(m, att, am), src)["seq"]
        finally:
            m.set_attention_core(False)

    def na_once(m, on):
        m.set_attention_core(on)
        try:
            return na_decode(m, fused_encode(m, att, am), src,
                             fused_fill=True)["seq"]
        finally:
            m.set_attention_core(False)

    for key, once, models in (("ar_decode_b64_ms", ar_once,
                               (("bfloat16", aic16), ("float32", aic))),
                              ("na_decode_b64_ms", na_once,
                               (("bfloat16", model16),))):
        res[key] = {}
        for name, m in models:
            once(m, True)
            once(m, False)
            # on and off in turns, one decode each: the host clock around a
            # synchronize (the end-to-end time), and the host thread's CPU
            # time (its work, which a busy shared host does not stretch);
            # medians of 9 each
            wall = {True: [], False: []}
            cpu = {True: [], False: []}
            for _ in range(9):
                for on in (True, False):
                    torch.cuda.synchronize()
                    t0, c0 = time.perf_counter(), time.thread_time()
                    once(m, on)
                    torch.cuda.synchronize()
                    wall[on].append((time.perf_counter() - t0) * 1e3)
                    cpu[on].append((time.thread_time() - c0) * 1e3)
            res[key][name] = {
                "use_pallas_on": sorted(wall[True])[4],
                "use_pallas_off": sorted(wall[False])[4],
                "host_cpu_on": sorted(cpu[True])[4],
                "host_cpu_off": sorted(cpu[False])[4],
                "readings_on": wall[True], "readings_off": wall[False],
                "host_syncs_on": count_syncs(lambda: once(m, True)),
                "host_syncs_off": count_syncs(lambda: once(m, False))}
    res["breakdown_b64_bf16"] = ar_breakdown(aic16, att, am)
    res["profile_b64_bf16"] = {
        "use_pallas_on": profile_decode(lambda: ar_once(aic16, True)),
        "use_pallas_off": profile_decode(lambda: ar_once(aic16, False))}
    res["profile_b64_f32_on"] = profile_decode(lambda: ar_once(aic, True))
    return res


def ar_breakdown(model, att, am, reps: int = 3):
    """Where one bf16 AR decode's time goes with use_pallas on: CUDA events
    around the encode (encoder-stack kernel), the cache set-up (cross K/V
    of every layer), the decoder steps (six layers each, #9 on the self-
    and cross-attention) and the head (generator + log-softmax); 'other'
    is the rest of the device timeline (embedding, selection, bookkeeping,
    and idle while the host enqueues).  Host enqueue time against wall time
    says whether the host bounds the decode."""
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import fused_encode
    dec = model._decoder("A")
    segs = {"cache": [], "steps": [], "head": []}

    def timed_call(seg, fn):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            segs[seg].append(ev)
            return out
        return run

    model.init_ar_cache = timed_call("cache", model.init_ar_cache)
    dec.step = timed_call("steps", dec.step)
    model.generate = timed_call("head", model.generate)
    model.set_attention_core(True)
    acc = {k: 0.0 for k in ("encode", *segs, "other", "total",
                            "host_enqueue", "wall")}
    try:
        for rep in range(reps + 1):
            for v in segs.values():
                v.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            mem = fused_encode(model, att, am)
            ev[1].record()
            ar_sample(model, mem, am.bool())
            ev[2].record()
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            if rep == 0:
                continue                               # warm-up
            parts = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in segs.items()}
            enc, total = ev[0].elapsed_time(ev[1]), ev[0].elapsed_time(ev[2])
            parts.update(encode=enc, total=total,
                         other=total - enc - sum(parts.values()),
                         host_enqueue=t_host * 1e3, wall=t_wall * 1e3)
            for k, v in parts.items():
                acc[k] += v / reps
    finally:
        model.set_attention_core(False)
        del model.init_ar_cache, model.generate, dec.step
    return {**{f"{k}_ms": v for k, v in acc.items()},
            "calls": {k: len(v) for k, v in segs.items()}}


@torch.no_grad()
def measure_sa(model, model16, att, am):
    """SA decode at B = 64: launches, rounds and host syncs of one decode,
    and its time on the kernel path and the plain path, for the default
    bfloat16 model (whole-stack route) and the float32 one (per-layer
    route); the bfloat16 decode's breakdown and device busy share.  Run on
    plans without the forced long phrases (``unforce_long``), so the
    rounds are mostly the narrow ones."""
    from boficap_tpu_torch.decode.bound_fill import fused_encode, sa_decode
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    res = {}
    for name, m in (("bfloat16", model16), ("float32", model)):
        def once(fused, m=m, stats=None):
            mem = fused_encode(m, att, am) if fused else m.encode(att, am)
            return sa_decode(m, mem, am.bool(), fused_fill=fused,
                             stats=stats)["seq"]

        stats = {}
        torch.cuda.synchronize()
        reset_launch_counts()
        once(True, stats=stats)
        torch.cuda.synchronize()
        counts = launch_counts()
        k1 = timed(lambda: once(True), reps=5, warm=1)
        p = timed(lambda: once(False), reps=5, warm=1)
        k2 = timed(lambda: once(True), reps=5, warm=1)
        res[name] = {"sa_decode_b64_ms": {"kernel_path": min(k1, k2),
                                          "plain_path": p},
                     "launches_per_decode": counts, "rounds": stats}
    res["breakdown_b64_bf16"] = sa_breakdown(model16, att, am)
    res["profile_b64_bf16"] = profile_decode(
        lambda: sa_decode(model16, fused_encode(model16, att, am), am.bool(),
                          fused_fill=True)["seq"])
    return res


def sa_breakdown(model, att, am, reps: int = 3):
    """Where one kernel-path SA decode's time goes: CUDA events around the
    calls it makes (encode, predictor, cross K/V projection, fill by round
    kind, head); 'other' is the device timeline between them (the round's
    bookkeeping, and idling while the host reads the round's sync).  Host
    time to enqueue is not separable here: every round syncs.  The fill of
    a narrow and of a wide round is also given per round."""
    from boficap_tpu_torch.decode import bound_fill as bf
    segs = {"predict": [], "cross_kv": [], "fill_narrow": [],
            "fill_wide": [], "fill_per_layer": [], "head": []}
    targets = {"cross_kv": ("project_cross_kv",),
               "fill_narrow": ("fused_window_decoder_stack",),
               "fill_wide": ("fused_window_wide_stack",),
               "fill_per_layer": ("fused_window_decoder_forward",),
               "head": ("fused_greedy_head",)}

    def timed_call(seg, fn):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            segs[seg].append(ev)
            return out
        return run

    saved = {n: getattr(bf, n) for names in targets.values() for n in names}
    for seg, names in targets.items():
        for n in names:
            setattr(bf, n, timed_call(seg, saved[n]))
    model.bound_step_cached = timed_call("predict", model.bound_step_cached)
    acc = {k: 0.0 for k in ("encode", *segs, "other", "total")}
    calls = {}
    try:
        for rep in range(reps + 1):
            for v in segs.values():
                v.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            ev[0].record()
            mem = bf.fused_encode(model, att, am)
            ev[1].record()
            bf.sa_decode(model, mem, am.bool(), fused_fill=True)
            ev[2].record()
            torch.cuda.synchronize()
            if rep == 0:
                continue                               # warm-up
            parts = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in segs.items()}
            calls = {k: len(v) for k, v in segs.items()}
            enc = ev[0].elapsed_time(ev[1])
            total = ev[0].elapsed_time(ev[2])
            parts.update(encode=enc, total=total,
                         other=total - enc - sum(parts.values()))
            for k, v in parts.items():
                acc[k] += v / reps
    finally:
        for n, fn in saved.items():
            setattr(bf, n, fn)
        del model.bound_step_cached
    per_round = {f"{k}_per_round_ms": acc[k] / calls[k]
                 for k in ("fill_narrow", "fill_wide") if calls[k]}
    return {**{f"{k}_ms": v for k, v in acc.items()}, **per_round,
            "calls": calls}


def breakdown(model, att, am, reps: int = 5):
    """Where one kernel-path NA decode's time goes at B = 64: device time
    between events around encode, bound, fill (decoder stack, on the route
    ``use_stacked`` names) and head, and the host's time to enqueue all of
    it (when that is close to the wall time the decode is bound by
    launches, not by the card)."""
    from boficap_tpu_torch.decode.bound_fill import (bound_plan, fused_encode,
                                                     use_stacked)
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    src = am.bool()
    segs = ("encode", "bound", "fill", "head")
    acc = {k: 0.0 for k in segs}
    host = wall = 0.0
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        mem = fused_encode(model, att, am)
        ev[1].record()
        s = bound_plan(model, mem, src, L, L)
        ev[2].record()
        total = s["last"] - 1
        ar = torch.arange(L, device=att.device)
        na_mask = (ar[None, None, :] < total[:, None, None]).expand(-1, L, L)
        x = model.na_inputs(s["extend_syn"][:, 1:-1])
        pack = model.packed_decoder("NA")
        if use_stacked(model, B):
            h = st.fused_decoder_stack_forward(
                x, mem, na_mask, src, pack.stack, pack.final_norm,
                model.num_heads)
        else:
            h = dl.fused_decoder_forward(x, mem, na_mask, src, pack.layers,
                                         pack.final_norm, model.num_heads)
        ev[3].record()
        dl.fused_greedy_head(h, *model.packed_head())
        ev[4].record()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        if _ == 0:
            continue                                   # warm-up
        for i, k in enumerate(segs):
            acc[k] += ev[i].elapsed_time(ev[i + 1]) / reps
        host += t_host * 1e3 / reps
        wall += t_wall * 1e3 / reps
    return {**{f"{k}_ms": v for k, v in acc.items()},
            "host_enqueue_ms": host, "wall_ms": wall}


def device_rows(rows):
    """(device us, name, count) of the rows of ``key_averages()`` that are
    the card's own work.  A ``record_function`` label (the program's
    ``bfc.*`` spans among them) comes back as a CUDA row whose device time
    is the label's whole extent: such rows are left out."""
    out = []
    for row in rows:
        dev_us = getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0))
        if (dev_us and str(getattr(row, "device_type", "")).endswith("CUDA")
                and not getattr(row, "is_user_annotation", False)):
            out.append((dev_us, row.key, row.count))
    return out


def profile_decode(fn):
    """Device busy share and kernel count of one decode, from
    torch.profiler (sum of CUDA kernel time over wall time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof.key_averages())
    busy_us = sum(dev_us for dev_us, _, _ in rows)
    n_kernels = sum(count for _, _, count in rows)
    top = sorted(((dev_us, key[:60], count) for dev_us, key, count in rows),
                 reverse=True)
    return {"wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall if wall else None,
            "cuda_kernels": n_kernels,
            "top_kernels": [{"name": n, "ms": t / 1e3, "count": c}
                            for t, n, c in top[:8]]}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 20: the mesh (one rank a device; NCCL alone, gloo ranks sharing the
# card, the server's replicas)
# ---------------------------------------------------------------------------

MESH_B = 8                    # images of the mesh phase's batches
# the CPU tests' tolerances (tests/test_torch_port_mesh.py, JAX
# test_dp_tp_step_matches_single_device's)
MESH_LOSS_REL, MESH_RTOL, MESH_ATOL = 1e-4, 2e-4, 2e-5


def mesh_opt():
    """graft_entry's tiny UIC (d 64, 2 + 2 layers, 4 heads) at float32,
    dropout off, plain SGD at rate 1 after the value clip (an update is
    the clipped gradient), over the synthetic corpus."""
    from boficap_tpu_torch.config import make_config
    return make_config(train_mode="UIC", input_json="synthetic",
                       input_att_dir="synthetic", batch_size=MESH_B,
                       max_boxes=R, N_enc=2, N_dec=2, N_len=1, d_model=64,
                       d_ff=128, num_att_heads=4, dtype="float32",
                       dropout=0.0, drop_prob_lm=0.0, noamopt=False,
                       optim="sgd", learning_rate=1.0, data_prefetch=0,
                       id="smokemesh")


def mesh_model(opt, device):
    """The seeded model of ``opt`` (its plans nudged as build's are) and
    the first train batch of the synthetic corpus."""
    from boficap_tpu_torch.convert import fill_random
    from boficap_tpu_torch.data.dataset import CaptionData
    from boficap_tpu_torch.models.boficap import build_model
    loader = CaptionData(opt)
    model = fill_random(build_model(opt, loader.vocab_size, device), SEED)
    with torch.no_grad():
        model.len_head2.bias += torch.tensor(
            [-1.0] + [1.5] * 3 + [0.0] * 16, device=device)
        model.syn_head2.bias += torch.tensor(
            [0.0] * 4 + [2.0] * 3 + [0.0] * 3, device=device)
    return model, loader.get_batch("train")


def mesh_step(device, mesh=None, drop_worst: float = 0.0):
    """One XE step of mesh_opt's model on its batch (the batch over the
    mesh's 'data' axis, the weights over 'model'); (metrics, the whole
    parameters on the CPU)."""
    from boficap_tpu_torch.convert import flax_layout
    from boficap_tpu_torch.parallel import gather_params, shard_params
    from boficap_tpu_torch.train import optim, steps
    opt = mesh_opt()
    model, batch = mesh_model(opt, device)
    if mesh is not None:
        shard_params(model, mesh)
    layout = flax_layout(model)
    o = optim.Optimizer(optim.build_optimizer(opt, layout), model, layout)
    m = steps.make_xe_step(model, o, mesh=mesh)(
        steps.to_device(batch, device), None, None, drop_worst)
    params = (gather_params(model) if mesh is not None else
              {k: v.detach() for k, v in model.named_parameters()})
    return ({k: float(v) for k, v in m.items()},
            {k: v.cpu() for k, v in params.items()})


@torch.no_grad()
def mesh_decode(device, mesh=None):
    """The plain NA decode of mesh_model's model at B = 64 (the weights
    over the mesh's 'model' axis); seq on the CPU."""
    from boficap_tpu_torch.decode.bound_fill import na_decode
    from boficap_tpu_torch.parallel import shard_params
    model, _ = mesh_model(mesh_opt(), device)
    if mesh is not None:
        shard_params(model, mesh)
    att, am = features(B, seed=31)
    att, am = att.to(device), am.to(device)
    return na_decode(model, model.encode(att, am), am.bool())["seq"].cpu()


def mesh_rank(rank, world, init_method, backend, shapes):
    """One rank of the mesh phase's group on the card: for each (data,
    model) shape, the step (without and with drop-worst), and the NA
    decode where 'model' has every rank; rank 0 returns them."""
    sys.path.insert(0, HERE)
    from boficap_tpu_torch.parallel import init_group, make_mesh
    dev = torch.device(DEV, 0)
    init_group(rank, world, init_method, dev, backend=backend, timeout_s=300)
    out = {}
    for shape in shapes:
        mesh = make_mesh(axis_names=("data", "model"), shape=shape,
                         device=dev)
        out[shape] = {"step": mesh_step(dev, mesh),
                      "step_drop_worst": mesh_step(dev, mesh, 0.5)}
        if shape[1] == world:
            out[shape]["decode"] = mesh_decode(dev, mesh)
    return out if rank == 0 else None


def same_step(what: str, got, want) -> dict:
    """A mesh step against the single-process one, by the CPU tests'
    tolerances; the largest parameter difference and move."""
    (mg, pg), (mw, pw) = got, want
    for k in mw:
        if abs(mg[k] - mw[k]) > MESH_LOSS_REL * max(1.0, abs(mw[k])):
            fail(f"mesh {what}: {k} {mg[k]} against {mw[k]}")
    worst = 0.0
    for k, w in pw.items():
        if not torch.allclose(pg[k], w, rtol=MESH_RTOL, atol=MESH_ATOL):
            fail(f"mesh {what}: parameter {k} differs by "
                 f"{float((pg[k] - w).abs().max())}")
        worst = max(worst, float((pg[k] - w).abs().max()))
    return {"loss": mg["loss"], "loss_single": mw["loss"],
            "loss_rel_err": abs(mg["loss"] - mw["loss"]) / abs(mw["loss"]),
            "params_max_abs_diff": worst,
            "bitwise": all(torch.equal(pg[k], w) for k, w in pw.items())}


@torch.no_grad()
def serve_answers(model, mesh):
    """serve_requests through CaptionServer(route='fused', mesh=mesh):
    each request's seq, the launch counts of the requests, the batches and
    the buckets."""
    from boficap_tpu_torch.ops import launch_counts, reset_launch_counts
    from boficap_tpu_torch.serve import CaptionServer
    att, am, n_single, n_burst, short = serve_requests()
    n = att.shape[0]
    ix_to_word = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}
    srv = CaptionServer(model, ix_to_word, mode="NAIC", max_batch=B,
                        max_wait_ms=5.0, max_regions=R, route="fused",
                        device=DEV, mesh=mesh)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()                       # the main path starts
        t0 = time.perf_counter()
        outs = [srv.submit(att[i].numpy(), am[i].numpy()).wait(timeout=300)
                for i in range(n_single)]
        futs = [srv.submit(att[i].numpy(), am[i].numpy())
                for i in range(n_single, n_single + n_burst)]
        futs += [srv.submit(att[i, :k].numpy())
                 for i, k in zip(range(n_single + n_burst, n), short)]
        outs += [f.wait(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        counts = launch_counts()                    # ... and ends
        shared = all(r is srv.replicas[0] for r in srv.replicas)
    finally:
        srv.close()
    return (torch.stack([torch.as_tensor(o["seq"]) for o in outs]), counts,
            batch_sizes(outs), list(srv.buckets), shared, n / wall)


def check_mesh(model16, smi: str) -> tuple:
    """Phase mesh: one float32 XE step in a one-rank NCCL group against
    the step without a mesh; a two-rank gloo group sharing the card (gloo
    copies through the host: no multi-GPU number comes of it): the step
    over 'data' (with and without drop-worst) against the single-process
    step by the CPU tests' tolerances, and the NA decode with the weights
    over 'model' (tp 2) token for token against the single-device decode;
    then CaptionServer(mesh=[card, card], route='fused') at bf16, every
    answer equal to the server without a mesh, #4, #5 and #3 launched,
    and both servers' requests/s on the same requests in this phase.
    Returns (result, the mesh server's launch counts)."""
    from boficap_tpu_torch.parallel.mesh import launch
    t0 = time.perf_counter()
    dev = torch.device(DEV, 0)
    single = {"step": mesh_step(dev), "step_drop_worst": mesh_step(dev, None,
                                                                   0.5)}
    want_seq = mesh_decode(dev)
    out = {"single_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    nccl = launch(mesh_rank, 1, "nccl", [(1, 1)])[(1, 1)]
    out["nccl_1_rank"] = {k: same_step(f"nccl {k}", nccl[k], single[k])
                          for k in single}
    if not out["nccl_1_rank"]["step"]["bitwise"]:
        fail("mesh: the one-rank NCCL step is not the no-mesh step bitwise")
    out["nccl_1_rank"]["decode_identical"] = bool(torch.equal(
        nccl["decode"], want_seq))
    if not out["nccl_1_rank"]["decode_identical"]:
        fail("mesh: the one-rank NCCL decode differs")
    out["nccl_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = launch(mesh_rank, 2, "gloo", [(2, 1), (1, 2)])
    out["gloo_2_ranks_dp"] = {k: same_step(f"gloo dp {k}", gloo[(2, 1)][k],
                                           single[k]) for k in single}
    out["gloo_2_ranks_tp"] = {k: same_step(f"gloo tp {k}", gloo[(1, 2)][k],
                                           single[k]) for k in single}
    tp_seq = gloo[(1, 2)]["decode"]
    if not torch.equal(tp_seq, want_seq):
        fail(f"mesh: the tp 2 NA decode differs from the single-device "
             f"decode in {int((tp_seq != want_seq).any(-1).sum())} samples")
    out["gloo_2_ranks_tp"]["decode"] = {
        "samples": int(tp_seq.shape[0]), "identical": True,
        "words": int((tp_seq > 0).sum())}
    out["gloo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _, want_batches, _, _, want_rate = serve_answers(model16, None)
    got, counts, batches, buckets, shared, rate = serve_answers(
        model16, [DEV, DEV])
    if not torch.equal(got, want):
        fail(f"mesh: {int((got != want).any(-1).sum())} answers of the "
             f"two-replica server differ from the server without a mesh")
    missing = [k for k in NA_KERNELS if counts[k] == 0]
    if missing or not shared or any(b % 2 for b in buckets):
        fail(f"mesh server: {missing} not launched, replicas shared "
             f"{shared}, buckets {buckets}")
    out["serve"] = {"replicas": 2, "device": smi, "dtype": "bfloat16",
                    "requests": int(got.shape[0]), "answers_equal": True,
                    "launches": counts, "batch_sizes": batches,
                    "no_mesh_batch_sizes": want_batches, "buckets": buckets,
                    "weights_shared": shared, "requests_per_s": rate,
                    "no_mesh_requests_per_s": want_rate}
    out["serve_s"] = time.perf_counter() - t0
    return out, counts


# ---------------------------------------------------------------------------
# phase 22: the kernel-parts tool's kernels (#10, #11)
# ---------------------------------------------------------------------------

PARTS_REPLACES = {
    "window_layer_parts": "scripts/bench_kernel_parts.py:164",
    "window_layer_hb": "scripts/bench_kernel_parts.py:460",
}
PARTS_SOURCE = "boficap_tpu_torch/csrc/window_parts.cu"


@torch.no_grad()
def check_kernel_parts(model) -> tuple:
    """Phase kernel_parts: #10 in every variant and #11 at W = 8 and 16
    against their twins at both dtypes, with each call's launches by kind
    (no copy launch with ``proj`` on: ``ops.window_parts.kernel_launches``);
    #10's full layer bitwise #8, and every variant's rows bitwise
    batch-independent (samples 0-6 of the B = 64 call against a B = 7
    call), at both dtypes; the tile plan's blocks (each of the six products
    at least 120 at B = 64, W = 8) and the hb block's shared memory from
    the library against their mirrors; then the tool's main path, the
    counts zeroed before it and read after.  Returns (the
    phase's dict, the tool run's launches, the kernels line's rows)."""
    import ctypes
    from boficap_tpu_torch import ops
    from boficap_tpu_torch.ops import _build
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    from boficap_tpu_torch.ops import window_parts as wp
    from boficap_tpu_torch.tools import bench_kernel_parts as tool
    H, FF = model.num_heads, 4 * D
    out, rows = {}, {}
    lib = _build.kernels().window_parts
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = TOL[dtype_name]
        w0 = st.pack_window_weights(model._decoder("SA"), dtype).layers[0]
        code = 0 if dtype == torch.float32 else 1
        tiles = {}
        for name, M, N, K in wp.layer_products(B, W_NARROW, D, FF):
            bm, bn = ctypes.c_int(), ctypes.c_int()
            blocks = lib.bfc_window_parts_tile(code, M, N, ctypes.byref(bm),
                                               ctypes.byref(bn))
            got = (bm.value, bn.value, blocks)
            if got != wp.product_tile(M, N, dtype) or blocks < 120:
                fail(f"kernel_parts {dtype_name} {name} product: tile "
                     f"{got}, mirror {wp.product_tile(M, N, dtype)}"
                     f" (at least 120 blocks)")
            tiles[name] = dict(zip(("bm", "bn", "blocks"), got))
        hb_smem = {}
        for Lk in (L + W_NARROW, L + 16, R, GRID, 256):
            c_smem = lib.bfc_window_hb_smem(Lk, D, H, code)
            if c_smem != wp.hb_shared_bytes(Lk, D, H, 4 - 2 * code):
                fail(f"kernel_parts {dtype_name}: hb smem at {Lk} keys "
                     f"{c_smem}, mirror "
                     f"{wp.hb_shared_bytes(Lk, D, H, 4 - 2 * code)}")
            hb_smem[Lk] = c_smem
        # profile_split's labels: the hb block before the layer's
        # attention block, whose name its own holds
        kinds = {"products": ("gemm_tc_kernel" if dtype == torch.bfloat16
                              else "ffma_gemm_kernel"),
                 "hb_attention": "hb_attention_kernel",
                 "attention": "attention_", "refnorm": "refnorm_kernel",
                 "copy": "parts_copy_kernel"}
        res = {}

        def held(name, call, plain, want_launches):
            got, want = call(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            if (not all(torch.isfinite(g.float()).all() for g in got)
                    or max(errs) > tol):
                fail(f"kernel_parts {name} {dtype_name}: rel err {errs} > "
                     f"{tol}")
            split = profile_split(call, kinds, reps=5)
            launches = {k: v for k, v in split["launches"].items() if v}
            if launches != {k: v for k, v in want_launches.items() if v}:
                fail(f"kernel_parts {name} {dtype_name}: launches "
                     f"{split['launches']}, want {want_launches}")
            kernel_ms = {k: split[f"{k}_ms"] for k in (*kinds, "other")
                         if split[f"{k}_ms"]}
            dev = device_ms(call)
            res[name] = {"rel_err": max(errs), "max_abs_err": max(
                (g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)), "launches": launches,
                "kernel_ms": kernel_ms, "device_ms": dev,
                "gap_ms": dev - sum(kernel_ms.values())}
            return got

        x, kc, vc, k2, v2, _, tgt, src = window_inputs(dtype, W_NARROW, 16)
        args = (x, kc[0], vc[0], k2[0], v2[0], tgt, src, w0, H)
        for name, parts in wp.VARIANTS:
            got = held(name, lambda p=parts: wp.fused_window_layer_parts(
                *args, p), lambda p=parts: wp.window_layer_parts_plain(
                *args, p), wp.kernel_launches(parts))
            if name == "full" and not all(
                    torch.equal(g, w) for g, w in
                    zip(got, dl.fused_window_decoder_layer(*args))):
                fail(f"kernel_parts full {dtype_name}: not bitwise #8")
            small = wp.fused_window_layer_parts(
                *(t[:7].contiguous() for t in args[:7]), w0, H, parts)
            if not all(torch.equal(g[:7], w) for g, w in zip(got, small)):
                fail(f"kernel_parts {name} {dtype_name}: samples 0-6 of "
                     f"B = {B} not bitwise a B = 7 call")
        times = {"window_layer_parts": device_ms(
            lambda: wp.fused_window_layer_parts(*args, wp.ALL_PARTS)),
            "window_layer": device_ms(
                lambda: dl.fused_window_decoder_layer(*args))}
        hb = {}
        for Wv in tool.HB_WINDOWS:
            xh, kch, vch, k2h, v2h, _, tgh, srh = window_inputs(dtype, Wv,
                                                               17 + Wv)
            hargs = (xh, kch[0], vch[0], k2h[0], v2h[0], tgh, srh, w0, H)
            held(f"hb_w{Wv}", lambda a=hargs: wp.fused_window_layer_hb(*a),
                 lambda a=hargs: wp.window_layer_hb_plain(*a),
                 wp.HB_LAUNCHES)
            hb[Wv] = hargs
        times["window_layer_hb"] = device_ms(
            lambda: wp.fused_window_layer_hb(*hb[W_NARROW]))
        times["window_layer_hb_w16"] = device_ms(
            lambda: wp.fused_window_layer_hb(*hb[16]))
        times["window_layer_w16"] = device_ms(
            lambda: dl.fused_window_decoder_layer(*hb[16]))
        # the hb block a launch (two a call): its profiled kernel time, at
        # bf16 with its wait for the chain's predecessor to drain
        hb_block_ms = {f"w{Wv}": res[f"hb_w{Wv}"]["kernel_ms"].get(
            "hb_attention", 0.0) / wp.HB_LAUNCHES["hb_attention"]
            for Wv in tool.HB_WINDOWS}
        # the twins and #8's yardstick on the same operands (W = 8)
        plain = {"window_layer_parts": device_ms(
            lambda: wp.window_layer_parts_plain(*args, wp.ALL_PARTS)),
            "window_layer_hb": device_ms(
                lambda: wp.window_layer_hb_plain(*hb[W_NARROW]))}
        lib_ms = device_ms(lambda: library_window_layer(*args))
        lib_w16 = device_ms(lambda: library_window_layer(*hb[16]))
        bnd = bounds(dtype_name, x.element_size())["window_layer"]
        bnd16 = bounds(dtype_name, x.element_size(),
                       w_narrow=16)["window_layer"]
        for name in PARTS_REPLACES:
            worst = max((r for k, r in res.items()
                         if (k.startswith("hb_") == (name ==
                                                     "window_layer_hb"))),
                        key=lambda r: r["max_abs_err"])
            rows.setdefault(name, {})[dtype_name] = {
                "ms": times[name], "plain_ms": plain[name],
                "library_ms": lib_ms, "bound_ms": bnd["bound_ms"],
                "bound_by": bnd["bound_by"],
                "max_abs_err": worst["max_abs_err"]}
        rows["window_layer_hb"][dtype_name]["w16"] = {
            "ms": times["window_layer_hb_w16"], "library_ms": lib_w16,
            **bnd16}
        ratio = {"parts_over_layer": times["window_layer_parts"]
                 / times["window_layer"],
                 "hb_over_parts": times["window_layer_hb"]
                 / times["window_layer_parts"]}
        out[dtype_name] = {"checks": res, "device_ms": times,
                           "plain_ms": plain, "library_ms": lib_ms,
                           "library_ms_w16": lib_w16, "bound": bnd,
                           "bound_w16": bnd16, "hb_block_ms": hb_block_ms,
                           "ratio": ratio, "tiles": tiles,
                           "hb_smem": hb_smem}

    # the main path: the tool's two mains at both dtypes, in process
    ops.reset_launch_counts()
    table = {dt: tool.main(["--dtype", dt, "--seed", str(SEED)])
             for dt in ("bfloat16", "float32")}
    launches = ops.launch_counts()

    def calls(rows):   # a stack's layer calls: each timing's, its retries'
        return sum((tool.TIMED_CALLS + r["retries"] * tool.REPS) * NL
                   for r in rows)

    want = {"window_layer_parts": sum(calls(t["parts"].values())
                                      for t in table.values()),
            "window_layer_hb": sum(
                1 + calls(v for k, v in t["hb"].items()
                          if k.startswith("hb_w")) for t in table.values())}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"kernel_parts: the tool launched {name} "
                 f"{launches[name]} times, not {n}")
    out["tool"] = table
    out["tool_launches"] = {k: v for k, v in launches.items() if v}
    # timings whose spin the host outran, run again (device_ms, timed_ms)
    out["spin_retries"] = {"device_ms": device_ms.retries,
                           "tool": tool.timed_ms.retries}
    return out, launches, rows


# ---------------------------------------------------------------------------
# phase 21: the diagnostics (--dump_attention, --report_flops,
# --profile_steps)
# ---------------------------------------------------------------------------

def quiet(fn, *args):
    """fn(*args) with its standard output kept: (value, the output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    return value, buf.getvalue()


def check_diagnostics(tmp: str) -> dict:
    """Phase diagnostics: the eval CLI with --dump_attention 1
    --report_flops 1 (NAIC, 10 test images) on a float32 checkpoint at
    uic_sd's widths over the CLI's synthetic corpus, in process on the
    card and with --device cpu: the same npz keys, every map within 1e-5,
    the same printed accumulator, and the card's FLOP counts equal to the
    CPU's (the work is fixed by the shapes); then the training CLI with
    --profile_steps 2 on the card: a trace under profile/ holding CUDA
    kernel events."""
    import numpy as np
    from boficap_tpu_torch.data.dataset import CaptionData
    from boficap_tpu_torch.tools import eval as teval
    from boficap_tpu_torch.tools import train as ttrain
    opt = eval_opt("uic_sd.yml", id="smokediag", dtype="float32")
    loader = CaptionData(opt)
    write_checkpoint(build("float32", vocab=loader.vocab_size), opt, loader,
                     tmp)
    runs, here = {}, os.getcwd()
    for dev in ("cuda", "cpu"):
        cwd = os.path.join(tmp, f"diag_{dev}")
        os.makedirs(cwd)
        os.chdir(cwd)
        try:
            t0 = time.perf_counter()
            _, printed = quiet(teval.main, [
                "--model", os.path.join(tmp, "model.ckpt"),
                "--infos_path", os.path.join(tmp, "infos_smokediag.pkl"),
                "--inference_mode", "NAIC", "--num_images", "10",
                "--language_eval", "0", "--device", dev,
                "--dump_attention", "1", "--report_flops", "1"])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
        with open(os.path.join(cwd, "eval_results",
                               "smokediag_test.json")) as f:
            flops = json.load(f)["flops"]
        lines = printed.splitlines()
        i = lines.index("attention 10x10 accumulator (saved full maps to "
                        "vis/attn.npz)")
        runs[dev] = {"maps": dict(np.load(os.path.join(cwd, "vis",
                                                       "attn.npz"))),
                     "acc": lines[i + 1:i + 11], "flops": flops,
                     "wall_s": wall}
    card, cpu = runs["cuda"], runs["cpu"]
    if list(card["maps"]) != list(cpu["maps"]):
        fail("diagnostics: the attention maps' keys differ card vs CPU")
    worst = max(float(np.abs(card["maps"][k] - cpu["maps"][k]).max())
                for k in cpu["maps"])
    if worst > 1e-5:
        fail(f"diagnostics: attention maps differ by {worst} card vs CPU")
    if card["acc"] != cpu["acc"]:
        fail("diagnostics: the printed accumulators differ")
    if {k: v["flops"] for k, v in card["flops"].items()} != {
            k: v["flops"] for k, v in cpu["flops"].items()}:
        fail(f"diagnostics: report_flops {card['flops']} on the card, "
             f"{cpu['flops']} on the CPU")
    out = {"dump_attention": {
        "maps": len(cpu["maps"]), "max_abs_err": worst,
        "example_key": next(iter(cpu["maps"])),
        "example_shape": list(next(iter(cpu["maps"].values())).shape),
        "card_s": card["wall_s"], "cpu_s": cpu["wall_s"]},
        "report_flops": {"card": card["flops"], "cpu": cpu["flops"],
                         "flops_equal": True}}
    ck = os.path.join(tmp, "prof")
    t0 = time.perf_counter()
    _, printed = quiet(ttrain.main, [
        "--cfg", os.path.join(HERE, "configs", "synthetic_smoke.yml"),
        "--id", "smokeprof", "--checkpoint_path", ck, "--profile_steps", "2",
        "--language_eval", "0", "--save_checkpoint_every", "100",
        "--losses_log_every", "1", "--max_epochs", "1"])
    wall = time.perf_counter() - t0
    traces = sorted(os.listdir(os.path.join(ck, "profile")))
    if "profiler trace written" not in printed or len(traces) != 1:
        fail(f"diagnostics: --profile_steps wrote {traces}")
    with open(os.path.join(ck, "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail("diagnostics: the profile holds no CUDA kernel event")
    out["profile_steps"] = {"trace": traces[0], "events": len(events),
                            "cuda_kernel_events": len(kernels),
                            "train_s": wall}
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "boficap_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False      # the contract is f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()

    from boficap_tpu_torch.ops import _build
    info = _build.probe()
    b = _build.build()
    regs = [ln.strip() for ln in b["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "probe", "nvidia_smi": smi, "capability": list(cap),
          "torch": info["torch"], "torch_cuda": info["torch_cuda"],
          "nvcc": info.get("nvcc_version"), "build_s": b["seconds"],
          "ptxas": regs})
    if tuple(cap) != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")
    _build.kernels()
    emit({"kernels": run_phases(smi)})
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def run_phases(smi: str):
    """Phases 2-22; returns the {"kernels": [...]} list."""
    # the same random weights at both compute dtypes: float32 for the
    # decode comparisons, the default (bfloat16) for the main paths
    model = build("float32")
    model16 = build()
    aic, aic16 = build("float32", "transformer.yml"), build(
        None, "transformer.yml")
    uic_s = build("float32", "uic_s_ori.yml")
    shift_stop([model, model16])
    long_shift = shape_plans([model, model16])
    errs = check_kernels(model)
    werrs = check_window_kernels(model)
    for dtype_name in errs:
        errs[dtype_name].update(werrs[dtype_name])
    emit({"phase": "kernels", "tolerance_rel": TOL, **errs,
          "products_bf16": check_products(torch.bfloat16),
          "products_float32": check_products(torch.float32)})
    na_dec, na_counts = check_decode(model)
    emit({"phase": "decode", **na_dec})
    served = check_serve(model16, "NAIC", NA_KERNELS)
    served["auto"] = {dt: check_serve(m, "NAIC", (), route="auto")
                      for dt, m in (("bfloat16", model16),
                                    ("float32", model))}
    emit({"phase": "serve", "card": smi, **served})
    sa_dec, sa_counts = check_sa_decode(model)
    emit({"phase": "sa_decode", "stop_bias_shift": -STOP_SHIFT,
          "long_bias_shift": long_shift, **sa_dec})
    bf16_dec = check_bf16_decodes(model16)
    emit({"phase": "bf16_decode", **bf16_dec})
    sa_served = check_serve(model16, "SAIC", SA_KERNELS)
    sa_served["auto"] = {dt: check_serve(m, "SAIC", (), route="auto")
                         for dt, m in (("bfloat16", model16),
                                       ("float32", model))}
    emit({"phase": "sa_serve", "card": smi, **sa_served})
    att_errs = check_attention()
    emit({"phase": "attention", "tolerance_rel": TOL, **att_errs})
    emit({"phase": "ar_decode", **check_ar_decodes(aic, uic_s, model),
          "bf16": check_bf16_ar(aic16)})
    aic16.set_attention_core(True)          # the server's model: use_pallas
    aic_served = check_serve(aic16, "AIC", AIC_KERNELS)
    n_batches = len(aic_served["batch_sizes"])
    want = 2 * aic16.N_dec * L * n_batches
    if aic_served["launches"]["attention_core"] != want:
        fail(f"aic_serve: attention_core launched "
             f"{aic_served['launches']['attention_core']} times, not "
             f"2 x {aic16.N_dec} layers x {L} steps x {n_batches} batches")
    aic16.set_attention_core(False)
    emit({"phase": "aic_serve", "card": smi, "use_pallas": True,
          "attention_core_expected": want, **aic_served})
    evaluated, eval_launches = check_eval(model16, aic16, aic)
    emit({"phase": "eval", "card": smi, **evaluated})
    with tempfile.TemporaryDirectory(prefix="boficap_train_") as tmp:
        trained, train_launches, model_t, batch_t = check_train(tmp)
        emit({"phase": "train", "card": smi, **trained})
        rl, rl_launches = check_rl(model_t, batch_t, tmp)
        emit({"phase": "rl", "card": smi, **rl})
        del model_t
        torch.cuda.empty_cache()
        prepro, prepro_launches = check_prepro(tmp)
        emit({"phase": "prepro", "card": smi, **prepro})
    decoders, dec_launches = check_decoders(aic)
    emit({"phase": "decoders", "card": smi, **decoders})
    pb_res, pb_launches = check_pb(smi)
    emit({"phase": "pb", "card": smi, **pb_res})
    short = {dt: {**errs[dt], "attention_core": att_errs[dt]["ar_cross"]}
             for dt in errs}
    raw, raw_launches = check_raw(model, aic16, smi, short)
    emit({"phase": "raw", **raw})
    unforce_long([model, model16], long_shift)
    times = measure(model, model16)
    times["products_bf16"] = measure_products(torch.bfloat16)
    times["products_float32"] = measure_products(torch.float32)
    times["layer_split_bf16"] = layer_split(model, torch.bfloat16)
    times["layer_split_float32"] = layer_split(model, torch.float32)
    times["layer_split_float32_196"] = layer_split(model, torch.float32,
                                                   regions=GRID)
    times["head_split"] = head_split(model)
    times["attention_paths"] = measure_attention_paths()
    times["refnorm"] = measure_refnorm()
    times["host_us_per_call"] = host_costs(model)
    times["ar"] = measure_ar(aic, aic16, model16)
    times["past_key_bound_196"] = measure_grid(model)
    times["head_gate"] = measure_head_gate(model, model16)
    times["raw"] = {
        "trunk_extract_ms_per_image": raw["trunk"]["extract_ms_per_image"],
        "trunk_forward_ms_b1": raw["trunk"]["forward_ms_b1"],
        "images_per_s": {run: {"kernels": r["images_per_s"],
                               "plain": r["plain_images_per_s"]}
                         for run, r in raw["cli"].items()
                         if isinstance(r, dict) and "images_per_s" in r}}
    emit({"phase": "times", "card": smi, "long_bias_shift": 0.0, **times})
    lstm, lstm_launches = check_lstm(smi)
    emit({"phase": "lstm", **lstm})
    t0 = time.perf_counter()
    meshed, mesh_launches = check_mesh(model16, smi)
    emit({"phase": "mesh", "card": smi, "seconds": time.perf_counter() - t0,
          **meshed})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="boficap_diag_") as tmp:
        diag = check_diagnostics(tmp)
    emit({"phase": "diagnostics", "card": smi,
          "seconds": time.perf_counter() - t0, **diag})
    t0 = time.perf_counter()
    parts, parts_launches, parts_rows = check_kernel_parts(model)
    emit({"phase": "kernel_parts", "card": smi, "tolerance_rel": TOL,
          "seconds": time.perf_counter() - t0, **parts})
    errs["float32"]["attention_core"] = att_errs["float32"]["ar_cross"]
    errs["bfloat16"]["attention_core"] = att_errs["bfloat16"]["ar_cross"]

    # launches: each kernel on the main path that runs it (the per-layer
    # kernels on the float32 decodes, their route)
    paths = {"attention_core": ("aic_serve", aic_served),
             "encoder_layer": ("na_decode_float32_per_layer",
                               {"launches": na_counts}),
             "decoder_layer": ("na_decode_float32_per_layer",
                               {"launches": na_counts}),
             "greedy_head": ("na_serve", served),
             "encoder_stack": ("na_serve", served),
             "decoder_stack": ("na_serve", served),
             "window_layer": ("sa_decode_float32_per_layer",
                              {"launches": sa_counts}),
             "window_stack": ("sa_serve", sa_served),
             "window_wide_stack": ("sa_serve", sa_served)}
    kernels = []
    for name in REPLACES:
        t32, t16 = times["float32"][name], times["bfloat16"][name]
        path, run = paths[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": run["launches"][name],
            "path": path,
            "max_abs_err": errs["float32"][name]["max_abs_err"],
            **{key: t32[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "dtype": "float32",
            "bf16": {key: t16[key] for key in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
            "bf16_max_abs_err": errs["bfloat16"][name]["max_abs_err"],
            "eval_launches": eval_launches.get(name, 0),
            "train_val_launches": train_launches.get(name, 0),
            "rl_launches": rl_launches.get(name, 0),
            "decoders_launches": dec_launches.get(name, 0),
            "pb_launches": pb_launches.get(name, 0),
            "lstm_launches": lstm_launches.get(name, 0),
            "prepro_launches": prepro_launches.get(name, 0),
            "raw_launches": raw_launches.get(name, 0),
            "mesh_serve_launches": mesh_launches.get(name, 0)})
        if name in GRID_KERNELS:
            # past 128 keys: the 196-region memory of a 14 x 14 image grid
            # (phase raw's check, phase times' numbers; #9's other paths)
            grid = times["past_key_bound_196"]
            kernels[-1]["past_key_bound_196"] = {
                dt: {"max_abs_err": raw["kernels"][dt][name]["max_abs_err"],
                     **{key: grid[dt][name][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "attention_paths",
                                    "by_path_ms") if key in grid[dt][name]}}
                for dt in ("float32", "bfloat16")}
        if name in ("encoder_layer", "decoder_layer"):
            # #1 and #2 at bf16 run at B > 128: the B = 256 NA decode
            kernels[-1]["bf16"]["launches"] = bf16_dec[
                "na_decode_b256_per_layer"]["launches"][name]
        if name == "attention_core":
            # the AR step's self-attention over the cache rows written
            kernels[-1]["ar_self_max_abs_err"] = {
                dt: {case: att_errs[dt][case]["max_abs_err"]
                     for case in att_errs[dt] if case.startswith("ar_self")}
                for dt in ("float32", "bfloat16")}
            # past the row path's 128 keys: PB_pad's packed widths
            kernels[-1]["pb_past_key_bound"] = {
                case: {key: r[key] for key in (
                    "path", "max_abs_err", "ms", "by_path_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                for case, r in pb_res["attention_past_key_bound"].items()}
    for name, replaces in PARTS_REPLACES.items():
        t32, t16 = parts_rows[name]["float32"], parts_rows[name]["bfloat16"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": PARTS_SOURCE,
            "replaces": replaces, "launches": parts_launches[name],
            "path": "kernel_parts_tool",
            "max_abs_err": t32["max_abs_err"],
            **{key: t32[key] for key in keys}, "dtype": "float32",
            "bf16": {key: t16[key] for key in keys},
            "bf16_max_abs_err": t16["max_abs_err"]})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
