"""The port's device mesh (``parallel/``) against the JAX package's
``parallel/mesh.py`` and the single-device path, on the CPU with gloo
ranks (the JAX package's mesh tests use virtual CPU devices):

  * ``pad_batch_to``'s round-robin wrap and the rules table
    (``param_partition_specs``) equal JAX's, leaf by leaf through the
    weight bridge;
  * one XE step (UIC, NAIC, AIC, UIC_s, PB_pad) over 2 'data' ranks,
    and over dp 2 x tp 2, equals the
    single-device step on the global batch (loss within 1e-4 relative,
    parameters within rtol 2e-4 / atol 2e-5, JAX
    ``test_dp_tp_step_matches_single_device``'s tolerances), with
    unequal token counts per shard, drop-worst, grad_accum and the
    global-norm clip; the update is plain SGD at rate 1 after the clip, so
    the parameters hold the gradients to these tolerances (Adam's first
    step is the rate times the gradient's sign, noise included: the port's
    training tests hold Adam updates to 1e-2 for that reason);
  * one RL step (structure loss with ``rl_kl``, the self-CIDEr and
    entropy weights, ``structure_loss_weight`` < 1 with its gt XE term, the
    max-margin loss, UIC_s's seqnll over its three branches) and one classic SCST step over 2 'data'
    ranks, each rank on its images' fixed samples and its rows of the host
    scores, equal to the single-device step by the same tolerances, the
    shards' sampled word counts far apart (the second shard's images
    sample the batch's shortest captions);
  * tensor-parallel NA and SA decodes token-identical to the
    single-device decode;
  * ``CaptionServer(mesh=...)`` with the CPU named 4 times;
  * ``--mesh_shape`` parsing and its divisibility error;
  * the kernels refusing a tensor-parallel slice.
"""

import numpy as np
import pytest
import torch

from boficap_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from boficap_tpu.parallel.mesh import param_partition_specs as jax_specs
from boficap_tpu_torch import config as tconfig
from boficap_tpu_torch.convert import flax_layout
from boficap_tpu_torch.models.layers import Dense
from boficap_tpu_torch.parallel import mesh as tmesh
from boficap_tpu_torch.parallel.tensor_parallel import Slice
from boficap_tpu_torch.serve import CaptionServer
from boficap_tpu_torch.tools import train as ttrain
from tests import _torch_port_mesh_util as U
from tests._torch_port_util import R, VOCAB, make_feats, make_pair

IX_TO_WORD = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}
# (train_mode, images a batch, drop_worst rate, grad_clip_mode, grad_accum)
CASES = [("UIC", 4, 0.0, "value", 1), ("UIC", 4, 0.5, "value", 1),
         ("UIC", 4, 0.0, "value", 2), ("NAIC", 4, 0.0, "norm", 1),
         ("AIC", 4, 0.0, "value", 1), ("UIC_s", 4, 0.0, "value", 1),
         ("PB_pad", 4, 0.0, "value", 1)]
# (train_mode, the RL fields, or "scst" for the classic SCST step)
RL_CASES = [("UIC", {"rl_kl": True}),
            ("UIC", {"self_cider_reward_weight": 0.5,
                     "entropy_reward_weight": 0.3}),
            ("UIC", {"structure_loss_weight": 0.5}),
            ("UIC", {"structure_loss_type": "max_margin"}),
            ("UIC_s", {"structure_loss_type": "seqnll"}),
            ("AIC", "scst")]
LOSS_REL, RTOL, ATOL = 1e-4, 2e-4, 2e-5


def test_pad_batch_to_wraps_rows():
    """pad > batch wraps rows round-robin, as JAX's (b = 3 -> 8 needs 5
    extra rows from a 3-row batch); tensors too; non-arrays pass."""
    batch = {"x": np.arange(3 * 2).reshape(3, 2), "meta": "keep"}
    got, want = tmesh.pad_batch_to(batch, 8), jax_pad_batch_to(batch, 8)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["x"][3:], batch["x"][[0, 1, 2, 0, 1]])
    assert got["meta"] == "keep"
    assert tmesh.pad_batch_to(batch, 3)["x"].shape == (3, 2)
    t = tmesh.pad_batch_to({"x": torch.arange(3)}, 8)["x"]
    assert t.tolist() == [0, 1, 2, 0, 1, 2, 0, 1]


def _pair(mode):
    if mode in ("updown", "aoa"):
        from tests.test_torch_port_lstm import build_pair
        _, params, tm, _ = build_pair(mode)
        return params, tm
    return make_pair(mode)[1:]


@pytest.mark.parametrize("mode", ["UIC", "AIC", "PB_pad", "UIC_s", "aoa",
                                  "updown"])
def test_partition_table_matches_jax(mode):
    """Every leaf's placement equals JAX's param_partition_specs on the
    same model, through the weight bridge's flax_layout.  The table shards
    the transformers' and AoANet's attentions (AoANet's refiner and
    decoder attention are the layers' MultiHeadAttention, so JAX's rules
    match them); UpDown matches no rule and replicates."""
    params, tm = _pair(mode)
    want = jax_specs(params)
    table = tmesh.param_partition_specs(tm)
    layout = flax_layout(tm)
    assert set(table) == set(layout)
    for name, spec in table.items():
        node = want["params"]
        for part in layout[name][0]:
            node = node[part]
        assert spec == tuple(node), name
    n_sharded = sum("model" in s for s in table.values())
    assert (n_sharded == 0) == (mode == "updown")


def _token_counts(mode, bs):
    cfg = U.config(mode, bs)
    _, batch = U.model_and_batch(cfg)
    words = (np.asarray(batch["masks"])[:, :, 1:] > 0).sum(axis=(1, 2))
    return words[:bs // 2].sum(), words[bs // 2:].sum()


def _same_step(ref, got, start):
    (mr, pr), (mg, pg), pr0 = ref, got, start
    assert abs(mg["loss"] - mr["loss"]) <= LOSS_REL * max(1.0,
                                                          abs(mr["loss"]))
    for k in mr:
        assert abs(mg[k] - mr[k]) <= LOSS_REL * max(1.0, abs(mr[k])), k
    assert set(pg) == set(pr)
    moved = 0.0
    for k, want in pr.items():
        moved = max(moved, float(np.abs(want - pr0[k]).max()))
        np.testing.assert_allclose(pg[k], want, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert moved > 100 * ATOL


@pytest.fixture(scope="module")
def single():
    return U.single_steps(CASES)


@pytest.fixture(scope="module")
def start():
    """The parameters before the step (every case starts from seed 0)."""
    return [{k: v.detach().numpy().copy() for k, v in U.model_and_batch(
        U.config(c[0], c[1]))[0].named_parameters()} for c in CASES]


@pytest.fixture(scope="module")
def dp2():
    return tmesh.launch(U.step_worker, 2, (2, 1), CASES)


@pytest.fixture(scope="module")
def dp2tp2():
    return tmesh.launch(U.step_worker, 4, (2, 2), CASES)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_dp_step_matches_single_device(case, single, dp2, start):
    """2 'data' ranks: the global batch's loss, metrics and updated
    parameters; the shards' token counts differ."""
    mode, bs = CASES[case][:2]
    a, b = _token_counts(mode, bs)
    assert a != b
    _same_step(single[case], dp2[case], start[case])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_dp_tp_step_matches_single_device(case, single, dp2tp2, start):
    """dp 2 x tp 2: the same, with every attention's heads, the FFN and
    the generator's vocabulary split over 'model'."""
    _same_step(single[case], dp2tp2[case], start[case])


@pytest.fixture(scope="module")
def single_rl():
    return [U.rl_once(mode, fields) for mode, fields in RL_CASES]


@pytest.fixture(scope="module")
def dp2_rl():
    return tmesh.launch(U.rl_worker, 2, (2, 1), RL_CASES)


@pytest.mark.parametrize("case", range(len(RL_CASES)),
                         ids=[f"{m}-{f if isinstance(f, str) else '-'.join(f)}"
                              for m, f in RL_CASES])
def test_dp_rl_step_matches_single_device(case, single_rl, dp2_rl):
    """2 'data' ranks, each with its images, their samples and its rows
    of the scores (the training CLI's split): the loss, every metric
    (rewards, struc losses, lm_loss, rl_kl) and the updated parameters of
    the single-device step on the whole batch."""
    mode, fields = RL_CASES[case]
    _, model, _, samples, _ = U.rl_inputs(mode, fields)
    for s in samples.values():
        words = (s["seq"] > 0).sum(-1)
        half = words.shape[0] // 2
        assert int(words[:half].sum()) != int(words[half:].sum())
    start = {k: v.detach().numpy().copy()
             for k, v in model.named_parameters()}
    _same_step(single_rl[case], dp2_rl[case], start)


def test_tp_decodes_token_identical():
    """NA and SA decodes, the batch over 'data' and the weights over
    'model' (dp 2 x tp 2), token-identical to the single-device decodes:
    seq, phrase_num and phrase_length."""
    want, got = tmesh.launch(U.tp_decode_worker, 4, (2, 2), 1)
    assert len(want) == 6
    assert (want[0] > 0).any()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_serve_mesh_equals_single_device():
    """A CaptionServer over the CPU named 4 times gives the single
    server's captions; its buckets are multiples of 4; max_batch 6
    raises."""
    _, _, tm = make_pair("UIC", "add", seed=4)
    att, am = make_feats(B=6, seed=11)
    kw = dict(mode="NAIC", max_batch=8, max_wait_ms=30.0, max_regions=R)
    outs = []
    for mesh in (None, ["cpu"] * 4):
        srv = CaptionServer(tm, IX_TO_WORD, device="cpu", mesh=mesh, **kw)
        try:
            futs = [srv.submit(att[i], am[i]) for i in range(6)]
            outs.append([f.wait(timeout=120) for f in futs])
            if mesh is not None:
                assert srv.buckets == [4, 8]
                assert all(r is tm for r in srv.replicas)
                assert {o["bucket"] for o in outs[-1]} <= {4, 8}
        finally:
            srv.close()
    assert [o["caption"] for o in outs[1]] == [o["caption"] for o in outs[0]]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a["seq"], b["seq"])
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        CaptionServer(tm, IX_TO_WORD, device="cpu", mesh=["cpu"] * 4,
                      mode="NAIC", max_batch=6, max_regions=R)


def test_mesh_shape_parses_int_and_dict():
    assert tconfig.parse_opt(["--mesh_shape", "4"]).mesh_shape == 4
    assert tconfig.parse_opt(["--mesh_shape", "{'data': 2}"]).mesh_shape \
        == {"data": 2}
    with pytest.raises(SystemExit):
        tconfig.parse_opt(["--mesh_shape", "data=2"])


@pytest.mark.parametrize("ms", ["{'data': 3}", "3"])
def test_mesh_shape_must_divide_batch(ms):
    """An explicit --mesh_shape that does not divide batch_size raises
    (JAX test_mesh_shape_must_divide_batch)."""
    opt = tconfig.parse_opt(["--cfg", "configs/synthetic_smoke.yml",
                             "--id", "msbad", "--batch_size", "4",
                             "--device", "cpu", "--mesh_shape", ms])
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.train(opt)


def test_kernels_refuse_a_tensor_parallel_slice():
    """The kernel packs raise on a sliced layer, and an attention slice
    with the attention core on raises: tensor parallelism runs the plain
    path."""
    tm = U.model_and_batch(U.config("UIC"))[0]
    dense = tm.encoder.layer0.self_attn.wq
    assert isinstance(dense, Dense)
    dense.tp = Slice("column", None, 0, [16, 16])
    with pytest.raises(ValueError, match="tensor-parallel slice"):
        tm.packed_encoder()
    att = tm.encoder.layer0.self_attn
    att.tp_size, att.use_core = 2, True
    q = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="plain attention"):
        att.attend(q, q, q, torch.ones(1, 2, dtype=torch.bool))


class _StubMesh:
    def __init__(self, tp):
        self.tp = tp

    def size(self, axis):
        return self.tp if axis == "model" else 1

    def index(self, axis):
        return 0

    def group(self, axis):
        return None


def test_shard_params_refuses_undivided_heads():
    """3 'model' ranks cannot split 2 heads: ValueError before any
    layer is touched in a way a step could run."""
    tm = U.model_and_batch(U.config("UIC"))[0]
    with pytest.raises(ValueError, match="heads over 3 model ranks"):
        tmesh.shard_params(tm, _StubMesh(3))
