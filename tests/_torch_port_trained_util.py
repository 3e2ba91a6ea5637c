"""Shared set-up of the trained-weight parity tests
(``tests/test_torch_port_trained.py``, ``tests/test_torch_port_trained_uic.py``):
a seeded corpus built in memory in the layout of
``scripts/make_synth_corpus.py`` (by the port's copy of it,
``boficap_tpu_torch.tools.make_synth_corpus.build``), a small model
trained on it by the port, and the same weights carried to the JAX
package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boficap_tpu.data import dataset as jds
from boficap_tpu.models.boficap import build_model as jax_build_model
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import init_params, to_jax_tree
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.tools import make_synth_corpus as synth
from boficap_tpu_torch.tools.make_synth_corpus import ArrayFeatures
from boficap_tpu_torch.train import steps as tsteps
from tests.test_model import tiny_cfg

L = 20                                     # max_length, the script's default
R = synth.SLOTS + synth.N_DISTRACT         # 9 regions
VOCAB = synth.VOCAB                        # 60 words, ids 4..63
N_IMAGES = 200                             # 160 train, 20 val, 20 test
CAPS = 5                                   # captions an image, all equal
# the script's captions are all 6 words long, so every ended beam would be
# as long as every other: an image whose last slot holds one of the first
# SHORT words of that slot's sub-vocabulary drops it (a 5-word caption,
# its last phrase one word shorter), which the image shows
SHORT = 4
# the model: tiny_cfg's widths (d_model 64, 2 + 2 layers, 4 heads)
BATCH = 24                                 # images a training step
LR = 3e-3                                  # Adam
STEPS = {"AIC": 60, "UIC": 80}
DEC_B = 12                                 # images a direct decode


def corpus(seed: int = 0, n: int = N_IMAGES, noise: float = 0.1,
           eos: bool = False):
    """The script's corpus (its codebook, slot words, phrase patterns,
    syntax ids, distractors and region shuffle, drawn in its order from
    ``seed``), in memory, CAPS captions an image; a caption whose last
    slot word is among the first SHORT of the slot ends one word early.
    ``eos``: each label row holds EOS after its last word (see the test
    module's docstring).  Returns (label arrays as the script stores them,
    images, region features [n, R, 2048])."""
    return synth.build(n, CAPS, L, noise, seed, short=SHORT, eos=eos)


def stores(data):
    """The corpus as a LabelStore of each package (JAX's, the port's)."""
    (labels, start, end, pn, pls, syns), images, _ = data
    ix_to_word = {str(i + 4): f"w{i}" for i in range(VOCAB)}
    return tuple(mod.LabelStore(images, ix_to_word, labels, start, end, pn,
                                pls, syns) for mod in (jds, tds))


def model_cfg(train_mode: str):
    """The JAX package's config of the small model (tiny_cfg's widths,
    L = 20, R regions, dropout off, float32)."""
    cfg = tiny_cfg(train_mode)
    cfg.update(max_length=L, max_boxes=R, dropout=0.0, drop_prob_lm=0.0,
               dtype="float32", decoder_input_mode="add")
    return cfg


def port_cfg(cfg, **fields):
    """The port's config of the same model, with loader ``fields``."""
    return make_config(**{**{k: cfg[k] for k in (
        "train_mode", "N_enc", "N_dec", "N_len", "d_model", "d_ff",
        "num_att_heads", "max_length", "decoder_input_mode",
        "att_feat_size", "max_boxes", "dtype", "dropout", "drop_prob_lm")},
        **fields})


def loader_fields(batch_size: int):
    return dict(input_json="synthetic", input_att_dir="synthetic",
                batch_size=batch_size, seq_per_img=1, data_prefetch=0,
                seed=0)


def train(train_mode: str, data):
    """A small ``train_mode`` model trained by the port: Adam at LR on
    BATCH-image batches of the corpus' train split for STEPS[train_mode]
    XE steps from the weights seed 0 makes.  Returns (the port's model,
    its losses)."""
    tcfg = port_cfg(model_cfg(train_mode), **loader_fields(BATCH))
    model = init_params(tcfg, VOCAB, seed=0, device="cpu")
    loader = tds.CaptionData(tcfg, labels=stores(data)[1],
                             features=ArrayFeatures(data[2]))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    losses = []
    for _ in range(STEPS[train_mode]):
        batch = tsteps.to_device(loader.get_batch("train"), "cpu")
        loss, _ = tsteps.xe_loss_fn(model, batch, None)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    model.eval().invalidate_packed()
    return model, losses


def carry(tm, train_mode: str):
    """(jax_model, params): the JAX package's model holding ``tm``'s
    weights."""
    jm = jax_build_model(model_cfg(train_mode), VOCAB)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(tm))
    return jm, params


def loaders(data, train_mode: str, batch_size: int):
    """A JAX and a port CaptionData over the corpus for ``train_mode``,
    ``batch_size`` images a batch."""
    out = []
    for mod, store, fin in zip((jds, tds), stores(data), (
            _jax_finalized, port_cfg)):
        out.append(mod.CaptionData(fin(model_cfg(train_mode),
                                       **loader_fields(batch_size)),
                                   labels=store,
                                   features=ArrayFeatures(data[2])))
    return out


def _jax_finalized(cfg, **fields):
    from boficap_tpu.config import finalize
    cfg = type(cfg)(cfg)
    cfg.update(fields)
    return finalize(cfg)


def decode_feats(data, n: int = DEC_B):
    """The corpus' first ``n`` (train) images' features and masks, two
    regions of the first image padded."""
    att = data[2][:n]
    am = np.ones((n, R), np.float32)
    am[0, -2:] = 0
    return att, am


def memories(jm, params, tm, att, am):
    """Each package's own encode of the same features, and the masks."""
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    return (jmem, jnp.asarray(am).astype(bool), tmem,
            torch.from_numpy(am).bool())


class Pair:
    """A trained port model ``tm``, the JAX model and params holding its
    weights, the corpus, and the decode batch's features and memories."""

    def __init__(self, mode: str, data, tm):
        self.mode, self.data, self.tm = mode, data, tm
        self.jm, self.params = carry(tm, mode)
        self.att, self.am = decode_feats(data)
        self.jmem, self.jsrc, self.tmem, self.tsrc = memories(
            self.jm, self.params, tm, self.att, self.am)


def trained_pair(train_mode: str, eos: bool = False) -> Pair:
    """The ``train_mode`` model trained on the corpus (``eos``: its rows
    end with EOS), with its loss asserted to have fallen five-fold."""
    data = corpus(eos=eos)
    tm, losses = train(train_mode, data)
    assert losses[-1] < 0.2 * losses[0], losses
    return Pair(train_mode, data, tm)


def to_np(out):
    return {k: np.asarray(v) for k, v in out.items()}
