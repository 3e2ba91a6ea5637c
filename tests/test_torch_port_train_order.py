"""The port's trainer consumes train batches in the JAX package's order: the
JAX trainer draws one batch to initialise the model before it restores the
loader (JAX tools/train.py:182,210), so a fresh run trains first on batch
2.  A fresh port run of N iterations saves the loader position of a fresh
``CaptionData`` (the JAX package's) that drew 1 + N train batches; a
resume restores the saved position (its own extra draw is replaced)."""

import os

import numpy as np

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.config import load_yaml_with_base
from boficap_tpu.data.dataset import CaptionData as JaxCaptionData
from boficap_tpu_torch.config import parse_opt
from boficap_tpu_torch.tools.train import train
from boficap_tpu_torch.train.state import load_infos

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.yml")
# 18 train images, batch 9: a fresh run's first epoch is draws 2 and 3 (the
# third wraps), 2 iterations; the next epoch is draws 4 and 5
FIELDS = dict(batch_size=9)


def _jax_loader(n_draws: int, resume_from=None, then: int = 0):
    """The JAX package's loader over the same corpus: ``n_draws`` train
    batches, then (a resume) the saved position ``resume_from`` restored
    and ``then`` more batches; its position."""
    cfg = jax_default_config()
    cfg.update(load_yaml_with_base(SMOKE))
    cfg.update(FIELDS)
    jax_finalize(cfg)
    loader = JaxCaptionData(cfg)
    for _ in range(n_draws):
        loader.get_batch("train")
    if resume_from is not None:
        loader.load_state_dict(resume_from)
        for _ in range(then):
            loader.get_batch("train")
    return loader.state_dict()


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for split in want:
        np.testing.assert_array_equal(np.asarray(got[split]["index_list"]),
                                      np.asarray(want[split]["index_list"]))
        assert int(got[split]["iter_counter"]) == int(
            want[split]["iter_counter"]), split


def test_fresh_run_and_resume_follow_jax_order(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    base = ["--cfg", SMOKE, "--id", "order", "--checkpoint_path", ck,
            "--device", "cpu", "--batch_size", str(FIELDS["batch_size"]),
            "--save_checkpoint_every", "1000", "--language_eval", "0"]
    train(parse_opt(base + ["--max_epochs", "1"]))
    infos = load_infos(ck, "order")
    assert infos["iter"] == 2 and infos["epoch"] == 1
    _same_state(infos["loader_state_dict"], _jax_loader(1 + 2))

    # the resume: the saved position wins over the resumed run's own draw
    # (the shuffle's random state is not saved, in either package, so a
    # resumed run's next epoch is the JAX resume's, not a continuous run's)
    saved = infos["loader_state_dict"]
    train(parse_opt(base + ["--max_epochs", "2", "--start_from", ck]))
    infos = load_infos(ck, "order")
    assert infos["iter"] == 4 and infos["epoch"] == 2
    _same_state(infos["loader_state_dict"],
                _jax_loader(1, resume_from=saved, then=2))
