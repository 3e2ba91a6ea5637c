"""Port parity, offline preprocessing: ``boficap_tpu_torch/prepro/`` against
the JAX package's ``prepro/`` on the cases of ``tests/test_prepro.py`` (and
the cutter goldens), and each of the eight dataset-building CLIs of
``boficap_tpu_torch/tools/`` against its ``scripts/`` counterpart, run in
subprocesses on a small seeded Karpathy-format corpus.  Everything is
exact: the json files equal, every h5 dataset equal in dtype and values,
the pickles equal (as sorted items: a document-frequency dict is built
from sets of n-grams, whose order follows each process's string hashing),
the printed phrase plans line for line."""

import json
import os
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pytest

from boficap_tpu.data import dataset as jds
from boficap_tpu.prepro import labels as jl
from boficap_tpu.prepro import phrase_pairs as jpp
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.prepro import labels as tl
from boficap_tpu_torch.prepro import phrase_pairs as tpp
from tests.test_prepro import tiny_dataset

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDENS = os.path.join(ROOT, "tests", "goldens", "constituency_cuts.json")
WORDS = ("a an the man woman dog cat two people table street park red "
         "small young riding sitting standing holding running is are of on "
         "in with near next to and while plate food pizza bus").split()


def _equal(got, want):
    """Nested lists / tuples / dicts / arrays equal, arrays in dtype too."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got == want and type(got) is type(want)


def karpathy(n_images: int = 24, seed: int = 0) -> dict:
    """A seeded dataset_coco.json: 5 captions an image of 4-16 words from
    WORDS (a few repeated, so phrase pairs merge), every split, COCO's
    filepath / filename / cocoid keys."""
    rs = np.random.RandomState(seed)
    stock = [" ".join(rs.choice(WORDS, rs.randint(4, 17)))
             for _ in range(8)]
    imgs = []
    for i in range(n_images):
        sents = []
        for j in range(5):
            raw = (stock[rs.randint(len(stock))] if rs.rand() < 0.5 else
                   " ".join(rs.choice(WORDS, rs.randint(4, 17))))
            sents.append({"raw": raw, "tokens": raw.split()})
        imgs.append({"cocoid": 1000 + i, "filepath": "val2014",
                     "filename": f"img{i}.jpg",
                     "split": ("train", "restval", "val", "test")[i % 4],
                     "sentences": sents})
    return {"images": imgs}


# ---------------------------------------------------------------------------
# the functions, on test_prepro.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thr", [0, 5])
def test_build_vocab_and_encode_match_jax(thr):
    jd, td = tiny_dataset(), tiny_dataset()
    _equal(tl.build_vocab(td["images"], thr),
           jl.build_vocab(jd["images"], thr))
    _equal(td, jd)                           # final_captions too
    vocab = sorted({w for img in jd["images"]
                    for c in img["final_captions"] for w in c})
    wtoi = {w: i + 4 for i, w in enumerate(vocab)}
    _equal(tl.encode_captions(td["images"], 20, wtoi),
           jl.encode_captions(jd["images"], 20, wtoi))


def test_cutters_match_jax():
    """split_run at 1-40 words and limits 5 and 19; heuristic_chunks on
    test_prepro.py's sentences, a 20-word run of one word and the 43
    constituency goldens; assemble_phrases on the spans and on
    test_prepro.py's length-capping cases."""
    for n in range(1, 41):
        for limit in (5, 19):
            assert tl.split_run(n, limit) == jl.split_run(n, limit)
    with open(GOLDENS) as f:
        golden = [c["tokens"] for c in json.load(f)["captions"]]
    sents = [s["tokens"] for img in tiny_dataset()["images"]
             for s in img["sentences"]]
    for toks in sents + golden + [["w"] * 20]:
        spans = tl.heuristic_chunks(toks)
        _equal(spans, jl.heuristic_chunks(toks))
        _equal(tl.assemble_phrases(len(toks), spans, 20),
               jl.assemble_phrases(len(toks), spans, 20))
    for case in ((20, [(0, 20, 4)], 20), (20, [], 20),
                 (12, [(0, 12, 5)], 20), (25, [(3, 4, 5)], 30)):
        _equal(tl.assemble_phrases(*case), jl.assemble_phrases(*case))


def test_cut_captions_and_prepro_match_jax(tmp_path, monkeypatch):
    """cut_captions (heuristic) equal; the parser cutters raise ImportError
    naming their package where it is missing; run_prepro's json and h5
    equal the JAX package's; prepro_captions' LabelStore equals the one
    both packages read from the files; write_prepro without h5py raises
    ImportError and writes nothing."""
    data = karpathy(seed=1)
    jd, td = json.loads(json.dumps(data)), json.loads(json.dumps(data))
    jl.build_vocab(jd["images"], 2)
    tl.build_vocab(td["images"], 2)
    _equal(tl.cut_captions(td["images"], 16), jl.cut_captions(jd["images"],
                                                              16))
    for name in ("spacy", "stanza"):
        try:
            __import__(name)
        except ImportError:
            with pytest.raises(ImportError, match=f"the {name} package"):
                tl.cut_captions(td["images"], 16, cutter=name)
    src = tmp_path / "dataset.json"
    src.write_text(json.dumps(data))
    files = {}
    for pkg, run in (("jax", jl.run_prepro), ("port", tl.run_prepro)):
        d = tmp_path / pkg
        d.mkdir()
        vocab = run(str(src), str(d / "talk.json"), str(d / "label.h5"),
                    16, 2, "heuristic")
        files[pkg] = (vocab, _read_dir(d))
    _equal(files["port"], files["jax"])
    res = tl.prepro_captions(json.loads(json.dumps(data))["images"], 16, 2)
    store = tl.label_store(res)
    for want in (tds.LabelStore.from_files(str(tmp_path / "port" /
                                               "talk.json"),
                                           str(tmp_path / "port" /
                                               "label.h5"), True),
                 jds.LabelStore.from_files(str(tmp_path / "jax" /
                                               "talk.json"),
                                           str(tmp_path / "jax" /
                                               "label.h5"), True)):
        for k in ("images", "ix_to_word", "vocab_size", "seq_length",
                  "labels", "label_start_ix", "label_end_ix", "phrase_num",
                  "phrase_length", "phrase_syn"):
            _equal(getattr(store, k), getattr(want, k))
    out = tmp_path / "none"
    out.mkdir()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        tl.write_prepro(res, str(out / "talk.json"), str(out / "l.h5"))
    assert os.listdir(out) == []


def test_phrase_pairs_match_jax():
    """The sentence table, the merge loop (word units and the label
    file's phrases), the merges applied back, and the KD splice."""
    data = karpathy(seed=2)
    imgs = data["images"]
    _equal(tpp.build_sentence_table(imgs), jpp.build_sentence_table(imgs))
    _equal(tpp.learn_phrase_pairs(imgs, threshold=2),
           jpp.learn_phrase_pairs(imgs, threshold=2))
    res = tl.prepro_captions(json.loads(json.dumps(imgs)), 16, 0)
    pdata = (res.label_start_ix, res.phrase_num, res.phrase_length)
    _equal(tpp.build_sentence_table(imgs, pdata),
           jpp.build_sentence_table(imgs, pdata))
    merges = jpp.learn_phrase_pairs(imgs, pdata, threshold=2)
    assert merges
    _equal(tpp.learn_phrase_pairs(imgs, pdata, threshold=2), merges)
    _equal(tpp.apply_merges_to_h5(imgs, *pdata, merges),
           jpp.apply_merges_to_h5(imgs, *pdata, merges))
    t = tiny_dataset()
    kd = {str(i): [f"kd caption {i} v{j}" for j in range(5)]
          for i in range(6)}
    _equal(tpp.splice_kd_captions(json.loads(json.dumps(t)), kd),
           jpp.splice_kd_captions(json.loads(json.dumps(t)), kd))


# ---------------------------------------------------------------------------
# the CLIs, in subprocesses, against scripts/
# ---------------------------------------------------------------------------

def _read_dir(d):
    """Every file under d by relative path: json parsed, h5 as {name:
    array}, a document-frequency pickle as its sorted items, npz as
    {name: array}, anything else as bytes."""
    out = {}
    for base, _, names in sorted(os.walk(d)):
        for n in sorted(names):
            p = os.path.join(base, n)
            rel = os.path.relpath(p, d)
            if n.endswith(".json"):
                with open(p) as f:
                    out[rel] = json.load(f)
            elif n.endswith(".h5"):
                with h5py.File(p, "r") as f:
                    out[rel] = {k: f[k][:] for k in f.keys()}
            elif n.endswith(".p"):
                with open(p, "rb") as f:
                    df = pickle.load(f)
                out[rel] = {"ref_len": df["ref_len"], "document_frequency":
                            sorted(df["document_frequency"].items())}
            elif n.endswith(".npz"):
                with np.load(p) as z:
                    out[rel] = {k: z[k] for k in z.files}
            else:
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


def _same_output(got: str, want: str, name: str) -> None:
    """The CLIs print the same lines, but for the cutter fallback's: there
    the port's ImportError names the missing package."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        tail = "; retrying with the heuristic cutter"
        if w.endswith(tail):
            assert g.endswith(tail) and "package" in g, (name, g)
        else:
            assert g == w, name


def _run_all(jobs):
    """Run every (cwd, argv) at once; returns their stdouts, each run
    checked to exit 0."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cwd, argv in jobs]
    outs = []
    for p, (_, argv) in zip(procs, jobs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (argv, err[-2000:])
        outs.append(out)
    return outs


def _pair(tmp_path, name, args, tag=""):
    """The (cwd, argv) of ``scripts/<name>.py`` and of the port's
    ``python -m boficap_tpu_torch.tools.<name>``, each in a directory of
    its own (made here) so their relative outputs land apart."""
    jobs = []
    for pkg, head in (("jax", [sys.executable,
                               os.path.join(ROOT, "scripts", name + ".py")]),
                      ("port", [sys.executable, "-m",
                                "boficap_tpu_torch.tools." + name])):
        d = tmp_path / f"{name}{tag}_{pkg}"
        d.mkdir()
        jobs.append((str(d), head + args))
    return jobs


def test_prepro_clis_match_scripts(tmp_path):
    """The eight CLIs on a 24-image seeded corpus, each against its
    script: prepro_labels (spaCy's default, which falls back to the
    heuristic cutter without spaCy, and --cutter heuristic --no_phrases),
    prepro_labels_stanford, stanford_cut (stanza's default and heuristic),
    KD_coco and make_synth_corpus; then, on the first label files,
    phrase_encoding (words and the h5's phrases), prep_h5 and
    prepro_ngrams (train and all)."""
    data = karpathy()
    src = tmp_path / "dataset_coco.json"
    src.write_text(json.dumps(data))
    kd = tmp_path / "kd.json"
    kd.write_text(json.dumps({str(1000 + i): [
        " ".join(np.random.RandomState(i).choice(WORDS, 6))
        for _ in range(5)] for i in range(0, 24, 3)}))
    s = str(src)
    first = [
        ("prepro_labels", ["--input_json", s, "--output_json", "talk.json",
                           "--output_h5", "talk", "--max_length", "16",
                           "--word_count_threshold", "2"], ""),
        ("prepro_labels", ["--input_json", s, "--output_json", "talk.json",
                           "--output_h5", "talk", "--cutter", "heuristic",
                           "--no_phrases"], "_np"),
        ("prepro_labels_stanford", ["--input_json", s, "--output_json",
                                    "st.json", "--output_h5", "st"], ""),
        ("stanford_cut", [], ""),
        ("stanford_cut", ["--cutter", "heuristic", "--sentences",
                          "a dog is running in the park",
                          "two people standing next to a red bus"], "_h"),
        ("KD_coco", ["--input_json", s, "--kd_json", str(kd),
                     "--output_json", "kd90.json"], ""),
        ("make_synth_corpus", ["--out", "synth", "--n_images", "12",
                               "--seed", "3"], ""),
    ]
    jobs, names = [], []
    for name, args, tag in first:
        jobs += _pair(tmp_path, name, args, tag)
        names.append(name + tag)
    outs = _run_all(jobs)
    for i, name in enumerate(names):
        j, t = (tmp_path / f"{name}_{p}" for p in ("jax", "port"))
        _equal(_read_dir(t), _read_dir(j))
        _same_output(outs[2 * i + 1], outs[2 * i], name)
        assert _read_dir(j) or outs[2 * i].strip(), name
    assert "[NP]" in outs[6] and "[VP]" in outs[8]

    talk = tmp_path / "prepro_labels_jax"
    h5 = str(talk / "talk_label.h5")
    pairs = tmp_path / "pairs.json"
    with h5py.File(h5, "r") as f:
        merges = jpp.learn_phrase_pairs(
            data["images"], (f["label_start_ix"][:], f["phrase_num"][:],
                             f["phrase_length"][:]), 2)
    assert merges
    pairs.write_text(json.dumps(merges))
    second = [
        ("phrase_encoding", ["--input_json", s, "--output_json", "pp.json",
                             "--phrase_count_threshold", "2"], ""),
        ("phrase_encoding", ["--input_json", s, "--input_h5", h5,
                             "--output_json", "pp.json",
                             "--phrase_count_threshold", "2"], "_h5"),
        ("prep_h5", ["--input_json", s, "--input_h5", h5, "--pair_json",
                     str(pairs), "--output_h5", "merged_label.h5"], ""),
        ("prepro_ngrams", ["--input_json", s, "--dict_json",
                           str(talk / "talk.json"), "--output_pkl", "coco",
                           "--split", "train"], ""),
        ("prepro_ngrams", ["--input_json", s, "--dict_json",
                           str(talk / "talk.json"), "--output_pkl", "coco"],
         "_all"),
    ]
    jobs, names = [], []
    for name, args, tag in second:
        jobs += _pair(tmp_path, name, args, tag)
        names.append(name + tag)
    outs = _run_all(jobs)
    for i, name in enumerate(names):
        j, t = (tmp_path / f"{name}_{p}" for p in ("jax", "port"))
        want = _read_dir(j)
        assert want, name
        _equal(_read_dir(t), want)
        _same_output(outs[2 * i + 1], outs[2 * i], name)
    with open(tmp_path / "prepro_ngrams_port" / "coco-words.p", "rb") as f:
        assert pickle.load(f)["ref_len"] == 12       # train and restval
    with h5py.File(tmp_path / "prep_h5_port" / "merged_label.h5") as f, \
            h5py.File(h5) as g:
        merged, cut = f["phrase_num"][:], g["phrase_num"][:]
    assert (merged <= cut).all() and (merged < cut).any()
