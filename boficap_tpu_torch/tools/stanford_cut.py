"""Demo of the constituency phrase cutter: the JAX package's
``scripts/stanford_cut.py`` (reference scripts/stanford_cut.py).  Cuts a
few sentences and prints their phrase plans.

    python -m boficap_tpu_torch.tools.stanford_cut --cutter heuristic \\
        --sentences "a man riding a wave on top of a surfboard"
"""

from __future__ import annotations

import argparse

from ..prepro.labels import assemble_phrases, heuristic_chunks, stanza_chunks

DEMO = [
    "a man riding a wave on top of a surfboard",
    "two dogs are playing with a frisbee in the park",
    "a close up of a plate of food with broccoli",
]
NAMES = {4: "VP", 5: "NP", 6: "CP"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sentences", nargs="*", default=DEMO)
    p.add_argument("--cutter", default="stanza",
                   choices=["stanza", "heuristic"])
    p.add_argument("--depth", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    nlp = None
    cutter = a.cutter
    if cutter == "stanza":
        try:
            import stanza
            nlp = stanza.Pipeline(lang="en",
                                  processors="tokenize,pos,constituency")
        except ImportError:
            print("stanza not installed; using the heuristic cutter")
            cutter = "heuristic"
    for sent in a.sentences:
        toks = sent.split()
        spans = (stanza_chunks(toks, nlp, a.depth) if cutter == "stanza"
                 else heuristic_chunks(toks))
        pl, lab, cnt = assemble_phrases(len(toks), spans, max(len(toks), 20))
        print(f"\n{sent}")
        start = 0
        for j in range(cnt):
            n = int(pl[j])
            print(f"  [{NAMES[int(lab[j])]}] "
                  f"{' '.join(toks[start:start + n])}")
            start += n


if __name__ == "__main__":
    main()
