"""METEOR metric.

Two paths, mirroring the reference's dependency structure
(coco_caption/pycocoevalcap/meteor/meteor.py — a Java stdio daemon around
``meteor-1.5.jar``):

* **jar path** — if the METEOR 1.5 jar is available (``SICZ_TPU_METEOR_JAR``
  env var or a jar next to this file), we speak the same
  ``SCORE ||| refs ||| hyp`` / ``EVAL ||| stats`` stdio protocol for official
  numbers.
* **lite path** — otherwise a pure-Python approximation: METEOR's exact-match
  stage plus a Porter-stem stage on the words the exact stage left unmatched
  (the classic Banerjee & Lavie 2005 configuration: harmonic mean weighted
  9:1 toward recall, fragmentation penalty ``0.5 * (chunks/matches)^3``, max
  over references).  Parity vs an independent implementation is
  machine-checked: ``tests/test_vocab_and_metrics.py`` scores a committed
  fixture against nltk's ``meteor_score`` (synonym stage disabled) and
  records the deviation — see docs/PARITY.md for the number.  The remaining
  divergence from *jar* METEOR 1.5 (synonym/paraphrase stages, 1.5's
  retuned alpha/beta/gamma/delta and content/function word weighting) is
  unquantifiable without the jar; scores are therefore clearly labeled
  ``METEOR(lite)`` in reports.
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

import numpy as np


def _find_jar() -> str:
    from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import find_jar
    return find_jar("SICZ_TPU_METEOR_JAR", "meteor-1.5.jar")


_STEM = None


def _stem():
    """Porter stemmer for the stem-match stage; identity fallback keeps the
    scorer functional (slightly lower scores) in stripped environments."""
    global _STEM
    if _STEM is None:
        try:
            from nltk.stem.porter import PorterStemmer
            _STEM = PorterStemmer().stem
        except Exception:
            _STEM = lambda w: w  # noqa: E731
    return _STEM


def _greedy_stage(hyp_enum, ref_enum, key):
    """One alignment stage, pinned to nltk's matching convention so the lite
    scorer is bit-identical to an independent oracle (see module docstring):
    hypothesis words are scanned right-to-left, each taking the RIGHTMOST
    still-unused reference occurrence with ``key(h) == key(r)``.

    hyp_enum/ref_enum: [(original_index, word)].  Returns ((i, j) pairs,
    unmatched hyp enum, unmatched ref enum)."""
    slots = {}
    for j, w in ref_enum:
        slots.setdefault(key(w), []).append(j)
    pairs, h_left, r_used = [], [], set()
    for i, w in reversed(hyp_enum):
        lst = slots.get(key(w))
        if lst:
            j = lst.pop()
            pairs.append((i, j))
            r_used.add(j)
        else:
            h_left.append((i, w))
    h_left.reverse()
    r_left = [(j, w) for j, w in ref_enum if j not in r_used]
    return pairs, h_left, r_left


def meteor_lite_sentence(hyp: str, refs: List[str],
                         alpha: float = 0.9, beta: float = 3.0,
                         gamma: float = 0.5) -> float:
    """Exact + Porter-stem METEOR for one sentence: max over references."""
    hyp_words = [w.lower() for w in hyp.split()]
    stem = _stem()
    best = 0.0
    for ref in refs:
        ref_words = [w.lower() for w in ref.split()]
        h_enum = list(enumerate(hyp_words))
        r_enum = list(enumerate(ref_words))
        exact, h_enum, r_enum = _greedy_stage(h_enum, r_enum, lambda w: w)
        stems, _, _ = _greedy_stage(h_enum, r_enum, stem)
        align = sorted(exact + stems)      # chunking is over hyp order
        m = len(align)
        if m == 0:
            continue
        p = m / len(hyp_words)
        r = m / len(ref_words)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        # count chunks: maximal runs contiguous in both hyp and ref
        chunks = 1
        for (i0, j0), (i1, j1) in zip(align, align[1:]):
            if not (i1 == i0 + 1 and j1 == j0 + 1):
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        best = max(best, fmean * (1 - penalty))
    return best


class Meteor:
    """Same interface as the reference wrapper (meteor/meteor.py:18-75)."""

    def __init__(self) -> None:
        self._jar = _find_jar()
        self._proc = None
        self._lock = threading.Lock()
        if self._jar:
            from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import java_cmd
            env = dict(os.environ)
            env["LC_ALL"] = "en_US.UTF_8"
            self._proc = subprocess.Popen(
                java_cmd() + ["-jar", "-Xmx2G", self._jar, "-", "-",
                              "-stdio", "-l", "en", "-norm"],
                cwd=os.path.dirname(os.path.abspath(self._jar)),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                # DEVNULL, not PIPE: nothing drains stderr, so a chatty jar
                # (per-line locale/token warnings) would fill the ~64KB pipe
                # and deadlock the stdout protocol mid-eval
                stderr=subprocess.DEVNULL, env=env,
                universal_newlines=True, bufsize=1)

    @property
    def using_jar(self) -> bool:
        return self._proc is not None

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        # gts insertion order — CocoEvalCap zips per-image scores against
        # gts.keys(); sorting here would misassign them (a latent bug in the
        # reference's vendored meteor.py we do not reproduce)
        img_ids = list(gts.keys())
        if self._proc is None:
            scores = [meteor_lite_sentence(res[i][0], gts[i]) for i in img_ids]
            return float(np.mean(scores)), scores
        with self._lock:
            eval_line = "EVAL"
            for i in img_ids:
                assert len(res[i]) == 1
                hyp = res[i][0].replace("|||", "").replace("  ", " ")
                score_line = " ||| ".join(("SCORE", " ||| ".join(gts[i]), hyp))
                self._proc.stdin.write(score_line + "\n")
                eval_line += " ||| " + self._proc.stdout.readline().strip()
            self._proc.stdin.write(eval_line + "\n")
            scores = [float(self._proc.stdout.readline().strip())
                      for _ in img_ids]
            final = float(self._proc.stdout.readline().strip())
        return final, scores

    def method(self) -> str:
        return "METEOR" if self.using_jar else "METEOR(lite)"

    def __del__(self):  # noqa: D105
        if self._proc is not None:
            try:
                self._proc.stdin.close()
                self._proc.kill()
                self._proc.wait()
            except Exception:
                pass
