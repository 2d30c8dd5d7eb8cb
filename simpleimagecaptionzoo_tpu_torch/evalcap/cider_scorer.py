"""Host-side CIDEr / CIDEr-D scorer.

Consensus-based image description evaluation (Vedantam et al., CVPR'15):
1..4-gram tf-idf vectors, cosine similarity with count clipping and a
gaussian length penalty (sigma=6), averaged over n and references, x10.

Behavioral parity targets in the reference:
* cider/pyciderevalcap/ciderD/ciderD_scorer.py (df from precomputed pickle
  ``<dataset>-train.p`` or 'corpus' mode) — used as the SCST training reward.
* coco_caption/pycocoevalcap/cider/cider_scorer.py (corpus df) — used by the
  eval-protocol metric suite.  NOTE: in this reference both copies carry the
  same math *including* clipping + length penalty, so one implementation
  serves both.

Quirk preserved on purpose: sentence "length" is accumulated from *bigram*
counts (``if n == 1: length += term_freq``, ciderD_scorer.py:139-140), i.e.
length = max(0, len(words)-1).  The deltas cancel for sentences with >= 1
word, but we keep the exact semantics for bit-parity.

Unlike the reference — which re-unpickles the idf table on every scorer
construction, i.e. every SCST batch (ciderD_scorer.py:79-82) — precomputed
df tables are cached per path at module level.
"""
from __future__ import annotations

import math
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def precook(sentence: str, n: int = 4) -> Dict[Tuple[str, ...], int]:
    """Count 1..n-grams of a whitespace-tokenized sentence."""
    words = sentence.split()
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


_DF_CACHE: dict = {}


def load_df_pickle(df_mode: str, df_dir: str) -> Tuple[float, dict]:
    """Load a precomputed ``{'ref_len': float, 'document_frequency': dict}``
    idf pickle (format of PreProcess/CIDEr_idf_preproccess.py:41-82).
    Cached — the reference reloads it per batch, a known perf bug
    (SURVEY.md §3.2)."""
    path = os.path.join(df_dir, df_mode + ".p")
    key = os.path.abspath(path)
    if key not in _DF_CACHE:
        with open(path, "rb") as f:
            pkl = pickle.load(f, encoding="latin1")
        # plain dict on purpose: a shared defaultdict would be silently
        # grown by every unseen-hypothesis lookup (scorers use .get)
        _DF_CACHE[key] = (np.log(float(pkl["ref_len"])),
                          dict(pkl["document_frequency"]))
    return _DF_CACHE[key]


def default_df_dir() -> str:
    return os.environ.get("SICZ_TPU_CIDER_DF_DIR", "cider_idf")


class CiderScorer:
    """Accumulating scorer: feed (test, refs) pairs, then compute."""

    def __init__(self, df_mode: str = "corpus", n: int = 4,
                 sigma: float = 6.0, df_dir: str | None = None) -> None:
        self.n = n
        self.sigma = sigma
        self.df_mode = df_mode
        self.crefs: List[List[Dict]] = []
        self.ctest: List[Dict] = []
        self.document_frequency: dict = defaultdict(float)
        self.ref_len: float | None = None
        if df_mode != "corpus":
            self.ref_len, self.document_frequency = load_df_pickle(
                df_mode, df_dir or default_df_dir())

    def append(self, test: str, refs: Sequence[str]) -> None:
        self.crefs.append([precook(ref, self.n) for ref in refs])
        self.ctest.append(precook(test, self.n))

    # -- internals ---------------------------------------------------------
    def _compute_doc_freq(self) -> None:
        for refs in self.crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                self.document_frequency[ngram] += 1

    def _counts2vec(self, cnts: Dict) -> Tuple[list, list, int]:
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, term_freq in cnts.items():
            df = np.log(max(1.0, self.document_frequency.get(ngram, 0.0)))
            n = len(ngram) - 1
            vec[n][ngram] = float(term_freq) * (self.ref_len - df)
            norm[n] += vec[n][ngram] ** 2
            if n == 1:            # bigram-count "length" — see module docstring
                length += term_freq
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vec_h, vec_r, norm_h, norm_r, len_h, len_r) -> np.ndarray:
        delta = float(len_h - len_r)
        val = np.zeros(self.n)
        for n in range(self.n):
            for ngram, w in vec_h[n].items():
                val[n] += min(w, vec_r[n][ngram]) * vec_r[n][ngram]
            if norm_h[n] != 0 and norm_r[n] != 0:
                val[n] /= norm_h[n] * norm_r[n]
            val[n] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def compute_score(self) -> Tuple[float, np.ndarray]:
        if self.df_mode == "corpus":
            self.document_frequency = defaultdict(float)
            self._compute_doc_freq()
            self.ref_len = np.log(float(len(self.crefs)))
        scores = []
        for test, refs in zip(self.ctest, self.crefs):
            vec, norm, length = self._counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = self._counts2vec(ref)
                score += self._sim(vec, vec_r, norm, norm_r, length, len_r)
            scores.append(float(np.mean(score)) / len(refs) * 10.0)
        arr = np.array(scores)
        return float(np.mean(arr)), arr


class CiderD:
    """Interface parity with cider/pyciderevalcap/ciderD/ciderD.py:16-44.

    ``gts``: {img_id: [tokenized caption strings]};
    ``res``: list of {'image_id':..., 'caption': [str]} entries.
    """

    def __init__(self, n: int = 4, sigma: float = 6.0, df: str = "corpus",
                 df_dir: str | None = None) -> None:
        self._n, self._sigma, self._df, self._df_dir = n, sigma, df, df_dir

    def compute_score(self, gts: Dict, res: List[Dict]):
        scorer = CiderScorer(df_mode=self._df, n=self._n, sigma=self._sigma,
                             df_dir=self._df_dir)
        for entry in res:
            hypo = entry["caption"]
            refs = gts[entry["image_id"]]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) > 0
            scorer.append(hypo[0], refs)
        return scorer.compute_score()

    def method(self) -> str:
        return "CIDEr-D"


class Cider(CiderD):
    """coco_caption-style interface: both gts and res are
    {img_id: [strings]} dicts (cider.py in coco_caption)."""

    def compute_score(self, gts: Dict, res: Dict):
        scorer = CiderScorer(df_mode=self._df, n=self._n, sigma=self._sigma,
                             df_dir=self._df_dir)
        for img_id in gts:
            hypo = res[img_id]
            refs = gts[img_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) > 0
            scorer.append(hypo[0], refs)
        return scorer.compute_score()

    def method(self) -> str:
        return "CIDEr"
