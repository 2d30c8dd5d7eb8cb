"""Corpus BLEU-1..4 with 'closest' effective reference length.

Reimplements the scoring semantics of the reference's vendored
coco_caption/pycocoevalcap/bleu/bleu_scorer.py (David Chiang's scorer):
clipped modified n-gram precision accumulated corpus-wide, per-sentence
'closest' reference length, tiny/small smoothing constants, brevity penalty
``exp(1 - 1/ratio)`` applied when ratio < 1, and per-image scores computed
from per-sentence statistics with per-sentence brevity penalty.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


_SMALL = 1e-9
_TINY = 1e-15


class BleuScorer:
    def __init__(self, n: int = 4) -> None:
        self.n = n
        self._sentences: List[tuple] = []   # (testlen, reflens, guess, correct)

    def append(self, test: str, refs: Sequence[str]) -> None:
        n = self.n
        test_words = test.split()
        testlen = len(test_words)
        test_counts = _ngram_counts(test_words, n)
        reflens = []
        max_ref_counts: Dict[tuple, int] = {}
        for ref in refs:
            ref_words = ref.split()
            reflens.append(len(ref_words))
            for ngram, cnt in _ngram_counts(ref_words, n).items():
                if cnt > max_ref_counts.get(ngram, 0):
                    max_ref_counts[ngram] = cnt
        guess = [max(0, testlen - k) for k in range(n)]
        correct = [0] * n
        for ngram, cnt in test_counts.items():
            correct[len(ngram) - 1] += min(max_ref_counts.get(ngram, 0), cnt)
        self._sentences.append((testlen, reflens, guess, correct))

    def compute_score(self, option: str = "closest") -> Tuple[List[float], List[List[float]]]:
        n = self.n
        total_testlen = 0
        total_reflen = 0.0
        total_guess = [0] * n
        total_correct = [0] * n
        per_image: List[List[float]] = [[] for _ in range(n)]

        for testlen, reflens, guess, correct in self._sentences:
            if option == "closest":
                reflen = min((abs(l - testlen), l) for l in reflens)[1]
            elif option == "shortest":
                reflen = min(reflens)
            else:  # average
                reflen = float(sum(reflens)) / len(reflens)
            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]
            # per-image score with its own brevity penalty
            bleu = 1.0
            for k in range(n):
                bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                per_image[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            if ratio < 1:
                for k in range(n):
                    per_image[k][-1] *= math.exp(1 - 1 / ratio)

        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        if ratio < 1:
            bleus = [b * math.exp(1 - 1 / ratio) for b in bleus]
        return bleus, per_image


class Bleu:
    """coco_caption-style interface (bleu/bleu.py:17-49)."""

    def __init__(self, n: int = 4) -> None:
        self._n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scorer = BleuScorer(n=self._n)
        for img_id in gts:
            hypo, ref = res[img_id], gts[img_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(ref, list) and len(ref) >= 1
            scorer.append(hypo[0], ref)
        return scorer.compute_score(option="closest")

    def method(self) -> str:
        return "Bleu"
