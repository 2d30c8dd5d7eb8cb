"""ROUGE-L: longest-common-subsequence F-measure.

Matches the semantics of the reference's vendored
coco_caption/pycocoevalcap/rouge/rouge.py:15-104 (Lin & Hovy):
per reference compute LCS precision/recall against the hypothesis, take the
max precision and max recall over references, combine with
``F = (1+b^2) p r / (r + b^2 p)`` with beta = 1.2; corpus score is the mean.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) DP, rolling one row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(cur[j - 1], prev[j])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2) -> None:
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) > 0
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            ref_words = ref.split()
            lcs = _lcs_len(hyp, ref_words)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref_words) if ref_words else 0.0)
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta ** 2) * prec_max * rec_max /
                    (rec_max + self.beta ** 2 * prec_max))
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [self.calc_score(res[i], gts[i]) for i in gts]
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "Rouge"
