"""COCO-protocol evaluation driver.

Mirrors the reference's two-layer protocol:

* :class:`CocoEvalCap` — equivalent of the vendored ``COCOEvalCap``
  (coco_caption/pycocoevalcap/eval.py:13-82): PTB-tokenize gts and res, run
  the scorer suite, populate ``eval`` (corpus metrics) and ``evalImgs``
  (per-image metrics).
* :func:`coco_eval` / :func:`coco_eval_specific` — equivalents of
  COCO_Eval_Utils.py:15-85: dump the generated captions to
  ``coco_caption/results/captions-generate.json`` (same path/format), run the
  suite against the modified-annotation json, print the metric table, return
  CIDEr.  ``coco_eval_specific`` additionally writes per-image CIDEr
  statistics, best/worst-50 lists and a histogram png.

METEOR falls back to a clearly-labeled lite scorer and SPICE is skipped when
the Java jars are absent (see meteor.py / spice.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData
from simpleimagecaptionzoo_tpu_torch.evalcap.bleu import Bleu
from simpleimagecaptionzoo_tpu_torch.evalcap.cider_scorer import Cider
from simpleimagecaptionzoo_tpu_torch.evalcap.meteor import Meteor
from simpleimagecaptionzoo_tpu_torch.evalcap.rouge import Rouge
from simpleimagecaptionzoo_tpu_torch.evalcap.spice import Spice
from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import PTBTokenizer


class CocoEvalCap:
    def __init__(self, gts: Dict[int, List[dict]], res: Dict[int, List[dict]],
                 include_spice: bool = True) -> None:
        """gts/res: {image_id: [{'caption': str, ...}, ...]}."""
        self.eval: Dict[str, float] = {}
        self.evalImgs: List[dict] = []
        self._img_to_eval: Dict = {}
        self._gts = gts
        self._res = res
        self._include_spice = include_spice

    def evaluate(self) -> None:
        print("tokenization...")
        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize(self._gts)
        res = tokenizer.tokenize(self._res)

        meteor = Meteor()
        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            # key = "METEOR" with the jar, "METEOR(lite)" with the fallback
            # so lite numbers are never mistaken for official METEOR
            (meteor, meteor.method()),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        if self._include_spice:
            spice = Spice()
            if spice.available:
                scorers.append((spice, "SPICE"))
            else:
                # key = "SPICE" with the jar, "SPICE(lite)" with the
                # rule-based fallback (spice_lite.py) so approximate
                # numbers are never mistaken for official SPICE
                from simpleimagecaptionzoo_tpu_torch.evalcap.spice_lite import \
                    SpiceLite
                print("SPICE jar unavailable — using SPICE(lite)")
                scorers.append((SpiceLite(), "SPICE(lite)"))

        for scorer, method in scorers:
            print("computing %s score..." % scorer.method())
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self.eval[m] = sc
                    self._set_img_scores(scs, gts.keys(), m)
            else:
                self.eval[method] = score
                # SPICE per-image scores are category dicts, not floats
                if not method.startswith("SPICE"):
                    self._set_img_scores(scores, gts.keys(), method)
        self.evalImgs = list(self._img_to_eval.values())

    def _set_img_scores(self, scores, img_ids, method) -> None:
        for img_id, score in zip(img_ids, scores):
            entry = self._img_to_eval.setdefault(img_id, {"image_id": img_id})
            entry[method] = score


class SpiceEvalCap:
    """SPICE-only eval driver — the "AllSPICE" surface of the vendored
    coco_caption (eval_spice.py:8-58, ``SpiceEval``/``COCOEvalCapSpice``):
    PTB-tokenize gts/res and run ONLY the SPICE scorer, populating ``eval``
    (corpus F-score) and ``imgToEval`` (per-image score breakdowns).  Used
    to score a merged multi-candidate result set, where the n-gram metrics
    of the full suite are not meaningful.  With the jar the key is
    ``SPICE``; without it the rule-based :class:`SpiceLite` fallback runs
    under the key ``SPICE(lite)`` (``using_jar`` says which)."""

    def __init__(self, gts: Dict[int, List[dict]],
                 res: Dict[int, List[dict]]) -> None:
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict = {}
        self._gts = gts
        self._res = res
        self._spice = Spice()
        if not self._spice.available:
            from simpleimagecaptionzoo_tpu_torch.evalcap.spice_lite import SpiceLite
            self._spice = SpiceLite()

    @property
    def using_jar(self) -> bool:
        return isinstance(self._spice, Spice)

    @property
    def available(self) -> bool:
        return True

    def evaluate(self):
        """Returns ``(corpus_spice, imgToEval)`` like the reference's
        SpiceEval.evaluate (eval_spice.py:20-42)."""
        key = "SPICE" if self.using_jar else "SPICE(lite)"
        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize(self._gts)
        res = tokenizer.tokenize(self._res)
        score, scores = self._spice.compute_score(gts, res)
        self.eval[key] = score
        for img_id, per_img in zip(gts.keys(), scores):
            entry = self.imgToEval.setdefault(img_id, {"image_id": img_id})
            entry[key] = per_img
        print("%s: %.3f" % (key, score))
        return score, self.imgToEval


def _load_gts_res(results: List[dict], eval_caption_path: str):
    """Build gts/res dicts restricted to the images present in ``results``
    (the reference sets ``params['image_id'] = cocoRes.getImgIds()``)."""
    capdata = CaptionData(annotation_file=eval_caption_path)
    res: Dict = {}
    for entry in results:
        res.setdefault(entry["image_id"], []).append(
            {"image_id": entry["image_id"], "caption": entry["caption"]})
    gts = {img_id: capdata.imgToAnns[img_id] for img_id in res}
    return gts, res


def coco_eval(results: List[dict], eval_caption_path: str,
              results_dir: str = "./coco_caption/results/") -> float:
    """Reference-format eval: dump results json, score, print, return CIDEr
    (COCO_Eval_Utils.py:15-35)."""
    os.makedirs(results_dir, exist_ok=True)
    res_file = os.path.join(results_dir, "captions-generate.json")
    # atomic write: multi-host runs have every process score (identical)
    # results, so concurrent writers on a shared filesystem must not
    # interleave partial contents; the port runs one process, whose index
    # in the tmp name is 0 (the JAX package writes its process index there)
    tmp = res_file + ".tmp.%d.%d" % (0, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(results, f)
    os.replace(tmp, res_file)

    gts, res = _load_gts_res(results, eval_caption_path)
    ev = CocoEvalCap(gts, res)
    ev.evaluate()

    cider = 0.0
    print("---------------Evaluation performance-----------------")
    for metric, score in ev.eval.items():
        print("%s: %.3f" % (metric, score))
        if metric == "CIDEr":
            cider = score
    return cider


def coco_eval_specific(results: List[dict], eval_caption_path: str,
                       entry_limit: int = 500,
                       statics_dir: str = "./Data/Eval_Statics/") -> float:
    """Per-image CIDEr statistics dump (COCO_Eval_Utils.py:37-85)."""
    gts, res = _load_gts_res(results, eval_caption_path)
    ev = CocoEvalCap(gts, res)
    ev.evaluate()

    os.makedirs(statics_dir, exist_ok=True)
    ans = [{"img_id": e["image_id"], "CIDEr": e.get("CIDEr", 0.0)}
           for e in ev.evalImgs]
    cider_arr = np.array([a["CIDEr"] for a in ans])
    order = np.argsort(cider_arr)[::-1]
    with open(os.path.join(statics_dir, "CIDEr_Result.txt"), "w") as f:
        f.write("img_id CIDEr\n")
        for a in ans[:entry_limit]:
            f.write("%s %s\n" % (a["img_id"], np.round(a["CIDEr"], 2)))
        f.write("best samples:\n")
        for idx in order[:50]:
            f.write("%s %s\n" % (ans[idx]["img_id"], np.round(ans[idx]["CIDEr"], 2)))
        f.write("worst samples:\n")
        for idx in order[::-1][:50]:
            f.write("%s %s\n" % (ans[idx]["img_id"], np.round(ans[idx]["CIDEr"], 2)))

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.hist(cider_arr, bins=list(range(11)))
        plt.title("Histogram of CIDEr Scores", fontsize=20)
        plt.xlabel("CIDEr score", fontsize=20)
        plt.ylabel("result counts", fontsize=20)
        plt.savefig(os.path.join(statics_dir, "ciderHist.png"), dpi=300)
        plt.close()
    except Exception as exc:  # matplotlib optional
        print("histogram skipped: %s" % exc)
    return float(ev.eval.get("CIDEr", 0.0))
