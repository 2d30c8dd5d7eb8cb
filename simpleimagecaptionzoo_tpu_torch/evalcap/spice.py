"""SPICE metric (Java jar wrapper, gracefully gated).

The reference runs SPICE via a vendored jar
(coco_caption/pycocoevalcap/spice/spice.py:18,72-79).  We speak the same
batch-json protocol when a jar is available (``SICZ_TPU_SPICE_JAR`` env var
or ``spice-1.0.jar`` next to this file); otherwise :class:`Spice` reports
itself unavailable and the eval drivers fall back to the rule-based
approximation in spice_lite.py under the clearly-distinct key
``SPICE(lite)`` — there is no faithful pure-Python SPICE (official
scores require Stanford scene-graph parsing).
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Dict

import numpy as np


def _find_jar() -> str:
    from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import find_jar
    return find_jar("SICZ_TPU_SPICE_JAR", "spice-1.0.jar")


class Spice:
    def __init__(self) -> None:
        self._jar = _find_jar()

    @property
    def available(self) -> bool:
        return bool(self._jar)

    def compute_score(self, gts: Dict, res: Dict):
        if not self._jar:
            raise RuntimeError("SPICE jar not available; metric skipped")
        assert sorted(gts.keys()) == sorted(res.keys())
        img_ids = sorted(gts.keys())
        input_data = [{"image_id": i, "tests": res[i], "refs": gts[i]}
                      for i in img_ids]
        workdir = os.path.dirname(os.path.abspath(self._jar))
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(input_data, f, indent=2)
            in_path = f.name
        out_path = in_path + ".out"
        cache = os.path.join(tempfile.gettempdir(), "spice_cache")
        os.makedirs(cache, exist_ok=True)
        try:
            from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import java_cmd
            subprocess.check_call(
                java_cmd() + ["-jar", "-Xmx8G", self._jar, in_path,
                              "-cache", cache, "-out", out_path,
                              "-subset", "-silent"],
                cwd=workdir)
            with open(out_path) as f:
                results = json.load(f)
        finally:
            for p in (in_path, out_path):
                if os.path.exists(p):
                    os.remove(p)
        by_id = {item["image_id"]: item["scores"] for item in results}
        spice_scores = [float(by_id[i]["All"]["f"]) for i in img_ids]
        scores = [by_id[i] for i in img_ids]
        return float(np.mean(spice_scores)), scores

    def method(self) -> str:
        return "SPICE"
