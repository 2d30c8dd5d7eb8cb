"""Per-model Engine subclasses (the JAX package's
``engine/model_engines.py``; reference ModelEngines/*.py).

Only the visualization hook ``show_additional_rlt`` differs between them
(the reference's ``modify_visual_inputs`` is the data layer's static-shape
padding here):

* NIC has no attention -> the base no-op (NIC_Engine.py:3).
* Spatial models overlay the 7x7 attention grid (BUTD_Engine.py:9-18).
* Detection models paint the attended bottom-up boxes (BUTD_Engine.py:49-59).

The png needs matplotlib; without it the hook logs one line saying so and
draws nothing.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from simpleimagecaptionzoo_tpu_torch.config import DataConfig, ModelConfig
from simpleimagecaptionzoo_tpu_torch.engine.engine import Engine

ATTENTION_PNG = "attention_visualization.png"


NO_MATPLOTLIB = ("attention visualization skipped: matplotlib is not "
                 "installed")


def _visualize_or_say(engine: Engine, alphas):
    """utils.visualize when there are alphas and matplotlib imports; None
    otherwise, after logging :data:`NO_MATPLOTLIB` when it is matplotlib
    that is missing."""
    if alphas is None:
        return None
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        engine._log(NO_MATPLOTLIB)
        return None
    from simpleimagecaptionzoo_tpu_torch.utils import visualize
    return visualize


class NICEngine(Engine):
    pass  # no attention to visualize (reference NIC_Engine.py:3)


class _SpatialAttnEngine(Engine):
    def show_additional_rlt(self, alphas, visual_item: Dict,
                            caption: List[str]):
        viz = _visualize_or_say(self, alphas)
        if viz is None or "img_tensors" not in visual_item:
            return
        viz.visualize_att(np.asarray(visual_item["img_tensors"]),
                          np.asarray(alphas)[:len(caption)], caption,
                          grid_side=self.cfg.enc_img_size,
                          save_path=ATTENTION_PNG)
        print("saved " + ATTENTION_PNG)


class _DetectionAttnEngine(Engine):
    def show_additional_rlt(self, alphas, visual_item: Dict,
                            caption: List[str]):
        viz = _visualize_or_say(self, alphas)
        bboxes = visual_item.get("bu_bboxes")
        image = visual_item.get("original_image")
        if viz is None or bboxes is None or image is None:
            return
        viz.visualize_att_bboxes(np.asarray(image),
                                 np.asarray(alphas)[:len(caption)],
                                 np.asarray(bboxes), caption,
                                 save_path=ATTENTION_PNG)
        print("saved " + ATTENTION_PNG)


class BUTDSpatialEngine(_SpatialAttnEngine):
    pass


class BUTDDetectionEngine(_DetectionAttnEngine):
    pass


class AoASpatialEngine(_SpatialAttnEngine):
    pass


class AoADetectionEngine(_DetectionAttnEngine):
    pass


_ENGINES = {
    "NIC": NICEngine,
    "BUTDSpatial": BUTDSpatialEngine,
    "BUTDDetection": BUTDDetectionEngine,
    "AoASpatial": AoASpatialEngine,
    "AoADetection": AoADetectionEngine,
}


def get_engine(model_config: ModelConfig, data_config: DataConfig, vocab,
               **kwargs) -> Engine:
    """Engine factory (reference Main.py:38-63 if/elif chain)."""
    cls = _ENGINES.get(model_config.model_type, Engine)
    return cls(model_config, data_config, vocab, **kwargs)
