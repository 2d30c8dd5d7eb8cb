"""Training state: the counterpart of the JAX package's ``engine/state.py``
(which replaces torch's in-place module and optimizer with one value)."""
from __future__ import annotations

import dataclasses
from typing import Any

from simpleimagecaptionzoo_tpu_torch.engine.optim import GradientTransformation


@dataclasses.dataclass
class TrainState:
    """params (float32 master weights), opt_state (the transform's moments),
    model_state (BatchNorm running stats and the like; AoADetection has
    none) and step (the global step count)."""

    params: Any
    opt_state: Any
    model_state: Any
    step: int

    @classmethod
    def create(cls, params, tx: GradientTransformation,
               model_state=None) -> "TrainState":
        return cls(params=params, opt_state=tx.init(params),
                   model_state=model_state if model_state is not None else {},
                   step=0)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def reset_optimizer(self, tx: GradientTransformation) -> "TrainState":
        """The epoch-boundary optimizer re-creation (reference
        Engine.py:135-138 builds a fresh optimizer every epoch, which
        resets the momenta); params, model_state and step are kept."""
        return self.replace(opt_state=tx.init(self.params))
