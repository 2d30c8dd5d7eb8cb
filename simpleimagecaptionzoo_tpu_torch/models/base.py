"""Captioner base contract and registry.

Counterpart of the JAX package's ``models/base.py``.  A captioner defines
*encode* and one *decoder step*; the decode loops in ``ops/decode.py`` are
derived from the step.  The grouped-lanes protocol of beam search comes with
the beam slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.ops import quant


@dataclasses.dataclass
class Encoded:
    """Output of a captioner's encode pass.

    features: (B, N, D) refined visual features the decoder attends over.
    mean:     (B, D) pooled feature fed to the first LSTM / context mix.
    mask:     optional (B, N) 0/1 mask over feature rows (None == all valid).
    extras:   model-specific precomputation, made once per encode instead of
              once per decode step (e.g. AoA's decoder K/V projections).
    """

    features: torch.Tensor
    mean: torch.Tensor
    mask: Optional[torch.Tensor] = None
    extras: Optional[dict] = None


class Captioner:
    """Base class: concrete models implement the methods below as functions
    of their parameter dicts."""

    def __init__(self, config: ModelConfig) -> None:
        self.config = config

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        raise NotImplementedError

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        """visual dict -> (Encoded, model_state passed through)."""
        raise NotImplementedError

    def init_state(self, params, encoded: Encoded) -> Any:
        raise NotImplementedError

    def step_core(self, params, encoded: Encoded, state,
                  tokens: torch.Tensor, *, train: bool = False,
                  generator=None):
        """One decode step up to, not including, the prediction head:
        (pre_logits (B, H), new_state, alpha (B, N) or None)."""
        raise NotImplementedError

    def predict(self, params, pre_logits: torch.Tensor) -> torch.Tensor:
        """Prediction head: pre_logits (..., H) -> logits (..., V), the
        weight-norm linear head of every family (AoA_Model.py:212)."""
        return L.dense_wn(params["predict"], pre_logits)

    def step(self, params, encoded: Encoded, state, tokens: torch.Tensor, *,
             train: bool = False, generator=None):
        """One decode step: (logits (B, V), new_state, alpha or None)."""
        out, new_state, alpha = self.step_core(params, encoded, state,
                                               tokens, train=train,
                                               generator=generator)
        return self.predict(params, out), new_state, alpha

    #: the layer dicts every decode step reads (the quantizable hot set);
    #: layers that run once per batch in encode stay at full precision
    decode_quant_paths: Tuple[Tuple[str, ...], ...] = ()

    def quantize_decode_params(self, params) -> Dict[str, Any]:
        """Weight-only int8 copy of ``params`` for serving decode
        (``ops/quant.py``): the layers of :attr:`decode_quant_paths` become
        ``{"q", "s", "b"}`` dicts, the rest is shared.  The result drops into
        any decode function unchanged."""
        if not self.decode_quant_paths:
            return params
        return quant.quantize_tree(params, self.decode_quant_paths)


_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_captioner(config: ModelConfig) -> Captioner:
    """Factory matching reference model_construction (Utils.py:161-203)."""
    # importing registers the classes
    from simpleimagecaptionzoo_tpu_torch.models import aoa  # noqa: F401
    if config.model_type not in _REGISTRY:
        raise ValueError("model_type %r is not ported yet (have %s)"
                         % (config.model_type, sorted(_REGISTRY)))
    return _REGISTRY[config.model_type](config)
