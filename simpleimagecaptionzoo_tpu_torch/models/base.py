"""Captioner base contract and registry.

Counterpart of the JAX package's ``models/base.py``.  A captioner defines
*encode* and one *decoder step*; the decode loops in ``ops/decode.py``
(greedy and beam search) are derived from the step, so they cannot drift
apart.  Beam search runs the grouped-lanes form of the step
(:meth:`Captioner.step_lanes_core`): the k beams of a sample are k lanes
that share the sample's encoding.

The from-pixels families (NIC, BUTDSpatial, AoASpatial: ``has_cnn``) run
their ResNet-101 in :meth:`Captioner._cnn_features`, from ``img_tensors``
(a uint8 or normalized batch, or a fast-ingest pad box with ``img_hw``).
Their pooled features come out float32, as in the JAX package, and each
family casts them to the dtype of the parameters they meet first.  That
is a deliberate difference: JAX's type promotion would run a bf16 decode's
decoder in float32 from there on (float32 features times bf16 weights),
where a torch product refuses mixed types; the port's bf16 decode from
pixels runs bf16 throughout, as its feature-mode decode does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.models import resnet
from simpleimagecaptionzoo_tpu_torch.ops import image, quant


@dataclasses.dataclass
class Encoded:
    """Output of a captioner's encode pass.

    features: (B, N, D) refined visual features the decoder attends over.
    mean:     (B, D) pooled feature fed to the first LSTM / context mix.
    mask:     optional (B, N) 0/1 mask over feature rows (None == all valid).
    extras:   model-specific precomputation, made once per encode instead of
              once per decode step (e.g. AoA's decoder K/V projections).  Its
              tensors are per sample, (B, ...); a prepared weight (a
              NamedTuple such as ``fused_lstm.LstmWeights``) is shared by
              every sample.
    """

    features: torch.Tensor
    mean: torch.Tensor
    mask: Optional[torch.Tensor] = None
    extras: Optional[dict] = None


class Captioner:
    """Base class: concrete models implement the methods below as functions
    of their parameter dicts."""

    #: the family's reference encodes pixels through a ResNet-101
    has_cnn = False

    def __init__(self, config: ModelConfig) -> None:
        self.config = config
        # the side a fast-ingest batch (a visual dict with "img_hw") is
        # resampled to on the device (ops/image.prepare_images); 224 is the
        # reference's default img_size
        self.ingest_out_size = 224

    def init_params(self, gen: torch.Generator,
                    include_cnn: bool = False) -> Dict[str, Any]:
        """Parameters on ``gen.device``, drawn from ``gen``.  The port's
        default is feature mode: ``include_cnn=True`` adds the ResNet-101
        (``cnn``, drawn after the rest, so the other leaves do not depend
        on it) and keeps its running statistics for
        :meth:`init_model_state`.  (The JAX package's default is
        ``has_cnn``, and True for NIC.)"""
        raise NotImplementedError

    def _add_cnn(self, params: dict, gen: torch.Generator,
                 include_cnn: bool) -> dict:
        if include_cnn:
            params["cnn"], self._cnn_stats = resnet.init(gen)
        return params

    def init_model_state(self) -> dict:
        """``{"cnn_stats": ...}``: the running statistics of the ResNet the
        last ``init_params(include_cnn=True)`` drew (None without one)."""
        return {"cnn_stats": getattr(self, "_cnn_stats", None)}

    def _cnn_features(self, params, visual, model_state, train: bool):
        """Pixels -> (the ResNet's feature map (B, 7, 7, 2048) NHWC at 224,
        model_state).  The trunk runs in ``resnet.apply``'s default dtype
        (bf16) whatever the decode's; ``train=True`` normalizes with the
        batch's statistics and returns ``model_state`` with the updated
        ``cnn_stats``."""
        images = image.prepare_images(visual, self.ingest_out_size)
        stats = (model_state or {})["cnn_stats"]
        if train:
            fmap, new_stats = resnet.apply(params["cnn"], stats, images,
                                           train=True)
            return fmap, dict(model_state or {}, cnn_stats=new_stats)
        return resnet.apply(params["cnn"], stats, images), model_state

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        """visual dict -> (Encoded, model_state: passed through, or with
        the updated ``cnn_stats`` of a from-pixels encode in train mode)."""
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

    # -- grouped-lanes protocol (beam search) -------------------------------
    def init_lane_state(self, params, encoded: Encoded, k: int):
        """Decoder state with a lanes axis: every leaf (B, k, ...).  The
        default inits a flat (B*k) state from the lane-broadcast encoding
        and folds the lanes axis back in."""
        b = encoded.mean.shape[0]
        flat = self.init_state(params,
                               _flatten_lanes(_broadcast_lanes(encoded, k)))
        return _tree_map(lambda s: s.reshape((b, k) + s.shape[1:]), flat)

    def step_lanes_core(self, params, encoded: Encoded, state,
                        tokens: torch.Tensor, *, train: bool = False,
                        generator=None):
        """One decode step over (B, k) lanes up to, not including, the
        head: (pre_logits (B, k, H), new_state (B, k, ...), alpha (B, k, N)
        or None).

        The default flattens the lanes into the batch axis and broadcasts
        the encoding, so each lane re-reads its sample's attention K/V.
        Attention models override it to put the lanes on the query axis
        instead (``models/aoa.py``)."""
        b, k = tokens.shape
        enc_k = _flatten_lanes(_broadcast_lanes(encoded, k))
        flat_state = _tree_map(lambda s: s.reshape((b * k,) + s.shape[2:]),
                               state)
        pre, new_state, alpha = self.step_core(
            params, enc_k, flat_state, tokens.reshape(b * k), train=train,
            generator=generator)
        unflat = lambda x: x.reshape((b, k) + x.shape[1:])   # noqa: E731
        return (unflat(pre), _tree_map(unflat, new_state),
                None if alpha is None else unflat(alpha))

    def step_lanes(self, params, encoded: Encoded, state,
                   tokens: torch.Tensor, *, train: bool = False,
                   generator=None):
        """One decode step over (B, k) lanes that share each sample's
        encoding: (logits (B, k, V), new_state (B, k, ...), alpha (B, k, N)
        or None)."""
        b, k = tokens.shape
        pre, new_state, alpha = self.step_lanes_core(
            params, encoded, state, tokens, train=train, generator=generator)
        logits = self.predict(params, pre.reshape((b * k,) + pre.shape[2:]))
        return logits.reshape((b, k) + logits.shape[1:]), new_state, alpha

    def param_labels(self, params) -> Any:
        """Every leaf of ``params`` labelled 'main', 'cnn' or 'cnn_frozen'
        for the two-LR optimizer partition (reference get_param_groups,
        NIC_Model.py:221-231), the same structure of strings.  Leaves under
        the top-level ``cnn`` are 'cnn' in its ``layer4`` (the only ResNet
        stage the reference fine-tunes, NIC_Model.py:238) and 'cnn_frozen'
        elsewhere; every other leaf is 'main'.
        ``engine/optim.apply_updates_partitioned`` leaves 'cnn_frozen'
        untouched."""
        def label(node, path):
            if isinstance(node, dict):
                return {k: label(v, path + (k,)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(label(v, path + (i,))
                                  for i, v in enumerate(node))
            if not path or path[0] != "cnn":
                return "main"
            return "cnn" if len(path) > 1 and path[1] == "layer4" \
                else "cnn_frozen"
        return label(params, ())

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


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples; a
    NamedTuple and any other leaf pass unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _map_encoded(fn, encoded: Encoded) -> Encoded:
    """``fn`` on the per-sample tensors of ``encoded``: features, mean,
    mask and the tensors of extras (a prepared weight is shared)."""
    return Encoded(features=fn(encoded.features), mean=fn(encoded.mean),
                   mask=None if encoded.mask is None else fn(encoded.mask),
                   extras=_tree_map(fn, encoded.extras))


def _broadcast_lanes(encoded: Encoded, k: int) -> Encoded:
    """Insert a lanes axis: every per-sample tensor (B, ...) ->
    (B, k, ...)."""
    return _map_encoded(
        lambda x: x[:, None].expand((x.shape[0], k) + x.shape[1:]), encoded)


def _flatten_lanes(encoded: Encoded) -> Encoded:
    """(B, k, ...) per-sample tensors -> (B*k, ...)."""
    return _map_encoded(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]),
        encoded)


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
    from simpleimagecaptionzoo_tpu_torch.models import butd  # noqa: F401
    from simpleimagecaptionzoo_tpu_torch.models import nic  # noqa: F401
    if config.model_type not in _REGISTRY:
        raise ValueError("model_type %r is not ported yet (have %s)"
                         % (config.model_type, sorted(_REGISTRY)))
    return _REGISTRY[config.model_type](config)
