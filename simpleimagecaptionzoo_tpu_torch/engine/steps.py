"""Decode entry points.

Counterpart of the JAX package's ``engine/steps.py``.  The port has the
two eval decodes: :func:`make_beam_decode` (the engine's default,
``eval_beam_size`` 3) and :func:`make_greedy_decode` (``eval_beam_size ==
-1``), each in float32, bf16 and int8 serving form.  PyTorch runs eagerly,
so there is no ``jit``: the returned function runs the decode when called.
"""
from __future__ import annotations

from typing import Optional

import torch

from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.models.base import Captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode


def _cast_floats(tree, dtype: Optional[torch.dtype], device=None):
    """Floating leaves -> ``dtype`` (when given), every leaf -> ``device``
    (when given).  A weight-only int8 layer (a dict with ``q`` and ``s``)
    keeps its types: its float32 scales and bias are the quantization's
    error budget."""
    if dtype is None and device is None:
        return tree

    def rec(node):
        if isinstance(node, dict):
            if "q" in node and "s" in node:
                return node if device is None else {
                    k: v.to(device) for k, v in node.items()}
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if isinstance(node, torch.Tensor):
            if device is not None:
                node = node.to(device)
            if dtype is not None and node.is_floating_point():
                node = node.to(dtype)
        return node

    return rec(tree)


def make_greedy_decode(model: Captioner, max_len: int = 20,
                       return_alphas: bool = False,
                       dtype: Optional[torch.dtype] = None, device="cuda"):
    """Eval decode: ``fn(params, model_state, visual)`` -> ids
    (B, max_len) [, alphas].  Params and visual move to ``device`` (the GPU
    unless the caller asks for the CPU); ``dtype=torch.bfloat16`` casts
    both, so ``bu_masks`` becomes bf16 too, as in the JAX package.  The
    top-k itself stays float32 (ops/fused_head.py).

    Int8 serving decode is this function with ``dtype=torch.bfloat16``
    called on ``model.quantize_decode_params(params)``, as the JAX package's
    engine does for ``--decode_dtype int8``: the int8 layer dicts keep
    their types through the cast, and the step runs through K3 and K1's
    int8 case (and K4 when ``SICZ_TPU_INT8_KV`` is on at encode)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, model_state, visual):
        params = _cast_floats(params, dtype, dev)
        visual = _cast_floats(visual, dtype, dev)
        enc, _ = model.encode(params, visual, train=False,
                              model_state=model_state)
        ids, alphas = decode.greedy(model, params, enc, max_len)
        return (ids, alphas) if return_alphas else ids

    return fn


def make_beam_decode(model: Captioner, beam_size: int = 3,
                     max_steps: int = 50, return_alphas: bool = False,
                     dtype: Optional[torch.dtype] = None, device="cuda"):
    """Batched beam decode: ``fn(params, model_state, visual)`` -> ids
    (B, max_steps+1) with column 0 = ``<sta>`` [, alphas (B, max_steps,
    N)].  Params and visual move to ``device`` and cast to ``dtype`` as in
    :func:`make_greedy_decode`; the beam scores stay float32
    (``ops/decode.py``).  Int8 serving beam decode is this function with
    ``dtype=torch.bfloat16`` called on ``model.quantize_decode_params(
    params)``."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, model_state, visual):
        params = _cast_floats(params, dtype, dev)
        visual = _cast_floats(visual, dtype, dev)
        enc, _ = model.encode(params, visual, train=False,
                              model_state=model_state)
        return decode.beam_search(model, params, enc, beam_size, max_steps,
                                  return_alphas=return_alphas)

    return fn
