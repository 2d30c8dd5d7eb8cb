"""Layer library: plain functions on nested dicts of tensors.

Counterpart of the JAX package's ``models/layers.py``, with the same
parameter layout (weights (in, out), LSTM gates i,f,g,o on the output dim,
weight-norm ``v`` (in, out) with ``g`` per column) and the same
initializer distributions, drawn from an explicit ``torch.Generator``.  The
tensors an initializer makes live on its generator's device.

A weight-only int8 layer (a dict holding ``"q"``, ``ops/quant.py``) runs
through kernel K3 in :func:`dense`, :func:`dense_wn` and :func:`lstm_cell`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from simpleimagecaptionzoo_tpu_torch.ops import dispatch, fused_lstm, quant
from simpleimagecaptionzoo_tpu_torch.parallel import global_rand


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U[-bound, bound) float32 on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u * (2.0 * bound) - bound


def dense_init(gen, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    """torch nn.Linear default: W, b ~ U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), bound)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), bound)
    return p


def dense_wn_init(gen, in_dim: int, out_dim: int, bias: bool = True,
                  zero_bias: bool = False) -> dict:
    """Weight norm: v (in, out), g (out,) = ||v||_col, so the initial
    effective weight equals v (torch semantics).  ``zero_bias`` matches the
    reference's ``predict.bias.data.fill_(0)`` (AoA_Model.py:221)."""
    bound = 1.0 / math.sqrt(in_dim)
    v = _uniform(gen, (in_dim, out_dim), bound)
    p = {"v": v, "g": torch.linalg.vector_norm(v, dim=0)}
    if bias:
        p["b"] = (torch.zeros((out_dim,), device=gen.device) if zero_bias
                  else _uniform(gen, (out_dim,), bound))
    return p


def embedding_init(gen, vocab_size: int, dim: int,
                   scale: Optional[float] = None) -> dict:
    """torch nn.Embedding default N(0,1); AoA re-inits U(-0.1,0.1)
    (AoA_Model.py:219): pass ``scale=0.1``."""
    if scale is None:
        table = torch.randn((vocab_size, dim), generator=gen,
                            device=gen.device)
    else:
        table = _uniform(gen, (vocab_size, dim), scale)
    return {"table": table}


def lstm_cell_init(gen, in_dim: int, hidden_dim: int) -> dict:
    """torch nn.LSTMCell: two bias vectors, all ~ U(-1/sqrt(H), +)."""
    bound = 1.0 / math.sqrt(hidden_dim)
    return {
        "w_ih": _uniform(gen, (in_dim, 4 * hidden_dim), bound),
        "w_hh": _uniform(gen, (hidden_dim, 4 * hidden_dim), bound),
        "b_ih": _uniform(gen, (4 * hidden_dim,), bound),
        "b_hh": _uniform(gen, (4 * hidden_dim,), bound),
    }


def layer_norm_std_init(dim: int, device="cpu") -> dict:
    return {"gain": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "q" in params:            # weight-only int8 (ops/quant.py, K3)
        return quant.quant_matmul(x, params)
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def dense_wn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Weight-norm linear.  The column norms are taken in float32 even when
    the params are bf16 (a bf16 sum of 1024 squares drifts ~0.3%)."""
    if "q" in params:            # weight-only int8 (ops/quant.py, K3)
        return quant.quant_matmul(x, params)
    v = params["v"]
    norm = torch.linalg.vector_norm(v.float(), dim=0).to(v.dtype)
    y = x @ (v * (params["g"] / (norm + 1e-12)))
    if "b" in params:
        y = y + params["b"]
    return y


def embedding(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor,
              prepared: Optional[fused_lstm.LstmWeights] = None,
              term: Optional[torch.Tensor] = None, lanes: int = 1):
    """torch nn.LSTMCell step -> (h', c') through kernel K2: launched for
    CUDA tensors, its plain version for CPU tensors.  ``prepared`` is
    ``fused_lstm.prepare_lstm(params)``, made once outside a decode loop;
    without it the weights are concatenated (and, in float32, split) here.
    Where autograd needs a gradient (grad mode on and an input that
    requires one) the step runs through ``fused_lstm.LstmCell``, whose
    backward is K2's backward kernel; decode keeps the direct call.

    A hoisted cell (the JAX package's ``lstm_cell_gates``, guarded by
    :func:`hoist_lstm_inputs`): ``prepared`` is
    ``prepare_lstm(params, keep=...)``, x holds only the inputs whose rows
    of ``w_ih`` it kept, and ``term`` (rows / lanes, 4H) is the rest of the
    input's projection plus ``b_ih``, added by K2 in its epilogue.

    Int8 params (``ops/quant.quantize_lstm``) take the JAX package's int8
    cell instead: the gates come from K3, rounded to x's dtype, and the gate
    math runs in that dtype.  K2 does not run then, and nothing is
    hoisted."""
    if "q" in params:
        if term is not None:
            raise ValueError("lstm_cell: an int8 cell takes the whole input, "
                             "not a gate term")
        gates = quant.quant_matmul(torch.cat([x, h], dim=-1), params)
        return fused_lstm.gate_math(gates, c)
    w = prepared if prepared is not None else fused_lstm.prepare_lstm(params)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (w.w_cat, w.b_sum, x, h, c, term)):
        return fused_lstm.lstm_cell_train(w, x, h, c, term, lanes)
    if term is None:
        return fused_lstm.lstm_cell_fused(w.w_cat, w.b_sum, x, h, c, w.split)
    return fused_lstm.lstm_cell_fused(w.w_cat, w.b_sum, x, h, c, w.split,
                                      term=term, lanes=lanes)


def hoist_lstm_inputs(params: dict) -> bool:
    """Whether a cell's input projections leave the step loop (the JAX
    package's ``layers.hoist_lstm_inputs``, ``models/layers.py:178-190``):
    under ``SICZ_TPU_PALLAS_LSTM`` ``auto`` (the default) and ``off``, and
    never for an int8 cell (its K3 product takes the whole concat) or under
    ``interpret``, which runs the whole concat every step.  In every mode
    the cell runs on K2 on the card (``ops/dispatch.py``)."""
    return ("q" not in params
            and dispatch.kernel_mode("SICZ_TPU_PALLAS_LSTM") != "interpret")


def layer_norm_std(params: dict, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """AoA_Model.py:22-25: unbiased std, eps added to the std.  Statistics
    in float32, result cast back to the input dtype.

    The variance is clamped to float32's smallest normal before the square
    root.  A constant row (a padded box's, all zero, in AoA's refiner) has
    variance 0, where sqrt's gradient is infinite: times the row's zero
    upstream gradient it gives NaN, which the JAX package's LayerNorm (and
    the reference's) spreads into every gradient of the feature
    projection.  The clamp gives that row a zero gradient and changes no
    value (the std moves by at most 1e-19 against eps 1e-6)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    std = torch.sqrt(var.clamp_min(torch.finfo(torch.float32).tiny))
    out = (params["gain"].float() * (xf - mean) / (std + eps)
           + params["bias"].float())
    return out.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (torch semantics).  A no-op when not training or
    rate <= 0.  The mask comes from ``generator``: its bits differ from the
    JAX package's, as the reference's torch stream did.  Under a process
    group the mask is the global batch's rows of this process (axis 0 is
    the batch; ``parallel.global_rand``).  ``mask``, when given, is one
    :func:`dropout_mask` drew earlier, and nothing is drawn here."""
    if mask is None:
        mask = dropout_mask(x.shape, rate, train, generator, x.device)
    return apply_dropout(x, mask, rate)


def dropout_mask(shape, rate: float, train: bool,
                 generator: Optional[torch.Generator],
                 device) -> Optional[torch.Tensor]:
    """The keep mask :func:`dropout` draws for a tensor of ``shape``
    (bool), or None where dropout is a no-op; drawn apart from its tensor,
    so a caller can draw it before the tensor exists."""
    if not train or rate <= 0.0:
        return None
    return global_rand(shape, generator, device) < 1.0 - rate


def apply_dropout(x: torch.Tensor, mask: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """``x`` through a keep mask of :func:`dropout_mask` (None: x)."""
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax with -1e9 masking (AoA_Model.py:63-64 convention)."""
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e9)
    return torch.softmax(scores, dim=dim)
