"""Decode loops derived from a captioner's step.

Counterpart of the JAX package's ``ops/decode.py``.  This slice ports greedy
decode; beam search, the multinomial rollout and teacher forcing follow in
later slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.models.base import Captioner, Encoded
from simpleimagecaptionzoo_tpu_torch.ops import fused_head


def greedy(model: Captioner, params, encoded: Encoded, max_len: int = 20
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (ids (B, max_len) int64, alphas (B, max_len, N) float32 or
    None).

    Each step ends in the fused head top-k with k=1 (kernel K1 on the
    card), so the (B, V) logits are never materialized.  The loop stops as
    soon as every lane has emitted ``<end>``; a lane is padded with
    ``<pad>`` after its ``<end>``, and a finished lane's alphas are zero, so
    the output does not depend on how long other lanes keep the loop
    alive."""
    mean = encoded.mean
    b, dev = mean.shape[0], mean.device
    head = fused_head.prepare_head(params["predict"], mean.dtype)
    state = model.init_state(params, encoded)
    tok = torch.full((b,), STA_ID, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    ids = torch.full((b, max_len), PAD_ID, dtype=torch.long, device=dev)
    alphas = None
    for t in range(max_len):
        hidden, state, alpha = model.step_core(params, encoded, state, tok)
        nxt = fused_head.topk_head(head, hidden, 1)[1][:, 0].long()
        nxt = torch.where(finished, PAD_ID, nxt)
        ids[:, t] = nxt
        if alpha is not None:
            if alphas is None:
                alphas = torch.zeros((b, max_len) + tuple(alpha.shape[1:]),
                                     dtype=torch.float32, device=dev)
            alphas[:, t] = torch.where(finished[:, None], 0.0, alpha.float())
        finished = finished | (nxt == END_ID)
        tok = nxt
        if bool(finished.all()):
            break
    return ids, alphas
