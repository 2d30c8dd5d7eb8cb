"""Training losses.

Counterpart of the JAX package's ``ops/losses.py``:
:func:`label_smoothing_loss`, the reference's LabelSmoothingLoss
(Utils.py:258-286): the KL divergence between log-softmax predictions and a
smoothed one-hot with mass ``smoothing / (V - 1)`` off the target, averaged
over the valid tokens.  The reference packs variable-length sequences; here,
as in the JAX package, the shapes stay fixed and a mask marks the valid
tokens, which gives the same per-token terms and the same mean (their sum
over the count, at least 1).  The constant entropy term ``sum td log td``
is kept, so the loss values equal the reference's.
:func:`reward_criterion` is SCST's REINFORCE loss.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, smoothing: float = 0.1
                         ) -> torch.Tensor:
    """logits (B, T, V) of any float dtype; targets (B, T) int; mask (B, T)
    0/1.  -> float32 scalar: mean KL(true_dist || softmax(logits)) over the
    valid tokens.  The (B, T, V) smoothed one-hot is never made: the sum
    splits into the off-target mass times the sum of log p and the
    target's correction."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    off = smoothing / (v - 1)
    target_logp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    sum_logp = logp.sum(dim=-1)
    xent = -(off * (sum_logp - target_logp) + confidence * target_logp)
    ent = 0.0
    if off > 0:
        ent += (v - 1) * off * math.log(off)
    if confidence > 0:
        ent += confidence * math.log(confidence)
    mask = mask.float()
    return (xent + ent).mul(mask).sum() / mask.sum().clamp_min(1.0)


def xe_mask_from_lengths(lengths: torch.Tensor, n_steps: int) -> torch.Tensor:
    """lengths (B,) = caption length - 1 (reference Engine.py:178) ->
    (B, n_steps) float32 mask of the prediction steps to score."""
    steps = torch.arange(n_steps, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).float()


def reward_criterion(sample_logprobs: torch.Tensor, seq: torch.Tensor,
                     reward: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """SCST's loss (the reference's RewardCriterion): sample_logprobs
    (B, L) float32, seq (B, L) the rollout's ids (0 from ``<end>`` on),
    reward (B, L) or (B,) -> scalar: the mean of -logp * reward over the
    steps up to and including each row's ``<end>`` (the mask is ``seq > 0``
    shifted right by one, its first column 1).  ``sample_weight`` (B,) 0/1
    marks the real rows of a padded batch: the others leave both the sum
    and the count."""
    if reward.dim() == 1:
        reward = reward[:, None].expand_as(sample_logprobs)
    mask = (seq > 0).float()
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
    if sample_weight is not None:
        mask = mask * sample_weight[:, None]
    out = -sample_logprobs * reward * mask
    return out.sum() / mask.sum().clamp_min(1.0)
