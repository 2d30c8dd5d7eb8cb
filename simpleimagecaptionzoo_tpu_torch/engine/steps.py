"""Train and decode entry points.

Counterpart of the JAX package's ``engine/steps.py``.  The port has the
XE training step (:func:`make_xe_train_step`, reference Engine.py:175-188:
forward, label smoothing, backward, the value clamp, the optimizer step)
with its validation loss (:func:`make_xe_eval_loss`), the SCST step
(:func:`make_scst_train_step`, reference Engine.py:258-272 and
Utils.py:319-367: a greedy baseline, a sampled rollout, the CIDEr-D reward
on the card, REINFORCE), and the two eval decodes:
:func:`make_beam_decode` (the engine's default, ``eval_beam_size`` 3) and
:func:`make_greedy_decode` (``eval_beam_size == -1``), each in float32,
bf16 and int8 serving form.  PyTorch runs eagerly, so there is no
``jit``: the returned function runs the step or the decode when called.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.engine.optim import (
    apply_updates_partitioned, tree_leaves, tree_map, tree_unflatten)
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models.base import Captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode
from simpleimagecaptionzoo_tpu_torch.ops.cider import self_critical_reward
from simpleimagecaptionzoo_tpu_torch.ops.losses import (label_smoothing_loss,
                                                        reward_criterion,
                                                        xe_mask_from_lengths)
from simpleimagecaptionzoo_tpu_torch.parallel import all_reduce_sum


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
    (B, max_len) [, alphas].  Params, model_state and visual move to
    ``device`` (the GPU unless the caller asks for the CPU);
    ``dtype=torch.bfloat16`` casts params and visual, so ``bu_masks``
    becomes bf16 too, and so do the ResNet's parameters and a float
    ``img_tensors``, as in the JAX package; model_state (the ResNet's
    running statistics) stays float32.  The top-k itself stays float32
    (ops/fused_head.py).

    From pixels (NIC, BUTDSpatial, AoASpatial with ``cnn`` in params and
    ``img_tensors`` in visual), encode runs the ResNet in bf16 whatever
    ``dtype`` is, as the JAX package's does (``resnet.apply``'s default).

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
                              model_state=_cast_floats(model_state, None,
                                                       dev))
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
                              model_state=_cast_floats(model_state, None,
                                                       dev))
        return decode.beam_search(model, params, enc, beam_size, max_steps,
                                  return_alphas=return_alphas)

    return fn


# ---------------------------------------------------------------------------
# XE training
# ---------------------------------------------------------------------------

def _stop_cnn_grads(params, freeze_cnn: bool):
    """The reference's fine-tune scope (NIC_Model.py:233-244): the ResNet's
    stem and layers 1-3 are always detached, and ``layer4`` too when
    ``freeze_cnn``.  Autograd then runs none of their backward, and their
    gradients come back zero; the optimizer's 'cnn_frozen' partition keeps
    them unchanged besides."""
    if "cnn" not in params:
        return params
    detach = lambda tree: tree_map(lambda t: t.detach(), tree)  # noqa: E731
    return dict(params, cnn={
        k: v if k == "layer4" and not freeze_cnn else detach(v)
        for k, v in params["cnn"].items()})


def xe_loss(model: Captioner, params, model_state, batch: Dict[str, Any],
            generator: Optional[torch.Generator], ss_prob, *,
            smoothing: float = 0.1, compute_dtype=None,
            ss_active: Optional[bool] = True, train: bool = True,
            ss_generator: Optional[torch.Generator] = None):
    """The XE loss of one batch: (loss (float32 scalar), valid tokens,
    new model_state).  ``batch``: ``visual`` (a dict), ``captions`` (B, T)
    int, ``lengths`` (B,) caption lengths and an optional
    ``sample_weight`` (B,) 0/1 marking the real rows of a padded batch.
    ``compute_dtype`` casts params and visual (differentiably, so the
    gradients of float32 params arrive in float32); the loss is float32.
    ``generator`` draws dropout (train mode), ``ss_generator`` the
    scheduled sampling (``decode.teacher_forced_logits``)."""
    captions = batch["captions"]
    mask = xe_mask_from_lengths(batch["lengths"] - 1, captions.shape[1] - 1)
    if "sample_weight" in batch:
        mask = mask * batch["sample_weight"][:, None]
    visual = _cast_floats(batch["visual"], compute_dtype)
    params = _cast_floats(params, compute_dtype)
    enc, new_ms = model.encode(params, visual, train=train,
                               generator=generator, model_state=model_state)
    logits = decode.teacher_forced_logits(
        model, params, enc, captions, ss_prob, generator, train=train,
        ss_active=ss_active, ss_generator=ss_generator)
    loss = label_smoothing_loss(logits, captions[:, 1:], mask, smoothing)
    return loss, mask.sum(), new_ms


def _require_on(tree, dev: torch.device, what: str) -> None:
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type != dev.type:
            raise ValueError("%s: a tensor lies on %s, the step runs on %s; "
                             "move the state there first" % (what, t.device,
                                                             dev))


def draw_generator_for(generator: Optional[torch.Generator], step: int,
                       device) -> torch.Generator:
    """The generator of training step ``step``'s draws (scheduled
    sampling's, the SCST rollout's): seeded from the step and
    ``generator``'s seed, apart from the dropout stream, so the dropout
    masks do not depend on the draws."""
    seed = generator.initial_seed() if generator is not None else 0
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step + 1) % (2 ** 63))


def make_xe_train_step(model: Captioner, tx, labels, smoothing: float = 0.1,
                       freeze_cnn: bool = False, compute_dtype=None,
                       ss_active: bool = True, device="cuda"):
    """Returns ``step(state, batch, generator, ss_prob, lr_main, lr_cnn)
    -> (state, {"loss", "tokens"})``, one XE training
    step on ``device`` (the GPU unless the caller asks for the CPU; the
    state and ``generator`` must live there, and the batch moves there).

    The step computes :func:`xe_loss` of the state's params, its gradient
    by autograd (each LSTM cell's through K2's backward kernel on the
    card), the update directions of ``tx`` (``engine/optim``) and the
    partitioned update; it returns a new :class:`TrainState` with step + 1
    and leaves the old one as it was.

    ``compute_dtype=torch.bfloat16`` is mixed precision: bf16 compute over
    the float32 master params and optimizer state, the loss float32.
    ``ss_active=False`` leaves scheduled sampling's head calls and draws
    out (the epochs before its schedule starts); with it on, the draws
    come from :func:`draw_generator_for` the step.  The ResNet's stem and
    layers 1-3 get no gradient; ``freeze_cnn`` stops it at ``layer4`` too
    (:func:`_stop_cnn_grads`).

    Under a process group ``batch`` is this process's rows of the global
    batch (``parallel``): the loss divides by the global token count, every
    draw is the global batch's, and one all-reduce a dtype sums the
    gradients, the loss and the token count before the update, so every
    process takes the step of the global batch and keeps the same params;
    the returned loss and tokens are the global batch's."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator], ss_prob, lr_main, lr_cnn):
        _require_on(state.params, dev, "make_xe_train_step")
        if generator is not None and generator.device.type != dev.type:
            raise ValueError("make_xe_train_step: the generator lies on %s, "
                             "the step runs on %s" % (generator.device, dev))
        ss_generator = (draw_generator_for(generator, state.step, dev)
                        if ss_active else None)
        batch = _cast_floats(batch, None, dev)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = _stop_cnn_grads(tree_unflatten(state.params, leaves),
                                 freeze_cnn)
        loss, tokens, new_ms = xe_loss(
            model, params, state.model_state, batch, generator, ss_prob,
            smoothing=smoothing, compute_dtype=compute_dtype,
            ss_active=ss_active, ss_generator=ss_generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # the global batch's gradient, loss and token count: summed over
        # the processes in one buffer (the identity with one process)
        *grads, loss, tokens = all_reduce_sum(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)] + [loss.detach(), tokens])
        grads = tree_unflatten(state.params, grads)
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state,
                                         state.params)
            new_params = apply_updates_partitioned(
                state.params, updates, labels, lr_main, lr_cnn)
        new_state = state.replace(params=new_params, opt_state=new_opt,
                                  model_state=new_ms, step=state.step + 1)
        return new_state, {"loss": loss, "tokens": tokens}

    return step


def make_xe_eval_loss(model: Captioner, smoothing: float = 0.1,
                      device="cuda"):
    """Validation loss: ``fn(params, model_state, batch)`` -> the float32
    XE loss with no dropout and no scheduled sampling.  Params,
    model_state and batch move to ``device`` (the GPU unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def fn(params, model_state, batch):
        loss, _, _ = xe_loss(model, _cast_floats(params, None, dev),
                             _cast_floats(model_state, None, dev),
                             _cast_floats(batch, None, dev),
                             None, 0.0, smoothing=smoothing, ss_active=False,
                             train=False)
        return loss

    return fn


# ---------------------------------------------------------------------------
# SCST training
# ---------------------------------------------------------------------------

def greedy_baseline(model: Captioner, params, model_state, visual,
                    max_len: int = 20, compute_dtype=None) -> torch.Tensor:
    """SCST's baseline: the greedy ids (B, max_len) in eval mode (no
    dropout, reference ``model.eval()``, Engine.py:258) and without
    gradient, params and visual cast to ``compute_dtype``."""
    with torch.no_grad():
        params = _cast_floats(params, compute_dtype)
        enc, _ = model.encode(params, _cast_floats(visual, compute_dtype),
                              train=False, model_state=model_state)
        return decode.greedy(model, params, enc, max_len)[0]


def scst_loss(model: Captioner, params, model_state, batch: Dict[str, Any],
              cider_table: dict, probe: int, greedy_seq: torch.Tensor,
              generator: Optional[torch.Generator],
              draw_generator: Optional[torch.Generator] = None, *,
              max_len: int = 20, compute_dtype=None, replay=None):
    """SCST's loss of one batch: (loss (float32 scalar), reward (B,),
    new model_state, seq, drawn).  ``batch``: ``visual``, ``ref_ids``
    (B, R, Lr), ``ref_lens`` (B, R), and optional ``ref_norms`` (B, R, 4)
    and ``sample_weight`` (B,) 0/1.  Encode runs in train mode, then the
    rollout (``decode.sample_rl``: dropout from ``generator``, the draws
    from ``draw_generator``); ``replay=(seq, drawn)`` recomputes a given
    rollout's logprobs instead (``decode.replay_logprobs``).  The reward
    is CIDEr-D of the rollout minus that of ``greedy_seq`` (a filler row
    of a padded batch gets 0), the loss ``reward_criterion``'s.
    ``compute_dtype`` casts params and visual differentiably; the logprobs
    and the loss are float32."""
    weight = batch.get("sample_weight")
    params = _cast_floats(params, compute_dtype)
    enc, new_ms = model.encode(params,
                               _cast_floats(batch["visual"], compute_dtype),
                               train=True, generator=generator,
                               model_state=model_state)
    if replay is None:
        seq, logp, drawn = decode.sample_rl(model, params, enc, max_len,
                                            generator, draw_generator)
    else:
        seq, drawn = replay
        logp = decode.replay_logprobs(model, params, enc, seq, drawn,
                                      generator)
    reward = self_critical_reward(cider_table, probe, seq, greedy_seq,
                                  batch["ref_ids"], batch["ref_lens"],
                                  ref_norms=batch.get("ref_norms"))
    if weight is not None:
        reward = reward * weight
    loss = reward_criterion(logp, seq, reward, sample_weight=weight)
    return loss, reward, new_ms, seq, drawn


def make_scst_train_step(model: Captioner, tx, labels, cider_table: dict,
                         probe: int, max_len: int = 20, compute_dtype=None,
                         device="cuda"):
    """Returns ``step(state, batch, generator, lr_main, lr_cnn) -> (state,
    {"loss", "reward"})``, one SCST training step on ``device`` (the GPU
    unless the caller asks for the CPU; the state, ``generator`` and
    ``cider_table`` (``CiderDTable.device_arrays``) must live there, and
    the batch moves there).  ``batch`` as :func:`scst_loss` takes it.

    The step computes :func:`greedy_baseline` (K1 and K2's forward on the
    card), then :func:`scst_loss` of the state's params, whose rollout
    runs each LSTM cell through K2 with its gradient, the draws from
    :func:`draw_generator_for` the step; the gradient by autograd (K2's
    backward kernel on the card; the ResNet's only from ``layer4``, as
    :func:`_stop_cnn_grads` with ``freeze_cnn`` off), the update directions
    of ``tx`` and the partitioned update.  It returns a new
    :class:`TrainState` with step + 1 and the mean reward over the real
    rows.  ``compute_dtype=torch.bfloat16`` is mixed precision, as in
    :func:`make_xe_train_step`.  Under a process group the step is the
    global batch's, as :func:`make_xe_train_step`'s (the loss over the
    global count, the draws the global batch's, the gradients, loss and
    reward summed in one all-reduce a dtype)."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator], lr_main, lr_cnn):
        _require_on(state.params, dev, "make_scst_train_step")
        _require_on(cider_table, dev, "make_scst_train_step's table")
        if generator is not None and generator.device.type != dev.type:
            raise ValueError("make_scst_train_step: the generator lies on "
                             "%s, the step runs on %s" % (generator.device,
                                                          dev))
        batch = _cast_floats(batch, None, dev)
        greedy_seq = greedy_baseline(model, state.params, state.model_state,
                                     batch["visual"], max_len, compute_dtype)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        loss, reward, new_ms, _, _ = scst_loss(
            model, _stop_cnn_grads(tree_unflatten(state.params, leaves),
                                   False), state.model_state,
            batch, cider_table, probe, greedy_seq, generator,
            draw_generator_for(generator, state.step, dev), max_len=max_len,
            compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        weight = batch.get("sample_weight")
        n = (weight.sum() if weight is not None
             else torch.tensor(float(reward.shape[0]), device=dev))
        # the global batch's gradient, loss and reward: summed over the
        # processes in one buffer (the identity with one process)
        *grads, loss, reward_sum, n = all_reduce_sum(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
            + [loss.detach(), reward.detach().sum(), n.float()])
        grads = tree_unflatten(state.params, grads)
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state,
                                         state.params)
            new_params = apply_updates_partitioned(
                state.params, updates, labels, lr_main, lr_cnn)
        new_state = state.replace(params=new_params, opt_state=new_opt,
                                  model_state=new_ms, step=state.step + 1)
        return new_state, {"loss": loss,
                           "reward": reward_sum / n.clamp_min(1.0)}

    return step
