"""Optimizer layer: the reference's optimizers as plain functions on trees
of tensors.

Counterpart of the JAX package's ``engine/optim.py`` (reference
Utils.py:217-250, Engine.py:126-138), with optax's formulas written out:

* Adam (0.9 / 0.999, eps 1e-8, no weight decay) or SGD (momentum 0.9,
  weight decay 1e-5), each after a hard elementwise clamp of the gradient
  to +-``grad_clip`` (0.1 XE, 0.25 SCST; Engine.py:187,271: a clamp, not a
  norm clip).  :func:`make_grad_transform` gives the update *directions*;
  the learning rates enter :func:`apply_updates_partitioned` per step, so
  the staircase schedule needs no new optimizer.
* Two parameter groups: the ResNet's ``layer4`` ('cnn') at the fine-tune
  LR, everything else ('main') at the main LR; 'cnn_frozen' leaves are left
  untouched, SGD's weight decay included (``Captioner.param_labels``).
* The optimizer is re-created every epoch (momenta reset):
  ``engine/state.TrainState.reset_optimizer``.

``torch.optim`` does not stand in: its Adam bias-corrects the step size
(``lr / (1 - b1^t)``, with eps added to sqrt(nu_hat) after the division),
where optax divides the moments themselves, and its SGD applies the
learning rate inside the momentum, where optax's trace is of the
unscaled gradient.  Trees are nested dicts and lists of tensors, as the
params; the functions return new tensors and leave their inputs as they
are.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM, SGD_WEIGHT_DECAY = 0.9, 1e-5


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, depth first, in the
    order of the containers (a dict's in its keys' order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: List[Any]):
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves`' order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, new state)``."""
    init: Callable
    update: Callable


def _adam(grad_clip: float) -> GradientTransformation:
    """optax.chain(clip(grad_clip), scale_by_adam(0.9, 0.999, 1e-8))."""

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return {"count": 0, "mu": zeros, "nu": tree_map(torch.zeros_like,
                                                        params)}

    def update(grads, state, params=None):
        count = state["count"] + 1

        def bias_correction(decay):
            # 1 - decay^count in float32, as optax computes it
            return 1.0 - float(torch.tensor(decay, dtype=torch.float32)
                               ** count)

        bc1, bc2 = bias_correction(ADAM_B1), bias_correction(ADAM_B2)
        new_mu, new_nu, updates = [], [], []
        for g, mu, nu in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                             tree_leaves(state["nu"])):
            g = g.clamp(-grad_clip, grad_clip)
            mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
            new_mu.append(mu)
            new_nu.append(nu)
            updates.append((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
        return (tree_unflatten(grads, updates),
                {"count": count, "mu": tree_unflatten(grads, new_mu),
                 "nu": tree_unflatten(grads, new_nu)})

    return GradientTransformation(init, update)


def _sgd(grad_clip: float) -> GradientTransformation:
    """optax.chain(clip(grad_clip), add_decayed_weights(1e-5),
    trace(decay=0.9, nesterov=False))."""

    def init(params):
        return {"trace": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        if params is None:
            raise ValueError("SGD's weight decay needs the params")
        new_trace = tree_map(
            lambda g, t, p: (g.clamp(-grad_clip, grad_clip)
                             + SGD_WEIGHT_DECAY * p) + SGD_MOMENTUM * t,
            grads, state["trace"], params)
        return new_trace, {"trace": new_trace}

    return GradientTransformation(init, update)


def make_grad_transform(name: str, grad_clip: float) -> GradientTransformation:
    """Direction-only transform: the value clamp, then Adam's or SGD's
    moments.  The caller multiplies by the per-partition learning rate
    (:func:`apply_updates_partitioned`)."""
    n = name.lower()
    if n == "adam":
        return _adam(grad_clip)
    if n == "sgd":
        return _sgd(grad_clip)
    raise ValueError("unknown optimizer %r (Adam|SGD)" % (name,))


def apply_updates_partitioned(params, updates, labels, lr_main: float,
                              lr_cnn: float):
    """p - lr[label] * u on every leaf, lr_main for 'main' and lr_cnn for
    'cnn'; a 'cnn_frozen' leaf comes back as it was (the reference never
    puts those in an optimizer group, so even SGD's weight decay must not
    move them).  ``labels`` is :meth:`Captioner.param_labels`'s tree."""

    def upd(p, u, label):
        if label == "cnn_frozen":
            return p
        lr = lr_cnn if label == "cnn" else lr_main
        return (p - float(lr) * u).to(p.dtype)

    return tree_map(upd, params, updates, labels)
