"""The prediction head over a vocab shard: the mesh's ``model`` axis.

On a mesh with a model axis of mp processes (``parallel.get_mesh``), each
process holds the columns of the weight-norm head that its model index
owns (``place_params``: V/mp of them, ids ``start`` to ``start + V/mp``).
Everything before the head is replicated over the model group, which holds
the same batch rows and draws the same random bits, so the replicated
activations agree bit for bit.  This module is the cross-shard part that
XLA inserts on the JAX side (the JAX package's ``parallel/mesh.py:125``):

* :func:`head_logits`, the training and sampling head: the pre-logits go
  through :class:`_ModelSum` (the identity; its backward sums the
  cotangent over the model group, the other shards' share of d pre_logits),
  the shard's logits through :class:`_GatherLogits` (all-gathered along
  V; its backward hands each process its own columns of the cotangent);
* :func:`topk_merge`, the decode head: each process runs kernel K1
  unchanged on its shard (``ops/fused_head.topk_head``, ids offset by the
  shard's start), the (m, k) values and ids and the (m,) logsumexp are
  gathered over the model group, the merged logsumexp is the logsumexp of
  the shards' and the merged top-k a stable descending sort of the mp k
  candidates in rank order: ``lax.top_k``'s order, the lower id first
  among equal values, as ``fused_head.topk_head_plain`` keeps it.

K1's pad columns (each shard's V/mp padded to 512) stay local: their logit
is -1e30, which neither wins nor adds to a logsumexp.  Without a model axis
each function is the single-process head.  The collectives are plain
``torch.distributed`` calls (under gloo a CUDA tensor goes through the
host, gloo's data path)."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.ops import fused_head
from simpleimagecaptionzoo_tpu_torch.parallel.mesh import Mesh, active_mesh


def _all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` from every process of the model group, in model order, on
    ``t``'s device."""
    wire = t.contiguous()
    if mesh.backend == "gloo" and wire.device.type != "cpu":
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(mesh.model_size)]
    dist.all_gather(parts, wire, group=mesh.model_group)
    return [p.to(t.device) for p in parts]


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    wire = t.contiguous()
    if mesh.backend == "gloo" and wire.device.type != "cpu":
        wire = wire.cpu()
    else:
        wire = wire.clone()
    dist.all_reduce(wire, group=mesh.model_group)
    return wire.to(t.device)


class _ModelSum(torch.autograd.Function):
    """y = x; the backward sums the cotangent over the model group (each
    shard's logits take their share of d x)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GatherLogits(torch.autograd.Function):
    """The shards' logits (..., V/mp) -> the whole (..., V), in model
    order; the backward keeps this shard's columns of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.per = mesh, x.shape[-1]
        return torch.cat(_all_gather(x, mesh), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_index * ctx.per
        return g[..., lo:lo + ctx.per], None


def shard_width(head: dict) -> int:
    """The columns of a head param dict: ``v``'s (the weight-norm head) or
    ``s``'s (its int8 form)."""
    return head["s"].shape[0] if "s" in head else head["v"].shape[-1]


def check_shard(head: dict, vocab_size: int) -> None:
    """On a model axis, refuse a head whose columns are not this process's
    shard of a vocabulary of ``vocab_size`` (a head left whole, say)."""
    mesh = active_mesh()
    if mesh is not None and shard_width(head) * mesh.model_size != \
            vocab_size:
        raise ValueError("the head holds %d columns; a vocabulary of %d "
                         "over a model axis of %d takes %d a process"
                         % (shard_width(head), vocab_size, mesh.model_size,
                            vocab_size // mesh.model_size))


def head_logits(head: dict, pre_logits: torch.Tensor) -> torch.Tensor:
    """The weight-norm head's logits (..., V) of ``pre_logits`` (..., H):
    on a model axis, this shard's columns gathered with the others' (with
    their gradients); else ``layers.dense_wn``."""
    mesh = active_mesh()
    if mesh is None:
        return L.dense_wn(head, pre_logits)
    logits = L.dense_wn(head, _ModelSum.apply(pre_logits, mesh))
    with torch.profiler.record_function("vocab_shard.gather_logits"):
        return _GatherLogits.apply(logits, mesh)


def gather_logits(logits: torch.Tensor) -> torch.Tensor:
    """This shard's logits (..., V/mp) -> the whole vocabulary's, outside
    autograd (the rescoring); ``logits`` itself without a model axis."""
    mesh = active_mesh()
    if mesh is None:
        return logits
    return torch.cat(_all_gather(logits, mesh), dim=-1)


def topk_merge(head: fused_head.Head, x: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fused_head.topk_head`` over the whole vocabulary: (top-k raw
    logits (m, k) float32 descending, vocab ids (m, k) int32, logsumexp
    (m,) float32).  ``head`` is this process's prepared head
    (``fused_head.prepare_head`` of its columns).  On a model axis K1 runs
    on the shard, its ids offset by the shard's start, and the shards'
    results merge as the module says."""
    mesh = active_mesh()
    vals, idx, lse = fused_head.topk_head(head, x, k)
    if mesh is None:
        return vals, idx, lse
    with torch.profiler.record_function("vocab_shard.topk_merge"):
        idx = idx + mesh.model_index * head.v
        # one gather: values, ids (their bits) and lse side by side
        packed = torch.cat([vals, idx.view(torch.float32), lse[:, None]],
                           dim=1)
        parts = _all_gather(packed, mesh)
        cand = torch.cat([p[:, :k] for p in parts], dim=1)
        ids = torch.cat([p[:, k:2 * k].contiguous().view(torch.int32)
                         for p in parts], dim=1)
        lse = torch.logsumexp(torch.stack([p[:, 2 * k] for p in parts]),
                              dim=0)
        vals, order = torch.sort(cand, dim=1, descending=True, stable=True)
        return vals[:, :k], ids.gather(1, order[:, :k]), lse
