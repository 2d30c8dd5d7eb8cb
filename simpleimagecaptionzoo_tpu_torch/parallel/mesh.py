"""Data parallelism over processes, on ``torch.distributed`` (the JAX
package's ``parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over its chips and lets XLA
place the collectives.  Here the ``data`` axis is the default process group:
one process a card under NCCL (``torch.cuda`` tensors), or processes on the
host under gloo.  Every process holds the same replicated params and
optimizer state, walks the same host-side control flow, and feeds its own
rows of each global batch (the batchers' ``process_index`` /
``process_count``, ``data/datasets._ProcessShard``).  The train steps then
make the step of the global batch out of the local ones:

* the losses divide each process's sum by the global count of valid tokens
  (``ops/losses.py``, :func:`global_sum`), and the gradients are summed
  over the processes (:func:`all_reduce_sum`, one flat buffer per dtype);
* every random draw takes the global batch's shape from a generator in the
  same state on every process, and each process keeps its own rows
  (:func:`global_rand`), so two processes draw what one process draws;
* the ResNet's train-mode batch statistics are the global batch's
  (:func:`all_reduce_sum_autograd` in ``models/resnet._bn``).

The backend is explicit: NCCL for CUDA tensors, gloo for the host.  Gloo's
data path is the host, so a CUDA tensor handed to a collective under gloo is
copied to the host, reduced there and copied back (two processes sharing
one card run so).  Without a process group (one process) every collective
here is the identity and no step changes a bit.

The mesh's optional ``model`` axis (``get_mesh(model_parallel=mp)``, the
JAX package's ``parallel/mesh.py:62-76``, ``:125-151``) lays the processes
out as (data, model), rank r at data index r // mp and model index r % mp:
the ``mp`` processes of one model group hold the same batch rows, and each
holds its column slice of the prediction head (:func:`place_params`;
``parallel/vocab_shard.py`` runs the head over the slice).  The data-axis
sums and draws above then run over the data group, the processes of one
model index.  Like the process group itself, the mesh that
:func:`get_mesh` built last is this process's: the collectives and the
head read it (:func:`active_mesh`).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

_timeout = datetime.timedelta(seconds=600)


def configure_collective_timeout(seconds: int = 600) -> datetime.timedelta:
    """Bound how long a collective waits on a straggling peer: the
    timeout :func:`init_process_group` gives the group (torch's default is
    30 minutes, so a dead rank would surface half an hour later at
    whatever collective was in flight).  Call it before the group starts;
    returns the timeout."""
    global _timeout
    _timeout = datetime.timedelta(seconds=int(seconds))
    return _timeout


def init_process_group(backend: str, world_size: int, rank: int,
                       init_method: Optional[str] = None,
                       store=None) -> None:
    """Start the default process group: ``backend`` ``"nccl"`` (one card a
    process; set the process's card first) or ``"gloo"`` (the host), the
    rendezvous at ``init_method`` (``tcp://host:port``, ``file://path``;
    default ``env://``, torchrun's variables) or through ``store`` (a
    ``torch.distributed.Store``).  A failure raises, whatever its cause;
    nothing carries on with one process."""
    if backend not in BACKENDS:
        raise ValueError("backend must be one of %s, got %r"
                         % (BACKENDS, backend))
    kw = dict(backend=backend, world_size=int(world_size), rank=int(rank),
              timeout=_timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)
    if not dist.is_initialized() or dist.get_world_size() != world_size:
        raise RuntimeError("init_process_group(%s, world_size=%d, rank=%d) "
                           "did not start the group" % (backend, world_size,
                                                        rank))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    """The default group's backend, or None without a process group."""
    return dist.get_backend() if dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh of this process: the data axis's ``size``
    processes and this one's ``index`` on it, the model axis's
    ``model_size`` and this one's ``model_index``, its tensors on
    ``device``.  ``data_group`` and ``model_group`` are the process groups
    of this process's data and model axes (None: the default group, or no
    group, for the data axis when the model axis has one process; None for
    a model axis of one)."""
    device: torch.device
    backend: Optional[str]
    size: int
    index: int
    model_size: int = 1
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


_active: Optional[Mesh] = None       # the mesh get_mesh built last
_groups: Dict[tuple, tuple] = {}     # (world group, world, mp) -> groups


def active_mesh() -> Optional[Mesh]:
    """The mesh :func:`get_mesh` built last in this process when its model
    axis has more than one process, else None."""
    return _active


def _axis_groups(world: int, mp: int):
    """-> (data groups by model index, model groups by data index).  Every
    process makes every group, in the same order (``new_group`` is
    collective); made once a process group and layout."""
    key = (id(dist.group.WORLD), world, mp)
    if key not in _groups:
        model = [dist.new_group(list(range(d * mp, (d + 1) * mp)))
                 for d in range(world // mp)]
        data = [dist.new_group(list(range(m, world, mp)))
                for m in range(mp)]
        _groups[key] = (data, model)
    return _groups[key]


def get_mesh(device="cuda", model_parallel: int = 1) -> Mesh:
    """The mesh of this process, its tensors on ``device``: the processes
    of the group (or this one alone) laid out as (data, model), with
    ``model_parallel`` processes on the model axis, rank r at data index
    r // model_parallel and model index r % model_parallel.  A world that
    ``model_parallel`` does not divide is refused, as the JAX package
    refuses a device count.  With ``model_parallel`` 1 the data axis is the
    whole group, as it is without a model axis."""
    global _active
    mp = int(model_parallel)
    world, rank = process_count(), process_index()
    if mp < 1 or world % mp:
        raise ValueError("%d processes not divisible by model_parallel=%d"
                         % (world, mp))
    dev = torch.device(device)
    if backend() == "nccl" and dev.type != "cuda":
        raise ValueError("the process group runs NCCL, which takes CUDA "
                         "tensors; the engine's device is %s" % dev)
    if mp == 1:
        _active = None
        return Mesh(dev, backend(), world, rank)
    data, model = _axis_groups(world, mp)
    _active = Mesh(dev, backend(), world // mp, rank // mp, mp, rank % mp,
                   data[rank % mp], model[rank // mp])
    return _active


def data_count() -> int:
    """The processes on the data axis (all of them without a model
    axis)."""
    return _active.size if _active is not None else process_count()


def data_index() -> int:
    """This process's index on the data axis (its rank without a model
    axis)."""
    return _active.index if _active is not None else process_index()


def _data_group():
    return _active.data_group if _active is not None else None


# ---------------------------------------------------------------------------
# moving tensors: the host batch, the replicated tree
# ---------------------------------------------------------------------------

def to_device(tree, device: torch.device):
    """A host batch (nested dicts of numpy arrays) -> tensors on
    ``device``: each array pinned and copied without blocking on a CUDA
    device; integer arrays other than uint8 pixels become int64 (token ids,
    lengths).  Lists (image ids) and scalars stay on the host."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        return tree
    a = np.ascontiguousarray(tree)
    if a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch (what its batcher yields) ->
    tensors on the mesh's device (:func:`to_device`).  Every process's
    rows together are the global batch; no collective runs here."""
    return to_device(batch, mesh.device)


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _collective(flat: torch.Tensor, op) -> torch.Tensor:
    """``op`` (an in-place collective) on ``flat``; under gloo a CUDA
    tensor goes through the host, gloo's data path."""
    if backend() == "gloo" and flat.device.type != "cpu":
        wire = flat.cpu()
        op(wire)
        return wire.to(flat.device)
    op(flat)
    return flat


def _end_to_end(tensors: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` (an in-place collective) once a dtype and device, on the
    tensors of that dtype laid end to end in one buffer -> the results
    (views of those buffers), in the tensors' order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in groups.values():
        flat = _collective(torch.cat([tensors[i].detach().reshape(-1)
                                      for i in idx]), op)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def replicate_tree(mesh: Mesh, tree):
    """Every tensor of ``tree`` on the mesh's device, with process 0's
    values on every process (one broadcast a dtype, of the leaves laid end
    to end).  Other leaves (None, ints) are kept as they are."""
    leaves = [t.to(mesh.device) if isinstance(t, torch.Tensor) else t
              for t in _leaves(tree)]
    if mesh.size > 1:
        at = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)]
        for i, t in zip(at, _end_to_end([leaves[i] for i in at],
                                        lambda w: dist.broadcast(w, 0))):
            leaves[i] = t
    return _rebuild(tree, iter(leaves))


HEAD_SHARDED = ("v", "g", "b")       # predict's leaves split over V


def place_params(mesh: Mesh, params):
    """The params on the mesh: replicated (:func:`replicate_tree`), but for
    the prediction head on a model axis of more than one process, of which
    each process keeps its column slice, ``predict``'s ``v`` (H, V/mp),
    ``g`` and ``b`` (V/mp,) at model index i: columns i V/mp to (i+1)
    V/mp.  Weight norm stays exact: it normalizes each column of ``v``
    (``models/layers.dense_wn``).  A vocabulary that the model axis does
    not divide is refused."""
    params = replicate_tree(mesh, params)
    if mesh.model_size == 1:
        return params
    head = dict(params["predict"])
    v = head["v"].shape[-1]
    if v % mesh.model_size:
        raise ValueError("a vocabulary of %d is not divisible by "
                         "model_parallel=%d" % (v, mesh.model_size))
    per = v // mesh.model_size
    lo = mesh.model_index * per
    for k in HEAD_SHARDED:
        if k in head:
            head[k] = head[k][..., lo:lo + per].contiguous()
    return dict(params, predict=head)


# ---------------------------------------------------------------------------
# sums over the processes: gradients, token counts, batch statistics
# ---------------------------------------------------------------------------

def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the data axis's processes of each tensor (new tensors,
    the inputs left as they are), through one all-reduce a dtype over the
    tensors laid end to end in one buffer.  Without a process group, or
    with one process on the data axis, the tensors come back as they are.
    Collective: every process calls it with the same shapes in the same
    order."""
    tensors = list(tensors)
    if not dist.is_initialized() or data_count() == 1:
        return tensors
    group = _data_group()
    # a profiler span a trace can read the collective's time from
    with torch.profiler.record_function("parallel.all_reduce_sum"):
        return _end_to_end(tensors,
                           lambda w: dist.all_reduce(w, group=group))


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``'s sum over the data axis's processes, outside autograd (a
    count, a denominator); ``t`` itself without a process group."""
    if not dist.is_initialized():
        return t
    return all_reduce_sum([t.detach()])[0]


class _AllReduceSum(torch.autograd.Function):
    """y = sum over processes of x; the backward sums the cotangents the
    same way (each process's loss depends on y, and the global loss is the
    sum of the processes')."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum([x])[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum([g.contiguous()])[0]


def all_reduce_sum_autograd(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_sum` of one tensor with its gradient (the ResNet's
    batch statistics); ``x`` itself without a process group."""
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x)


def global_rand(shape, generator: Optional[torch.Generator], device,
                dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` as the global batch draws it: with P processes
    the draw takes the shape of the global batch (``shape[0] * P`` rows)
    from ``generator``, which is in the same state on every process, and
    this process keeps its own rows.  So every draw of a step (dropout
    masks, scheduled sampling's coins, the Gumbel uniforms) is the one
    process's draw on the whole batch, and the generators stay in step.
    P counts the data axis: the processes of one model group hold the same
    rows and draw the same bits.  ``torch.rand(shape)`` itself without a
    process group."""
    count = data_count()
    if count == 1:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)
    shape = tuple(shape)
    rows = shape[0]
    u = torch.rand((rows * count,) + shape[1:], generator=generator,
                   device=device, dtype=dtype)
    i = data_index()
    return u[i * rows:(i + 1) * rows]


# ---------------------------------------------------------------------------
# host values across processes
# ---------------------------------------------------------------------------

def _wire_device() -> torch.device:
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_allgather(x) -> np.ndarray:
    """Host-value all-gather: (...) on each process -> (P, ...) on every
    process, in process order; ``x[None]`` without a process group.  Every
    process passes the same shape and dtype."""
    a = np.ascontiguousarray(np.asarray(x))
    if not dist.is_initialized():
        return a[None]
    t = torch.from_numpy(a.copy()).to(_wire_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def host_read(x) -> np.ndarray:
    """This process's rows of a global batch (a tensor or an array, the
    rows on axis 0: eval's decoded ids) -> the whole batch as a host array
    on EVERY process, the data axis's rows in its order, so that every
    process scores the same full result set.  Replicated values (params)
    need no gather: copy them to the host directly."""
    if not dist.is_initialized() or data_count() == 1:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    t = (x.detach() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(np.asarray(x)).copy()))
    t = t.contiguous().to(_wire_device())
    parts = [torch.empty_like(t) for _ in range(data_count())]
    dist.all_gather(parts, t, group=_data_group())
    return torch.cat(parts).cpu().numpy()


def barrier(tag: str) -> None:
    """Cross-process barrier (a no-op without a process group), placed
    after process 0's checkpoint writes so that no process reads a
    checkpoint before it is complete.  ``tag`` names the site."""
    del tag
    if not dist.is_initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def processes_agree(fingerprint) -> bool:
    """True iff every process passed a bit-identical fingerprint array.
    Collective.  Gathers the fingerprint's raw bytes (as the JAX package
    does), so two float64 checksums that differ only below float32
    precision still disagree."""
    a = np.ascontiguousarray(np.asarray(fingerprint))
    g = host_allgather(a.view(np.uint8).reshape(-1))
    return bool(np.all(g == g[0]))


def local_batch_slice(global_batch_size: int, mesh: Mesh) -> int:
    """Rows of each global batch this process materializes (the batchers'
    per-process feeding seam; one process on the data axis: the full
    batch)."""
    if global_batch_size % mesh.size:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by the data axis's {mesh.size} processes")
    return global_batch_size // mesh.size
