"""Checkpoints in the JAX package's layout and format (its
``engine/checkpoint.py``; reference Engine.py:43-88), so either package reads
the other's files:

    CheckPoints/Model_<model_type>_Dataset_<ds>/
        cp/Captioner_[scst_]cp.msgpack        latest weights
        cp/[scst_]state_histories.json        {"cider_his": [...]}; resume
                                              epoch = len+1 (Engine.py:60-69)
        best/Captioner_[scst_]cp.msgpack      best-on-val weights
        best/[best_score_record|best_scst_score_record].json   {"cider": x}

The SCST best record is ``best_scst_score_record.json`` on both sides, as in
the JAX package (the reference writes one name and reads another,
Engine.py:243 vs :77).  Only params and model_state are saved: the
optimizer is rebuilt every epoch (Engine.py:135-138).  The JAX package's
step-level (mid-epoch) checkpoints are not ported.

The weights file is flax's msgpack state dict, written and read here with
``msgpack`` alone (:func:`to_bytes`, :func:`from_bytes`): a dict stays a map
keyed by its keys (sorted), a list becomes a map keyed ``"0"``, ``"1"``, ... (AoA's
``refine``), None is nil, and an array is ``ExtType(1, packb((shape,
dtype name, C-order bytes)))``; a bf16 tensor is written under the name
``bfloat16`` with its raw bits.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3      # flax's _MsgpackExtType codes
# flax splits a leaf above this many bytes into chunks (MAX_CHUNK_SIZE); no
# leaf of the zoo comes near it, so the port refuses one instead
MAX_CHUNK_SIZE = 2 ** 30


def _leaf_bytes(shape, name: str, raw: bytes) -> bytes:
    import msgpack
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError(
            "a checkpoint leaf of shape %s (%d bytes) exceeds flax's chunk "
            "size %d; the port writes no chunked leaves"
            % (tuple(shape), len(raw), MAX_CHUNK_SIZE))
    return msgpack.packb((tuple(shape), name, raw), use_bin_type=True)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:       # numpy has no bf16: carry the bits
        return _leaf_bytes(t.shape, "bfloat16",
                           t.view(torch.int16).numpy().tobytes("C"))
    a = t.numpy()
    return _leaf_bytes(a.shape, a.dtype.name, a.tobytes("C"))


def _state_dict(tree):
    """flax's to_state_dict on nested dicts and lists of tensors, a dict's
    keys in sorted order: the order the JAX package's manager hands flax
    (``jax.tree_util.tree_map`` rebuilds dicts sorted), so both packages
    write the same bytes for the same tree."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree: Any) -> bytes:
    """``tree`` (nested dicts and lists of tensors, numpy arrays or None)
    -> the bytes ``flax.serialization.to_bytes`` writes for it."""
    import msgpack

    def ext(x):
        if isinstance(x, torch.Tensor):
            return msgpack.ExtType(_EXT_NDARRAY, _tensor_bytes(x))
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.ascontiguousarray(x)
            return msgpack.ExtType(
                _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR,
                _leaf_bytes(a.shape, a.dtype.name, a.tobytes("C")))
        raise TypeError("cannot write %r to a checkpoint" % type(x))

    return msgpack.packb(_state_dict(tree), default=ext, strict_types=True)


def _leaf_from(data: bytes) -> torch.Tensor:
    import msgpack
    shape, name, raw = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        a = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(name)).copy()
                            ).reshape(shape)


def _restore(template, state, path: str):
    """flax's from_state_dict: ``template``'s structure with ``state``'s
    leaves; a key of the file that the template lacks is ignored, a key of
    the template that the file lacks is an error."""
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError("checkpoint: %s holds a %s, the model a dict"
                             % (path or ".", type(state).__name__))
        missing = [k for k in template if str(k) not in state]
        if missing:
            raise ValueError("checkpoint: %s lacks %s" % (path or ".",
                                                          missing))
        return {k: _restore(v, state[str(k)], "%s/%s" % (path, k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(template):
            raise ValueError("checkpoint: %s holds %s entries, the model %d"
                             % (path, len(state) if isinstance(state, dict)
                                else type(state).__name__, len(template)))
        return type(template)(_restore(v, state[str(i)], "%s/%d" % (path, i))
                              for i, v in enumerate(template))
    if isinstance(template, torch.Tensor):
        if not isinstance(state, torch.Tensor):
            raise ValueError("checkpoint: %s holds %s, the model a tensor"
                             % (path, type(state).__name__))
        if tuple(state.shape) != tuple(template.shape):
            raise ValueError("checkpoint: %s has shape %s, the model %s"
                             % (path, tuple(state.shape),
                                tuple(template.shape)))
        return state.to(template.device)
    return state


def from_bytes(template: Any, data: bytes) -> Any:
    """``flax.serialization.from_bytes``: the file's leaves in
    ``template``'s structure, each tensor on its template leaf's device and
    in the file's dtype."""
    import msgpack

    def ext(code, raw):
        if code == _EXT_NDARRAY:
            return _leaf_from(raw)
        if code == _EXT_NPSCALAR:
            return _leaf_from(raw).reshape(())
        raise ValueError("checkpoint: unknown msgpack extension %d" % code)

    state = msgpack.unpackb(data, ext_hook=ext, raw=False)
    if isinstance(state, dict) and "__msgpack_chunked_array__" in state:
        raise ValueError("checkpoint: chunked leaves are not supported")
    return _restore(template, state, "")


def _tag(model_type: str, dataset_name: str) -> str:
    return f"Model_{model_type}_Dataset_{dataset_name}"


class CheckpointManager:
    def __init__(self, model_type: str, dataset_name: str,
                 root: str = "./CheckPoints") -> None:
        self.root_dir = os.path.join(root, _tag(model_type, dataset_name))
        self.cp_dir = os.path.join(self.root_dir, "cp")
        self.best_dir = os.path.join(self.root_dir, "best")
        os.makedirs(self.cp_dir, exist_ok=True)
        os.makedirs(self.best_dir, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _weights(self, d: str, scst: bool) -> str:
        return os.path.join(d, "Captioner_%scp.msgpack" % ("scst_" if scst else ""))

    def _histories(self, scst: bool) -> str:
        return os.path.join(self.cp_dir,
                            "%sstate_histories.json" % ("scst_" if scst else ""))

    def _best_record(self, scst: bool) -> str:
        name = "best_scst_score_record.json" if scst else "best_score_record.json"
        return os.path.join(self.best_dir, name)

    # -- save ----------------------------------------------------------------
    @staticmethod
    def _atomic_write(path: str, data, binary: bool) -> None:
        """tmp + os.replace: a crash mid-write leaves the previous complete
        file, not a truncated one."""
        tmp = "%s.tmp.%d" % (path, os.getpid())
        if binary:
            with open(tmp, "wb") as f:
                f.write(data)
        else:
            with open(tmp, "w") as f:
                json.dump(data, f)
        os.replace(tmp, path)

    def save(self, tree: Any, cider_history: list, scst: bool = False) -> None:
        """Latest checkpoint + cider history (reference save_checkpoint,
        Engine.py:81-88).  ``tree`` = {'params':..., 'model_state':...}."""
        self._atomic_write(self._weights(self.cp_dir, scst), to_bytes(tree),
                           binary=True)
        self._atomic_write(self._histories(scst),
                           {"cider_his": list(map(float, cider_history))},
                           binary=False)

    def save_best(self, tree: Any, cider: float, scst: bool = False) -> None:
        self._atomic_write(self._weights(self.best_dir, scst), to_bytes(tree),
                           binary=True)
        self._atomic_write(self._best_record(scst), {"cider": float(cider)},
                           binary=False)

    # -- load ----------------------------------------------------------------
    def load(self, template: Any, scst: bool = False, best: bool = False
             ) -> Tuple[Optional[Any], list, int]:
        """Returns (tree or None, cider_history, start_epoch) with the
        reference's fallback semantics (Engine.py:43-70): best-if-asked, else
        latest; resume epoch = len(cider_his) + 1.  The tree's tensors land
        on the devices of ``template``'s."""
        if best:
            path = self._weights(self.best_dir, scst)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    tree = from_bytes(template, f.read())
                return tree, [], 1
            print("best %scheckpoint not found; falling back to latest."
                  % ("scst " if scst else ""))
        cider_his: list = []
        if os.path.exists(self._histories(scst)):
            with open(self._histories(scst)) as f:
                cider_his = json.load(f)["cider_his"]
        path = self._weights(self.cp_dir, scst)
        tree = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                tree = from_bytes(template, f.read())
        else:
            # reference Engine.py:68 prints and proceeds on the current
            # weights; say so, since the caller then continues on them
            print("WARNING: recent %scheckpoint not found in %s — "
                  "proceeding with the CURRENT (e.g. freshly initialized) "
                  "weights." % ("scst " if scst else "", self.cp_dir))
        return tree, cider_his, len(cider_his) + 1

    def history_best(self, scst: bool = False) -> float:
        """Best val CIDEr across all runs (reference load_history_best_score,
        Engine.py:72-78)."""
        path = self._best_record(scst)
        if os.path.exists(path):
            with open(path) as f:
                return float(json.load(f)["cider"])
        return 0.0
