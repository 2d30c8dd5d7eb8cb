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
optimizer is rebuilt every epoch (Engine.py:135-138).  The step-level
(mid-epoch) resume point, with the JAX package's file names, also carries
the optimizer's moments:

        cp/midepoch_[scst_]cp.e<E>s<S>.msgpack  params, model_state, opt_state
        cp/midepoch_[scst_]state.json           the resume point (epoch,
                                                steps done, the generator's
                                                state, the step count, the
                                                run's fingerprint); its
                                                rename is the commit point

The weights file is flax's msgpack state dict, written and read here with
``msgpack`` alone (:func:`write_tree` / :func:`to_bytes`, :func:`from_bytes`): a dict stays a map
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


def _sized(small: int, codes, n: int) -> bytes:
    """A msgpack length header: ``small`` byte-wide lengths from
    ``codes[0]``, then 2 and 4 bytes (big-endian)."""
    for code, width in zip(codes, (small, 2, 4)):
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError("msgpack: %d bytes is too long" % n)


def _write_leaf(f, code: int, a: np.ndarray, name: str) -> None:
    """One array as flax writes it, ``ExtType(code, packb((shape, dtype
    name, C-order bytes)))``, its bytes written straight from the array
    (no copy of the data)."""
    import msgpack
    if a.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            "a checkpoint leaf of shape %s (%d bytes) exceeds flax's chunk "
            "size %d; the port writes no chunked leaves"
            % (a.shape, a.nbytes, MAX_CHUNK_SIZE))
    head = (b"\x93" + msgpack.packb(tuple(a.shape))
            + msgpack.packb(name, use_bin_type=True)
            + _sized(1, (0xc4, 0xc5, 0xc6), a.nbytes))
    n = len(head) + a.nbytes
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    ext = (bytes([fixed[n]]) if n in fixed
           else _sized(1, (0xc7, 0xc8, 0xc9), n))
    f.write(ext + bytes([code]) + head)
    f.write(memoryview(a.reshape(-1).view(np.uint8)))


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


def write_tree(f, tree: Any) -> None:
    """Write to the binary file ``f`` the bytes
    ``flax.serialization.to_bytes`` writes for ``tree`` (nested dicts and
    lists of tensors, numpy arrays, ints or None), each array's data
    straight from its host copy."""
    import msgpack
    packer = msgpack.Packer(strict_types=True)

    def rec(x):
        if isinstance(x, dict):
            f.write(packer.pack_map_header(len(x)))
            for k, v in x.items():
                f.write(packer.pack(k))
                rec(v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:   # numpy has no bf16: the bits
                _write_leaf(f, _EXT_NDARRAY, t.view(torch.int16).numpy(),
                            "bfloat16")
            else:
                a = t.numpy()
                _write_leaf(f, _EXT_NDARRAY, a, a.dtype.name)
        elif isinstance(x, (np.ndarray, np.generic)):
            a = np.ascontiguousarray(x)
            _write_leaf(f, _EXT_NDARRAY if isinstance(x, np.ndarray)
                        else _EXT_NPSCALAR, a, a.dtype.name)
        elif x is None or type(x) in (bool, int, float, str):
            f.write(packer.pack(x))
        else:
            raise TypeError("cannot write %r to a checkpoint" % type(x))

    rec(_state_dict(tree))


def to_bytes(tree: Any) -> bytes:
    """``tree`` (nested dicts and lists of tensors, numpy arrays or None)
    -> the bytes ``flax.serialization.to_bytes`` writes for it."""
    import io
    buf = io.BytesIO()
    write_tree(buf, tree)
    return buf.getvalue()


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
    def _atomic_write(path: str, data, binary: bool) -> int:
        """tmp + os.replace: a crash mid-write leaves the previous complete
        file, not a truncated one.  ``binary``: ``data`` is a tree, written
        by :func:`write_tree`; else json.  -> the bytes written."""
        tmp = "%s.tmp.%d" % (path, os.getpid())
        if binary:
            with open(tmp, "wb") as f:
                write_tree(f, data)
                n = f.tell()
        else:
            with open(tmp, "w") as f:
                json.dump(data, f)
                n = f.tell()
        os.replace(tmp, path)
        return n

    def save(self, tree: Any, cider_history: list, scst: bool = False) -> None:
        """Latest checkpoint + cider history (reference save_checkpoint,
        Engine.py:81-88).  ``tree`` = {'params':..., 'model_state':...}."""
        self._atomic_write(self._weights(self.cp_dir, scst), tree,
                           binary=True)
        self._atomic_write(self._histories(scst),
                           {"cider_his": list(map(float, cider_history))},
                           binary=False)

    def save_best(self, tree: Any, cider: float, scst: bool = False) -> None:
        self._atomic_write(self._weights(self.best_dir, scst), tree,
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

    # -- mid-epoch (crash tolerance beyond the reference) --------------------
    def _midepoch_prefix(self, scst: bool) -> str:
        return "midepoch_%s" % ("scst_" if scst else "")

    def _midepoch_meta(self, scst: bool) -> str:
        return os.path.join(self.cp_dir,
                            self._midepoch_prefix(scst) + "state.json")

    def save_midepoch(self, tree: Any, meta: dict, scst: bool = False) -> int:
        """tree = {'params', 'model_state', 'opt_state'}; meta = {'epoch',
        'steps_done', ...} (json-serializable).  -> the weights file's bytes.

        The weights land in a file of their own, named in the meta; the
        meta's rename is the commit point, so a crash anywhere leaves the
        previous meta naming its own complete weights."""
        wname = "%scp.e%ds%d.msgpack" % (self._midepoch_prefix(scst),
                                         int(meta["epoch"]),
                                         int(meta["steps_done"]))
        wpath = os.path.join(self.cp_dir, wname)
        tmp = wpath + ".tmp"
        with open(tmp, "wb") as f:
            write_tree(f, tree)
            n = f.tell()
        os.replace(tmp, wpath)
        mpath = self._midepoch_meta(scst)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(meta, weights=wname), f)
        os.replace(tmp, mpath)          # commit point
        self._prune_midepoch(scst, keep=wname)
        return n

    def _prune_midepoch(self, scst: bool, keep: Optional[str]) -> None:
        """Remove the weights files of older resume points, and the
        ``.msgpack.tmp`` left by a crash during a save."""
        prefix = self._midepoch_prefix(scst) + "cp."
        for name in os.listdir(self.cp_dir):
            if (name.startswith(prefix)
                    and (name.endswith(".msgpack")
                         or name.endswith(".msgpack.tmp"))
                    and name != keep):
                try:
                    os.remove(os.path.join(self.cp_dir, name))
                except FileNotFoundError:
                    pass

    def midepoch_meta(self, scst: bool = False) -> Optional[dict]:
        """The committed resume point's meta, or None."""
        mpath = self._midepoch_meta(scst)
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            return json.load(f)

    def load_midepoch(self, template: Any, scst: bool = False
                      ) -> Tuple[Optional[Any], Optional[dict]]:
        """(tree in ``template``'s structure, its tensors on the template
        leaves' devices, meta), or (None, None) without a committed resume
        point."""
        meta = self.midepoch_meta(scst)
        if meta is None:
            return None, None
        wpath = os.path.join(self.cp_dir, meta.get("weights", ""))
        if not os.path.isfile(wpath):
            return None, None
        with open(wpath, "rb") as f:
            tree = from_bytes(template, f.read())
        return tree, meta

    def clear_midepoch(self, scst: bool = False) -> None:
        try:
            os.remove(self._midepoch_meta(scst))
        except FileNotFoundError:
            pass                        # another process already cleared it
        self._prune_midepoch(scst, keep=None)

    def history_best(self, scst: bool = False) -> float:
        """Best val CIDEr across all runs (reference load_history_best_score,
        Engine.py:72-78)."""
        path = self._best_record(scst)
        if os.path.exists(path):
            with open(path) as f:
                return float(json.load(f)["cider"])
        return 0.0
