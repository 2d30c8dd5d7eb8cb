"""Carry parameter trees between the JAX package and this one.

Both packages lay parameters out the same way: nested dicts (and the AoA
``refine`` list) of arrays, weights stored (in, out), LSTM gates packed
i,f,g,o on the output dim, weight-norm ``v`` (in, out) with ``g`` per column.
So the bridge only changes the array type; it never relayouts.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def from_jax(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None):
    """JAX param tree (leaves numpy or anything ``np.asarray`` takes) -> the
    same structure of torch tensors on ``device``; a bf16 leaf comes over
    bit for bit as ``torch.bfloat16``.  ``dtype``, if given, casts
    the floating leaves; integer leaves keep their type, and so does every
    leaf of a weight-only int8 layer (a dict with ``q`` and ``s``), whose
    float32 scales and bias are the quantization's error budget."""
    if isinstance(tree, dict):
        if "q" in tree and "s" in tree:
            dtype = None
        return {k: from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device, dtype) for v in tree)
    if tree is None:
        return None
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX's is ml_dtypes'), and
        # torch.from_numpy refuses it: carry the bits, which is exact
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_numpy(params: Any):
    """Inverse of :func:`from_jax`: torch tensors -> numpy arrays, same
    structure.  numpy has no bfloat16, so bf16 leaves come back as float32
    (exact: every bf16 value is a float32 value)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_numpy(v) for v in params)
    if params is None:
        return None
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
