"""Multi-process coordination (the JAX package's ``engine/multihost.py``).

The contract of a data-parallel run (``parallel``): every process holds the
same replicated state and walks the same host-side control flow; process 0
is the single writer of checkpoints and ``metrics.jsonl``, and each write
is followed by a ``barrier``; agreement checks turn a would-be silent fork
of the state into a loud error.  Mixin methods expect the Engine attribute
``tree``.
"""
from __future__ import annotations

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves, tree_map
from simpleimagecaptionzoo_tpu_torch.parallel import (process_count,
                                                      process_index,
                                                      processes_agree)


class MultiHostMixin:
    @property
    def _is_writer(self) -> bool:
        """Process 0 writes the checkpoints and metrics (every process
        holds the same replicated state, so one copy is complete); a
        ``barrier`` after the write is the commit point."""
        return process_index() == 0

    def _host_tree(self):
        """The replicated tree on the host (no collective: every process
        holds all of it)."""
        return tree_map(lambda t: t.detach().cpu()
                        if isinstance(t, torch.Tensor) else t, self.tree)

    def _check_multihost_ckpt(self, tree, meta: tuple, tag: str) -> None:
        """With several processes: check that every process loaded the
        SAME checkpoint.  Epoch checkpoints are written by process 0 alone;
        on storage the others cannot see they would load nothing (or a
        stale file) and fork the replicated state.  Fingerprint = (found,
        *meta, the float64 sum of every numeric leaf); collective, so every
        process calls it at the same site."""
        if process_count() == 1:
            return
        csum = 0.0
        if tree is not None:
            for leaf in tree_leaves(tree):
                if isinstance(leaf, torch.Tensor):
                    csum += float(leaf.detach().double().sum())
                elif isinstance(leaf, (int, float, np.ndarray)):
                    csum += float(np.asarray(leaf, np.float64).sum())
        fp = np.array([0.0 if tree is None else 1.0,
                       *[float(m) for m in meta], csum], np.float64)
        if not processes_agree(fp):
            raise RuntimeError(
                f"{tag}: processes loaded different checkpoint contents "
                f"(process {process_index()}: "
                f"{'missing' if tree is None else 'found'}, meta={meta}). "
                "The checkpoint directory must be storage every process "
                "sees: copy it to all hosts or point checkpoint_root at a "
                "shared filesystem.")
