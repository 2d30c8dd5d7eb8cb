"""Observability: logging, progress bars, the metrics JSONL and the profiler
window (the JAX package's ``engine/observe.py``).

Everything here is host-side reporting around the training and eval loops,
with no effect on the steps.  Mixin methods expect the Engine attributes
``verbose`` / ``tqdm_visible`` / ``profile_dir`` / ``device`` / ``ckpt``
and ``_is_writer`` (``multihost.py``).
"""
from __future__ import annotations

import json
import os
import time

import torch

from simpleimagecaptionzoo_tpu_torch.parallel import (process_count,
                                                      process_index)


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a CUDA launch returns before
    the card runs it); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ObservabilityMixin:
    _profiler = None
    _profile_done = False

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _monitor(self, iterable, total: int, desc: str):
        """tqdm progress bar with live loss postfix (reference
        Engine.py:171-174; toggle like --tqdm_visible, Main.py:148)."""
        if not self.tqdm_visible:
            return iterable
        try:
            import tqdm
            return tqdm.tqdm(iterable, total=total, desc=desc)
        except ImportError:
            return iterable

    def _log_metrics(self, record: dict):
        """Append a JSONL metrics record next to the checkpoints (process 0
        alone in a data-parallel run: every process holds the same
        record)."""
        if not self._is_writer:
            return
        with open(os.path.join(self.ckpt.root_dir, "metrics.jsonl"),
                  "a") as f:
            f.write(json.dumps(record) + "\n")

    @staticmethod
    def _epoch_rate(n_exec: int, t0: float, t_work) -> float:
        """Steps/sec without the first step (``t_work`` is stamped once
        step 1's result is ready, so the window holds ``n_exec - 1`` steps:
        the first one builds the kernels and warms the allocator).  0.0 for
        an empty epoch; the full window's rate when a single step leaves
        nothing to exclude."""
        now = time.perf_counter()
        if n_exec == 0:
            return 0.0
        if n_exec == 1 or t_work is None:
            return n_exec / max(now - t0, 1e-9)
        return (n_exec - 1) / max(now - t_work, 1e-9)

    def _profile_window(self, n_exec: int) -> None:
        """``--profile_dir``: one torch.profiler trace of steps 3-7 of the
        first training epoch that runs, written as a Chrome trace
        (``trace.json``).  Step 1 builds the kernels and step 2 is its warm
        shadow, so the window holds five steady steps; both boundaries wait
        for the device, so no step's work leaks across them.  With several
        processes each writes into ``process_<index>/`` of the directory,
        so that none overwrites another's trace."""
        if not self.profile_dir or self._profile_done:
            return
        if self._profiler is None and n_exec == 2:
            from torch.profiler import ProfilerActivity, profile
            sync(self.device)
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif self._profiler is not None and n_exec >= 7:
            self._profile_close()

    def _profile_close(self) -> None:
        """Stop and write a trace still open (an epoch shorter than the
        window ends it early)."""
        if self._profiler is None:
            return
        sync(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        out = self.profile_dir
        if process_count() > 1:
            out = os.path.join(out, "process_%d" % process_index())
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        self._profile_done = True
        self._log(f"  profiler trace (steps 3-7 or to the epoch's end) -> "
                  f"{path}")
