"""Tracing and profiling helpers (the JAX package's ``utils/profiling.py``):
a throughput meter, a ``torch.profiler`` trace around a region, a step timer
that waits for the card, and FLOP / MFU bookkeeping for a bench."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class ThroughputMeter:
    """Counts items (steps, captions, tokens) per wall-clock second."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._items = 0.0

    def add(self, n: float) -> None:
        self._items += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else 0.0

    @property
    def items(self) -> float:
        return self._items


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device=None):
    """``with profiler_trace(dir):`` records the region with
    ``torch.profiler`` (host ops, and the card's kernels when ``device`` is
    a CUDA device) and writes it as a Chrome trace, ``dir/trace.json``.
    Both ends wait for ``device``, so no work leaks across them.  A no-op
    when ``log_dir`` is empty or None.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        yield prof
        _sync(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def step_timer(name: str, sink=print, device=None):
    """Prints ``[name] <seconds>s`` of the block.  With a CUDA ``device``
    the card is synchronized before each reading of the clock, so the time
    holds the block's device work and nothing queued before it."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    sink(f"[{name}] {time.perf_counter() - t0:.3f}s")


# ---------------------------------------------------------------------------
# FLOPs / MFU accounting (roofline bookkeeping for the benches)
# ---------------------------------------------------------------------------

# Dense tensor-core peaks of the card the port targets, against which MFU
# is reported (the denominator stays auditable): NVIDIA H100 SXM, 989
# TFLOP/s bf16 and 67 TFLOP/s float32 (the CUDA cores; a 3xTF32 product
# is counted as the float32 product it computes).
PEAK_CARD = "NVIDIA H100 SXM (dense)"
PEAK_TFLOPS = {"bf16": 989.0, "f32": 67.0}


def aten_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: the aten
    operators it has formulas for (matmuls, convolutions, attention), run
    on whatever device the arguments lie on.  The port's hand kernels
    (K1-K4, launched through their C entries) are not aten operators, so a
    call on the card counts none of their work, and on the CPU it counts
    their plain versions' products.  It replaces the JAX package's
    ``xla_flops`` (XLA's cost analysis), which has no PyTorch counterpart;
    ``utils/flops.py``'s analytic counts are the bench's numbers.  Returns
    None when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = float(counter.get_total_flops())
    return total if total > 0 else None


def mfu(flops_per_call: Optional[float], seconds_per_call: float,
        dtype: str = "bf16") -> Optional[dict]:
    """-> {'achieved_tflops', 'mfu', 'peak_tflops_assumed', 'peak_of'} or
    None; ``peak_of`` names the card whose peak is the denominator."""
    if not flops_per_call or seconds_per_call <= 0:
        return None
    achieved = flops_per_call / seconds_per_call / 1e12
    peak = PEAK_TFLOPS[dtype]
    return {"achieved_tflops": round(achieved, 2),
            "mfu": round(achieved / peak, 4),
            "peak_tflops_assumed": peak,
            "peak_of": PEAK_CARD}
