"""Fused prediction-head -> logsumexp -> top-k (kernel K1).

Counterpart of the JAX package's ``ops/fused_head.py``.  Every decode step
ends with the (H, V) weight-norm head and a small selection over its logits:
argmax for greedy decode, a per-row top-k for beam search.  The kernel
(``csrc/fused_head.cu``) computes the logits chunk by chunk in float32 and
keeps them out of device memory; it returns the top-k raw logits, their
vocab ids and the logsumexp, so ``vals - lse[:, None]`` are the exact top-k
log-softmax values.  The head weight is float32 or bf16 (x's dtype), or
int8 with a per-column scale (``ops/quant.py``'s layout, the int8 serving
path); the product is float32 either way.

:func:`topk_head` launches the kernel for a CUDA tensor and takes
:func:`topk_head_plain`, the same function in plain PyTorch, for a CPU
tensor only.  The kernel's partial pass has four routes, chosen by
:func:`head_route` from dtypes, shapes and alignment: ``"wgmma"`` (bf16 x
with bf16 or int8 w on the tensor cores, TMA-fed, an int8 w widened to bf16
in shared memory first; chunks of ``HEAD_CHUNK_WGMMA`` columns),
``"tf32x3"`` (float32 x and w on the tensor cores as three TF32 products,
float32-accurate: ``ops/tf32.py``; chunks of ``HEAD_CHUNK_TF32X3``),
``"tf32x2"`` (float32 x with an int8 w: two TF32 products, the int8 w
exact in TF32, transposed and widened to float32 in shared memory; chunks
of ``HEAD_CHUNK_TF32X3``) and ``"cuda_core"`` (operands TMA cannot take;
chunks of ``HEAD_CHUNK``).
``COUNT`` counts every launch, ``COUNT_WGMMA``, ``COUNT_TF32X3`` and
``COUNT_TF32X2`` those of the tensor-core routes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from simpleimagecaptionzoo_tpu_torch.ops import _build, tf32

K_ALIGN = 128                   # x feature axis alignment
V_TILE = 512                    # vocab padding unit (the JAX package's)
HEAD_CHUNK = 128                # columns per chunk, "cuda_core" route (BN)
HEAD_CHUNK_WGMMA = 256          # columns per chunk, "wgmma" route (tc::BN)
HEAD_CHUNK_TF32X3 = 128         # columns per chunk, "tf32x3" and "tf32x2" (BN)
MAX_K = 16
_NEG = -1e30
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}   # common.cuh

COUNT = _build.Counter()           # every launch, any route
COUNT_WGMMA = _build.Counter()     # launches of the "wgmma" route
COUNT_TF32X3 = _build.Counter()    # launches of the "tf32x3" route
COUNT_TF32X2 = _build.Counter()    # launches of the "tf32x2" route


class Head(NamedTuple):
    """A head prepared for the kernel: w (Kp, Vp) in the compute dtype or
    int8, s and b (Vp,) float32, the true vocab size v, and, for a float32
    w, its TF32 split for the "tf32x3" route (else None)."""
    w: torch.Tensor
    s: torch.Tensor
    b: torch.Tensor
    v: int
    split: Optional[tf32.Split] = None


def prepare_head(head: dict, dtype: torch.dtype) -> Head:
    """Head param dict -> :class:`Head`.  Loop-invariant: call once per
    decode.

    Takes the weight-norm head ``{"v", "g", "b"}`` (effective weight
    computed in float32, then cast to ``dtype``), a plain dense
    ``{"w", "b"}``, or the int8 head ``{"q", "s", "b"}`` (``q`` stays int8
    and is already padded; its scale is per column).  K pads to 128 and V to
    512 with zeros; pad columns get scale 0 and bias -1e30, so their logit
    is -1e30 and never wins.  A float32 head also gets its TF32 split."""
    if "q" in head:                      # ops/quant.py layout, pre-padded
        q = head["q"]
        v = head["s"].shape[0]
        vp = q.shape[1]
        s = torch.nn.functional.pad(head["s"].float(), (0, vp - v))
        b = torch.nn.functional.pad(head["b"].float(), (0, vp - v),
                                    value=_NEG)
        return Head(q.contiguous(), s, b, v)
    if "v" in head:
        vv = head["v"].float()
        w = vv * (head["g"].float()
                  / (torch.linalg.vector_norm(vv, dim=0) + 1e-12))
    else:
        w = head["w"].float()
    k, v = w.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    vp = -(-v // V_TILE) * V_TILE
    w = torch.nn.functional.pad(w, (0, vp - v, 0, kp - k)).to(dtype)
    s = torch.zeros(vp, dtype=torch.float32, device=w.device)
    s[:v] = 1.0
    b = torch.full((vp,), _NEG, dtype=torch.float32, device=w.device)
    b[:v] = head["b"].float() if "b" in head else 0.0
    w = w.contiguous()
    return Head(w, s, b, v,
                tf32.prepare_split(w) if dtype == torch.float32 else None)


def _prepared(head: Union[dict, Head], x: torch.Tensor):
    if not isinstance(head, Head):
        head = prepare_head(head, x.dtype)
    kp = head.w.shape[0]
    if x.shape[1] != kp:
        x = torch.nn.functional.pad(x, (0, kp - x.shape[1]))
    return head, x


def logits_plain(head: Union[dict, Head], x: torch.Tensor) -> torch.Tensor:
    """The head's float32 logits (m, Vp), pad columns at -1e30: what K1
    reduces without writing it out."""
    head, x = _prepared(head, x)
    return (x.float() @ head.w.float()) * head.s + head.b


def topk_head_plain(head: Union[dict, Head], x: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch on materialized float32 logits."""
    logits = logits_plain(head, x)
    # a stable descending sort keeps equal values in id order: lax.top_k's
    # tie order, which torch.topk does not promise
    vals, idx = torch.sort(logits, dim=1, descending=True, stable=True)
    lse = torch.logsumexp(logits, dim=1)
    return vals[:, :k], idx[:, :k].to(torch.int32), lse


def head_route(w: torch.Tensor, x: torch.Tensor) -> str:
    """The partial pass's route for these operands, when x's and w's rows
    are multiples of 16 bytes (for TMA) and both start on 16-byte
    boundaries: ``"wgmma"`` when x is bf16 and w bf16 or int8,
    ``"tf32x3"`` when both are float32, ``"tf32x2"`` when x is float32 and
    w int8; else ``"cuda_core"``."""
    if ((x.shape[1] * x.element_size()) % 16 == 0
            and (w.shape[1] * w.element_size()) % 16 == 0
            and _build.tma_aligned(x, w)):
        if x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16,
                                                     torch.int8):
            return "wgmma"
        if x.dtype == torch.float32 and w.dtype == torch.float32:
            return "tf32x3"
        if x.dtype == torch.float32 and w.dtype == torch.int8:
            return "tf32x2"
    return "cuda_core"


def head_chunks(route: str, vp: int) -> int:
    """Vocab chunks of the partial pass over ``vp`` columns on ``route``:
    one (max, sum, top-k) partial per row and chunk."""
    width = {"wgmma": HEAD_CHUNK_WGMMA, "tf32x3": HEAD_CHUNK_TF32X3,
             "tf32x2": HEAD_CHUNK_TF32X3, "cuda_core": HEAD_CHUNK}[route]
    return -(-vp // width)


def _run_kernel(head: Head, x: torch.Tensor, k: int, route: str):
    w, s, b = head.w, head.s, head.b
    m, kp = x.shape
    vp = w.shape[1]
    if not (x.is_cuda and w.device == x.device and s.device == x.device
            and b.device == x.device):
        raise ValueError("fused_head: x, w, s and b must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype not in (
            x.dtype, torch.int8):
        raise TypeError("fused_head: x must be float32 or bfloat16 and w "
                        "the same or int8, got %s and %s" % (x.dtype,
                                                            w.dtype))
    if s.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("fused_head: s and b must be float32")
    if w.shape[0] != kp or s.shape != (vp,) or b.shape != (vp,):
        raise ValueError("fused_head: shapes x %s w %s s %s b %s disagree"
                         % (tuple(x.shape), tuple(w.shape), tuple(s.shape),
                            tuple(b.shape)))
    if not 1 <= k <= min(MAX_K, head.v):
        raise ValueError("fused_head: k=%d outside [1, %d]"
                         % (k, min(MAX_K, head.v)))
    x = x.contiguous()
    if not (w.is_contiguous() and s.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_head: w, s and b must be contiguous")
    # alignment: head_route checked it, and the C entries of the
    # tensor-core routes refuse a misaligned pointer (CUDA error 716)
    if route == "tf32x3" and not (
            x.dtype == torch.float32 and w.dtype == torch.float32
            and kp % 4 == 0 and vp % 4 == 0):
        raise ValueError("fused_head: the tf32x3 route takes float32 x and "
                         "w with K and V multiples of 4; got %s, %s, K=%d, "
                         "V=%d" % (x.dtype, w.dtype, kp, vp))
    if route == "tf32x2" and not (
            x.dtype == torch.float32 and w.dtype == torch.int8
            and kp % 4 == 0 and vp % 16 == 0):
        raise ValueError("fused_head: the tf32x2 route takes float32 x and "
                         "int8 w with K a multiple of 4 and V of 16; got %s, "
                         "%s, K=%d, V=%d" % (x.dtype, w.dtype, kp, vp))
    if route == "wgmma" and not (
            x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16,
                                                      torch.int8)
            and kp % 8 == 0 and (vp * w.element_size()) % 16 == 0):
        raise ValueError("fused_head: the wgmma route takes bf16 x and bf16 "
                         "or int8 w with K a multiple of 8 and rows of w "
                         "of 16 bytes; got %s, %s, K=%d, V=%d"
                         % (x.dtype, w.dtype, kp, vp))
    lib = _build.load("fused_head", _declare)
    nchunk = head_chunks(route, vp)
    dev = x.device
    # the partials (max, sum, then k values and k int32 ids per row and
    # chunk) share one scratch allocation: fewer host calls per launch
    n = m * nchunk
    scratch = torch.empty(n * (2 + 2 * k), dtype=torch.float32, device=dev)
    at = scratch.data_ptr()
    pmax, psum, pval, pidx = (ctypes.c_void_p(at + 4 * off)
                              for off in (0, n, 2 * n, (2 + k) * n))
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    lse = torch.empty((m,), dtype=torch.float32, device=dev)
    p = _build.ptr
    if route == "wgmma":
        code = lib.fused_head_topk_wgmma(
            p(x), p(w), p(s), p(b), pmax, psum, pval, pidx,
            p(vals), p(idx), p(lse), m, kp, vp, k, nchunk, _DTYPE[w.dtype],
            _build.stream_of(x))
        _build.check(code, "fused_head_topk_wgmma")
        COUNT_WGMMA.n += 1
    elif route == "tf32x3":
        split = head.split if head.split is not None else \
            tf32.prepare_split(w)
        if not all(t.shape == (vp, kp) and t.is_contiguous()
                   and t.dtype == torch.float32 and t.device == dev
                   for t in split):
            raise ValueError("fused_head: the split must be two contiguous "
                             "float32 (Vp, Kp) tensors on x's device")
        code = lib.fused_head_topk_tf32x3(
            p(x), p(split.hi), p(split.lo), p(s), p(b), pmax, psum, pval,
            pidx, p(vals), p(idx), p(lse), m, kp, vp, k, nchunk,
            _build.stream_of(x))
        _build.check(code, "fused_head_topk_tf32x3")
        COUNT_TF32X3.n += 1
    elif route == "tf32x2":
        code = lib.fused_head_topk_tf32x2(
            p(x), p(w), p(s), p(b), pmax, psum, pval, pidx,
            p(vals), p(idx), p(lse), m, kp, vp, k, nchunk,
            _build.stream_of(x))
        _build.check(code, "fused_head_topk_tf32x2")
        COUNT_TF32X2.n += 1
    elif route == "cuda_core":
        code = lib.fused_head_topk(
            p(x), p(w), p(s), p(b), pmax, psum, pval, pidx,
            p(vals), p(idx), p(lse), m, kp, vp, k, nchunk, _DTYPE[x.dtype],
            _DTYPE[w.dtype], _build.stream_of(x))
        _build.check(code, "fused_head_topk")
    else:
        raise ValueError("fused_head: unknown route %r" % (route,))
    COUNT.n += 1
    return vals, idx, lse


def _declare(lib) -> None:
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.fused_head_topk.argtypes = [vp_] * 11 + [i_] * 7 + [vp_]
    lib.fused_head_topk.restype = i_
    lib.fused_head_topk_wgmma.argtypes = [vp_] * 11 + [i_] * 6 + [vp_]
    lib.fused_head_topk_wgmma.restype = i_
    lib.fused_head_topk_tf32x3.argtypes = [vp_] * 12 + [i_] * 5 + [vp_]
    lib.fused_head_topk_tf32x3.restype = i_
    lib.fused_head_topk_tf32x2.argtypes = [vp_] * 11 + [i_] * 5 + [vp_]
    lib.fused_head_topk_tf32x2.restype = i_


def enabled(k: int) -> bool:
    """Does beam search take the fused head at beam ``k``?  The counterpart
    of the JAX package's ``fused_head.enabled``: the kernel takes every k
    up to ``MAX_K`` on every device (a CPU tensor takes its plain version),
    so only k decides; a wider beam takes the full-logits branch of
    ``ops/decode.beam_search``."""
    return 1 <= k <= MAX_K


def topk_head(head: Union[dict, Head], x: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (m, H) -> (top-k raw logits (m, k) float32 descending, vocab ids
    (m, k) int32, logsumexp (m,) float32).  ``idx[:, 0]`` is the argmax.
    ``head`` is the param dict or a :class:`Head` from
    :func:`prepare_head`.  A CUDA ``x`` launches the kernel on
    :func:`head_route`'s route; a CPU ``x`` takes the plain version."""
    head, x = _prepared(head, x)
    if x.device.type == "cpu":
        return topk_head_plain(head, x, k)
    x = x.contiguous()
    return _run_kernel(head, x, k, head_route(head.w, x))
