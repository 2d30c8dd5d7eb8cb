"""Int8 K/V attention for the AoA decode loop (kernel K4).

Counterpart of the JAX package's ``ops/int8_attention.py``.  With
``SICZ_TPU_INT8_KV`` on (``ops/dispatch.py``), encode stores the decoder's
hoisted K/V projections as int8 with a symmetric per-row scale
(:func:`quantize_rows`), and every decode step attends through
:func:`lanes_attention_int8`::

    scores = (q . kq^T) * k_s / sqrt(dh)    masked to -1e9, softmax -> p
    out    = (p * v_s) @ vq                 per head, in q's dtype
    pmean  = sum over heads of p / heads    float32 (the alphas)

It launches ``csrc/int8_attention.cu`` for a CUDA ``q`` and takes
:func:`lanes_attention_int8_plain` for a CPU ``q`` only.  The kernel has two
routes, chosen by :func:`attention_route`: ``"tma"`` (a block per sample,
its int8 K and V requested whole by TMA at entry, every head at once) and
``"cuda_core"`` (a block per sample looping over the heads), for the
shapes and pointers the first does not take.  ``COUNT`` counts every launch, ``COUNT_TMA`` those of the ``"tma"``
route.  :func:`supported`
keeps the JAX package's gate (``d % heads``, ``dh % 128``, ``n <= 2048``):
those numbers are the TPU's lanes, kept because the gate decides whether
encode stores int8 K/V, and both packages must decide alike.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.ops import _build
from simpleimagecaptionzoo_tpu_torch.ops.dispatch import kernel_mode

MAX_K = 16
MAX_N = 2048
_NEG = -1e9

# the "tma" route: a block holds at most 227 KB of shared memory
TMA_SMEM = 232448
TMA_BOX_ROWS = 256

COUNT = _build.Counter()           # every launch, either route
COUNT_TMA = _build.Counter()       # launches of the "tma" route


def _mode() -> str:
    return kernel_mode("SICZ_TPU_INT8_KV", default="off")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, D) float -> (int8 (B, N, D), float32 scales (B, N)).  Symmetric
    per-row scale max(max|x|, 1e-8) / 127; an all-zero row quantizes to
    zeros."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def supported(b: int, k: int, n: int, d: int, heads: int) -> bool:
    """Does K4 take these shapes, with the switch on?  ``k`` is the query
    rows per sample (1 for greedy, the beam for beam search).  The JAX
    package's gate also holds a VMEM plan, which has room for every k <= 16
    at n <= 2048 and dh 128; the port's kernel takes k <= 16."""
    if _mode() == "off":
        return False
    if heads <= 0 or d % heads or not 1 <= k <= MAX_K:
        return False
    return (d // heads) % 128 == 0 and n <= MAX_N


def encode_should_quantize(b: int, n: int, d: int, heads: int) -> bool:
    """Encode's decision to store int8 K/V: the switch is on and K4 takes
    up to 4 query rows (greedy and beam 3)."""
    return _mode() != "off" and supported(b, 4, n, d, heads)


def _mask(mask: Optional[torch.Tensor], b: int, n: int,
          device) -> torch.Tensor:
    if mask is None:
        return torch.ones((b, n), dtype=torch.float32, device=device)
    return mask.float()


def lanes_attention_int8_plain(q, kq, ks, vq, vs, mask, num_heads: int):
    """K4's function in plain PyTorch, in the kernel's order of operations
    (the scales fold into the scores and into p)."""
    b, k, d = q.shape
    n = kq.shape[1]
    dh = d // num_heads
    mask_f = _mask(mask, b, n, q.device)
    q4 = q.float().reshape(b, k, num_heads, dh)
    k4 = kq.float().reshape(b, n, num_heads, dh)
    v4 = vq.float().reshape(b, n, num_heads, dh)
    scores = (torch.einsum("bqhd,bnhd->bhqn", q4, k4)
              * ks.float()[:, None, None, :] * (1.0 / math.sqrt(dh)))
    scores = torch.where(mask_f[:, None, None, :] > 0, scores,
                         torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)                       # (B, H, k, N)
    pv = p * vs.float()[:, None, None, :]
    out = torch.einsum("bhqn,bnhd->bqhd", pv, v4).reshape(b, k, d)
    return out.to(q.dtype), p.mean(dim=1)


def tma_smem_bytes(k: int, n: int, d: int, heads: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block (one sample) of the "tma" route
    (csrc/int8_attention.cu attn_plan) for q of ``dtype``: K and V in boxes
    of at most 256 rows by 128 bytes, the two barriers, the scores and p *
    vs (heads x k x n each), and ks, vs and mask; 128 bytes to align.
    float32 q with 3 or more rows (the beam) is staged in shared memory:
    its k x d values and 16 bytes to align them."""
    nbox = -(-n // TMA_BOX_ROWS)
    rows = -(-n // nbox)
    staged = dtype == torch.float32 and k >= 3
    return (128 + 2 * (d // 128) * nbox * rows * 128 + 16
            + 4 * (2 * heads * k * n + 3 * n)
            + (16 + 4 * k * d if staged else 0))


def attention_route(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                    n: int, d: int, heads: int) -> str:
    """The kernel route for q (B, k, D) over kq and vq (B, n, d):
    ``"tma"`` when dh is a multiple of 128, d a multiple of 16, q, kq and
    vq start on 16-byte boundaries (TMA, and q's 16-byte vector loads) and
    the block's plan fits 227 KB of
    shared memory (at d 1,024, 8 heads and k 1, n up to 109); else
    ``"cuda_core"``."""
    k = q.shape[1]
    if (heads >= 1 and d % 16 == 0 and d % heads == 0
            and (d // heads) % 128 == 0 and 1 <= k <= MAX_K
            and 1 <= n <= MAX_N and q.data_ptr() % 16 == 0
            and kq.data_ptr() % 16 == 0 and vq.data_ptr() % 16 == 0
            and tma_smem_bytes(k, n, d, heads, q.dtype) <= TMA_SMEM):
        return "tma"
    return "cuda_core"


def _run_kernel(q, kq, ks, vq, vs, mask_f, num_heads: int, route: str):
    b, k, d = q.shape
    n = kq.shape[1]
    ts = (q, kq, ks, vq, vs, mask_f)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("int8_attention: all tensors must be on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("int8_attention: q must be float32 or bfloat16, got "
                        "%s" % q.dtype)
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (ks, vs, mask_f)):
        raise TypeError("int8_attention: kq, vq must be int8 and ks, vs, "
                        "mask float32")
    if (kq.shape != (b, n, d) or vq.shape != (b, n, d)
            or any(t.shape != (b, n) for t in (ks, vs, mask_f))):
        raise ValueError("int8_attention: shapes q %s kq %s vq %s ks %s vs %s "
                         "mask %s disagree" % tuple(tuple(t.shape) for t in
                                                   ts))
    if num_heads <= 0 or d % num_heads or (d // num_heads) % 128 or not (
            1 <= k <= MAX_K and 1 <= n <= MAX_N):
        raise ValueError("int8_attention: the kernel takes dh %% 128 == 0, "
                         "k <= %d, n <= %d; got d=%d heads=%d k=%d n=%d"
                         % (MAX_K, MAX_N, d, num_heads, k, n))
    q, ks, vs, mask_f = (t.contiguous() for t in (q, ks, vs, mask_f))
    if not (kq.is_contiguous() and vq.is_contiguous()) or (
            kq.data_ptr() % 4 or vq.data_ptr() % 4):
        raise ValueError("int8_attention: kq and vq must be contiguous and "
                         "4-byte aligned")
    lib = _build.load("int8_attention", _declare)
    out = torch.empty((b, k, d), dtype=q.dtype, device=q.device)
    pmean = torch.empty((b, k, n), dtype=torch.float32, device=q.device)
    if route == "tma":
        # the C entry refuses (invalid value) what the route does not take
        entry = lib.int8_attention_tma
    elif route == "cuda_core":
        entry = lib.int8_attention
    else:
        raise ValueError("int8_attention: unknown route %r" % (route,))
    p = _build.ptr
    code = entry(
        p(q), p(kq), p(ks), p(vq), p(vs), p(mask_f), p(out), p(pmean), b, k,
        n, d, num_heads, 1.0 / math.sqrt(d // num_heads),
        0 if q.dtype == torch.float32 else 1, _build.stream_of(q))
    _build.check(code, "int8_attention" + ("_tma" if route == "tma" else ""))
    if route == "tma":
        COUNT_TMA.n += 1
    COUNT.n += 1
    return out, pmean


def _declare(lib) -> None:
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.int8_attention, lib.int8_attention_tma):
        fn.argtypes = [vp_] * 8 + [i_] * 5 + [ctypes.c_float] + [i_, vp_]
        fn.restype = i_


def lanes_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor,
                         mask: Optional[torch.Tensor], num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, k, D) over int8 K/V (B, N, D) with scales (B, N) -> (attended
    (B, k, D) in q's dtype, mean-head attention (B, k, N) float32).  A CUDA
    ``q`` launches the kernel on :func:`attention_route`'s route; a CPU
    ``q`` takes the plain version."""
    if q.device.type == "cpu":
        return lanes_attention_int8_plain(q, kq, ks, vq, vs, mask, num_heads)
    n, d = kq.shape[1], q.shape[2]
    return _run_kernel(q, kq, ks, vq, vs, _mask(mask, q.shape[0], n, q.device),
                       num_heads, attention_route(q, kq, vq, n, d, num_heads))
