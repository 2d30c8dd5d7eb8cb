"""Weight-only int8 for the decode-step layers (kernel K3).

Counterpart of the JAX package's ``ops/quant.py``.  A quantized layer is the
dict ``{"q": int8 (Kp, Np), "s": float32 (N,), "b": float32 (N,)}``: a
per-output-channel symmetric scale, K zero-padded to a multiple of 128 and N
to a multiple of 512 (the JAX package's layout, kept so trees carry across
unchanged).  ``layers.dense``, ``layers.dense_wn`` and ``layers.lstm_cell``
dispatch on ``"q"``, so a decode runs unchanged on a quantized tree.

:func:`quant_matmul` computes ``(x @ q) * s + b`` with float32 accumulation,
rounded once to x's dtype.  It launches ``csrc/quant_matmul.cu`` for a CUDA
``x`` and takes :func:`quant_matmul_plain` for a CPU ``x`` only.  The JAX
package's row-count and VMEM gate is the TPU's; K3 takes any row count.
The kernel has three routes, chosen by :func:`quant_route` from dtypes,
shapes and alignment: ``"wgmma"`` (bf16 x; q widened to bf16 in shared
memory between its TMA load and the tensor-core product), ``"tf32x2"``
(float32 x; q transposed and widened to float32 in shared memory, and two
TF32 products, x_lo q + x_hi q, which keep float32 accuracy because an
int8 q is exact in TF32) and ``"cuda_core"`` (operands TMA cannot take).
``COUNT`` counts every launch, ``COUNT_WGMMA`` and ``COUNT_TF32X2`` those
of the tensor-core routes.
"""
from __future__ import annotations

import torch

from simpleimagecaptionzoo_tpu_torch.ops import _build

K_ALIGN = 128
N_ALIGN = 512

COUNT = _build.Counter()           # every launch, either route
COUNT_WGMMA = _build.Counter()     # launches of the "wgmma" route
COUNT_TF32X2 = _build.Counter()    # launches of the "tf32x2" route


# ---------------------------------------------------------------------------
# quantizers (once per decode, outside the step loop)
# ---------------------------------------------------------------------------

def _quantize(w: torch.Tensor, bias) -> dict:
    """w (K, N) float -> {"q" int8 (Kp, Np), "s" float32 (N,), "b" float32
    (N,)}: s_n = max(max|w[:, n]|, 1e-8) / 127, q = clip(round(w / s)), with
    round half to even as ``jnp.round``.  Pad rows and columns are 0."""
    w = w.float()
    k, n = w.shape
    s = torch.clamp(w.abs().amax(dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    kp = -(-k // K_ALIGN) * K_ALIGN
    np_ = -(-n // N_ALIGN) * N_ALIGN
    q = torch.nn.functional.pad(q, (0, np_ - n, 0, kp - k))
    b = (torch.zeros((n,), dtype=torch.float32, device=w.device)
         if bias is None else bias.float())
    return {"q": q.contiguous(), "s": s, "b": b}


def quantize_dense(p: dict) -> dict:
    """``layers.dense`` params {"w", "b"?} -> quantized dict."""
    return _quantize(p["w"], p.get("b"))


def quantize_dense_wn(p: dict) -> dict:
    """``layers.dense_wn`` params {"v", "g", "b"?}: quantize the effective
    weight v * g / (||v||_col + 1e-12), taken in float32."""
    v = p["v"].float()
    w = v * (p["g"].float() / (torch.linalg.vector_norm(v, dim=0) + 1e-12))
    return _quantize(w, p.get("b"))


def quantize_lstm(p: dict) -> dict:
    """``layers.lstm_cell`` params -> the packed [w_ih; w_hh] quantized, with
    bias b_ih + b_hh; the cell then runs ``quant_matmul([x, h])``."""
    w = torch.cat([p["w_ih"], p["w_hh"]], dim=0)
    return _quantize(w, p["b_ih"] + p["b_hh"])


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "q" in p and "s" in p


def quantize_tree(params: dict, paths) -> dict:
    """A copy of ``params`` with each layer dict that ``paths`` addresses (a
    tuple of keys each) replaced by its quantized form; the layer kind comes
    from the dict's keys.  ``params`` itself is not changed, and subtrees
    off the paths are shared."""
    def convert(leaf: dict) -> dict:
        if "w_ih" in leaf:
            return quantize_lstm(leaf)
        if "v" in leaf:
            return quantize_dense_wn(leaf)
        if "w" in leaf:
            return quantize_dense(leaf)
        raise ValueError("not a quantizable layer dict: %s" % list(leaf))

    def rec(node, path):
        if not path:
            return convert(node)
        out = dict(node)
        out[path[0]] = rec(node[path[0]], path[1:])
        return out

    out = params
    for p in paths:
        out = rec(out, tuple(p))
    return out


# ---------------------------------------------------------------------------
# the dequantizing product
# ---------------------------------------------------------------------------

def _operands(x: torch.Tensor, qp: dict):
    """-> (x as (m, K), q, s float32 (n,), b float32 (n,), lead shape)."""
    s = qp["s"].float()
    b = qp["b"].float()
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[1] > qp["q"].shape[0]:
        raise ValueError("quant_matmul: x has %d features, q only %d rows"
                         % (x2.shape[1], qp["q"].shape[0]))
    return x2, qp["q"], s, b, tuple(x.shape[:-1])


def quant_matmul_plain(x: torch.Tensor, qp: dict) -> torch.Tensor:
    """K3's function in plain PyTorch: float32 product of x and the widened
    q (exact for float32 and bf16 x), ``* s + b``, rounded to x's dtype."""
    x2, q, s, b, lead = _operands(x, qp)
    n = s.shape[0]
    acc = x2.float() @ q[:x2.shape[1], :n].float()
    return (acc * s + b).to(x.dtype).reshape(lead + (n,))


def quant_route(x2: torch.Tensor, q: torch.Tensor) -> str:
    """The kernel route for x2 (m, K) and q, when x2's rows are 16 bytes
    (K a multiple of 8 in bf16, of 4 in float32: TMA's rule) and x2 and q
    start on 16-byte boundaries with 16-byte row strides: ``"wgmma"`` for
    bf16 x2, ``"tf32x2"`` for float32; else ``"cuda_core"``."""
    if ((x2.shape[1] * x2.element_size()) % 16 == 0
            and _build.tma_aligned(x2, q)):
        if x2.dtype == torch.bfloat16:
            return "wgmma"
        if x2.dtype == torch.float32:
            return "tf32x2"
    return "cuda_core"


def _run_kernel(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: torch.Tensor, route: str) -> torch.Tensor:
    m, k = x2.shape
    kp, np_ = q.shape
    n = s.shape[0]
    if not all(t.is_cuda and t.device == x2.device for t in (x2, q, s, b)):
        raise ValueError("quant_matmul: x, q, s and b must be on one CUDA "
                         "device")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("quant_matmul: x must be float32 or bfloat16, got %s"
                        % x2.dtype)
    if q.dtype != torch.int8:
        raise TypeError("quant_matmul: q must be int8, got %s" % q.dtype)
    if b.shape != (n,) or n > np_ or m == 0:
        raise ValueError("quant_matmul: shapes x %s q %s s %s b %s disagree"
                         % (tuple(x2.shape), tuple(q.shape), tuple(s.shape),
                            tuple(b.shape)))
    if not q.is_contiguous():
        raise ValueError("quant_matmul: q must be contiguous")
    x2, s, b = x2.contiguous(), s.contiguous(), b.contiguous()
    lib = _build.load("quant_matmul", _declare)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    p = _build.ptr
    if route == "wgmma":
        # alignment: quant_route checked it, and the C entry refuses a
        # misaligned pointer (CUDA error 716)
        if x2.dtype != torch.bfloat16 or k % 8:
            raise ValueError("quant_matmul: the wgmma route takes bf16 x "
                             "with K a multiple of 8; got %s, K=%d"
                             % (x2.dtype, k))
        code = lib.quant_matmul_wgmma(p(x2), p(q), p(s), p(b), p(out), m, k,
                                      n, kp, np_, _build.stream_of(x2))
        _build.check(code, "quant_matmul_wgmma")
        COUNT_WGMMA.n += 1
    elif route == "tf32x2":
        if x2.dtype != torch.float32 or k % 4:
            raise ValueError("quant_matmul: the tf32x2 route takes float32 x "
                             "with K a multiple of 4; got %s, K=%d"
                             % (x2.dtype, k))
        code = lib.quant_matmul_tf32x2(p(x2), p(q), p(s), p(b), p(out), m, k,
                                       n, kp, np_, _build.stream_of(x2))
        _build.check(code, "quant_matmul_tf32x2")
        COUNT_TF32X2.n += 1
    elif route == "cuda_core":
        code = lib.quant_matmul(p(x2), p(q), p(s), p(b), p(out), m, k, n, kp,
                                np_, 0 if x2.dtype == torch.float32 else 1,
                                _build.stream_of(x2))
        _build.check(code, "quant_matmul")
    else:
        raise ValueError("quant_matmul: unknown route %r" % (route,))
    COUNT.n += 1
    return out


def _declare(lib) -> None:
    import ctypes
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul.argtypes = [vp_] * 5 + [i_] * 6 + [vp_]
    lib.quant_matmul.restype = i_
    lib.quant_matmul_wgmma.argtypes = [vp_] * 5 + [i_] * 5 + [vp_]
    lib.quant_matmul_wgmma.restype = i_
    lib.quant_matmul_tf32x2.argtypes = [vp_] * 5 + [i_] * 5 + [vp_]
    lib.quant_matmul_tf32x2.restype = i_


def quant_matmul(x: torch.Tensor, qp: dict) -> torch.Tensor:
    """x (..., K) with a quantized layer dict -> (..., N) in x's dtype.  A
    CUDA ``x`` launches the kernel on :func:`quant_route`'s route; a CPU
    ``x`` takes the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qp)
    x2, q, s, b, lead = _operands(x, qp)
    x2 = x2.contiguous()
    return _run_kernel(x2, q, s, b, quant_route(x2, q)).reshape(
        lead + (s.shape[0],))
