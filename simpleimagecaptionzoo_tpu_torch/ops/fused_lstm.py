"""Fused LSTM cell forward (kernel K2).

Counterpart of the JAX package's ``ops/pallas_lstm.py``.  One step of torch
nn.LSTMCell::

    gates = [x, h] @ w_cat + b_sum;  c' = sig(f)*c + sig(i)*tanh(g);
    h' = sig(o)*tanh(c')

with float32 accumulation and a float32 epilogue, h' and c' cast back to
their dtype: the Pallas kernel's semantics.  In bf16 that differs from the
JAX package's jnp fallback cell (``layers.py:148-150``), whose bf16 matmuls
round the gates to bf16 before the nonlinearities; the port follows the
kernel, and so does its plain version, which upcasts before its matmul.

:func:`lstm_cell_fused` launches ``csrc/fused_lstm.cu`` for CUDA tensors and
takes :func:`lstm_cell_plain` for CPU tensors only.  The kernel has three
routes, chosen by :func:`lstm_route` from dtypes, shapes and alignment:
``"wgmma"`` (bf16 on the tensor cores, TMA-fed), ``"tf32x3"`` (float32 on
the tensor cores as three TF32 products, float32-accurate: ``ops/tf32.py``)
and ``"cuda_core"`` (shapes and pointers TMA cannot take).  ``COUNT``
counts every launch, ``COUNT_WGMMA`` and ``COUNT_TF32X3`` those of the
tensor-core routes.

The backward (the JAX package's custom VJP, ``pallas_lstm.py:445-491``):
:class:`LstmCell`, a ``torch.autograd.Function``, runs the forward above
and saves (x, h, c, w_cat, b_sum), as JAX's ``_cell_fwd`` does; its
backward launches ``fused_lstm_cell_bwd`` (:func:`lstm_cell_bwd`: the
forward's product again, on the forward's route and tiles, with an
epilogue that forms the gate gradients, so the recomputed gates never
reach memory) and finishes with three float32 products (dxh = d_gates
W^T, dW = [x, h]^T d_gates, db = sum d_gates), each cotangent cast to its
primal's dtype, as JAX's.  The recompute is in float32, the function the
forward computes; in bf16 JAX's recompute rounds the gates to bf16 first,
so bf16 gradients differ from JAX's by about a bf16 ulp of the gates.
``COUNT_BWD``, ``COUNT_BWD_WGMMA`` and ``COUNT_BWD_TF32X3`` count the
backward's launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from simpleimagecaptionzoo_tpu_torch.ops import _build, tf32

COUNT = _build.Counter()           # every launch, any route
COUNT_WGMMA = _build.Counter()     # launches of the "wgmma" route
COUNT_TF32X3 = _build.Counter()    # launches of the "tf32x3" route
COUNT_BWD = _build.Counter()       # every launch of the backward, any route
COUNT_BWD_WGMMA = _build.Counter()
COUNT_BWD_TF32X3 = _build.Counter()


class LstmWeights(NamedTuple):
    """The cell's weights prepared for the kernel: w_cat (E+H, 4H), b_sum
    (4H,) in the params' dtype, and, for float32, w_cat's TF32 split for
    the "tf32x3" route (else None)."""
    w_cat: torch.Tensor
    b_sum: torch.Tensor
    split: Optional[tf32.Split]


def prepare_lstm(params: dict) -> LstmWeights:
    """LSTM param dict -> :class:`LstmWeights`.  Loop-invariant: compute
    once per decode (or training step), not per step.  w_cat and b_sum
    carry autograd's graph to the params; the TF32 split is made from a
    detached w_cat, so autograd neither tracks nor keeps it."""
    w_cat = torch.cat([params["w_ih"], params["w_hh"]], dim=0).contiguous()
    split = (tf32.prepare_split(w_cat.detach())
             if w_cat.dtype == torch.float32 else None)
    return LstmWeights(w_cat, (params["b_ih"] + params["b_hh"]).contiguous(),
                       split)


def gate_math(gates: torch.Tensor, c: torch.Tensor):
    """i, f, g, o gate blocks -> (h', c') in the dtype of ``gates`` (the
    JAX package's ``layers._gate_math``)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """K2's function in plain PyTorch: float32 gates and epilogue."""
    gates = (torch.cat([x, h], dim=-1).float() @ w_cat.float()
             + b_sum.float())
    h_new, c_new = gate_math(gates, c.float())
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_cell_bwd_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                        x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                        dh_new: torch.Tensor, dc_new: torch.Tensor):
    """K2 backward's function in plain PyTorch: the gates recomputed in
    float32 as the forward computes them, then the gate gradients of
    JAX's ``_cell_bwd`` (``pallas_lstm.py:455-491``).  -> (d_gates (B, 4H)
    float32, gates i, f, g, o; dc in c's dtype)."""
    gates = (torch.cat([x, h], dim=-1).float() @ w_cat.float()
             + b_sum.float())
    zi, zf, zg, zo = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    cf = c.float()
    tc = torch.tanh(f * cf + i * g)
    dh = dh_new.float()
    dc_total = dc_new.float() + dh * o * (1.0 - tc * tc)
    d_gates = torch.cat([dc_total * g * i * (1.0 - i),
                         dc_total * cf * f * (1.0 - f),
                         dc_total * i * (1.0 - g * g),
                         dh * tc * o * (1.0 - o)], dim=-1)
    return d_gates, (dc_total * f).to(c.dtype)


def lstm_route(w_cat: torch.Tensor, x: torch.Tensor, h: torch.Tensor) -> str:
    """The kernel route for these operands, when E and H make 16-byte rows
    (TMA) and x, h and w_cat start on 16-byte boundaries: ``"wgmma"`` when
    all are bf16, ``"tf32x3"`` when all are float32; else
    ``"cuda_core"``."""
    e, hidden = x.shape[1], h.shape[1]
    dtype = x.dtype
    if (dtype in (torch.bfloat16, torch.float32)
            and w_cat.dtype == dtype and h.dtype == dtype and e > 0
            and (e * x.element_size()) % 16 == 0
            and (hidden * x.element_size()) % 16 == 0
            and _build.tma_aligned(w_cat, x, h)):
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "cuda_core"


def lstm_bwd_route(w_cat: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                   *epilogue: torch.Tensor) -> str:
    """The backward's route: the forward's (:func:`lstm_route`), unless an
    operand of the epilogue (c, b_sum, dh', dc') breaks the tensor-core
    epilogue's pairs (two elements at once: 4-byte alignment in bf16,
    8-byte in float32), which goes to ``"cuda_core"``."""
    route = lstm_route(w_cat, x, h)
    if route != "cuda_core" and any(
            t.data_ptr() % (2 * t.element_size()) for t in epilogue):
        return "cuda_core"
    return route


def _check(ts, x, h, c, w_cat, b_sum, more=()):
    b, e = x.shape
    hidden = h.shape[1]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("fused_lstm: all tensors must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in ts):
        raise TypeError("fused_lstm: x, h, c, w_cat and b_sum must share "
                        "one dtype, float32 or bfloat16; got %s"
                        % [t.dtype for t in ts])
    if (h.shape != (b, hidden) or c.shape != (b, hidden)
            or any(t.shape != (b, hidden) for t in more)
            or w_cat.shape != (e + hidden, 4 * hidden)
            or b_sum.shape != (4 * hidden,)):
        raise ValueError("fused_lstm: shapes x %s h %s c %s w_cat %s b_sum %s "
                         "%sdisagree" % (tuple(tuple(t.shape) for t in
                                               (x, h, c, w_cat, b_sum))
                                         + ("dh' and dc' %s "
                                            % [tuple(t.shape) for t in more]
                                            if more else "",)))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_lstm: inputs must be contiguous")


def _check_split(split, x, e, hidden):
    if not all(t.shape == (4 * hidden, e + hidden) and t.is_contiguous()
               and t.dtype == torch.float32 and t.device == x.device
               for t in split):
        raise ValueError("fused_lstm: the split must be two contiguous "
                         "float32 (4H, E+H) tensors on x's device")


def _run_kernel(w_cat, b_sum, x, h, c, route, split=None):
    b, e = x.shape
    hidden = h.shape[1]
    _check((w_cat, b_sum, x, h, c), x, h, c, w_cat, b_sum)
    lib = _build.load("fused_lstm", _declare)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    p = _build.ptr
    if route == "wgmma":
        # alignment: lstm_route checked it, and the C entry refuses a
        # misaligned pointer (CUDA error 716)
        if x.dtype != torch.bfloat16 or e % 8 or hidden % 8:
            raise ValueError("fused_lstm: the wgmma route takes bf16 with E "
                             "and H multiples of 8; got %s, E=%d, H=%d"
                             % (x.dtype, e, hidden))
        code = lib.fused_lstm_cell_wgmma(
            p(x), p(h), p(c), p(w_cat), p(b_sum), p(h_out), p(c_out), b, e,
            hidden, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_wgmma")
        COUNT_WGMMA.n += 1
    elif route == "tf32x3":
        if x.dtype != torch.float32 or e % 4 or hidden % 4:
            raise ValueError("fused_lstm: the tf32x3 route takes float32 "
                             "with E and H multiples of 4; got %s, E=%d, "
                             "H=%d" % (x.dtype, e, hidden))
        if split is None:
            split = tf32.prepare_split(w_cat)
        _check_split(split, x, e, hidden)
        code = lib.fused_lstm_cell_tf32x3(
            p(x), p(h), p(c), p(split.hi), p(split.lo), p(b_sum), p(h_out),
            p(c_out), b, e, hidden, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_tf32x3")
        COUNT_TF32X3.n += 1
    elif route == "cuda_core":
        code = lib.fused_lstm_cell(
            p(x), p(h), p(c), p(w_cat), p(b_sum), p(h_out), p(c_out), b, e,
            hidden, 0 if x.dtype == torch.float32 else 1,
            _build.stream_of(x))
        _build.check(code, "fused_lstm_cell")
    else:
        raise ValueError("fused_lstm: unknown route %r" % (route,))
    COUNT.n += 1
    return h_out, c_out


def _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new, route,
                    split=None):
    """The backward kernel on ``route`` -> (d_gates (B, 4H) float32, dc)."""
    b, e = x.shape
    hidden = h.shape[1]
    _check((w_cat, b_sum, x, h, c, dh_new, dc_new), x, h, c, w_cat, b_sum,
           more=(dh_new, dc_new))
    lib = _build.load("fused_lstm", _declare)
    d_gates = torch.empty((b, 4 * hidden), dtype=torch.float32,
                          device=x.device)
    dc = torch.empty_like(c)
    p = _build.ptr
    epi = (p(dh_new), p(dc_new), p(d_gates), p(dc), b, e, hidden)
    if route == "wgmma":
        if x.dtype != torch.bfloat16 or e % 8 or hidden % 8:
            raise ValueError("fused_lstm: the wgmma route takes bf16 with E "
                             "and H multiples of 8; got %s, E=%d, H=%d"
                             % (x.dtype, e, hidden))
        code = lib.fused_lstm_cell_bwd_wgmma(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *epi, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_bwd_wgmma")
        COUNT_BWD_WGMMA.n += 1
    elif route == "tf32x3":
        if x.dtype != torch.float32 or e % 4 or hidden % 4:
            raise ValueError("fused_lstm: the tf32x3 route takes float32 "
                             "with E and H multiples of 4; got %s, E=%d, "
                             "H=%d" % (x.dtype, e, hidden))
        if split is None:
            split = tf32.prepare_split(w_cat)
        _check_split(split, x, e, hidden)
        code = lib.fused_lstm_cell_bwd_tf32x3(
            p(x), p(h), p(c), p(split.hi), p(split.lo), p(b_sum), *epi,
            _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_bwd_tf32x3")
        COUNT_BWD_TF32X3.n += 1
    elif route == "cuda_core":
        code = lib.fused_lstm_cell_bwd(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *epi,
            0 if x.dtype == torch.float32 else 1, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_bwd")
    else:
        raise ValueError("fused_lstm: unknown route %r" % (route,))
    COUNT_BWD.n += 1
    return d_gates, dc


def map_encodes() -> int:
    """TMA tensor maps the library has encoded so far, on every host thread
    (the map cache's misses; ``csrc/hopper.cuh``)."""
    return int(_build.load("fused_lstm", _declare).fused_lstm_map_encodes())


def _declare(lib) -> None:
    import ctypes
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.fused_lstm_cell.argtypes = [vp_] * 7 + [i_] * 4 + [vp_]
    lib.fused_lstm_cell.restype = i_
    lib.fused_lstm_cell_wgmma.argtypes = [vp_] * 7 + [i_] * 3 + [vp_]
    lib.fused_lstm_cell_wgmma.restype = i_
    lib.fused_lstm_cell_tf32x3.argtypes = [vp_] * 8 + [i_] * 3 + [vp_]
    lib.fused_lstm_cell_tf32x3.restype = i_
    lib.fused_lstm_cell_bwd.argtypes = [vp_] * 9 + [i_] * 4 + [vp_]
    lib.fused_lstm_cell_bwd.restype = i_
    lib.fused_lstm_cell_bwd_wgmma.argtypes = [vp_] * 9 + [i_] * 3 + [vp_]
    lib.fused_lstm_cell_bwd_wgmma.restype = i_
    lib.fused_lstm_cell_bwd_tf32x3.argtypes = [vp_] * 10 + [i_] * 3 + [vp_]
    lib.fused_lstm_cell_bwd_tf32x3.restype = i_
    lib.fused_lstm_map_encodes.argtypes = []
    lib.fused_lstm_map_encodes.restype = ctypes.c_ulonglong


def lstm_cell_fused(w_cat: torch.Tensor, b_sum: torch.Tensor,
                    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    split: Optional[tf32.Split] = None):
    """(h', c') of one cell step from :func:`prepare_lstm`'s weights.  A
    CUDA ``x`` launches the kernel on :func:`lstm_route`'s route; a CPU
    ``x`` takes the plain version (on the unsplit w_cat).  ``split`` is
    :func:`prepare_lstm`'s; without it the "tf32x3" route splits w_cat for
    this call."""
    if x.device.type == "cpu":
        return lstm_cell_plain(w_cat, b_sum, x, h, c)
    return _run_kernel(w_cat, b_sum, x, h, c, lstm_route(w_cat, x, h), split)


def lstm_cell_bwd(w_cat: torch.Tensor, b_sum: torch.Tensor, x: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor, dh_new: torch.Tensor,
                  dc_new: torch.Tensor, split: Optional[tf32.Split] = None):
    """K2's backward kernel: (d_gates (B, 4H) float32, dc) from the
    forward's inputs and the cotangents dh', dc' (c's dtype, contiguous).
    A CUDA ``x`` launches ``fused_lstm_cell_bwd`` on
    :func:`lstm_bwd_route`'s route; a CPU ``x`` takes
    :func:`lstm_cell_bwd_plain`."""
    if x.device.type == "cpu":
        return lstm_cell_bwd_plain(w_cat, b_sum, x, h, c, dh_new, dc_new)
    return _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new,
                           lstm_bwd_route(w_cat, x, h, c, b_sum, dh_new,
                                          dc_new), split)


class LstmCell(torch.autograd.Function):
    """One cell step under autograd: (w_cat, b_sum, x, h, c, split_hi,
    split_lo) -> (h', c').  The forward runs :func:`lstm_cell_fused` and
    saves its inputs; the backward runs :func:`lstm_cell_bwd` and the three
    float32 products.  The TF32 split (float32 only, else None) is a
    detached input that gets no gradient."""

    @staticmethod
    def forward(ctx, w_cat, b_sum, x, h, c, split_hi, split_lo):
        split = None if split_hi is None else tf32.Split(split_hi, split_lo)
        h_new, c_new = lstm_cell_fused(w_cat, b_sum, x, h, c, split)
        ctx.save_for_backward(x, h, c, w_cat, b_sum, split_hi, split_lo)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        x, h, c, w_cat, b_sum, hi, lo = ctx.saved_tensors
        split = None if hi is None else tf32.Split(hi, lo)
        d_gates, dc = lstm_cell_bwd(w_cat, b_sum, x, h, c,
                                    dh_new.to(h.dtype).contiguous(),
                                    dc_new.to(c.dtype).contiguous(), split)
        e = x.shape[1]
        dxh = d_gates @ w_cat.float().t()
        dw = torch.cat([x, h], dim=-1).float().t() @ d_gates
        return (dw.to(w_cat.dtype), d_gates.sum(dim=0).to(b_sum.dtype),
                dxh[:, :e].to(x.dtype), dxh[:, e:].to(h.dtype), dc, None,
                None)


def lstm_cell_train(w: LstmWeights, x: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor):
    """(h', c') of one cell step through :class:`LstmCell`, for a step
    whose gradient autograd needs."""
    hi, lo = w.split if w.split is not None else (None, None)
    return LstmCell.apply(w.w_cat, w.b_sum, x, h, c, hi, lo)
