"""Fused LSTM cell forward (kernel K2).

Counterpart of the JAX package's ``ops/pallas_lstm.py``.  One step of torch
nn.LSTMCell::

    gates = [x, h] @ w_cat + b_sum;  c' = sig(f)*c + sig(i)*tanh(g);
    h' = sig(o)*tanh(c')

with float32 accumulation and a float32 epilogue, h' and c' cast back to
their dtype: the Pallas kernel's semantics.

The gate term (the JAX package's default mode, ``models/layers.py:162``
``lstm_cell_gates``): the part of a cell's input that is projected once
outside the step loop arrives as ``term`` (R, 4H) in x's dtype, and the
kernel computes ``[x, h] @ w_cat + b_sum + term[row // lanes]`` with the
term added in its float32 epilogue, after the bias.  ``lanes`` is k in beam
search (the k lanes of a sample read one row in place) and 1 elsewhere.
``w_cat`` then holds only the rows of ``w_ih`` that stay in the step, then
``w_hh``, and ``b_sum`` is ``b_hh`` (:func:`prepare_lstm` with ``keep``);
E may be 0 (NIC's teacher-forced cell).  The term is read by plain loads,
so a new slice each step costs no tensor map.  In bf16 that differs from the
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

The backward (the JAX package's custom VJP, ``pallas_lstm.py:445-491``;
its ``_cell_bwd`` at ``:455`` is jnp around the Pallas forward: the gate
recompute, the gate gradients, and three float32 products):
:class:`LstmCell`, a ``torch.autograd.Function``, runs the forward above
and saves (x, h, c, w_cat, b_sum), as JAX's ``_cell_fwd`` does; its
backward calls :func:`lstm_cell_bwd_full`, which returns (dW, db, dx, dh,
dc), each in its primal's dtype, from at most three launches and no
library call:

1. ``fused_lstm_cell_bwd`` (:func:`lstm_cell_bwd` alone): the forward's
   product again, on the forward's route and tiles, with an epilogue that
   forms the gate gradients (d_gates, float32 in both dtypes, as JAX's),
   so the recomputed gates never reach memory.  On the tensor-core routes
   it also writes d_gates in the form the products load (a
   :class:`GateGrads`): on "wgmma" its two bf16 parts (:func:`split_bf16`,
   d_hi + d_lo within 2^-16 |d|), on "tf32x3" its transpose's two TF32
   parts.
2. dx·dh = d_gates w_cat^T (``csrc/lstm_bwd.cu``): 2xBF16 (d_hi w + d_lo w,
   :func:`mm_2xbf16`) or 3xTF32 (``tf32.mm_3xtf32``), float32-accurate
   as JAX's float32 products; the reduction over 4H split across blocks
   (:func:`dxh_splits`) and summed in a fixed order.
3. dW = [x, h]^T d_gates and db = the batch sums of d_gates, one launch.

No float atomics: a step's gradients are the same bits from run to run.
Bound at the XE shape (B=128, E=2,048, H=1,024; the recompute and two
products, w_cat read twice, dW written once; H100 SXM): 0.023 ms in bf16
(bytes), 0.059 ms in float32 (three TF32 products at a third of 494.7
TFLOP/s).  The products take the tensor cores where the backward kernel
does and E is a multiple of 64 (:func:`lstm_bwd_products_route`); else
(E=200, or pointers TMA cannot take) the backward kernel runs on its own
route and the products are float32 ``torch.matmul`` calls, as the JAX
package leaves them to XLA: chosen by shape and counted, never a fallback
from a failure.  The recompute is in float32, the function the forward
computes; in bf16 JAX's recompute rounds the gates to bf16 first, so bf16
gradients differ from JAX's by about a bf16 ulp of the gates.  A
cotangent autograd did not form (the last step's c') reaches the backward
as None and the kernel reads it as zero (``set_materialize_grads(False)``:
no zero fill).  ``COUNT_BWD`` (``_WGMMA``, ``_TF32X3``) count the backward
kernel's launches, ``COUNT_DXH`` and ``COUNT_DW`` (and theirs by route)
the products'.  Plain versions: :func:`lstm_cell_bwd_plain`,
:func:`lstm_bwd_dxh_plain`, :func:`lstm_bwd_dw_plain`,
:func:`lstm_bwd_products_plain` and the whole :func:`lstm_cell_bwd_full_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.ops import _build, tf32

COUNT = _build.Counter()           # every launch, any route
COUNT_WGMMA = _build.Counter()     # launches of the "wgmma" route
COUNT_TF32X3 = _build.Counter()    # launches of the "tf32x3" route
COUNT_BWD = _build.Counter()       # every launch of the backward, any route
COUNT_BWD_WGMMA = _build.Counter()
COUNT_BWD_TF32X3 = _build.Counter()
COUNT_DXH = _build.Counter()       # the backward's dx·dh kernel, any route
COUNT_DXH_WGMMA = _build.Counter()
COUNT_DXH_TF32X3 = _build.Counter()
COUNT_DW = _build.Counter()        # the backward's dW·db kernel, any route
COUNT_DW_WGMMA = _build.Counter()
COUNT_DW_TF32X3 = _build.Counter()


class LstmWeights(NamedTuple):
    """The cell's weights prepared for the kernel: w_cat (E+H, 4H), b_sum
    (4H,) in the params' dtype, and, for float32, w_cat's TF32 split for
    the "tf32x3" route (else None)."""
    w_cat: torch.Tensor
    b_sum: torch.Tensor
    split: Optional[tf32.Split]


def prepare_lstm(params: dict, keep=None) -> LstmWeights:
    """LSTM param dict -> :class:`LstmWeights`.  Loop-invariant: compute
    once per decode (or training step), not per step.  w_cat and b_sum
    carry autograd's graph to the params; the TF32 split is made from a
    detached w_cat, so autograd neither tracks nor keeps it.

    ``keep``: None for the whole cell (w_cat = [w_ih; w_hh], b_sum = b_ih
    + b_hh); else the hoisted form, a sequence of (start, stop) row ranges
    of ``w_ih`` that stay in the step (possibly none): w_cat = those rows
    of w_ih, then w_hh, and b_sum = b_hh alone (``b_ih`` rides in the gate
    term)."""
    if keep is None:
        w_cat = torch.cat([params["w_ih"], params["w_hh"]], dim=0)
        b_sum = params["b_ih"] + params["b_hh"]
    else:
        w_cat = torch.cat([params["w_ih"][a:b] for a, b in keep]
                          + [params["w_hh"]], dim=0)
        b_sum = params["b_hh"]
    w_cat = w_cat.contiguous()
    split = (tf32.prepare_split(w_cat.detach())
             if w_cat.dtype == torch.float32 else None)
    return LstmWeights(w_cat, b_sum.contiguous(), split)


def _term_rows(term: Optional[torch.Tensor], lanes: int, acc):
    """The term's row for each row of the cell, in ``acc``: row r reads
    term row r // lanes (None stays None)."""
    if term is None:
        return None
    t = term.to(acc)
    return t if lanes == 1 else t.repeat_interleave(lanes, dim=0)


def _gates_plain(w_cat, b_sum, x, h, term, lanes, acc):
    """[x, h] @ w_cat + b_sum (+ the term's rows) in ``acc``, the kernel's
    order: the product, then the bias, then the term."""
    gates = torch.cat([x, h], dim=-1).to(acc) @ w_cat.to(acc) + b_sum.to(acc)
    if term is not None:
        gates = gates + _term_rows(term, lanes, acc)
    return gates


def gate_math(gates: torch.Tensor, c: torch.Tensor):
    """i, f, g, o gate blocks -> (h', c') in the dtype of ``gates`` (the
    JAX package's ``layers._gate_math``)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    term: Optional[torch.Tensor] = None, lanes: int = 1):
    """K2's function in plain PyTorch: float32 gates and epilogue (float64
    for float64 inputs, the exact reference ``engine/holds.py`` holds the
    float32 kernel against), with the gate term where one is given."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    gates = _gates_plain(w_cat, b_sum, x, h, term, lanes, acc)
    h_new, c_new = gate_math(gates, c.to(acc))
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_cell_bwd_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                        x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                        dh_new: Optional[torch.Tensor],
                        dc_new: Optional[torch.Tensor],
                        term: Optional[torch.Tensor] = None, lanes: int = 1):
    """K2 backward's function in plain PyTorch: the gates recomputed in
    float32 as the forward computes them (with the gate term where one is
    given), then the gate gradients of JAX's ``_cell_bwd``
    (``pallas_lstm.py:455-491``).  A cotangent of None (one autograd did
    not form) is zero.  -> (d_gates (B, 4H) float32, gates i, f, g, o; dc
    in c's dtype); float64 throughout for float64 inputs, the exact
    reference ``engine/holds.py`` holds the float32 kernels against.  The
    term's gradient is d_gates (:func:`term_grad`)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    gates = _gates_plain(w_cat, b_sum, x, h, term, lanes, acc)
    zi, zf, zg, zo = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    cf = c.to(acc)
    tc = torch.tanh(f * cf + i * g)
    dh = torch.zeros_like(cf) if dh_new is None else dh_new.to(acc)
    dc_total = dh * o * (1.0 - tc * tc)
    if dc_new is not None:
        dc_total = dc_total + dc_new.to(acc)
    d_gates = torch.cat([dc_total * g * i * (1.0 - i),
                         dc_total * cf * f * (1.0 - f),
                         dc_total * i * (1.0 - g * g),
                         dh * tc * o * (1.0 - o)], dim=-1)
    return d_gates, (dc_total * f).to(c.dtype)


def term_grad(d: torch.Tensor, term: torch.Tensor, lanes: int = 1):
    """The gate term's gradient from the rows' gate gradients ``d`` (B, 4H)
    (float32 d_gates, or the backward kernel's d_term): each term row's
    lanes summed (in float32, float64 for float64), in the term's dtype
    (float64 stays float64)."""
    if lanes > 1:
        acc = torch.float64 if d.dtype == torch.float64 else torch.float32
        d = d.to(acc).reshape(-1, lanes, d.shape[-1]).sum(dim=1)
    out = term.dtype if d.dtype != torch.float64 else torch.float64
    return d.to(out)


def split_bf16(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 d -> (d_hi, d_lo), both bf16: d_hi = bf16(d), d_lo =
    bf16(d - d_hi), so d_hi + d_lo is d within 2^-16 |d| (bf16 rounds to
    8 significant bits, twice).  The operands of the bf16 products of K2's
    backward (the backward kernel's epilogue forms them)."""
    hi = d.to(torch.bfloat16)
    return hi, (d - hi.float()).to(torch.bfloat16)


def mm_2xbf16(a_hi: torch.Tensor, a_lo: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The 2xBF16 product of the bf16 kernels, in plain PyTorch: a_hi b +
    a_lo b summed in float32.  Each bf16 product of two bf16 values is
    exact in float32, so with ``split_bf16``'s parts and a bf16 ``b`` this
    is the float32 product of a b to the 2^-16 of the split."""
    bf = b.float()
    return a_hi.float() @ bf + a_lo.float() @ bf


def lstm_bwd_products_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                            x: torch.Tensor, h: torch.Tensor,
                            d_gates: torch.Tensor):
    """The products of K2's backward in plain PyTorch, float32 (float64
    for float64 d_gates), as JAX's ``_cell_bwd`` forms them
    (``pallas_lstm.py:478-487``): dxh = d_gates w_cat^T, dW = [x, h]^T
    d_gates, db = the sum of d_gates over the batch.  -> (dW in w_cat's
    dtype, db in b_sum's, dx in x's, dh in h's)."""
    dx, dh = lstm_bwd_dxh_plain(w_cat, d_gates, x.shape[1])
    dw, db = lstm_bwd_dw_plain(x, h, d_gates)
    return (dw.to(w_cat.dtype), db.to(b_sum.dtype), dx.to(x.dtype),
            dh.to(h.dtype))


def lstm_bwd_dxh_plain(w_cat: torch.Tensor, d_gates: torch.Tensor, e: int):
    """The dx·dh kernel's function: d_gates w_cat^T in d_gates' precision
    (float32, or float64), split at column ``e`` -> (dx, dh) in w_cat's
    dtype (float64 stays float64)."""
    dxh = d_gates @ w_cat.to(d_gates.dtype).t()
    out = w_cat.dtype if d_gates.dtype != torch.float64 else torch.float64
    return dxh[:, :e].to(out), dxh[:, e:].to(out)


def lstm_bwd_dw_plain(x: torch.Tensor, h: torch.Tensor,
                      d_gates: torch.Tensor):
    """The dW·db kernel's function: [x, h]^T d_gates and the column sums of
    d_gates, in d_gates' precision -> (dW, db) in x's dtype (float64 stays
    float64)."""
    dw = torch.cat([x, h], dim=-1).to(d_gates.dtype).t() @ d_gates
    out = x.dtype if d_gates.dtype != torch.float64 else torch.float64
    return dw.to(out), d_gates.sum(dim=0).to(out)


def lstm_cell_bwd_full_plain(w_cat: torch.Tensor, b_sum: torch.Tensor,
                             x: torch.Tensor, h: torch.Tensor,
                             c: torch.Tensor, dh_new: Optional[torch.Tensor],
                             dc_new: Optional[torch.Tensor],
                             term: Optional[torch.Tensor] = None,
                             lanes: int = 1):
    """The whole of K2's backward in plain PyTorch: JAX's ``_cell_bwd``
    with float32 products (:func:`lstm_cell_bwd_plain`, then
    :func:`lstm_bwd_products_plain`; float64 for float64 inputs) -> (dW,
    db, dx, dh, dc), each in its primal's dtype; with a gate term, then
    d_term (:func:`term_grad`)."""
    d_gates, dc = lstm_cell_bwd_plain(w_cat, b_sum, x, h, c, dh_new, dc_new,
                                      term, lanes)
    out = lstm_bwd_products_plain(w_cat, b_sum, x, h, d_gates) + (dc,)
    if term is None:
        return out
    return out + (term_grad(d_gates, term, lanes),)


def lstm_route(w_cat: torch.Tensor, x: torch.Tensor, h: torch.Tensor) -> str:
    """The kernel route for these operands, when E and H make 16-byte rows
    (TMA) and x, h and w_cat start on 16-byte boundaries: ``"wgmma"`` when
    all are bf16, ``"tf32x3"`` when all are float32; else
    ``"cuda_core"``.  E = 0 (a cell whose whole input is hoisted into the
    gate term) takes the tensor-core routes: no step reads x, and x needs
    no alignment."""
    e, hidden = x.shape[1], h.shape[1]
    dtype = x.dtype
    if (dtype in (torch.bfloat16, torch.float32)
            and w_cat.dtype == dtype and h.dtype == dtype
            and (e * x.element_size()) % 16 == 0
            and (hidden * x.element_size()) % 16 == 0
            and _build.tma_aligned(w_cat, h, *((x,) if e else ()))):
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "cuda_core"


def lstm_bwd_route(w_cat: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                   *epilogue: torch.Tensor) -> str:
    """The backward's route: the forward's (:func:`lstm_route`), unless an
    operand of the epilogue (c, b_sum, the term, dh', dc'; the term and a
    cotangent may be None) breaks the tensor-core
    epilogue's pairs (two elements at once: 4-byte alignment in bf16,
    8-byte in float32), which goes to ``"cuda_core"``."""
    route = lstm_route(w_cat, x, h)
    if route != "cuda_core" and any(
            t is not None and t.data_ptr() % (2 * t.element_size())
            for t in epilogue):
        return "cuda_core"
    return route


def lstm_bwd_products_route(w_cat: torch.Tensor, x: torch.Tensor,
                            h: torch.Tensor, *epilogue: torch.Tensor) -> str:
    """The route of the backward's products: the backward kernel's
    (:func:`lstm_bwd_route`) when that is a tensor-core route and E is a
    multiple of 64, 0 included (dW's boxes of x and h then never straddle
    the two):
    ``"wgmma"`` (2xBF16) or ``"tf32x3"`` (3xTF32), kernels of
    ``csrc/lstm_bwd.cu``; else ``"cuda_core"``, where they are float32
    ``torch.matmul`` products, as the JAX package leaves them to XLA."""
    route = lstm_bwd_route(w_cat, x, h, *epilogue)
    if route != "cuda_core" and x.shape[1] % 64 == 0:
        return route
    return "cuda_core"


def dxh_splits(b: int, e: int, hidden: int, sms: int, route: str) -> int:
    """How many blocks share the reduction of each 128 x 128 tile of the
    dx·dh kernel: at most one wave, one block an SM over the ``sms`` of the
    card, each split at least 4 stages deep (64 values of 4H a stage in
    bf16, 32 in float32), at least 1; and at most 8 on the "tf32x3" route
    and 3 on "wgmma", the fastest at every training cell on the H100
    (``scripts/probe_lstm_bwd.py --splits``: the last block of a tile sums
    the others' partials, a round of loads each, which the shorter bf16
    stages do not pay back)."""
    tiles = -(-(e + hidden) // 128) * -(-b // 128)
    stages = -(-(4 * hidden) // (64 if route == "wgmma" else 32))
    cap = 3 if route == "wgmma" else 8
    return max(1, min(cap, stages // 4, sms // tiles))


def _check_term(term, lanes, x, hidden):
    """The gate term: (rows / lanes, 4H), contiguous, in x's dtype, on x's
    device, lanes >= 1 dividing the rows; None passes."""
    if term is None:
        return
    b = x.shape[0]
    if not (isinstance(lanes, int) and lanes >= 1 and b % lanes == 0
            and term.shape == (b // lanes, 4 * hidden)
            and term.is_contiguous() and term.dtype == x.dtype
            and term.device == x.device):
        raise ValueError(
            "fused_lstm: the gate term must be a contiguous (rows / lanes, "
            "4H) tensor of x's dtype on x's device, lanes dividing the rows; "
            "got %s %s%s for %d rows, H=%d, lanes %r"
            % (tuple(term.shape), term.dtype,
               "" if term.is_contiguous() else " (not contiguous)", b,
               hidden, lanes))


def _check(ts, x, h, c, w_cat, b_sum, more=(), term=None, lanes=1):
    b, e = x.shape
    hidden = h.shape[1]
    _check_term(term, lanes, x, hidden)
    ts = tuple(t for t in ts if t is not None)
    more = tuple(t for t in more if t is not None)
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


def _run_kernel(w_cat, b_sum, x, h, c, route, split=None, term=None,
                lanes=1):
    b, e = x.shape
    hidden = h.shape[1]
    _check((w_cat, b_sum, x, h, c), x, h, c, w_cat, b_sum, term=term,
           lanes=lanes)
    lib = _build.load("fused_lstm", _declare)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    p = _build.ptr
    t = (_build.ptr_or_null(term), lanes)
    if route == "wgmma":
        # alignment: lstm_route checked it, and the C entry refuses a
        # misaligned pointer (CUDA error 716)
        if x.dtype != torch.bfloat16 or e % 8 or hidden % 8:
            raise ValueError("fused_lstm: the wgmma route takes bf16 with E "
                             "and H multiples of 8; got %s, E=%d, H=%d"
                             % (x.dtype, e, hidden))
        code = lib.fused_lstm_cell_wgmma(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *t, p(h_out), p(c_out), b,
            e, hidden, _build.stream_of(x))
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
            p(x), p(h), p(c), p(split.hi), p(split.lo), p(b_sum), *t,
            p(h_out), p(c_out), b, e, hidden, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_tf32x3")
        COUNT_TF32X3.n += 1
    elif route == "cuda_core":
        code = lib.fused_lstm_cell(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *t, p(h_out), p(c_out), b,
            e, hidden, 0 if x.dtype == torch.float32 else 1,
            _build.stream_of(x))
        _build.check(code, "fused_lstm_cell")
    else:
        raise ValueError("fused_lstm: unknown route %r" % (route,))
    COUNT.n += 1
    return h_out, c_out


class GateGrads(NamedTuple):
    """The backward kernel's gate gradients in the forms the products
    load: ``d`` (B, 4H) float32 on every route; on the "wgmma" route
    ``hi``, ``lo``, d's bf16 parts (B, 4H) (:func:`split_bf16`); on the
    "tf32x3" route d^T's TF32 parts (4H, pitch), pitch B rounded up to a
    multiple of 4 (``tf32.split_tf32``); else None."""
    d: torch.Tensor
    hi: Optional[torch.Tensor]
    lo: Optional[torch.Tensor]


def _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new, route,
                    split=None, parts=False, term=None, lanes=1):
    """The backward kernel on ``route`` -> (d_gates (B, 4H) float32, dc);
    with ``parts`` (a tensor-core route) -> (:class:`GateGrads`, dc), the
    products' operands written beside d_gates.  A cotangent may be None
    (zero).  With a gate term, a third value: d_term (B, 4H) in the term's
    dtype, d_gates itself in float32, written by the kernel in bf16."""
    b, e = x.shape
    hidden = h.shape[1]
    _check((w_cat, b_sum, x, h, c, dh_new, dc_new), x, h, c, w_cat, b_sum,
           more=(dh_new, dc_new), term=term, lanes=lanes)
    if parts and route == "cuda_core":
        raise ValueError("fused_lstm: the products' operands come from a "
                         "tensor-core route")
    lib = _build.load("fused_lstm", _declare)
    d_gates = torch.empty((b, 4 * hidden), dtype=torch.float32,
                          device=x.device)
    dc = torch.empty_like(c)
    d_term = (None if term is None or x.dtype == torch.float32
              else torch.empty((b, 4 * hidden), dtype=x.dtype,
                               device=x.device))
    hi = lo = None
    p, opt = _build.ptr, _build.ptr_or_null
    epi = (opt(term), lanes, opt(dh_new), opt(dc_new), p(d_gates), p(dc),
           opt(d_term))
    dims = (b, e, hidden)
    if route == "wgmma":
        if x.dtype != torch.bfloat16 or e % 8 or hidden % 8:
            raise ValueError("fused_lstm: the wgmma route takes bf16 with E "
                             "and H multiples of 8; got %s, E=%d, H=%d"
                             % (x.dtype, e, hidden))
        if parts:
            hi = torch.empty((b, 4 * hidden), dtype=torch.bfloat16,
                             device=x.device)
            lo = torch.empty_like(hi)
        code = lib.fused_lstm_cell_bwd_wgmma(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *epi, opt(hi), opt(lo),
            *dims, _build.stream_of(x))
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
        pitch = -(-b // 4) * 4
        if parts:
            hi = torch.empty((4 * hidden, pitch), dtype=torch.float32,
                             device=x.device)
            lo = torch.empty_like(hi)
        code = lib.fused_lstm_cell_bwd_tf32x3(
            p(x), p(h), p(c), p(split.hi), p(split.lo), p(b_sum), *epi,
            opt(hi), opt(lo), pitch, *dims, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_bwd_tf32x3")
        COUNT_BWD_TF32X3.n += 1
    elif route == "cuda_core":
        code = lib.fused_lstm_cell_bwd(
            p(x), p(h), p(c), p(w_cat), p(b_sum), *epi, *dims,
            0 if x.dtype == torch.float32 else 1, _build.stream_of(x))
        _build.check(code, "fused_lstm_cell_bwd")
    else:
        raise ValueError("fused_lstm: unknown route %r" % (route,))
    COUNT_BWD.n += 1
    g = GateGrads(d_gates, hi, lo) if parts else d_gates
    if term is None:
        return g, dc
    return g, dc, d_gates if d_term is None else d_term


_SMS = {}           # device index -> its SM count
_TILE_COUNTS = {}   # device index -> dx·dh's per-tile counters, zero at rest


def _sms(device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _tile_counts(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, zero: made once (the
    kernel leaves them zero after every launch)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    have = _TILE_COUNTS.get(i)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TILE_COUNTS[i] = have
    return have


def _check_products(w_cat, x, h, route):
    b, e = x.shape
    hidden = h.shape[1]
    want = torch.bfloat16 if route == "wgmma" else torch.float32
    if route not in ("wgmma", "tf32x3"):
        raise ValueError("fused_lstm: the products' kernels take the wgmma "
                         "or tf32x3 route, not %r" % (route,))
    if (x.dtype != want or h.dtype != want or w_cat.dtype != want
            or e % 64 or hidden % (8 if route == "wgmma" else 4)
            or w_cat.shape != (e + hidden, 4 * hidden)):
        raise ValueError("fused_lstm: the %s products take %s x, h and "
                         "w_cat, E a multiple of 64 (0 included); got %s, "
                         "E=%d, H=%d"
                         % (route, want, x.dtype, e, hidden))


def _run_dxh_kernel(w_cat, g: GateGrads, x, h, route):
    """dx·dh = d_gates w_cat^T on ``route``'s kernel -> (dx, dh) in x's and
    h's dtype."""
    _check_products(w_cat, x, h, route)
    b, e = x.shape
    hidden = h.shape[1]
    lib = _build.load("lstm_bwd", _declare_products)
    dx = torch.empty_like(x)
    dh = torch.empty_like(h)
    splits = dxh_splits(b, e, hidden, _sms(x.device), route)
    ws = count = None
    if splits > 1:
        ws = torch.empty((splits, b, e + hidden), dtype=torch.float32,
                         device=x.device)
        count = _tile_counts(x.device, -(-(e + hidden) // 128) * -(-b // 128))
    p, opt = _build.ptr, _build.ptr_or_null
    if route == "wgmma":
        code = lib.lstm_bwd_dxh_wgmma(p(g.hi), p(g.lo), p(w_cat), p(dx), p(dh),
                                      opt(ws), opt(count), b, e, hidden,
                                      splits, _build.stream_of(x))
        COUNT_DXH_WGMMA.n += 1
    else:
        code = lib.lstm_bwd_dxh_tf32x3(p(g.d), p(w_cat), p(dx), p(dh),
                                       opt(ws), opt(count), b, e, hidden,
                                       splits, _build.stream_of(x))
        COUNT_DXH_TF32X3.n += 1
    _build.check(code, "lstm_bwd_dxh_" + route)
    COUNT_DXH.n += 1
    return dx, dh


def _run_dw_kernel(x, h, g: GateGrads, w_cat, b_sum, route):
    """dW = [x, h]^T d_gates and db = its column sums on ``route``'s
    kernel -> (dW in w_cat's dtype, db in b_sum's)."""
    _check_products(w_cat, x, h, route)
    if b_sum.dtype != w_cat.dtype or b_sum.shape != (w_cat.shape[1],):
        raise ValueError("fused_lstm: b_sum must be (4H,) in w_cat's dtype")
    b, e = x.shape
    hidden = h.shape[1]
    lib = _build.load("lstm_bwd", _declare_products)
    dw = torch.empty_like(w_cat)
    db = torch.empty_like(b_sum)
    p = _build.ptr
    if route == "wgmma":
        code = lib.lstm_bwd_dw_wgmma(p(x), p(h), p(g.hi), p(g.lo), p(g.d),
                                     p(dw), p(db), b, e, hidden,
                                     _build.stream_of(x))
        COUNT_DW_WGMMA.n += 1
    else:
        code = lib.lstm_bwd_dw_tf32x3(p(x), p(h), p(g.hi), p(g.lo),
                                      g.hi.shape[1], p(g.d), p(dw), p(db), b,
                                      e, hidden, _build.stream_of(x))
        COUNT_DW_TF32X3.n += 1
    _build.check(code, "lstm_bwd_dw_" + route)
    COUNT_DW.n += 1
    return dw, db


def map_encodes() -> int:
    """TMA tensor maps the forward and backward libraries have encoded so
    far, on every host thread (the map caches' misses;
    ``csrc/hopper.cuh``)."""
    return int(_build.load("fused_lstm", _declare).fused_lstm_map_encodes()
               + _build.load("lstm_bwd",
                             _declare_products).lstm_bwd_map_encodes())


def _declare(lib) -> None:
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    # every entry: ..., b_sum, term, lanes, ...
    lib.fused_lstm_cell.argtypes = ([vp_] * 6 + [i_] + [vp_] * 2 + [i_] * 4
                                    + [vp_])
    lib.fused_lstm_cell.restype = i_
    lib.fused_lstm_cell_wgmma.argtypes = ([vp_] * 6 + [i_] + [vp_] * 2
                                          + [i_] * 3 + [vp_])
    lib.fused_lstm_cell_wgmma.restype = i_
    lib.fused_lstm_cell_tf32x3.argtypes = ([vp_] * 7 + [i_] + [vp_] * 2
                                           + [i_] * 3 + [vp_])
    lib.fused_lstm_cell_tf32x3.restype = i_
    lib.fused_lstm_cell_bwd.argtypes = ([vp_] * 6 + [i_] + [vp_] * 5
                                        + [i_] * 4 + [vp_])
    lib.fused_lstm_cell_bwd.restype = i_
    lib.fused_lstm_cell_bwd_wgmma.argtypes = ([vp_] * 6 + [i_] + [vp_] * 7
                                              + [i_] * 3 + [vp_])
    lib.fused_lstm_cell_bwd_wgmma.restype = i_
    lib.fused_lstm_cell_bwd_tf32x3.argtypes = ([vp_] * 7 + [i_] + [vp_] * 7
                                               + [i_] * 4 + [vp_])
    lib.fused_lstm_cell_bwd_tf32x3.restype = i_
    lib.fused_lstm_map_encodes.argtypes = []
    lib.fused_lstm_map_encodes.restype = ctypes.c_ulonglong


def _declare_products(lib) -> None:
    vp_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bwd_dxh_wgmma.argtypes = [vp_] * 7 + [i_] * 4 + [vp_]
    lib.lstm_bwd_dxh_wgmma.restype = i_
    lib.lstm_bwd_dxh_tf32x3.argtypes = [vp_] * 6 + [i_] * 4 + [vp_]
    lib.lstm_bwd_dxh_tf32x3.restype = i_
    lib.lstm_bwd_dw_wgmma.argtypes = [vp_] * 7 + [i_] * 3 + [vp_]
    lib.lstm_bwd_dw_wgmma.restype = i_
    lib.lstm_bwd_dw_tf32x3.argtypes = [vp_] * 4 + [i_] + [vp_] * 3 + \
        [i_] * 3 + [vp_]
    lib.lstm_bwd_dw_tf32x3.restype = i_
    lib.lstm_bwd_map_encodes.argtypes = []
    lib.lstm_bwd_map_encodes.restype = ctypes.c_ulonglong


def lstm_cell_fused(w_cat: torch.Tensor, b_sum: torch.Tensor,
                    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    split: Optional[tf32.Split] = None,
                    term: Optional[torch.Tensor] = None, lanes: int = 1):
    """(h', c') of one cell step from :func:`prepare_lstm`'s weights.  A
    CUDA ``x`` launches the kernel on :func:`lstm_route`'s route; a CPU
    ``x`` takes the plain version (on the unsplit w_cat).  ``split`` is
    :func:`prepare_lstm`'s; without it the "tf32x3" route splits w_cat for
    this call.  ``term`` (rows / lanes, 4H) in x's dtype, or None: the gate
    term, row r of the cell adding term row r // lanes."""
    if x.device.type == "cpu":
        _check_term(term, lanes, x, h.shape[1])
        return lstm_cell_plain(w_cat, b_sum, x, h, c, term, lanes)
    return _run_kernel(w_cat, b_sum, x, h, c, lstm_route(w_cat, x, h), split,
                       term, lanes)


def lstm_cell_bwd(w_cat: torch.Tensor, b_sum: torch.Tensor, x: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor,
                  dh_new: Optional[torch.Tensor],
                  dc_new: Optional[torch.Tensor],
                  split: Optional[tf32.Split] = None,
                  term: Optional[torch.Tensor] = None, lanes: int = 1):
    """K2's backward kernel: (d_gates (B, 4H) float32, dc) from the
    forward's inputs and the cotangents dh', dc' (c's dtype, contiguous;
    None is zero); with a gate term, then d_term (B, 4H) in the term's
    dtype, each row's own (:func:`term_grad` sums a term row's lanes).  A
    CUDA ``x`` launches ``fused_lstm_cell_bwd`` on :func:`lstm_bwd_route`'s
    route; a CPU ``x`` takes :func:`lstm_cell_bwd_plain`."""
    if x.device.type == "cpu":
        _check_term(term, lanes, x, h.shape[1])
        d_gates, dc = lstm_cell_bwd_plain(w_cat, b_sum, x, h, c, dh_new,
                                          dc_new, term, lanes)
        if term is None:
            return d_gates, dc
        return d_gates, dc, d_gates.to(term.dtype)
    return _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new,
                           lstm_bwd_route(w_cat, x, h, c, b_sum, term,
                                          dh_new, dc_new), split,
                           term=term, lanes=lanes)


def lstm_cell_bwd_full(w_cat: torch.Tensor, b_sum: torch.Tensor,
                       x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                       dh_new: Optional[torch.Tensor],
                       dc_new: Optional[torch.Tensor],
                       split: Optional[tf32.Split] = None,
                       term: Optional[torch.Tensor] = None, lanes: int = 1):
    """The whole of K2's backward, what :class:`LstmCell` calls: (dW, db,
    dx, dh, dc), each in its primal's dtype, from the forward's inputs and
    the cotangents (as :func:`lstm_cell_bwd`); with a gate term, then
    d_term (the term's shape and dtype, lanes summed).  A CPU ``x`` takes
    :func:`lstm_cell_bwd` (there its plain version) and the plain
    products.  A CUDA ``x`` launches the backward kernel and, on
    :func:`lstm_bwd_products_route`'s tensor-core routes, the dx·dh and
    dW·db kernels (three launches, no library call); on ``"cuda_core"``
    the products are float32 ``torch.matmul`` calls.  The term adds no
    launch: its gradient is the kernel's d_gates (float32) or d_term
    (bf16)."""
    if x.device.type == "cpu":
        out = lstm_cell_bwd(w_cat, b_sum, x, h, c, dh_new, dc_new,
                            term=term, lanes=lanes)
        grads = lstm_bwd_products_plain(w_cat, b_sum, x, h, out[0]) + (
            out[1],)
    else:
        epilogue = (c, b_sum, term, dh_new, dc_new)
        route = lstm_bwd_route(w_cat, x, h, *epilogue)
        if lstm_bwd_products_route(w_cat, x, h, *epilogue) == "cuda_core":
            out = _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new,
                                  route, split, term=term, lanes=lanes)
            grads = lstm_bwd_products_plain(w_cat, b_sum, x, h, out[0]) + (
                out[1],)
        else:
            out = _run_bwd_kernel(w_cat, b_sum, x, h, c, dh_new, dc_new,
                                  route, split, parts=True, term=term,
                                  lanes=lanes)
            g = out[0]
            dx, dh = _run_dxh_kernel(w_cat, g, x, h, route)
            dw, db = _run_dw_kernel(x, h, g, w_cat, b_sum, route)
            grads = (dw, db, dx, dh, out[1])
    if term is None:
        return grads
    # one row a term row: the term's dtype as written; else the lanes'
    # float32 sum, rounded once
    d32 = out[0].d if isinstance(out[0], GateGrads) else out[0]
    return grads + (term_grad(out[2] if lanes == 1 else d32, term, lanes),)


def _cotangent(g: Optional[torch.Tensor], like: torch.Tensor):
    return None if g is None else g.to(like.dtype).contiguous()


class LstmCell(torch.autograd.Function):
    """One cell step under autograd: (w_cat, b_sum, x, h, c, split_hi,
    split_lo[, term, lanes]) -> (h', c').  The forward runs
    :func:`lstm_cell_fused` and saves its inputs; the backward runs
    :func:`lstm_cell_bwd_full` and returns the term's gradient beside the
    others (its lanes summed).  Autograd does not fill a missing cotangent
    with zeros (the last step's c' has none): the backward kernel reads it
    as zero.  The term may be None; the TF32 split (float32 only, else
    None) is a detached input that gets no gradient."""

    @staticmethod
    def forward(ctx, w_cat, b_sum, x, h, c, split_hi, split_lo, term=None,
                lanes=1):
        split = None if split_hi is None else tf32.Split(split_hi, split_lo)
        # the term by keyword, as every caller passes it (engine/holds
        # reads it there)
        tkw = {} if term is None else dict(term=term, lanes=lanes)
        h_new, c_new = lstm_cell_fused(w_cat, b_sum, x, h, c, split, **tkw)
        ctx.save_for_backward(x, h, c, w_cat, b_sum, term, split_hi,
                              split_lo)
        ctx.lanes = lanes
        ctx.set_materialize_grads(False)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        x, h, c, w_cat, b_sum, term, hi, lo = ctx.saved_tensors
        split = None if hi is None else tf32.Split(hi, lo)
        grads = lstm_cell_bwd_full(
            w_cat, b_sum, x, h, c, _cotangent(dh_new, h),
            _cotangent(dc_new, c), split, term=term, lanes=ctx.lanes)
        dw, db, dx, dh, dc = grads[:5]
        d_term = grads[5] if term is not None else None
        return dw, db, dx, dh, dc, None, None, d_term, None


def lstm_cell_train(w: LstmWeights, x: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor, term: Optional[torch.Tensor] = None,
                    lanes: int = 1):
    """(h', c') of one cell step through :class:`LstmCell`, for a step
    whose gradient autograd needs."""
    hi, lo = w.split if w.split is not None else (None, None)
    return LstmCell.apply(w.w_cat, w.b_sum, x, h, c, hi, lo, term, lanes)
