"""Holding a decode or a training step through the kernels against the
same run through their plain versions.

:func:`plain_versions` swaps every kernel wrapper a decode or an XE step
calls (K2's backward included) for its plain PyTorch version (the
reference run); :func:`held_calls` holds every kernel call of a run
against its plain version on the same inputs, to the kernel's own
tolerance; :func:`recording_shapes` records each launch's kernel, route
and shape where the wrapper reaches its kernel;
:func:`beam_tol`, :func:`rescored_margin` and :func:`beam_gate` are the
beam decode's end-to-end gate: a winner hangs on every step's sums, so no
id is a sound gate where the kernels round differently from their plain
versions (bf16, int8); both runs' winners are rescored by the plain step
instead.  Used by ``chip_smoke.py``, the card tests and
``scripts/rehearse_beam_gate.py``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.engine import steps
from simpleimagecaptionzoo_tpu_torch.ops import (decode, fused_head,
                                                 fused_lstm, int8_attention,
                                                 quant)

# K1's hold on its values and logsumexp (chip_smoke.py phase 3), per dtype
K1_VALUE_HOLD = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
ROWS_IDENTICAL = 0.99            # the float32 beam gate: rows as the plain run


def _lstm_plain(w_cat, b_sum, x, h, c, split=None, term=None, lanes=1):
    # the plain cell takes the unsplit w_cat, not the TF32 split
    return fused_lstm.lstm_cell_plain(w_cat, b_sum, x, h, c, term, lanes)


def _lstm_bwd_plain(w_cat, b_sum, x, h, c, dh_new, dc_new, split=None,
                    term=None, lanes=1):
    d_gates, dc = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, x, h, c,
                                                 dh_new, dc_new, term, lanes)
    if term is None:
        return d_gates, dc
    return d_gates, dc, d_gates.to(term.dtype)


def _lstm_bwd_full_plain(w_cat, b_sum, x, h, c, dh_new, dc_new, split=None,
                         term=None, lanes=1):
    return fused_lstm.lstm_cell_bwd_full_plain(w_cat, b_sum, x, h, c, dh_new,
                                               dc_new, term, lanes)


def _term(kw):
    """The gate term and lanes of a K2 call's keywords (the port passes
    them by keyword only)."""
    return kw.get("term"), kw.get("lanes", 1)


def plain_swaps() -> List[Tuple[object, str, Callable]]:
    """(module, wrapper's name, plain version) of every kernel wrapper a
    decode or an XE step calls: K1 (and K1-int8), K2, its backward kernel
    and its whole backward (the kernel and its products: what LstmCell
    calls), K3 and K4."""
    return [(fused_head, "topk_head", fused_head.topk_head_plain),
            (fused_lstm, "lstm_cell_fused", _lstm_plain),
            (fused_lstm, "lstm_cell_bwd", _lstm_bwd_plain),
            (fused_lstm, "lstm_cell_bwd_full", _lstm_bwd_full_plain),
            (quant, "quant_matmul", quant.quant_matmul_plain),
            (int8_attention, "lanes_attention_int8",
             int8_attention.lanes_attention_int8_plain)]


@contextlib.contextmanager
def plain_versions(wrap: Optional[Callable[[str, Callable], Callable]] = None):
    """The decode's kernel wrappers swapped for their plain versions on the
    same tensors; ``wrap(name, plain)``, when given, returns what stands in
    for wrapper ``name`` instead (a plain version with planted noise or a
    planted fault)."""
    swaps = plain_swaps()
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain if wrap is None else wrap(name, plain))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _beyond(got, want, atol, rtol=0.0) -> float:
    """Largest |got - want| beyond atol + rtol |want| (0 when within, and
    for an empty tensor: dx of a cell whose E is 0)."""
    diff = (got.float() - want.float()).abs()
    if diff.numel() == 0:
        return 0.0
    return float((diff - atol - rtol * want.float().abs()).clamp_min(0).max())


def _hold_k1(plain, a, kw, got):
    head, x, k = a
    vals, ids, lse = got
    pv, pi, pl = plain(head, x, k + 1)
    hold = K1_VALUE_HOLD[x.dtype]
    err = max(float((vals - pv[:, :k]).abs().max()),
              float((lse - pl).abs().max()))
    if err > hold:
        return "values or lse off by %.3g (hold %g)" % (err, hold)
    # ids must match where the plain logits leave a gap > 1e-3 on both
    # sides of the position
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    bad = int(((ids != pi[:, :k]) & (gaps[:, :k] > 1e-3) & (lo > 1e-3)).sum())
    return "%d ids differ where the gap exceeds 1e-3" % bad if bad else None


def _hold_k2(plain, a, kw, got):
    term, lanes = _term(kw)
    if a[3].dtype == torch.float32:
        # against the plain version's function in float64: from pixels,
        # BUTD's cells sum |x||w| up to 250 a gate, where cuBLAS's float32
        # product (the plain version in float32) is itself off by up to
        # 1.45e-5 and the kernel by 5.56e-6 (PERF.md section 6;
        # scripts/probe_lstm_f64.py)
        want, tol = plain(*(t.double() for t in a[:5]), term=_double(term),
                          lanes=lanes), 1e-5
    else:
        want, tol = plain(*a[:5], term=term, lanes=lanes), 1e-2
    err = max(_beyond(g, w, tol, tol) for g, w in zip(got, want))
    if err:
        return "h' or c' off by %.3g beyond rtol and atol %g" % (err, tol)
    return None


def _hold_k2_bwd(plain, a, kw, got):
    term, lanes = _term(kw)
    want = plain(*a[:7], term=term, lanes=lanes)
    tol = 1e-5 if a[2].dtype == torch.float32 else 1e-2
    err = max(_beyond(g, w, tol, tol) for g, w in zip(got, want))
    if err:
        return ("d_gates, dc or d_term off by %.3g beyond rtol and atol %g"
                % (err, tol))
    return None


def _double(t):
    return None if t is None else t.double()


def k2_bwd_full_errors(args, got, term=None, lanes=1) -> dict:
    """How far K2's whole backward (dW, db, dx, dh, dc and, with a gate
    term, d_term: ``got``, on the forward's inputs and cotangents
    ``args``) lies beyond its holds, by output name (0 where within).
    float32, against the function in float64: dx, dh, dc and d_term (which
    is d_gates, lanes summed) within 1e-5 (rtol and atol, K2's float32
    hold); dW and db within 1e-5 of the sum over the batch of |[x, h]_b|
    |d_b| (and |d_b|), plus 1e-6: B terms are summed, as K3's hold is
    relative to the sum of |x q s|.  bf16: rtol and atol 1e-2 against the
    plain version."""
    names = ("dW", "db", "dx", "dh", "dc", "d_term")
    w_cat, b_sum, x, h, c, dh_new, dc_new = args[:7]
    if x.dtype != torch.float32:
        want = fused_lstm.lstm_cell_bwd_full_plain(*args[:7], term, lanes)
        return {n: _beyond(g, w, 1e-2, 1e-2)
                for n, g, w in zip(names, got, want)}
    a64 = [_double(t) for t in args[:7]]
    d, dc = fused_lstm.lstm_cell_bwd_plain(*a64, _double(term), lanes)
    want = fused_lstm.lstm_bwd_products_plain(*a64[:4], d) + (dc,)
    if term is not None:
        want = want + (fused_lstm.term_grad(d, term, lanes),)
    err = {n: _beyond(g, w, 1e-5, 1e-5)
           for n, g, w in zip(names[2:], got[2:], want[2:])}
    da = d.abs()
    lim_w = 1e-5 * (torch.cat([a64[2], a64[3]], dim=-1).abs().t() @ da) + 1e-6
    err["dW"] = _beyond(got[0], want[0], lim_w)
    err["db"] = _beyond(got[1], want[1], 1e-5 * da.sum(dim=0) + 1e-6)
    return err


def _hold_k2_bwd_full(plain, a, kw, got):
    # the plain version stands in for the function; in float32 the hold's
    # reference is that function in float64 (k2_bwd_full_errors)
    err = k2_bwd_full_errors(a, got, *_term(kw))
    if max(err.values()):
        return "off beyond their holds: %s" % ", ".join(
            "%s by %.3g" % kv for kv in err.items() if kv[1])
    return None


def _hold_k3(plain, a, kw, got):
    x, qp = a
    want = plain(x, qp)
    if x.dtype == torch.float32:
        # 1e-5 of the sum of |x q s|, the float32 rounding bound of a dot
        # product summed in another order
        k, n = x.shape[-1], want.shape[-1]
        lim = 1e-5 * (x.abs().reshape(-1, k) @ (qp["q"][:k, :n].float().abs()
                                                * qp["s"][:n].float()))
        err = _beyond(got.reshape(lim.shape), want.reshape(lim.shape),
                      lim + 1e-6)
    else:
        err = _beyond(got, want, 1e-2, 1e-2)
    return "off by %.3g beyond its hold" % err if err else None


def _hold_k4(plain, a, kw, got):
    q, mask = a[0], a[5]
    out, pm = got
    want, pwant = plain(*a)
    err = (_beyond(out, want, 2e-5) if q.dtype == torch.float32
           else _beyond(out, want, 1e-2, 1e-2))
    err_p = float((pm - pwant).abs().max())
    masked = 0.0
    if mask is not None and bool((mask == 0).any()):
        off = (mask == 0)[:, None, :].expand_as(pm)
        masked = float(pm[off].abs().max())
    if err or err_p > 2e-6 or masked:
        return ("out off by %.3g beyond its hold, pmean by %.3g (hold 2e-6), "
                "pmean on masked boxes %.3g" % (err, err_p, masked))
    return None


# each wrapper's hold: (its plain version, its arguments, what it returned)
# -> None, or what broke (the tolerances of chip_smoke.py phases 3-7)
_HOLDS = {"topk_head": _hold_k1, "lstm_cell_fused": _hold_k2,
          "lstm_cell_bwd": _hold_k2_bwd,
          "lstm_cell_bwd_full": _hold_k2_bwd_full,
          "quant_matmul": _hold_k3, "lanes_attention_int8": _hold_k4}


@contextlib.contextmanager
def held_calls(failures: list):
    """Every call of a kernel wrapper in the block also runs its plain
    version on the same inputs, and each call whose result breaks the
    kernel's hold appends (wrapper's name, what broke) to ``failures``.
    What the wrapper returned is passed on, so the decode runs as it
    would."""
    swaps = plain_swaps()
    saved = [getattr(mod, name) for mod, name, _ in swaps]

    def held(name, run, plain):
        def fn(*a, **kw):
            got = run(*a, **kw)
            why = _HOLDS[name](plain, a, kw, got)
            if why:
                failures.append((name, why))
            return got
        return fn

    for (mod, name, plain), run in zip(swaps, saved):
        setattr(mod, name, held(name, run, plain))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# (module, launching function, its arguments -> (kernel, route, rows,
# last)): last is K1's k, K4's query rows, and the width of x for K2, K2's
# backward kernel and its products (dx·dh, dW·db) and K3
_SHAPE_OF = [
    (fused_head, "_run_kernel", lambda head, x, k, route: (
        "K1", route, x.shape[0], k)),
    (fused_lstm, "_run_kernel", lambda w_cat, b_sum, x, h, c, route,
     split=None, term=None, lanes=1: ("K2", route, x.shape[0], x.shape[1])),
    (fused_lstm, "_run_bwd_kernel", lambda w_cat, b_sum, x, h, c, dh, dc,
     route, split=None, parts=False, term=None, lanes=1: (
         "K2bwd", route, x.shape[0], x.shape[1])),
    (fused_lstm, "_run_dxh_kernel", lambda w_cat, g, x, h, route: (
        "K2dxh", route, x.shape[0], x.shape[1])),
    (fused_lstm, "_run_dw_kernel", lambda x, h, g, w_cat, b_sum, route: (
        "K2dw", route, x.shape[0], x.shape[1])),
    (quant, "_run_kernel", lambda x2, q, s, b, route: (
        "K3", route, x2.shape[0], x2.shape[1])),
    (int8_attention, "_run_kernel", lambda q, kq, ks, vq, vs, mask_f, heads,
     route: ("K4", route, q.shape[0], q.shape[1]))]


@contextlib.contextmanager
def recording_shapes(shapes: list):
    """Appends (kernel, route, rows, last) to ``shapes`` at every launch of
    K1 (rows of x, and k), K2 and its backward kernel ("K2bwd") and
    products ("K2dxh", "K2dw"; rows and width of x: E, the cell's input
    without h), K3 (rows and width of x: K) and K4
    (samples and query rows), where each wrapper reaches its kernel."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _SHAPE_OF]

    def recorder(shape_of, run):
        def rec(*a, **kw):
            shapes.append(shape_of(*a, **kw))
            return run(*a, **kw)
        return rec

    for (mod, name, shape_of), (_, _, run) in zip(_SHAPE_OF, saved):
        setattr(mod, name, recorder(shape_of, run))
    try:
        yield
    finally:
        for mod, name, run in saved:
            setattr(mod, name, run)


def beam_tol(dtype: torch.dtype, max_steps: int) -> float:
    """How far below the plain run's winner a row's kernel winner may
    score: a step's log-prob (vals - lse) moves by up to twice K1's value
    hold, doubled for the state's own differences; a winner's score by
    ``max_steps`` times that; a flip between two winners costs at most
    twice a winner's error."""
    return 2 * max_steps * 4 * K1_VALUE_HOLD[dtype]


def rescored_margin(model, params, visual, ids: torch.Tensor,
                    ref_ids: torch.Tensor, dtype: torch.dtype,
                    device, model_state=None) -> torch.Tensor:
    """(B,) float32: each row's ``ids`` minus its ``ref_ids``, both scored
    by :func:`decode.sequence_logprob` through the plain step in ``dtype``
    (params, model_state and visual cast and moved as the decode entry
    points do)."""
    with plain_versions(), torch.inference_mode():
        p = steps._cast_floats(params, dtype, device)
        enc, _ = model.encode(
            p, steps._cast_floats(visual, dtype, device),
            model_state=steps._cast_floats(model_state, None, device))
        return (decode.sequence_logprob(model, p, enc, ids)
                - decode.sequence_logprob(model, p, enc, ref_ids))


def beam_gate(float32_path: bool, ids: torch.Tensor, ref_ids: torch.Tensor,
              margin: torch.Tensor, tol: float) -> Tuple[bool, float]:
    """The beam decode's gate against the plain run: float32 (K1 and K2 in
    float32) passes with ``ROWS_IDENTICAL`` of its rows equal to the plain
    run's; the other paths pass where no row's margin
    (:func:`rescored_margin`) is below ``-tol``.  -> (passed, share of rows
    identical)."""
    rows_same = float((ids == ref_ids).all(dim=1).float().mean())
    if float32_path:
        return rows_same >= ROWS_IDENTICAL, rows_same
    return float(margin.min()) >= -tol, rows_same
