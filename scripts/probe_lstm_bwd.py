#!/usr/bin/env python3
"""K2's whole backward on the card, alone: build, hold and time.

    python3 scripts/probe_lstm_bwd.py [--seed 0] [--quick]

Builds ``fused_lstm`` and ``lstm_bwd`` from the sources, prints ptxas's
registers, shared memory and spills of the backward's kernels, then at
each cell shape of the training paths (AoADetection E=2,048 H=1,024,
BUTD's td E=4,096 and lang E=3,072, NIC E=512 H=512, AoASpatial E=1,024
H=512) and rows 128, 64 and 192, in float32 and bf16: the gate kernel's
products' operands (d_hi + d_lo within 2^-16 |d|; d^T's TF32 parts), the
dx·dh and dW·db kernels against their plain versions on the same d_gates,
the whole backward (``lstm_cell_bwd_full``) against
``lstm_cell_bwd_full_plain`` to ``engine/holds.k2_bwd_full_errors``, and
the launches each makes.  Then it times, in turns on the same card (CUDA
events, the L2 flushed before each launch, device-only: the card kept
busy while the host issues): the whole backward, the gate kernel with
float32 ``torch.matmul`` products (the earlier path), and
``torch.lstm_cell``'s backward through autograd.  ``--quick``: B=128 at
AoA's shape only, no timing (a first build and check).  Prints one JSON
line last.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SHAPES = (("aoa", 2048, 1024), ("butd_td", 4096, 1024),
          ("butd_lang", 3072, 1024), ("nic", 512, 512), ("aoasp", 1024, 512))
ROWS = (128, 64, 192)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="only the host's time a call (AoA's cell, B=128): "
                    "the whole backward, the matmul path and each kernel, "
                    "on the same buffers and on fresh ones, with the TMA "
                    "map encodes a call")
    ap.add_argument("--flush", action="store_true",
                    help="only AoA's cell at B=128: each kernel of the "
                    "backward, torch.lstm_cell's backward and a read of "
                    "w_cat timed after the L2 flush chip_smoke uses (a "
                    "128 MB write, which leaves the L2 dirty) and after a "
                    "128 MB read (which leaves it clean)")
    ap.add_argument("--splits", action="store_true",
                    help="only dx·dh at 2 to 8 splits of its reduction, "
                    "every training cell, B=128, both routes")
    ap.add_argument("--sweep", action="store_true",
                    help="only time dx·dh at 1, 2, 4 and 8 splits of its "
                    "reduction and dx·dh and dW·db at B=64, 128 and 192 "
                    "(AoA's and NIC's cells)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_lstm_bwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.ops import _build, fused_lstm, tf32
    dev = torch.device("cuda")
    t0 = time.time()
    libs = _build.build(["fused_lstm", "lstm_bwd"])
    print("build %.1f s" % (time.time() - t0), flush=True)
    for line in cs.ptxas_lines(libs["lstm_bwd"], markers=("lstm_bwd",)):
        print("  ptxas " + line)
    for line in cs.ptxas_lines(libs["fused_lstm"], markers=("Lb1E",)):
        print("  ptxas " + line)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {"card": torch.cuda.get_device_name(0), "holds": [], "times": []}
    shapes = SHAPES[:1] if args.quick else SHAPES
    rows = ROWS[:1] if args.quick else ROWS
    if args.flush:
        out["flush"] = flush_modes(torch, cs, fused_lstm, tf32, gen)
        print(json.dumps({"probe_lstm_bwd": out}))
        return 0
    if args.host:
        out["host"] = host(torch, fused_lstm, tf32, gen)
        print(json.dumps({"probe_lstm_bwd": out}))
        return 0
    if args.splits:
        out["splits"] = split_sweep(torch, cs, fused_lstm, tf32, gen, flush)
        print(json.dumps({"probe_lstm_bwd": out}))
        return 0
    if args.sweep:
        out["sweep"] = sweep(torch, cs, fused_lstm, tf32, gen, flush)
        print(json.dumps({"probe_lstm_bwd": out}))
        return 0
    for tag, e, hd in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            bound = 1 / hd ** 0.5
            w_cat = ((torch.rand(e + hd, 4 * hd, generator=gen, device=dev)
                      * 2 - 1) * bound).to(dtype)
            b_sum = ((torch.rand(4 * hd, generator=gen, device=dev) * 2 - 1)
                     * bound).to(dtype)
            split = tf32.prepare_split(w_cat) if route == "tf32x3" else None
            for b in rows:
                x, h, c, dh, dc = (torch.randn(b, n, generator=gen,
                                               device=dev).to(dtype)
                                   for n in (e, hd, hd, hd, hd))
                args7 = (w_cat, b_sum, x, h, c, dh, dc)
                assert fused_lstm.lstm_bwd_products_route(
                    w_cat, x, h, c, b_sum, dh, dc) == route
                g, kdc = fused_lstm._run_bwd_kernel(*args7, route, split,
                                                    parts=True)
                dx, dhh = fused_lstm._run_dxh_kernel(w_cat, g, x, h, route)
                dw, db = fused_lstm._run_dw_kernel(x, h, g, w_cat, b_sum,
                                                   route)
                torch.cuda.synchronize()
                rec = dict(shape=tag, dtype=dn, b=b, e=e, h=hd)
                d = g.d
                if route == "wgmma":
                    rec["split_err"] = float(
                        ((g.hi.float() + g.lo.float() - d).abs()
                         / d.abs().clamp_min(1e-30)).max())
                else:
                    dt = d.t()
                    rec["split_err"] = float(
                        ((g.hi[:, :b] + g.lo[:, :b] - dt).abs()
                         / dt.abs().clamp_min(1e-30)).max())
                # each kernel against its plain version on the same d
                f64 = route == "tf32x3"
                dref = d.double() if f64 else d
                pdx, pdh = fused_lstm.lstm_bwd_dxh_plain(w_cat, dref, e)
                pdw, pdb = fused_lstm.lstm_bwd_dw_plain(x, h, dref)
                tol = 1e-5 if f64 else 1e-2
                rec["dxh_err"] = max(holds._beyond(dx, pdx, tol, tol),
                                     holds._beyond(dhh, pdh, tol, tol))
                if f64:
                    lim = 1e-5 * (torch.cat([x, h], -1).double().abs().t()
                                  @ dref.abs()) + 1e-6
                    rec["dw_err"] = max(
                        holds._beyond(dw, pdw, lim),
                        holds._beyond(db, pdb, 1e-5 * dref.abs().sum(0)
                                      + 1e-6))
                else:
                    rec["dw_err"] = max(holds._beyond(dw, pdw, tol, tol),
                                        holds._beyond(db, pdb, tol, tol))
                rec["dxh_max_abs"] = max(
                    float((dx.float() - pdx.float()).abs().max()),
                    float((dhh.float() - pdh.float()).abs().max()))
                rec["dw_max_abs"] = float((dw.float() - pdw.float())
                                          .abs().max())
                full = fused_lstm.lstm_cell_bwd_full(*args7, split)
                torch.cuda.synchronize()
                rec["full_err"] = holds.k2_bwd_full_errors(args7, full)
                again = fused_lstm.lstm_cell_bwd_full(*args7, split)
                rec["deterministic"] = all(bool(torch.equal(a, b_))
                                           for a, b_ in zip(full, again))
                out["holds"].append(rec)
                print(json.dumps(rec), flush=True)
            if args.quick:
                continue
            b = 128
            x, h, c, dh, dc = (torch.randn(b, n, generator=gen,
                                           device=dev).to(dtype)
                               for n in (e, hd, hd, hd, hd))
            lw = [t.clone().requires_grad_() for t in (
                w_cat[:e].t().contiguous(), w_cat[e:].t().contiguous(),
                b_sum, torch.zeros_like(b_sum))]
            li = [t.clone().requires_grad_() for t in (x, h, c)]
            lh, lc = torch.lstm_cell(li[0], tuple(li[1:]), *lw)

            def old():
                dg, kdc = fused_lstm._run_bwd_kernel(
                    w_cat, b_sum, x, h, c, dh, dc, route, split)
                return fused_lstm.lstm_bwd_products_plain(
                    w_cat, b_sum, x, h, dg) + (kdc,)
            g, _ = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh, dc,
                                              route, split, parts=True)
            fns = {"new": lambda: fused_lstm.lstm_cell_bwd_full(
                       w_cat, b_sum, x, h, c, dh, dc, split),
                   "old": old,
                   "gate": lambda: fused_lstm._run_bwd_kernel(
                       w_cat, b_sum, x, h, c, dh, dc, route, split,
                       parts=True),
                   "dxh": lambda: fused_lstm._run_dxh_kernel(
                       w_cat, g, x, h, route),
                   "dw": lambda: fused_lstm._run_dw_kernel(
                       x, h, g, w_cat, b_sum, route),
                   "lib": lambda: torch.autograd.grad(
                       (lh, lc), li + lw, (dh, dc), retain_graph=True)}
            order = ["new", "old", "lib", "gate", "dxh", "dw", "dw", "dxh",
                     "gate", "lib", "old", "new"]
            turns = cs.time_turns(torch, fns, flush, order,
                                  lead=8 * cs.DEVICE_LEAD)
            rec = dict(shape=tag, dtype=dn, b=b, splits=fused_lstm.dxh_splits(
                b, e, hd, fused_lstm._sms(dev), route), **{
                k: sum(v) / len(v) for k, v in turns.items()}, turns=turns)
            out["times"].append(rec)
            print(json.dumps(rec), flush=True)
    print(json.dumps({"probe_lstm_bwd": out}))
    return 0


class _ReadFlush:
    """Stands in for chip_smoke's flush buffer: its zero_() reads 128 MB
    instead of writing them, so the L2 is cold and clean."""

    def __init__(self, torch, dev):
        self.buf = torch.ones(32 * 1024 * 1024, device=dev)
        self.out = torch.empty((), device=dev)

    def zero_(self):
        import torch
        torch.sum(self.buf, dim=0, out=self.out)


def flush_modes(torch, cs, fused_lstm, tf32, gen):
    """Device ms (chip_smoke.time_turns, device-only) of the backward's
    kernels, the whole backward, torch.lstm_cell's backward and a read of
    w_cat (its sum), at AoA's cell, B=128, both dtypes, after each flush:
    "write" (chip_smoke's) and "read"."""
    dev = torch.device("cuda")
    res = []
    e, hd = SHAPES[0][1:]
    flushes = {"write": torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                                    device=dev),
               "read": _ReadFlush(torch, dev)}
    for dtype in (torch.float32, torch.bfloat16):
        route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        w_cat = ((torch.rand(e + hd, 4 * hd, generator=gen, device=dev) * 2
                  - 1) / hd ** 0.5).to(dtype)
        b_sum = torch.zeros(4 * hd, device=dev, dtype=dtype)
        split = tf32.prepare_split(w_cat) if route == "tf32x3" else None
        x, h, c, dh, dc = (torch.randn(128, n, generator=gen,
                                       device=dev).to(dtype)
                           for n in (e, hd, hd, hd, hd))
        g, _ = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh, dc,
                                          route, split, parts=True)
        lw = [t.clone().requires_grad_() for t in (
            w_cat[:e].t().contiguous(), w_cat[e:].t().contiguous(), b_sum,
            torch.zeros_like(b_sum))]
        li = [t.clone().requires_grad_() for t in (x, h, c)]
        lh, lc = torch.lstm_cell(li[0], tuple(li[1:]), *lw)
        fns = {"full": lambda: fused_lstm.lstm_cell_bwd_full(
                   w_cat, b_sum, x, h, c, dh, dc, split),
               "gate": lambda: fused_lstm._run_bwd_kernel(
                   w_cat, b_sum, x, h, c, dh, dc, route, split, parts=True),
               "dxh": lambda: fused_lstm._run_dxh_kernel(w_cat, g, x, h,
                                                         route),
               "dw": lambda: fused_lstm._run_dw_kernel(x, h, g, w_cat,
                                                       b_sum, route),
               "lib": lambda: torch.autograd.grad(
                   (lh, lc), li + lw, (dh, dc), retain_graph=True),
               "read_w": lambda: w_cat.sum()}
        order = list(fns) + list(fns)[::-1]
        for kind, fl in flushes.items():
            turns = cs.time_turns(torch, fns, fl, order,
                                  lead=8 * cs.DEVICE_LEAD)
            rec = dict(dtype=str(dtype), flush=kind, **{
                k: sum(v) / len(v) for k, v in turns.items()})
            res.append(rec)
            print(json.dumps(rec), flush=True)
    return res


def host(torch, fused_lstm, tf32, gen, n=50):
    """Host microseconds a call (the mean of ``n`` calls issued back to
    back, the card kept busy first so that no call waits for it) and TMA
    map encodes a call, at AoA's cell, B=128: the whole backward, the matmul
    path, the backward kernel alone, dx·dh, dW·db; each on the same
    buffers every call ("same") and on ``n`` sets made beforehand
    ("fresh": every map a miss)."""
    import time
    dev = torch.device("cuda")
    res = []
    e, hd = SHAPES[0][1:]
    for dtype in (torch.float32, torch.bfloat16):
        route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        w_cat = ((torch.rand(e + hd, 4 * hd, generator=gen, device=dev) * 2
                  - 1) / hd ** 0.5).to(dtype)
        b_sum = torch.zeros(4 * hd, device=dev, dtype=dtype)
        split = tf32.prepare_split(w_cat) if route == "tf32x3" else None

        def inputs():
            return [torch.randn(128, k, generator=gen, device=dev).to(dtype)
                    for k in (e, hd, hd, hd, hd)]
        same = inputs()
        fresh = [inputs() for _ in range(n)]
        gs = [fused_lstm._run_bwd_kernel(w_cat, b_sum, *a, route, split,
                                         parts=True)[0] for a in fresh]

        def old(x, h, c, dh, dc):
            d, kdc = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh,
                                                dc, route, split)
            return fused_lstm.lstm_bwd_products_plain(w_cat, b_sum, x, h,
                                                      d) + (kdc,)
        calls = {
            "full": lambda i, a: fused_lstm.lstm_cell_bwd_full(
                w_cat, b_sum, *a, split),
            "old": lambda i, a: old(*a),
            "gate": lambda i, a: fused_lstm._run_bwd_kernel(
                w_cat, b_sum, *a, route, split, parts=True),
            "dxh": lambda i, a: fused_lstm._run_dxh_kernel(
                w_cat, gs[i], a[0], a[1], route),
            "dw": lambda i, a: fused_lstm._run_dw_kernel(
                a[0], a[1], gs[i], w_cat, b_sum, route)}
        for name, fn in calls.items():
            for kind in ("same", "fresh"):
                fn(0, same)
                torch.cuda.synchronize()
                torch.cuda._sleep(2_000_000_000 // 1000 * 50)   # ~50 ms
                enc0 = fused_lstm.map_encodes()
                t0 = time.perf_counter()
                for i in range(n):
                    fn(i, same if kind == "same" else fresh[i])
                us = (time.perf_counter() - t0) / n * 1e6
                enc = (fused_lstm.map_encodes() - enc0) / n
                torch.cuda.synchronize()
                rec = dict(dtype=str(dtype), call=name, buffers=kind,
                           host_us=us, map_encodes=enc)
                res.append(rec)
                print(json.dumps(rec), flush=True)
    return res


def with_splits(fused_lstm, k, run):
    """``run()`` with dx·dh's reduction split ``k`` ways."""
    saved = fused_lstm.dxh_splits
    fused_lstm.dxh_splits = lambda *a: k
    try:
        return run()
    finally:
        fused_lstm.dxh_splits = saved


def split_sweep(torch, cs, fused_lstm, tf32, gen, flush):
    """dx·dh's device time at 2 to 8 splits of its reduction, at every
    training cell (B=128), both routes, in turns."""
    dev = torch.device("cuda")
    res = []
    for tag, e, hd in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            w_cat = ((torch.rand(e + hd, 4 * hd, generator=gen, device=dev)
                      * 2 - 1) / hd ** 0.5).to(dtype)
            b_sum = torch.zeros(4 * hd, device=dev, dtype=dtype)
            split = tf32.prepare_split(w_cat) if route == "tf32x3" else None
            x, h, c, dh, dc = (torch.randn(128, n, generator=gen,
                                           device=dev).to(dtype)
                               for n in (e, hd, hd, hd, hd))
            g, _ = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh, dc,
                                              route, split, parts=True)
            fns = {"s%d" % k: (lambda k=k: with_splits(
                       fused_lstm, k, lambda: fused_lstm._run_dxh_kernel(
                           w_cat, g, x, h, route))) for k in range(2, 9)}
            order = list(fns) + list(fns)[::-1]
            turns = cs.time_turns(torch, fns, flush, order,
                                  lead=cs.DEVICE_LEAD)
            rec = dict(shape=tag, dtype=str(dtype), now=fused_lstm.dxh_splits(
                128, e, hd, fused_lstm._sms(dev), route), **{
                k: sum(v) / len(v) for k, v in turns.items()})
            res.append(rec)
            print(json.dumps(rec), flush=True)
    return res


def sweep(torch, cs, fused_lstm, tf32, gen, flush):
    """dx·dh's device time at 1, 2, 4 and 8 splits of its reduction (B=128)
    and at its own split at B=64 and 192, and dW·db's at B=64, 128 and
    192, at AoA's and NIC's cells, both routes."""
    dev = torch.device("cuda")
    res = []
    for tag, e, hd in (SHAPES[0], SHAPES[3]):
        for dtype in (torch.float32, torch.bfloat16):
            route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            w_cat = ((torch.rand(e + hd, 4 * hd, generator=gen, device=dev)
                      * 2 - 1) / hd ** 0.5).to(dtype)
            b_sum = torch.zeros(4 * hd, device=dev, dtype=dtype)
            split = tf32.prepare_split(w_cat) if route == "tf32x3" else None
            fns = {}
            for b in ROWS:
                x, h, c, dh, dc = (torch.randn(b, n, generator=gen,
                                               device=dev).to(dtype)
                                   for n in (e, hd, hd, hd, hd))
                g, _ = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh,
                                                  dc, route, split,
                                                  parts=True)
                if b == 128:
                    for k in (1, 2, 4, 8):
                        fns["dxh_s%d" % k] = (
                            lambda k=k, g=g, x=x, h=h: with_splits(
                                fused_lstm, k, lambda: fused_lstm
                                ._run_dxh_kernel(w_cat, g, x, h, route)))
                else:
                    fns["dxh_b%d" % b] = (
                        lambda g=g, x=x, h=h: fused_lstm._run_dxh_kernel(
                            w_cat, g, x, h, route))
                fns["dw_b%d" % b] = (
                    lambda g=g, x=x, h=h: fused_lstm._run_dw_kernel(
                        x, h, g, w_cat, b_sum, route))
            order = list(fns) + list(fns)[::-1]
            turns = cs.time_turns(torch, fns, flush, order,
                                  lead=cs.DEVICE_LEAD)
            rec = dict(shape=tag, dtype=str(dtype), **{
                k: sum(v) / len(v) for k, v in turns.items()})
            res.append(rec)
            print(json.dumps(rec), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
