#!/usr/bin/env python3
"""Does the beam decode's gate pass differences the size of the kernels'
holds, and fail real faults?

    python3 scripts/rehearse_beam_gate.py [--device cuda] [--seed 0]
        [--small] [--out results.json]

The gate is the one ``chip_smoke.py`` phase 9 applies to a beam decode
through the kernels against the same decode through their plain versions
(``engine/holds.py``): end to end, float32 ids identical in 99 % of rows,
and bf16 and int8 winners rescored by the plain step, none more than
``beam_tol`` below the plain run's; and every kernel call of the decode
held against its plain version on the same inputs, to the kernel's own
tolerance (``held_calls``).  Here the "kernel run" is the plain versions
with something planted in them, on the same model and inputs as phase 9
(AoADetection at full width, random weights from ``--seed``, B=384, beam
3, 20 steps; ``--small``: hidden 256, 2 heads, vocab 1,000, 5 boxes with
1-5 valid, B=16, 8 steps), on the four paths (float32, bf16, int8
float32, int8 bf16; int8 K/V on):

- ``noise``: each kernel's outputs moved by 99 % of its hold
  (``chip_smoke.py`` phases 3-7): K1's values and logsumexp each by a
  uniform draw within 1e-4 (float32 x) or 2e-3 (bf16 x); in one entry in
  ten of K2's h' and c', K3's output and K4's output, one bf16 ulp up or
  down, or in float32 K2 1e-5, K3 1e-5 of the sum of |x q s| and K4 2e-5,
  either way.  No call may break its hold; the end-to-end gates' verdict
  is reported (it shows whether they are looser or stricter than the
  holds).
- ``k1_ids``: K1 returns its second and third ids swapped (their values
  kept).  The gate must fail.
- ``k4_mask`` (int8 paths): K4 attends over the masked boxes too.  The
  gate must fail.

Prints, per path and plant, the share of rows identical to the plain run,
the least rescored margin, the end-to-end verdict, the calls that broke
their hold and the gate's verdict (both parts); exits 1 when noise breaks
a call's hold or a fault passes the gate.  Needs no kernel build: only the plain
versions run, on ``--device`` (the card unless the caller asks for the
CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PATHS = ("float32", "bfloat16", "int8/float32", "int8/bfloat16")
SMALL = dict(config=dict(model_type="AoADetection", vocab_size=1000,
                         embed_dim=256, hidden_dim=256, enc_dim=64,
                         num_heads=2, num_refine_layers=1, max_bu_len=5),
             batch=16, steps=8, min_valid=1)
# the planted noise's share of each float32 hold: the perturbed value's own
# float32 rounding stays inside the hold
SIZE = 0.99


def full_size():
    import chip_smoke
    return dict(config=chip_smoke.FULL, batch=chip_smoke.B,
                steps=chip_smoke.MAX_LEN, min_valid=10)


def _one_ulp_or(t, amount, gen):
    """t with one entry in ten moved up or down: by one ulp of its own
    value for bf16 ``t``, else by ``amount`` (a number or a tensor like
    t)."""
    import torch
    pick = torch.rand(t.shape, generator=gen, device=t.device) < 0.1
    sign = torch.where(torch.rand(t.shape, generator=gen, device=t.device)
                       < 0.5, -1.0, 1.0)
    tf = t.float()
    if t.dtype == torch.bfloat16:
        amount = torch.where(tf == 0, 0.0, torch.exp2(
            torch.floor(torch.log2(tf.abs().clamp_min(1e-30))) - 7))
    return torch.where(pick, tf + sign * amount, tf).to(t.dtype)


def planter(plant: str, gen):
    """``wrap`` for :func:`holds.plain_versions`: each plain version with
    ``plant`` ("noise", "k1_ids", "k4_mask" or "none") put in."""
    import torch
    from simpleimagecaptionzoo_tpu_torch.engine.holds import K1_VALUE_HOLD

    def uniform(t, h):
        return t + h * (2 * torch.rand(t.shape, generator=gen,
                                       device=t.device) - 1)

    def wrap(name, plain):
        if plant == "noise" and name == "topk_head":
            def fn(head, x, k):
                vals, ids, lse = plain(head, x, k)
                h = SIZE * K1_VALUE_HOLD[x.dtype]
                return uniform(vals, h), ids, uniform(lse, h)
        elif plant == "noise" and name == "lstm_cell_fused":
            def fn(w_cat, b_sum, x, h, c, split=None):
                # in float32 the hold's reference is the function in
                # float64 (engine/holds.py): the noise goes on that
                args = (w_cat, b_sum, x, h, c)
                if x.dtype == torch.float32:
                    args = tuple(t.double() for t in args)
                h2, c2 = (t.to(h.dtype) for t in plain(*args))
                return (_one_ulp_or(h2, SIZE * 1e-5, gen),
                        _one_ulp_or(c2, SIZE * 1e-5, gen))
        elif plant == "noise" and name == "quant_matmul":
            def fn(x, qp):
                y = plain(x, qp)
                k = x.shape[-1]
                size = ((x.abs().float().reshape(-1, k)
                         @ qp["q"][:k, :y.shape[-1]].float().abs())
                        * qp["s"][:y.shape[-1]].float().abs())
                return _one_ulp_or(y, SIZE * 1e-5 * size.reshape(y.shape),
                                   gen)
        elif plant == "noise" and name == "lanes_attention_int8":
            def fn(*a):
                out, pm = plain(*a)
                return _one_ulp_or(out, SIZE * 2e-5, gen), pm
        elif plant == "k1_ids" and name == "topk_head":
            def fn(head, x, k):
                vals, ids, lse = plain(head, x, k)
                return vals, ids[:, [0, 2, 1] + list(range(3, k))], lse
        elif plant == "k4_mask" and name == "lanes_attention_int8":
            def fn(q, kq, ks, vq, vs, mask, heads):
                return plain(q, kq, ks, vq, vs, None, heads)
        else:
            fn = plain
        return fn

    return wrap


def plants_of(path: str):
    return ("noise", "k1_ids") + (("k4_mask",) if path.startswith("int8")
                                  else ())


def rehearse(device, size, seed=0, paths=PATHS, log=print):
    """Runs the rehearsal; -> {path: {plant: reading}} with each reading's
    ``rows_identical``, ``min_margin``, ``tol``, ``end_to_end_passed``,
    ``calls_broken``, ``passed`` (both parts) and ``as_expected``: for
    noise, no call broke its hold; for a fault, the gate failed."""
    import torch
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner

    cfg, b, max_steps = size["config"], size["batch"], size["steps"]
    n_box, lo = cfg["max_bu_len"], size["min_valid"]
    os.environ["SICZ_TPU_INT8_KV"] = "auto"
    gen = torch.Generator(device=device).manual_seed(seed)
    model = get_captioner(ModelConfig(**cfg))
    params = model.init_params(gen)
    qparams = model.quantize_decode_params(params)
    valid = lo + torch.arange(b, device=device) % (n_box - lo + 1)
    visual = {"bu_feats": torch.relu(torch.randn(
        b, n_box, cfg["enc_dim"], generator=gen, device=device)),
        "bu_masks": (torch.arange(n_box, device=device)[None]
                     < valid[:, None]).float()}
    out = {}
    for path in paths:
        dtype = torch.bfloat16 if path.endswith("bfloat16") else torch.float32
        prm = qparams if path.startswith("int8") else params
        fn = steps.make_beam_decode(model, beam_size=3, max_steps=max_steps,
                                    dtype=dtype, device=device)
        with holds.plain_versions():
            ref = fn(prm, {}, visual)
        tol = holds.beam_tol(dtype, max_steps)
        out[path] = {}
        for plant in plants_of(path):
            pgen = torch.Generator(device=device).manual_seed(seed + 1)
            failures = []
            with holds.plain_versions(planter(plant, pgen)), \
                    holds.held_calls(failures):
                ids = fn(prm, {}, visual)
            margin = holds.rescored_margin(model, prm, visual, ids, ref,
                                           dtype, device)
            end_to_end, rows_same = holds.beam_gate(
                path == "float32", ids, ref, margin, tol)
            passed = end_to_end and not failures
            r = out[path][plant] = dict(
                rows_identical=rows_same, min_margin=float(margin.min()),
                rows_below=int((margin < 0).sum()), tol=tol,
                end_to_end_passed=end_to_end, calls_broken=len(failures),
                first_broken=failures[0] if failures else None,
                passed=passed,
                as_expected=(not failures) if plant == "noise"
                else not passed)
            log("%-13s %-7s rows identical %.4f; least rescored margin "
                "%.6f (tol %.4f), %d rows below 0: end-to-end gate %s; "
                "%d calls broke their hold%s; gate %s%s"
                % (path, plant, rows_same, r["min_margin"], tol,
                   r["rows_below"], "passes" if end_to_end else "fails",
                   len(failures), " (first: %s: %s)" % failures[0]
                   if failures else "", "passes" if passed else "fails",
                   "" if r["as_expected"] else "  <- not as it should"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    size = SMALL if args.small else full_size()
    res = rehearse(device, size, args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    wrong = [(p, k) for p, r in res.items() for k, v in r.items()
             if not v["as_expected"]]
    if wrong:
        print("rehearse_beam_gate: not as it should for %s" % wrong,
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
