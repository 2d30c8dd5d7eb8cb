#!/usr/bin/env python3
"""chip_smoke.py's phases 19 and 20 alone on the card: the build of the
port's kernels (phase 2), then serving BUTDSpatial from pixels
(chip_smoke.drive_serve) and training from pixels (chip_smoke.
drive_pixel_training: BUTDSpatial and AoASpatial XE and SCST, NIC's SCST),
with the same gates; each phase's seconds by part, the two phases' seconds
beside their budget (chip_smoke.PHASES_19_20_S), the kernels line of their
entries and the results as JSON (``--out``).  A quicker loop than the
whole smoke run while phases 19-20 change.  Run alone, the phases also
pay what the whole run pays earlier: the profiler's first start, cuDNN's
first choice of algorithms for the trunk.  With ``--check`` every profiled
step is also read through torch's FunctionEvent tree
(chip_smoke.parts_by_function_events, what profile_step read before) and
the two readings are compared part by part (their seconds then count in
the phases' time).

    python3 scripts/probe_phase19_20.py [--seed 0] [--check] [--out p.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def checking_readings(torch, checks):
    """chip_smoke.read_trace wrapped so that each trace it reads is also
    read through torch's FunctionEvent tree (chip_smoke.function_events,
    chip_smoke.parts_by_function_events), the pair appended to
    ``checks``."""
    read = cs.read_trace

    def both(torch_, result, ranges):
        got = read(torch_, result, ranges)
        checks.append((dict(got["parts"]), cs.parts_by_function_events(
            torch, cs.function_events(torch, result), ranges)))
        return got
    return both


def compare_readings(checks):
    """Each profiled step's parts read from the raw events against the
    FunctionEvent tree's, logged: -> how many steps read the same parts,
    and {step: {part: (raw ms, tree ms)}} where a part differs by more
    than 1e-9 ms."""
    out, same = {}, 0
    for i, (got, ref) in enumerate(checks):
        diff = {k: (got.get(k, 0.0), ref.get(k, 0.0))
                for k in set(got) | set(ref)
                if abs(got.get(k, 0.0) - ref.get(k, 0.0)) > 1e-9}
        if diff:
            out[i] = diff
        else:
            same += 1
        cs.log("reading of profiled step %d: %s" % (
            i, "the same parts" if not diff else "differs %s" % diff))
    return {"steps_alike": same, "differing": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_phase19_20: no CUDA device", file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = resolve_device("cuda")
    t0 = time.time()
    _build.build(["fused_head", "fused_lstm", "lstm_bwd", "quant_matmul",
                  "int8_attention"])
    cs.log("build %.1f s" % (time.time() - t0))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    scst = cs.scst_data(torch, args, dev, cs.BENCH_VOCAB)
    kernels, on_path, checks = {}, set(), []
    if args.check:
        cs.read_trace = checking_readings(torch, checks)
    t19 = time.time()
    res = {"card": smi, "serve": cs.drive_serve(
        torch, args, dev, gen, smi, flush, kernels, on_path)}
    failed = None
    try:
        res["pixel_training"] = cs.drive_pixel_training(
            torch, args, dev, gen, smi, flush, kernels, on_path, scst)
    except RuntimeError as e:
        # the readings below are still printed; the probe fails at its end
        failed = res["failed"] = str(e)
        res["pixel_training"] = {}
    s1920 = time.time() - t19
    res["seconds"] = dict(
        phases_19_20=s1920, budget=cs.PHASES_19_20_S,
        phase19=res["serve"]["seconds"],
        phase20=res["pixel_training"].get("seconds"),
        phase20_by_run=res["pixel_training"].get("split_s"))
    if args.check:
        res["readings"] = compare_readings(checks)
    res["kernels"] = list(kernels.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    print(json.dumps({"kernels": res["kernels"]}, default=str))
    print(json.dumps({"phases19_20_seconds": res["seconds"], "card": smi,
                      "readings": res.get("readings")}))
    if failed:
        print("probe_phase19_20: %s" % failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
