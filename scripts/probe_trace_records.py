#!/usr/bin/env python3
"""How often a device-only torch.profiler trace of one decode holds fewer
K2 records than the decode launched: BUTDDetection greedy at B=384,
float32, 20 steps (chip_smoke.py phase 22's decode: K2 twice a step), each
trace taken right after an untraced decode of the same inputs, as
chip_smoke.hoist_decodes takes it.  Three ways in turns, ``--reps`` traces
each: "raw" reads the trace's raw events alone (chip_smoke.device_kinds),
"events" also builds torch's FunctionEvent list (``prof.events()``) after
the trace and counts there too, "pause" waits half a second on a quiet
card before the trace.  Prints, per way, the traces whose K2 records
differ from the wrapper's launches, and whether the two readings of one
trace ever differ.

    python3 scripts/probe_trace_records.py [--reps 30] [--out p.json]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_trace_records: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine import steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import _build, fused_lstm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = resolve_device("cuda")
    _build.build(["fused_head", "fused_lstm", "lstm_bwd", "quant_matmul",
                  "int8_attention"])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    butd = get_captioner(load_model_config(
        os.path.join(cs.HERE, "Configs", "Models", "BUTDDetection.json"),
        vocab_size=cs.FULL["vocab_size"]))
    params = butd.init_params(gen)
    cfg = butd.config
    visual = {"bu_feats": torch.relu(torch.randn(
        cs.B, cs.N_BOX, cfg.enc_dim, generator=gen, device=dev)),
        "bu_masks": torch.ones(cs.B, cs.N_BOX, device=dev)}
    fn = steps.make_greedy_decode(butd, max_len=cs.MAX_LEN,
                                  dtype=torch.float32, device="cuda")
    cuda_t = torch.autograd.DeviceType.CUDA
    fn(params, {}, visual)
    torch.cuda.synchronize()
    rows, ways = [], ("raw", "events", "pause")
    for rep in range(args.reps):
        for way in ways:
            fused_lstm.COUNT.n = 0
            fn(params, {}, visual)                 # the untraced decode
            torch.cuda.synchronize()
            launched = fused_lstm.COUNT.n
            if way == "pause":
                time.sleep(0.5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(params, {}, visual)
                torch.cuda.synchronize()
            raw = sum(1 for ev, name, _, _ in cs.raw_events(
                torch, prof.profiler.kineto_results)
                if ev.device_type() == cuda_t and "lstm_cell" in name)
            row = dict(rep=rep, way=way, launched=launched, raw=raw)
            if way == "events":
                row["events"] = sum(
                    1 for e in prof.events()
                    if e.device_type == cuda_t and "lstm_cell" in e.name)
            rows.append(row)
    short = {w: [r for r in rows if r["way"] == w
                 and r["raw"] != r["launched"]] for w in ways}
    split = [r for r in rows if "events" in r and r["events"] != r["raw"]]
    for w in ways:
        cs.log("%s (%s): %d of %d traces hold another K2 count than the %d "
               "launches: %s" % (w, smi, len(short[w]), args.reps,
                                 rows[0]["launched"],
                                 [(r["rep"], r["raw"]) for r in short[w]]))
    cs.log("the raw and the FunctionEvent readings of one trace differ in "
           "%d traces" % len(split))
    res = {"card": smi, "rows": rows,
           "short": {w: len(v) for w, v in short.items()},
           "readings_differ": len(split)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
