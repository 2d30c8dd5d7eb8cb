#!/usr/bin/env python3
"""chip_smoke.py's phase 24 alone on the card: the build of the port's
kernels (phase 2), then the synthetic-data quality gate through the port
(AoADetection at QUALITY_r03_AoADetection.json's settings, every kernel
launch recorded and each launch shape held against its plain version) and
the two demos, with the same gates (chip_smoke.drive_phase24); the kernels
line of its entries and the results as JSON (``--out``).  A quicker loop
than the whole smoke run while phase 24 changes.

    python3 scripts/probe_phase24.py [--seed 0] [--out p24.json]
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_phase24: no CUDA device", file=sys.stderr)
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
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    kernels, on_path = {}, set()
    res = cs.drive_phase24(torch, args, dev, smi, flush, kernels, on_path)
    missing = [k for k in on_path if not kernels[k].get("launches")]
    cs.require(not missing, "entries not launched on the path: %s" % missing)
    res["kernels"] = list(kernels.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    print(json.dumps({"kernels": res["kernels"]}, default=str))
    print(json.dumps({"phase24_seconds": res["seconds"], "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
