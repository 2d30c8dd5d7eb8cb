#!/usr/bin/env python3
"""chip_smoke.py's phase 21 alone on the card: the build of the port's
kernels (phase 2), then mid-epoch resume, data-parallel training and the
reference-checkpoint round trip at full width (chip_smoke.drive_phase21),
with the same gates; the kernels line of its entries and the results as
JSON (``--out``).  A quicker loop than the whole smoke run while phase 21
changes.

    python3 scripts/probe_phase21.py [--seed 0] [--out p21.json]
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
        print("probe_phase21: no CUDA device", file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
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
    model = get_captioner(ModelConfig(**cs.FULL))
    params = model.init_params(gen)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    kernels, on_path = {}, set()
    res = cs.drive_phase21(torch, args, dev, flush, kernels, on_path, model,
                           params)
    res["card"] = smi
    res["kernels"] = list(kernels.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    print(json.dumps({"kernels": res["kernels"]}))
    print(json.dumps({"phase21_seconds": res["seconds"], "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
