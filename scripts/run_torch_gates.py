#!/usr/bin/env python3
"""The port's synthetic-data quality gate for each model family at the
settings of the JAX package's newest complete records,
``QUALITY_r04_<model>_zipf.json``: ``--zipf --beam_tolerance 0.05
--n_images 2000 --epochs 5 --scst_epochs 4 --gate``, every other flag at
its default (256 wide, batch 64, threshold 0.9, ``lift``).  Each family
runs once, in a process of its own
(``python -m simpleimagecaptionzoo_tpu_torch.examples.train_synthetic``),
on one generated root that they share (the dataset is a function of its
flags; each run clears only its own model's checkpoints), and writes its
record as read, PASS or FAIL, to ``<out_dir>/QUALITY_torch_r01_<model>_zipf.json``
and its whole output to ``<out_dir>/gate_<model>.log``.  It prints each
record and each stage's seconds beside the card's name and power limit.

    python3 scripts/run_torch_gates.py [--models NIC AoADetection ...] \
        [--out_dir quality_gates] [--root DIR] [--gpu_id 0]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["NIC", "BUTDSpatial", "BUTDDetection", "AoASpatial",
          "AoADetection"]
ZIPF_ARGV = ["--zipf", "--beam_tolerance", "0.05", "--n_images", "2000",
             "--epochs", "5", "--scst_epochs", "4", "--gate"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", nargs="+", default=MODELS, choices=MODELS)
    ap.add_argument("--out_dir", default="quality_gates")
    ap.add_argument("--root", default=None,
                    help="the generated dataset's root (default: a new "
                         "temporary directory)")
    ap.add_argument("--gpu_id", default="0")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    root = args.root or tempfile.mkdtemp(prefix="torch_gates_")
    card = "cpu"
    if args.gpu_id != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    summary = {}
    for model in args.models:
        rec_path = os.path.join(out_dir,
                                "QUALITY_torch_r01_%s_zipf.json" % model)
        log_path = os.path.join(out_dir, "gate_%s.log" % model)
        cmd = [sys.executable, "-m",
               "simpleimagecaptionzoo_tpu_torch.examples.train_synthetic",
               "--model", model, "--root", root, "--gate_out", rec_path,
               "--gpu_id", args.gpu_id] + ZIPF_ARGV
        t0 = time.time()
        with open(log_path, "w") as log:
            rc = subprocess.run(cmd, cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT).returncode
        seconds = time.time() - t0
        with open(log_path) as f:
            lines = f.read().splitlines()
        stages = [ln for ln in lines if ln.startswith("STAGE_SECONDS: ")]
        rates = [ln for ln in lines if "steps/sec, first step excluded" in ln]
        summary[model] = dict(rc=rc, seconds=round(seconds, 1))
        if os.path.exists(rec_path):
            with open(rec_path) as f:
                summary[model]["record"] = json.load(f)
        print("%s: exit %d in %.1f s on %s" % (model, rc, seconds, card))
        print("  record %s" % json.dumps(summary[model].get("record")))
        print("  %s" % (stages[-1] if stages else "no STAGE_SECONDS line"))
        for ln in rates:
            print("  " + ln.strip())
        if rc not in (0, 1):
            print("  the run failed; its last lines:\n    "
                  + "\n    ".join(lines[-25:]))
        sys.stdout.flush()
    print(json.dumps({"card": card, "gates": summary}))
    return 0 if all(v["rc"] in (0, 1) for v in summary.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
