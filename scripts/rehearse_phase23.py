#!/usr/bin/env python3
"""chip_smoke.py's phase 23 on the CPU at small sizes: the same
orchestration, children and gates (chip_smoke.drive_phase23): (a) the
COCO14 dry run of AoADetection and NIC at 32 wide (the tool's CPU form,
--gpu_id cpu), (b) the model axis of two gloo processes with AoADetection
32 wide over the full vocabulary of 10,102 (a shard of 5,051 columns),
decodes at B=16 with 6 boxes and the XE step at B=8.  No kernel launches,
timings or kernel entries: those need the card.  It finds wrong paths,
arguments and shapes before a chip call; it times nothing that counts.

    python3 scripts/rehearse_phase23.py
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SMALL = dict(model_type="AoADetection", vocab_size=cs.CLI_VOCAB,
             embed_dim=32, hidden_dim=32, enc_dim=2048, num_heads=2,
             num_refine_layers=1, max_bu_len=6)


def main() -> int:
    import torch
    torch.set_num_threads(1)
    cs.CHILD_THREADS = 1
    cs.PHASE23_S = cs.CHILD_S = 3600.0
    dims = dict(aoa=SMALL, b=16, n_box=SMALL["max_bu_len"], xe_b=8, t=8)
    t0 = time.time()
    out = cs.drive_phase23(torch, argparse.Namespace(seed=0),
                           torch.device("cpu"), "CPU (rehearsal)", None, {},
                           set(), dims=dims, gpu="cpu")
    print(json.dumps(out, default=str))
    print("rehearsal of phase 23 passed in %.1f s (CPU)" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
