#!/usr/bin/env python3
"""chip_smoke.py's phase 21 on the CPU at small sizes: the same
orchestration, children and gates (chip_smoke.drive_phase21) with
AoADetection 32 wide, (b)'s batches of 8 and (c)'s decode at B=16, the
CLI and the tools at --gpu_id cpu, gloo for (b) (no NCCL, no kernel entries:
both need the card).  (b) leaves the from-pixels run out: at two images of
64 px a process the full trunk's float32 rounding grows past DP_PX_TOL
through its depth.  It finds wrong paths, arguments and shapes before a
chip call; it times nothing that counts.

    python3 scripts/rehearse_phase21.py

Every process computes on one host thread: (a) runs six CLI children at
once, and its resumes are bit-identical on the CPU at one thread only.  At
two or more, the CPU's backward of the word embedding (the index's
accumulating put of each token's row) sums repeated ids in an order that
changes from run to run, so two uninterrupted XE runs already differ in
their last bits (the embedding table's gradient by up to 3e-10).  On the
card that sum runs on the GPU, and the children keep CHILD_THREADS.
"""
import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SMALL = dict(model_type="AoADetection", vocab_size=cs.CLI_VOCAB,
             embed_dim=32, hidden_dim=32, enc_dim=2048, num_heads=2,
             num_refine_layers=1, max_bu_len=6)


def main() -> int:
    import torch
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    torch.set_num_threads(1)
    cs.CHILD_THREADS = 1
    cs.PHASE21_S = cs.CHILD_S = 3600.0
    cs.REF_B = 16
    cs.DP_PARTS = ["xe", "scst", "eval"]
    models = tempfile.mkdtemp(prefix="rehearse_phase21_")
    with open(os.path.join(models, "AoADetection.json"), "w") as f:
        json.dump(dict({k: v for k, v in SMALL.items()
                        if k not in ("vocab_size", "max_bu_len")},
                       optimizer="Adam", lr=2e-4, scst_lr=2e-5), f)
    model = get_captioner(ModelConfig(**SMALL))
    params = model.init_params(torch.Generator().manual_seed(0))
    dims = dict(aoa=SMALL, n_box=SMALL["max_bu_len"], b=8, t=8, px_b=4,
                side=64, eval_b=4,
                px=dict(embed_dim=16, hidden_dim=16, atten_dim=8))
    t0 = time.time()
    out = cs.drive_phase21(torch, argparse.Namespace(seed=0),
                           torch.device("cpu"), None, {}, set(), model,
                           params, dims=dims, models=models + os.sep,
                           gpu="cpu")
    print(json.dumps({k: v for k, v in out.items()
                      if k != "kernel_entries"}, default=str))
    print("rehearsal of phase 21 passed in %.1f s (CPU)" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
