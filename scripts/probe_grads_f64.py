#!/usr/bin/env python3
"""The first XE step's gradients through the kernels and through the plain
versions, each against the same step in float64, on the card.

    python3 scripts/probe_grads_f64.py [--seed 0]

AoADetection (chip_smoke.py phase 14's width and batch) and BUTDDetection
(phase 16's: examples/bench_train.py's vocabulary), float32, scheduled
sampling off and on at 0.25: the loss and every leaf's gradient of one XE
step (engine/steps.xe_loss, B=128, captions padded to 22, the batch and
the draws of chip_smoke.drive_xe) three ways: through the kernels in
float32 (K2's whole backward on the "tf32x3" route), through the plain
versions in float32 (cuBLAS float32 products, TF32 off), and through the
plain versions in float64 (params and features cast; the loss itself is
float32).  Per leaf, the norm of each float32 run's difference from the
float64 run over that leaf's norm (floored at 1e-3 of the largest leaf's,
as chip_smoke's gate is), and the same between the two float32 runs.
Prints one JSON line per family and variant.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_grads_f64: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from simpleimagecaptionzoo_tpu_torch.config import (ModelConfig,
                                                        load_model_config)
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import _build
    dev = torch.device("cuda")
    _build.build(["fused_lstm", "lstm_bwd", "fused_head"])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fams = [("AoADetection", get_captioner(ModelConfig(**cs.FULL)))]
    fams.append(("BUTDDetection", get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", "BUTDDetection.json"),
        vocab_size=cs.BENCH_VOCAB))))
    for name, model in fams:
        params = model.init_params(gen)
        v, enc_dim = model.config.vocab_size, model.config.enc_dim
        rng = np.random.default_rng(args.seed)
        caps = rng.integers(4, v, size=(cs.TRAIN_B, cs.TRAIN_T))
        caps[:, 0] = 1
        lens = rng.integers(8, cs.TRAIN_T, size=(cs.TRAIN_B,))
        for i, n in enumerate(lens):
            caps[i, n - 1] = 2
            caps[i, n:] = 0
        g0 = torch.Generator(device=dev).manual_seed(args.seed + 1)
        batch = {"visual": {
            "bu_feats": torch.relu(torch.randn(cs.TRAIN_B, cs.N_BOX, enc_dim,
                                               generator=g0, device=dev)),
            "bu_masks": torch.ones(cs.TRAIN_B, cs.N_BOX, device=dev)},
            "captions": torch.from_numpy(caps).to(dev),
            "lengths": torch.from_numpy(lens).to(dev)}
        names = optim.tree_leaves(cs._paths(params))
        for ss in (False, True):
            def grads(dtype):
                g = torch.Generator(device=dev).manual_seed(args.seed + 2)
                leaves = [p.detach().requires_grad_()
                          for p in optim.tree_leaves(params)]
                loss, _, _ = steps.xe_loss(
                    model, optim.tree_unflatten(params, leaves), {}, batch,
                    g, cs.TRAIN_SS if ss else 0.0, smoothing=0.1,
                    compute_dtype=dtype, ss_active=ss,
                    ss_generator=steps.draw_generator_for(
                        torch.Generator(device=dev).manual_seed(
                            args.seed + 2), 0, dev))
                return float(loss.detach()), torch.autograd.grad(loss,
                                                                 leaves)

            k_loss, k = grads(None)
            with holds.plain_versions():
                p_loss, p = grads(None)
                e_loss, e = grads(torch.float64)
            norms = [float(t.double().norm()) for t in e]
            floor = 1e-3 * max(norms)

            def rel(a, b):
                out = [float((x.double() - y.double()).norm()) / max(n, floor)
                       for x, y, n in zip(a, b, norms)]
                worst = sorted(zip(out, names))[-3:]
                return max(out), worst

            rec = dict(family=name, scheduled_sampling=ss,
                       loss=dict(kernels=k_loss, plain=p_loss,
                                 plain64=e_loss))
            for tag, (a, b) in (("kernels_vs_float64", (k, e)),
                                ("plain_vs_float64", (p, e)),
                                ("kernels_vs_plain", (k, p))):
                rec[tag], rec[tag + "_worst"] = rel(a, b)
            print(json.dumps(rec), flush=True)
            del k, p, e
    return 0


if __name__ == "__main__":
    sys.exit(main())
