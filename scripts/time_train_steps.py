#!/usr/bin/env python3
"""XE training steps of the port at full width, timed on the card, from
the package tree under ``--root`` (so that two trees can be held side by
side in one call: a parent checkout unpacked beside this one).

    python3 scripts/time_train_steps.py [--root .] [--steps 6] [--seed 0]

AoADetection (chip_smoke.py phase 14's width, batch and Adam) with
scheduled sampling off, and BUTDDetection (phase 16's: examples/
bench_train.py's vocabulary, scheduled sampling on at 0.25), each in
float32 and in bf16 over float32 masters, B=128, captions padded to 22:
``--steps`` steps through engine.steps.make_xe_train_step, ms a step (host
clock around each step and a synchronize; the median of all but the
first), then one more step under torch.profiler tracing the card alone:
its busy milliseconds (the union of kernel spans), the span and the idle
share.  Prints one JSON line per model and dtype, with the root, the card
and its power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_train_steps: no CUDA device", file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.config import (ModelConfig,
                                                        load_model_config)
    from simpleimagecaptionzoo_tpu_torch.engine import optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from torch.profiler import ProfilerActivity, profile
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    b, t, n_box = 128, 22, 36
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    models = [
        ("AoADetection", get_captioner(ModelConfig(
            model_type="AoADetection", vocab_size=10102, embed_dim=1024,
            hidden_dim=1024, enc_dim=2048, num_heads=8, num_refine_layers=6,
            max_bu_len=n_box)), 2e-4, False),
        ("BUTDDetection", get_captioner(load_model_config(
            os.path.join(root, "Configs", "Models", "BUTDDetection.json"),
            vocab_size=9962)), None, True)]
    for name, model, lr, ss in models:
        params = model.init_params(gen)
        lr = lr if lr is not None else model.config.lr
        v, enc_dim = model.config.vocab_size, model.config.enc_dim
        rng = np.random.default_rng(args.seed)
        caps = rng.integers(4, v, size=(b, t))
        caps[:, 0] = 1
        lens = rng.integers(8, t, size=(b,))
        for i, n in enumerate(lens):
            caps[i, n - 1] = 2
            caps[i, n:] = 0
        g0 = torch.Generator(device=dev).manual_seed(args.seed + 1)
        batch = {"visual": {
            "bu_feats": torch.relu(torch.randn(b, n_box, enc_dim,
                                               generator=g0, device=dev)),
            "bu_masks": torch.ones(b, n_box, device=dev)},
            "captions": torch.from_numpy(caps).to(dev),
            "lengths": torch.from_numpy(lens).to(dev)}
        labels = model.param_labels(params)
        for dn, cdtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            tx = optim.make_grad_transform("Adam", 0.1)
            step = steps.make_xe_train_step(
                model, tx, labels, smoothing=0.1, compute_dtype=cdtype,
                ss_active=ss, device="cuda")
            st = TrainState.create(params, tx)
            g_run = torch.Generator(device=dev).manual_seed(args.seed + 2)
            ss_prob = 0.25 if ss else 0.0
            times = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = step(st, batch, g_run, ss_prob, lr, 0.0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st, _ = step(st, batch, g_run, ss_prob, lr, 0.0)
                torch.cuda.synchronize()
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            busy, end = 0.0, spans[0][0]
            for s, e in spans:
                busy += max(0.0, e - max(s, end))
                end = max(end, e)
            span = spans[-1][1] - spans[0][0]
            rest = sorted(times[1:])
            print(json.dumps(dict(
                root=root, card=card, model=name, dtype=dn,
                scheduled_sampling=ss, ms_per_step=rest[len(rest) // 2],
                step_ms=times, device_busy_ms=busy / 1e3,
                device_span_ms=span / 1e3, idle_share=1 - busy / span,
                kernel_launches=len(spans))), flush=True)
            del st
    return 0


if __name__ == "__main__":
    sys.exit(main())
