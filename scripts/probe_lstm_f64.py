#!/usr/bin/env python3
"""K2's float32 route and its plain version, each against the cell's
function in float64, on BUTDSpatial's cells from pixels and in feature
mode.

    python3 scripts/probe_lstm_f64.py [--seed 0]

Builds BUTDSpatial at the width of Configs/Models/BUTDSpatial.json (vocab
10,102) with the full ResNet-101, its running statistics set to 64
photo-like images' own (``chip_smoke.py`` phase 17's recipe), and runs one
float32 beam-3 decode of 384 other images on the GPU; then BUTDDetection
in feature mode on ``relu(randn)`` boxes (phase 10's input).  Every K2
call is also computed by the plain version (cuBLAS float32) and by the
same function in float64.  Per cell width it prints how far each float32
result (h', c') lies from float64, how far beyond the float32 hold (rtol
and atol 1e-5) each lies, the largest |x|, |c| and gate, and the largest
row sum of |[x, h]| |W|: the magnitude the float32 sums round at.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HOLD = 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as C
    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine import steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def model(family):
        return get_captioner(load_model_config(os.path.join(
            HERE, "Configs", "Models", family + ".json"), vocab_size=10102))

    def f64(w, b, x, h, c):
        z = torch.cat([x, h], -1).double() @ w.double() + b.double()
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        c2 = torch.sigmoid(zf) * c.double() + torch.sigmoid(zi) * torch.tanh(
            zg)
        return torch.sigmoid(zo) * torch.tanh(c2), c2, z

    def beyond(got, want):
        return float(((got.double() - want).abs() - HOLD
                      - HOLD * want.abs()).clamp_min(0).max())

    rows = []
    fused = fused_lstm.lstm_cell_fused

    def probe(w, b, x, h, c, split=None):
        out = fused(w, b, x, h, c, split)
        plain = fused_lstm.lstm_cell_plain(w, b, x, h, c)
        h64, c64, z = f64(w, b, x, h, c)
        xh = torch.cat([x, h], -1).double()
        rows.append(dict(
            e=x.shape[1],
            kernel_err=max(float((out[0].double() - h64).abs().max()),
                           float((out[1].double() - c64).abs().max())),
            plain_err=max(float((plain[0].double() - h64).abs().max()),
                          float((plain[1].double() - c64).abs().max())),
            kernel_beyond=max(beyond(out[0], h64), beyond(out[1], c64)),
            plain_beyond=max(beyond(plain[0], h64), beyond(plain[1], c64)),
            x=float(x.abs().max()), c=float(c.abs().max()),
            z=float(z.abs().max()),
            sum_xw=float((xh.abs() @ w.double().abs()).max())))
        return out

    def report(tag):
        print(tag)
        for e in sorted({r["e"] for r in rows}):
            rs = [r for r in rows if r["e"] == e]
            top = {k: max(r[k] for r in rs) for k in rs[0] if k != "e"}
            print("  E=%d, %d calls: |h' or c' - float64| kernel %.3g, plain "
                  "%.3g; beyond the hold: kernel %.3g in %d calls, plain "
                  "%.3g in %d calls; max |x| %.3g, |c| %.3g, |gate| %.3g, "
                  "row sum |x||w| %.3g"
                  % (e, len(rs), top["kernel_err"], top["plain_err"],
                     top["kernel_beyond"],
                     sum(r["kernel_beyond"] > 0 for r in rs),
                     top["plain_beyond"],
                     sum(r["plain_beyond"] > 0 for r in rs), top["x"],
                     top["c"], top["z"], top["sum_xw"]))
        rows.clear()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    fused_lstm.lstm_cell_fused = probe
    try:
        sp = model("BUTDSpatial")
        prm = sp.init_params(gen, include_cnn=True)
        ms = {"cnn_stats": C.calibrated_stats(
            torch, prm["cnn"], sp.init_model_state()["cnn_stats"],
            C.photo_batch(torch, gen, C.CAL_B, 224, dev))}
        vis = {"img_tensors": C.photo_batch(torch, gen, C.B, 224, dev)}
        with torch.inference_mode():
            enc, _ = sp.encode(prm, vis, model_state=ms)
        print("BUTDSpatial from pixels: features mean %.3f, max %.3f; "
              "their 49-region mean up to %.3f"
              % (float(enc.features.mean()), float(enc.features.max()),
                 float(enc.mean.abs().max())))
        steps.make_beam_decode(sp, beam_size=C.BEAM, max_steps=C.MAX_LEN,
                               dtype=torch.float32)(prm, ms, vis)
        torch.cuda.synchronize()
        report("BUTDSpatial from pixels, float32 beam 3 (%s)" % smi)

        det = model("BUTDDetection")
        bvis = {"bu_feats": torch.relu(torch.randn(
            C.B, C.N_BOX, det.config.enc_dim, generator=gen, device=dev)),
            "bu_masks": torch.ones(C.B, C.N_BOX, device=dev)}
        steps.make_beam_decode(det, beam_size=C.BEAM, max_steps=C.MAX_LEN,
                               dtype=torch.float32)(det.init_params(gen), {},
                                                    bvis)
        torch.cuda.synchronize()
        report("BUTDDetection in feature mode, relu(randn) boxes, float32 "
               "beam 3 (%s)" % smi)
    finally:
        fused_lstm.lstm_cell_fused = fused
    return 0


if __name__ == "__main__":
    sys.exit(main())
