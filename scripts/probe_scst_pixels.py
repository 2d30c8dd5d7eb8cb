#!/usr/bin/env python3
"""SCST's first step from pixels on the card: K2's float32 forward and the
gradients it moves.

    python3 scripts/probe_scst_pixels.py [--family BUTDSpatial] [--variants]
        [--relu [--plant D ...]] [--draws 1] [--out x.json]

BUTDSpatial (or --family) at its published width with the full ResNet-101
(random, statistics calibrated as chip_smoke.py phase 17 calibrates them),
B=128 photo-like images, chip_smoke.py phase 15's references and table:
the first SCST step's gradients (engine/steps.scst_loss with the fine-tune
scope) through the kernels, through the plain versions (the kernel run's
ids replayed), in float64 (the same replay) and with K2's forward plain and
its backward on the kernels, and the reverse; each leaf outside the ResNet
against float64 (chip_smoke.beyond_float64: its distance over its norm,
floored at 1e-3 of the largest leaf's).  Then K2's forward on the
rollout's own inputs, against float64: the mean |error| of h' and c', and
the mean over columns of |the error's mean over rows| (the part the batch's
sums do not average out), for the kernel, the plain version and the 3xTF32
products emulated in PyTorch (ops/tf32.mm_3xtf32).

The tf32x3 consumer (csrc/hopper.cuh) sums a 32-value stage's 12 products
in a fresh partial on the tensor core, then adds it into the float32
result.  With --variants, the same for copies of the kernels built from a
patched hopper.cuh (into the gitignored build directory): "k8", a partial
a k8 step (its 3 products), and "product", a partial a product; each
copy's K2 forward is also timed (device only) at B=128 (E=4,096) and
B=384 (E=2,048) beside the kernel's.  --draws N repeats the gradients'
comparison on N draws of the data (seeds 0 .. N-1; the rest on the first).
--relu compares on the kernel run's branch of every torch.relu
(chip_smoke.relu_branches); --plant D ... adds, for each D, a kernel run
whose K2 h' is shifted by D times its largest |h'| and the flips the plain
replay reads against it: what chip_smoke.FLIP_TOL sees of such a fault.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the tf32x3 consumer's products: a 32-value stage (12 products) into one
# fresh partial
STAGE = """    split_a(frag + s * STAGE_BYTES, hi, lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
      const uint64_t dl = desc_a(st + A_BYTES + B_BYTES + kk * 32);
      wgmma_m64n128k8_tf32(part, lo[kk], dh, kk > 0);   // the first starts the partial
      wgmma_m64n128k8_tf32(part, hi[kk], dl, 1);
      wgmma_m64n128k8_tf32(part, hi[kk], dh, 1);
    }
    wgmma_commit();
    fence_regs(part);
    wgmma_wait<0>();
    fence_regs(part);
    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
"""


def _group(ops):
    """wgmma products into a fresh partial, then added into acc."""
    body = "      fence_regs(part);\n      wgmma_fence();\n"
    for i, (a, d) in enumerate(ops):
        body += ("      wgmma_m64n128k8_tf32(part, %s[kk], %s, %d);\n"
                 % (a, d, 1 if i else 0))
    return body + ("      wgmma_commit();\n      fence_regs(part);\n"
                   "      wgmma_wait<0>();\n      fence_regs(part);\n"
                   "#pragma unroll\n"
                   "      for (int i = 0; i < 64; ++i) acc[i] += part[i];\n")


def _consume(groups):
    body = ("    split_a(frag + s * STAGE_BYTES, hi, lo);\n"
            "#pragma unroll\n    for (int kk = 0; kk < BK / 8; ++kk) {\n"
            "      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);\n"
            "      const uint64_t dl = desc_a(st + A_BYTES + B_BYTES + kk * "
            "32);\n")
    for g in groups:
        body += _group(g)
    return body + ("    }\n    if (threadIdx.x % 128 == 0) "
                   "mbar_arrive(&r.empty[s]);\n")


PRODUCTS = (("lo", "dh"), ("hi", "dl"), ("hi", "dh"))
# the corrections (a_lo b_hi, a_hi b_lo) of the stage's four k8 steps in
# one fresh partial, then each k8 step's a_hi b_hi in a fresh partial
SPLIT = """    split_a(frag + s * STAGE_BYTES, hi, lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
      const uint64_t dl = desc_a(st + A_BYTES + B_BYTES + kk * 32);
      wgmma_m64n128k8_tf32(part, lo[kk], dh, kk > 0);
      wgmma_m64n128k8_tf32(part, hi[kk], dl, 1);
    }
    wgmma_commit();
    fence_regs(part);
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
      fence_regs(part);
      wgmma_fence();
      wgmma_m64n128k8_tf32(part, hi[kk], dh, 0);
      wgmma_commit();
      fence_regs(part);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);
"""
VARIANTS = {"k8": _consume([PRODUCTS]),
            "product": _consume([[p] for p in PRODUCTS]), "split": SPLIT}


def _kahan_group(ops):
    """wgmma products onto the carried compensation in ``part``, then
    added into acc by TwoSum, whose rounding error ``part`` carries on."""
    body = "      fence_regs(part);\n      wgmma_fence();\n"
    for a, d in ops:
        body += "      wgmma_m64n128k8_tf32(part, %s[kk], %s, 1);\n" % (a, d)
    return body + ("      wgmma_commit();\n      fence_regs(part);\n"
                   "      wgmma_wait<0>();\n      fence_regs(part);\n"
                   "#pragma unroll\n      for (int i = 0; i < 64; ++i) {\n"
                   "        const float s_ = acc[i] + part[i];\n"
                   "        const float bp = s_ - acc[i];\n"
                   "        part[i] = (acc[i] - (s_ - bp)) + (part[i] - bp);\n"
                   "        acc[i] = s_;\n      }\n")


def _kahan(groups):
    body = ("    split_a(frag + s * STAGE_BYTES, hi, lo);\n"
            "#pragma unroll\n    for (int kk = 0; kk < BK / 8; ++kk) {\n"
            "      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);\n"
            "      const uint64_t dl = desc_a(st + A_BYTES + B_BYTES + kk * "
            "32);\n")
    for g in groups:
        body += _kahan_group(g)
    return body + ("    }\n    if (threadIdx.x % 128 == 0) "
                   "mbar_arrive(&r.empty[s]);\n")


# the consume loop's opening and closing, where the compensated variants
# zero the carried compensation and add its last value
OPEN = ("void consume(const Ring& r, float (&acc)[64], int nk, int wg) {\n"
        "  float part[64];                             // one stage's "
        "products\n")
CLOSE = STAGE + "  }\n}\n\n}  // namespace tf32x3"
KAHAN = {"kahan": [[p] for p in PRODUCTS],
         "kahan_kk": [PRODUCTS[:2], PRODUCTS[2:]]}


def _patched(hop, name):
    if name in VARIANTS:
        return hop.replace(STAGE, VARIANTS[name])
    body = _kahan(KAHAN[name])
    out = hop.replace(OPEN, OPEN + "#pragma unroll\n  for (int i = 0; i < 64; "
                      "++i) part[i] = 0.f;\n")
    return out.replace(CLOSE, body + "  }\n#pragma unroll\n  for (int i = 0; "
                       "i < 64; ++i) acc[i] += part[i];\n}\n\n}  // "
                       "namespace tf32x3")
LIBS = ("fused_head", "fused_lstm", "lstm_bwd")


def make_variants(_build):
    """A csrc copy per variant (patched hopper.cuh), its libraries built
    with one nvcc each, all started together -> {variant: csrc dir}."""
    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f:
        hop = f.read()
    if hop.count(STAGE) != 1 or hop.count(OPEN) != 1 or \
            hop.count(CLOSE) != 1:
        raise RuntimeError("probe: tf32x3's consume loop is not as expected")
    dirs, procs = {"kernel": _build.CSRC_DIR}, []
    for name in list(VARIANTS) + list(KAHAN):
        d = os.path.join(_build.BUILD_DIR, "probe_scst_pixels", name)
        if os.path.exists(d):
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(_patched(hop, name))
        dirs[name] = d
        for lib in LIBS:
            out = os.path.join(d, "lib%s.so" % lib)
            procs.append((name, lib, out, subprocess.Popen(
                [_build.nvcc_path()] + [f for f in _build.NVCC_FLAGS
                                        if f not in ("-Xptxas", "-v")]
                + ["-I", d, "-o", out, os.path.join(d, lib + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, lib, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("probe: nvcc failed for %s %s:\n%s"
                               % (name, lib, text))
    return dirs


def use(_build, d):
    """Load the libraries of csrc copy ``d`` from now on."""
    import ctypes
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head, fused_lstm
    for lib in LIBS:
        _build._LIBS.pop(lib, None)
    if d == _build.CSRC_DIR:
        return
    declare = {"fused_head": fused_head._declare,
               "fused_lstm": fused_lstm._declare,
               "lstm_bwd": fused_lstm._declare_products}
    for lib in LIBS:
        L = ctypes.CDLL(os.path.join(d, "lib%s.so" % lib))
        declare[lib](L)
        _build._LIBS[lib] = L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="BUTDSpatial")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--relu", action="store_true",
                    help="also compare on one branch of every torch.relu: "
                         "the plain and float64 replays take the kernel "
                         "run's masks")
    ap.add_argument("--plant", type=float, nargs="*", default=[],
                    help="with --relu: for each value d, a kernel run with "
                         "K2's h' shifted by d times its largest |h'|, its "
                         "masks replayed by the plain run; the flips show "
                         "what chip_smoke.FLIP_TOL reads of such a fault "
                         "(the rest of the comparisons skipped)")
    ap.add_argument("--draws", type=int, default=1,
                    help="data draws (seeds 0, 1, ...): the ResNet, its "
                         "statistics, the images and the decoder's weights")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import _build, fused_lstm, tf32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = resolve_device("cuda")
    _build.build(["fused_head", "fused_lstm", "lstm_bwd", "quant_matmul",
                  "int8_attention"])
    dirs = make_variants(_build) if args.variants else {
        "kernel": _build.CSRC_DIR}
    ns = argparse.Namespace(seed=0)
    td, probe, ref_ids, ref_lens, ref_norms = C.scst_data(torch, ns, dev,
                                                          C.BENCH_VOCAB)
    model = get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", args.family + ".json"),
        vocab_size=C.CLI_VOCAB))
    saved = {n: getattr(m, n) for m, n, _ in holds.plain_swaps()}
    flush = torch.empty(32 * 1024 * 1024, device=dev)

    def only(which):
        return lambda name, plain: plain if name in which else saved[name]

    def g():
        return torch.Generator(device=dev).manual_seed(4)

    def k2_ms(gen):
        res = {}
        for b, e in ((128, 4096), (384, 2048)):
            hd = 1024
            w = torch.randn(e + hd, 4 * hd, generator=gen, device=dev) * 0.02
            bias = torch.zeros(4 * hd, device=dev)
            x, h, c = (torch.randn(b, n, generator=gen, device=dev)
                       for n in (e, hd, hd))
            split = tf32.prepare_split(w)
            res["B%dE%d" % (b, e)] = C.time_ms(
                torch, lambda: fused_lstm.lstm_cell_fused(w, bias, x, h, c,
                                                          split),
                flush, lead=C.DEVICE_LEAD)
        return res

    def relu_branch(draw, grads, greedy, rep, trunk, names):
        """The kernel run's gradients against the plain and float64
        replays on the kernel run's branch of every torch.relu (its masks
        replayed: x * mask); the flips, elements whose sign the replay's
        pre-activation does not share with the kernel run's, counted with
        their largest |x| over the tensor's largest."""
        relu = torch.relu
        masks, flips = [], []

        def recording(x):
            masks.append(x > 0)
            return relu(x)

        def replaying(x):
            m = masks[len(flips) % len(masks)]
            d = (x > 0) != m
            flips.append((int(d.sum()), float(x.abs()[d].max()) / float(
                x.abs().max()) if bool(d.any()) else 0.0))
            return x * m.to(x.dtype)
        torch.relu = recording
        try:
            _, _, kg = grads(greedy, rep)
        finally:
            torch.relu = relu
        out = {}
        for label, dtype in (("plain", None), ("float64", torch.float64)):
            flips.clear()
            torch.relu = replaying
            try:
                with holds.plain_versions():
                    out[label] = grads(greedy, rep, dtype)[2]
            finally:
                torch.relu = relu
            out[label + "_flips"] = (sum(n for n, _ in flips),
                                     max(f for _, f in flips))
        # planted: K2's h' shifted in the kernel run, the plain replay's
        # flips against its branches
        run = fused_lstm.lstm_cell_fused
        for d in args.plant:
            def shifted(*a, **kw):
                h2, c2 = run(*a, **kw)
                return h2 + d * h2.detach().abs().max(), c2
            masks.clear()
            fused_lstm.lstm_cell_fused = shifted
            torch.relu = recording
            try:
                grads(greedy, rep)
            finally:
                torch.relu = relu
                fused_lstm.lstm_cell_fused = run
            flips.clear()
            torch.relu = replaying
            try:
                with holds.plain_versions():
                    grads(greedy, rep)
            finally:
                torch.relu = relu
            out["planted %g" % d] = (sum(n for n, _ in flips),
                                     max(f for _, f in flips))
            print("draw %d, K2's h' planted +%g of its largest |h'|: flips "
                  "against the plain replay %s (count, largest |x| over the "
                  "tensor's largest; FLIP_TOL %g)"
                  % (draw, d, out["planted %g" % d], C.FLIP_TOL), flush=True)
        r = C.beyond_float64(kg, out["plain"], out["float64"], skip=trunk)
        print("draw %d, kernel, on the kernel run's relu branch: the largest "
              "%.3g (the plain replay's %.3g), excess %.3g; the worst %s; "
              "flips against the plain run %s, against float64 %s (count, "
              "largest |x| over the tensor's largest)"
              % (draw, r[1], r[2], r[0], [(names[i], a) for _, a, _, i in
                                          r[3]], out["plain_flips"],
                 out["float64_flips"]), flush=True)
        return dict(largest=r[1], plain=r[2], excess=r[0],
                    flips_plain=out["plain_flips"],
                    flips_float64=out["float64_flips"],
                    planted={k[8:]: v for k, v in out.items()
                             if k.startswith("planted ")})

    out = {"card": card, "family": args.family, "draws": []}
    for draw in range(args.draws):
        # the draw's ResNet, statistics, images and decoder weights
        gen = torch.Generator(device=dev).manual_seed(draw)
        cnn, st0 = resnet.init(gen)
        cal = C.calibrated_stats(torch, cnn, st0,
                                 C.photo_batch(torch, gen, C.CAL_B, 224, dev))
        visual = {"img_tensors": C.photo_batch(torch, gen, C.TRAIN_B, 224,
                                               dev)}
        params = dict(model.init_params(gen), cnn=cnn)
        ms = {"cnn_stats": cal}
        batch = {"visual": visual, "ref_ids": ref_ids, "ref_lens": ref_lens,
                 "ref_norms": ref_norms}
        names = optim.tree_leaves(C._paths(params))
        trunk = [i for i, n in enumerate(names) if n.startswith("cnn.")]

        def grads(greedy, replay=None, dtype=None):
            leaves = [p.detach().requires_grad_()
                      for p in optim.tree_leaves(params)]
            loss, _, _, seq, drawn = steps.scst_loss(
                model, steps._stop_cnn_grads(
                    optim.tree_unflatten(params, leaves), False), ms, batch,
                td, probe, greedy, g(), steps.draw_generator_for(g(), 0, dev),
                max_len=C.MAX_LEN, compute_dtype=dtype, replay=replay)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            return seq, drawn, [torch.zeros_like(p) if x is None else x
                                for p, x in zip(leaves, got)]

        use(_build, _build.CSRC_DIR)
        greedy = steps.greedy_baseline(model, params, ms, visual, C.MAX_LEN)
        seq, drawn, _ = grads(greedy)
        rep = (seq, drawn)
        with holds.plain_versions():
            _, _, pg = grads(greedy, rep)
            _, _, eg = grads(greedy, rep, torch.float64)

        def emulated(w_cat, b_sum, x, h, c, split=None):
            gates = tf32.mm_3xtf32(torch.cat([x, h], -1), w_cat) + b_sum
            return fused_lstm.gate_math(gates, c)
        # the plain run with K2's product in 3xTF32, summed in IEEE float32
        with holds.plain_versions(lambda name, plain: emulated
                                  if name == "lstm_cell_fused" else plain):
            _, _, xg = grads(greedy, rep)
        emul = C.beyond_float64(xg, pg, eg, skip=trunk)

        def against(kg, label):
            r = C.beyond_float64(kg, pg, eg, skip=trunk)
            worst = [(names[i], a) for _, a, _, i in r[3]]
            print("draw %d, %s: leaves outside the ResNet against float64 "
                  "(over their norm, floored): the largest %.3g (the plain "
                  "run's %.3g, the 3xTF32-emulated plain run's %.3g), "
                  "excess over the plain run %.3g; the worst %s"
                  % (draw, label, r[1], r[2], emul[1], r[0], worst),
                  flush=True)
            return dict(largest=r[1], plain=r[2], emulated=emul[1],
                        excess=r[0], worst=worst)

        def k2_errors(label):
            rec = []
            run = fused_lstm.lstm_cell_fused

            def wrap(*a, **kw):
                rec.append((tuple(t.detach().clone()
                                  if isinstance(t, torch.Tensor) else t
                                  for t in a), kw))
                return run(*a, **kw)
            fused_lstm.lstm_cell_fused = wrap
            try:
                grads(greedy, rep)
            finally:
                fused_lstm.lstm_cell_fused = run
            agg = {}
            with torch.no_grad():
                for a, kw in rec:
                    w_cat, b_sum, x, h, c = a[:5]
                    eh, ec = fused_lstm.lstm_cell_plain(*(t.double()
                                                          for t in a[:5]))
                    gates = tf32.mm_3xtf32(torch.cat([x, h], -1),
                                           w_cat) + b_sum
                    got_k = run(*a, **kw)
                    why = holds._HOLDS["lstm_cell_fused"](
                        holds._lstm_plain, a, got_k)
                    st = agg.setdefault("kernel calls breaking K2's hold",
                                        [0.0, 0.0])
                    st[0] += float(why is not None)
                    for how, (gh, gc) in (
                            ("kernel", got_k),
                            ("plain", fused_lstm.lstm_cell_plain(*a[:5])),
                            ("3xtf32 emulated",
                             fused_lstm.gate_math(gates, c))):
                        for nm, got, ex in (("h'", gh, eh), ("c'", gc, ec)):
                            d = got.double() - ex
                            st = agg.setdefault("%s %s" % (how, nm),
                                                [0.0, 0.0])
                            st[0] += float(d.abs().mean()) / len(rec)
                            st[1] += float(d.mean(0).abs().mean()) / len(rec)
            for k, (m, col) in sorted(agg.items()):
                print("draw %d, %s: K2 forward on the rollout's inputs, %s: "
                      "mean |err| %.3g, mean |column mean of err| %.3g"
                      % (draw, label, k, m, col), flush=True)
            return {k: dict(mean_abs=m, column_mean_abs=col)
                    for k, (m, col) in agg.items()}

        res = {}
        if args.relu:
            res["relu"] = relu_branch(draw, grads, greedy, rep, trunk, names)
            if args.plant:
                out["draws"].append(res)
                continue
        for name, d in dirs.items():
            use(_build, d)
            _, _, kg = grads(greedy, rep)
            r = res[name] = {"kernels": against(kg, name)}
            r["k2_forward_errors"] = k2_errors(name)
            if draw:
                continue
            with holds.plain_versions(only({"lstm_cell_fused"})):
                _, _, mixed = grads(greedy, rep)
            r["plain forward, kernel backward"] = against(
                mixed, name + ", K2's forward plain")
            with holds.plain_versions(only({"lstm_cell_bwd_full",
                                            "lstm_cell_bwd"})):
                _, _, mixed = grads(greedy, rep)
            r["kernel forward, plain backward"] = against(
                mixed, name + ", K2's backward plain")
            r["k2_forward_device_ms"] = k2_ms(gen)
            print("%s: K2 forward device ms %s (%s)" % (
                name, r["k2_forward_device_ms"], card), flush=True)
        out["draws"].append(res)
    use(_build, _build.CSRC_DIR)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
