#!/usr/bin/env python3
"""Where the time of the "tf32x2" route goes (K3 in float32), on one CUDA GPU.

    python3 scripts/probe_tf32x2.py [--out results.json]

Builds copies of simpleimagecaptionzoo_tpu_torch/csrc/quant_matmul.cu, each
with a patched csrc/hopper.cuh beside it, into the port's gitignored build
directory:

  kernel        the kernel as it is;
  instrumented  the kernel with SM-cycle counters (in shared memory): per
                block, consumer warpgroup 0's thread 0 sums the cycles it
                spends waiting for a stage (x loaded, q widened), splitting
                x, in the products (wgmma.fence to wgmma.wait; both
                warpgroups' products share the tensor cores), and freeing
                the stage and adding its partial; the producer's threads 0
                (which also issues the TMA loads) and 1 the cycles they
                wait for a stage's TMA data, widen it (with the proxy fence
                and the arrival), and (thread 0) wait for a free slot and
                issue the next loads;
  split by integers
                x rounded to TF32 by two integer operations instead of
                cvt.rna.tf32.f32 (split_a is shared with the 3xTF32
                routes of K1 and K2).

At the int8 decode step's shapes (the LSTM gates, aoa_dec.q, aoa_dec.aoa;
m=384 and the beam's m=1,152; float32 x) it prints each copy's device time
(CUDA events, a 128 MB buffer written before each launch, the card kept
busy while the host launches), and for the instrumented one the median
cycles per stage of each phase over the blocks.  Every copy's output is
held against the plain version (K3's float32 hold).  Exits nonzero when
there is no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the phases each block's counters sum (16 debug words a block)
CONSUMER = ("wait for the stage", "split x", "products",
            "free the stage, add the partial")
PRODUCER = ("wait for TMA data", "widen, fence, arrive",
            "wait for a slot, issue loads")


def patch(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError("probe: the kernel source no longer has %r" % old)
    return src.replace(old, new)


DBG = ("__device__ unsigned long long* g_dbg;\n"
       "__device__ __forceinline__ unsigned long long* probe_slots() {\n"
       "  return g_dbg + 16 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
       "}\n"
       "__device__ __forceinline__ long long* probe_acc() {\n"
       "  __shared__ long long acc[16];\n"
       "  return acc;\n"
       "}\n\n")

RING_INIT = ("      mbar_init(&r.ready[s], 128);\n"
             "      mbar_init(&r.empty[s], 2);\n    }\n")
SPLIT = ("    split_a(frag + s * STAGE_BYTES, hi, lo);\n    fence_regs(part);\n"
         "    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < BK / 8; ++kk) {\n"
         "      const uint64_t dq")
END = ("    wgmma_wait<0>();\n    fence_regs(part);\n"
       "    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);\n"
       "#pragma unroll\n    for (int i = 0; i < 64; ++i) acc[i] += part[i];\n"
       "  }\n}\n\n}  // namespace tf32x2")
PRODUCER_LOOP = ("  for (int t = 0; t < nk; ++t) {\n    const int s = t % STAGES;\n"
                 "    uint8_t* st = ring + s * STAGE_BYTES;\n"
                 "    mbar_wait(&full[s], (t / STAGES) & 1);\n")
PRODUCER_END = ("    mbar_arrive(&ready[s]);\n"
                "    // the slot of step t - 1, free once its products are done\n"
                "    if (tid == 0 && t + STAGES - 1 < nk) load_step(t + STAGES - 1);\n"
                "  }\n")


def tick(who, slot, cond="true"):
    """Thread ``who`` adds the cycles since its last tick to counter
    ``slot`` (in shared memory, so that no register is taken)."""
    return ("    if (%s && threadIdx.x == %d) { c1 = clock64(); probe_acc()[%d] += "
            "c1 - c0; c0 = c1; }\n" % (cond, who, slot))


def instrumented(hop):
    """hopper.cuh with the counters (see the module docstring): consumer
    warpgroup 0's thread 0 in slots 0-3, the producer's threads 0 and 1
    (threadIdx 256, 257) in slots 4-6 and 7-8."""
    s = patch(hop, "namespace sicz {\nnamespace hopper {\n",
              "namespace sicz {\nnamespace hopper {\n\n" + DBG)
    s = patch(s, PRODUCER_LOOP, "  long long c0 = clock64(), c1;\n" + PRODUCER_LOOP
              + tick(256, 4, "TF32") + tick(257, 7, "TF32"))
    s = patch(s, PRODUCER_END,
              "    mbar_arrive(&ready[s]);\n" + tick(256, 5, "TF32")
              + tick(257, 8, "TF32")
              + "    if (tid == 0 && t + STAGES - 1 < nk) load_step(t + STAGES - 1);\n"
              + tick(256, 6, "TF32") + "  }\n  if (TF32 && tid < 2)\n"
              "    for (int i = 0; i < 3 - tid; ++i)\n"
              "      probe_slots()[4 + 3 * tid + i] = probe_acc()[4 + 3 * tid + i];\n")
    s = patch(s, RING_INIT, RING_INIT + "    for (int i = 0; i < 16; ++i) "
              "probe_acc()[i] = 0;\n")
    s = patch(s, "  const uint32_t frag = a_frag(r.stages, wg);\n"
              "  for (int t = 0; t < nk; ++t) {\n"
              "    const int s = t % STAGES;\n"
              "    const uint32_t ph = (t / STAGES) & 1;\n",
              "  const uint32_t frag = a_frag(r.stages, wg);\n"
              "  long long c0 = clock64(), c1;\n"
              "  for (int t = 0; t < nk; ++t) {\n"
              "    const int s = t % STAGES;\n"
              "    const uint32_t ph = (t / STAGES) & 1;\n")
    s = patch(s, SPLIT, tick(0, 0) + "    split_a(frag + s * STAGE_BYTES, hi, lo);\n"
              + tick(0, 1) + SPLIT[SPLIT.index("    fence_regs"):])
    return patch(s, END, "    wgmma_wait<0>();\n    fence_regs(part);\n" + tick(0, 2)
                 + "    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);\n"
                 "#pragma unroll\n    for (int i = 0; i < 64; ++i) acc[i] += part[i];\n"
                 "    fence_regs(acc);\n" + tick(0, 3) + "  }\n"
                 "  if (threadIdx.x == 0)\n"
                 "    for (int i = 0; i < 4; ++i) probe_slots()[i] = probe_acc()[i];\n"
                 "}\n\n}  // namespace tf32x2")


def split_by_integers(hop):
    """x rounded to TF32 by two integer operations, (bits + 0x1000) &
    0xFFFFE000 (cvt.rna's rounding but for NaN payloads), in place of
    cvt.rna.tf32.f32."""
    return patch(hop, "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : "
                 "\"=r\"(r) : \"f\"(f));\n  return r;\n",
                 "  return (__float_as_uint(f) + 0x1000u) & 0xFFFFE000u;\n")


def variants(hop):
    return {"kernel": hop, "instrumented": instrumented(hop),
            "split by integers": split_by_integers(hop)}


SET_DBG = ('\nextern "C" int set_dbg(void* p) {\n'
           '  return (int)cudaMemcpyToSymbol(sicz::hopper::g_dbg, &p, sizeof(p));\n'
           '}\n')


def build_all(_build, hop, src):
    """One nvcc per copy, all started together -> {name: ctypes library}."""
    procs = {}
    for name, text in variants(hop).items():
        d = os.path.join(_build.BUILD_DIR, "probe_tf32x2",
                         "".join(c if c.isalnum() else "_" for c in name))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(text)
        cu = os.path.join(d, "quant_matmul.cu")
        with open(cu, "w") as f:
            f.write(src + (SET_DBG if name == "instrumented" else ""))
        lib = os.path.join(d, "libprobe.so")
        # the copy's directory first: its hopper.cuh shadows csrc's
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path()] + [f for f in _build.NVCC_FLAGS
                                    if f not in ("-Xptxas", "-v")]
            + ["-I", d, "-I", _build.CSRC_DIR, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("probe: nvcc failed for %s:\n%s" % (name, out))
        L = ctypes.CDLL(lib)
        L.quant_matmul_tf32x2.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
        libs[name] = L
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.ops import _build
    from simpleimagecaptionzoo_tpu_torch.ops import quant

    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f:
        hop = f.read()
    with open(os.path.join(_build.CSRC_DIR, "quant_matmul.cu")) as f:
        src = f.read()
    libs = build_all(_build, hop, src)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(32 * 1024 * 1024, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def device_ms(fn, reps=20):
        for _ in range(3):
            fn()
        evs = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(500_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        t = sorted(s.elapsed_time(e) for s, e in evs)
        return t[len(t) // 2]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    results = {"card": card, "shapes": []}
    shapes = [("lstm", 384, 3072, 4096), ("aoa_dec.q", 384, 1024, 1024),
              ("aoa_dec.aoa", 384, 2048, 2048), ("lstm", 1152, 3072, 4096),
              ("aoa_dec.q", 1152, 1024, 1024),
              ("aoa_dec.aoa", 1152, 2048, 2048)]
    for what, m, k, n in shapes:
        w = (torch.rand(k, n, generator=gen, device=dev) * 2 - 1) / k ** 0.5
        qp = quant.quantize_dense({"w": w, "b": torch.randn(
            n, generator=gen, device=dev)})
        x = torch.randn(m, k, generator=gen, device=dev)
        q, s, b = qp["q"], qp["s"], qp["b"]
        out = torch.empty(m, n, device=dev)
        blocks = ((n + 127) // 128) * ((m + 127) // 128)
        dbg = torch.zeros(blocks * 16, dtype=torch.int64, device=dev)
        code = libs["instrumented"].set_dbg(ptr(dbg))
        if code:
            raise RuntimeError("probe: set_dbg failed, CUDA error %d" % code)
        row = {"what": what, "m": m, "k": k, "n": n, "blocks": blocks,
               "ms": {}}
        for name, L in libs.items():
            def run(L=L):
                code = L.quant_matmul_tf32x2(
                    ptr(x), ptr(q), ptr(s), ptr(b), ptr(out), m, k, n,
                    q.shape[0], q.shape[1],
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if code:
                    raise RuntimeError("probe: launch failed, CUDA error %d"
                                       % code)
            row["ms"][name] = device_ms(run)
            run()
            torch.cuda.synchronize()
            want = quant.quant_matmul_plain(x, qp)
            lim = 1e-5 * (x.abs() @ (q[:k, :n].float().abs() * s)) + 1e-6
            if not bool(((out - want).abs() <= lim).all()):
                raise RuntimeError("probe: the %s copy breaks K3's float32 "
                                   "hold at %s m=%d" % (name, what, m))
            if name == "instrumented":
                rows = dbg.view(blocks, 16).cpu().tolist()
                nk = (k + 31) // 32
                row["cycles_per_stage"] = {
                    "consumer": {p: statistics.median(r[i] for r in rows) / nk
                                 for i, p in enumerate(CONSUMER)},
                    "producer thread 0": {
                        p: statistics.median(r[4 + i] for r in rows) / nk
                        for i, p in enumerate(PRODUCER)},
                    "producer thread 1": {
                        p: statistics.median(r[7 + i] for r in rows) / nk
                        for i, p in enumerate(PRODUCER[:2])}}
        results["shapes"].append(row)
        print("%s m=%d K=%d n=%d (%d blocks), device ms: %s"
              % (what, m, k, n, blocks, ", ".join(
                  "%s %.4f" % kv for kv in row["ms"].items())))
        for who, ph in row["cycles_per_stage"].items():
            print("    %-18s cycles per stage (median over blocks): %s"
                  % (who, ", ".join("%s %.0f" % kv for kv in ph.items())))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
