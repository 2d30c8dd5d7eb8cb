#!/usr/bin/env python3
"""Where the time of K4's "tma" route goes, on one CUDA GPU.

    python3 scripts/probe_int8_attention.py [--k 1 3]

Builds three instrumented copies of
simpleimagecaptionzoo_tpu_torch/csrc/int8_attention.cu (into the port's
gitignored build directory): the kernel with per-block timestamps (the
global timer at entry and exit, the SM clock between its phases), the same
kernel stopped once its K and V have landed (the loads alone), and one that
skips the TMA loads (the arithmetic alone, on whatever shared memory
holds).  At the greedy decode shape (B=384, N=36 with 10-36 valid, D=1024,
8 heads, bf16 q) it prints, for each query-row count k: the device time of
each copy (CUDA events, a 128 MB buffer written before each launch, the
card kept busy while the host launches), the span of the global timer
from the first block's entry to the last block's exit, the blocks resident
at once, and the median SM cycles of each phase of a block.  A clone of K
and V (28.3 MB read and written) is timed beside them as a yardstick of
the card's bandwidth.  Then, at float32 q with k=3 (the float32 beam
step), it times the kernel as it is, which stages q's rows in shared
memory there, against a copy that reads q through L1, in turns, and holds
both against the plain version.  Exits nonzero when there is no CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("setup (ks, vs, mask; q prefetch)", "wait for K", "scores",
          "wait for V, softmax, P.V")


def stamp(i):
    """Thread 0 records the global timer in slot i and the SM clock in
    slot 6 + i of its block's 12 debug words."""
    return ('if (tid == 0) { unsigned long long t_; asm volatile("mov.u64 '
            '%%0, %%%%globaltimer;" : "=l"(t_)); dbg[blockIdx.x * 12 + %d] = '
            't_; dbg[blockIdx.x * 12 + %d] = clock64(); }' % (i, 6 + i))


def patch(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError("probe: the kernel source no longer has %r" % old)
    return src.replace(old, new)


def instrumented(src):
    s = patch(src, "int rows, float inv_sqrt_dh) {\n  extern __shared__",
              "int rows, float inv_sqrt_dh, unsigned long long* dbg) {\n"
              "  extern __shared__")
    s = patch(s, "  const size_t row0 = b * k;", "  const size_t row0 = b * k;\n"
              + stamp(0))
    s = patch(s, "  mbar_wait(&bar[0], 0);\n", "  %s\n  mbar_wait(&bar[0], 0);\n"
              "  %s\n" % (stamp(1), stamp(2)))
    s = patch(s, "  mbar_wait(&bar[1], 0);\n", "  %s\n  mbar_wait(&bar[1], 0);\n"
              % stamp(3))
    s = patch(s, "  for (int e = tid; e < k * N; e += NT) {              "
              "// pmean, in head order",
              "  %s\n  for (int e = tid; e < k * N; e += NT) {" % stamp(4))
    s = patch(s, "    pmean[row0 * N + e] = acc;\n  }\n}",
              "    pmean[row0 * N + e] = acc;\n  }\n  __syncthreads();\n  %s\n}"
              % stamp(5))
    s = patch(s, "k, N, D, heads, p.nbox, p.rows, inv_sqrt_dh);",
              "k, N, D, heads, p.nbox, p.rows, inv_sqrt_dh, g_dbg);")
    s = patch(s, "template <typename T, int KB>\ncudaError_t launch_kb(",
              "unsigned long long* g_dbg = nullptr;\n"
              "template <typename T, int KB>\ncudaError_t launch_kb(")
    return s + ('\nextern "C" void set_dbg(void* p) '
                '{ tma::g_dbg = (unsigned long long*)p; }\n')


def q_through_l1(src):
    """The kernel with q read through L1 at every k: attend_tma<float, 4>
    as it was before it staged q's rows in shared memory."""
    return patch(src, "constexpr bool q_staged = std::is_same<T, float>::value"
                 " && KB == 4;", "constexpr bool q_staged = false;")


def variants(src):
    s = instrumented(src)
    loads = patch(s, "  mbar_wait(&bar[0], 0);\n",
                  "  mbar_wait(&bar[0], 0);\n  mbar_wait(&bar[1], 0);\n  %s\n"
                  "  return;\n" % stamp(5))
    compute = patch(s, "    mbar_expect_tx(&bar[0], bytes);\n"
                    "    mbar_expect_tx(&bar[1], bytes);\n",
                    "    mbar_arrive(&bar[0]);\n    mbar_arrive(&bar[1]);\n")
    compute = compute.replace(
        "    for (int g = 0; g < ncol; ++g)\n      for (int j = 0; j < nbox; ++j)\n"
        "        tma_load_2d(",
        "    if (bytes == 0) for (int g = 0; g < ncol; ++g)\n"
        "      for (int j = 0; j < nbox; ++j)\n        tma_load_2d(")
    return {"full": s, "loads only": loads, "arithmetic only": compute}


def build(_build, name, text):
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, name + ".cu")
    lib = os.path.join(out_dir, "lib%s.so" % name)
    with open(src, "w") as f:
        f.write(text)
    r = subprocess.run([_build.nvcc_path()] + [
        f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        + ["-I", _build.CSRC_DIR, "-o", lib, src], capture_output=True,
        text=True, timeout=600)
    if r.returncode:
        raise RuntimeError("probe: nvcc failed for %s:\n%s" % (name, r.stderr))
    L = ctypes.CDLL(lib)
    L.int8_attention_tma.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                     + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])
    return L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[1, 3])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.ops import _build
    from simpleimagecaptionzoo_tpu_torch.ops import int8_attention as IA

    with open(os.path.join(_build.CSRC_DIR, "int8_attention.cu")) as f:
        src = f.read()
    libs = {name: build(_build, "probe_" + name.replace(" ", "_"), text)
            for name, text in variants(src).items()}
    q_libs = {"smem": build(_build, "probe_q_smem", src),
              "l1": build(_build, "probe_q_l1", q_through_l1(src))}
    dev = torch.device("cuda")
    B, N, D, H = 384, 36, 1024, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    kq, ks = IA.quantize_rows(torch.randn(B, N, D, generator=gen, device=dev))
    vq, vs = IA.quantize_rows(torch.randn(B, N, D, generator=gen, device=dev))
    valid = 10 + torch.arange(B, device=dev) % 27
    mask = (torch.arange(N, device=dev)[None] < valid[:, None]).float()
    flush = torch.empty(32 * 1024 * 1024, device=dev)

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

    print(torch.cuda.get_device_name(0))
    print("clone of K and V (28.3 MB read, 28.3 MB written): %.4f ms"
          % device_ms(lambda: (kq.clone(), vq.clone())))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for k in args.k:
        q = torch.randn(B, k, D, generator=gen, device=dev).bfloat16()
        out = torch.empty(B, k, D, dtype=q.dtype, device=dev)
        pm = torch.empty(B, k, N, device=dev)
        for name, L in libs.items():
            dbg = torch.zeros(B * 12, dtype=torch.int64, device=dev)
            L.set_dbg(ptr(dbg))

            def run(L=L):
                code = L.int8_attention_tma(
                    ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(mask),
                    ptr(out), ptr(pm), B, k, N, D, H,
                    ctypes.c_float(1 / 128 ** 0.5), 1,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if code:
                    raise RuntimeError("probe: launch failed, CUDA error %d"
                                       % code)

            ms = device_ms(run)
            run()
            torch.cuda.synchronize()
            rows = dbg.view(B, 12).cpu().tolist()
            t0 = min(r[0] for r in rows)
            span = (max(r[5] for r in rows) - t0) / 1e3
            events = sorted([(r[0], 1) for r in rows] + [(r[5], -1) for r in rows])
            live = most = 0
            for _, x in events:
                live += x
                most = max(most, live)
            print("k=%d %-16s device %.4f ms; global timer span %.2f us; "
                  "%d blocks resident at once" % (k, name, ms, span, most))
            if name == "full":
                for j, phase in enumerate(PHASES):
                    cyc = [r[7 + j] - r[6 + j] for r in rows]
                    print("    %-34s median %6d cycles, p90 %6d"
                          % (phase, statistics.median(cyc),
                             sorted(cyc)[int(0.9 * len(cyc))]))

    # float32 q at k=3 (attend_tma<float, 4>, the float32 beam step): q's
    # rows staged in shared memory against q read through L1, in turns
    q = torch.randn(B, 3, D, generator=gen, device=dev)
    want, pwant = IA.lanes_attention_int8_plain(q, kq, ks, vq, vs, mask, H)
    turns = {"l1": [], "smem": []}
    for name in ("l1", "smem", "smem", "l1"):
        out = torch.empty(B, 3, D, device=dev)
        pm = torch.empty(B, 3, N, device=dev)

        def run(L=q_libs[name]):
            code = L.int8_attention_tma(
                ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(mask),
                ptr(out), ptr(pm), B, 3, N, D, H,
                ctypes.c_float(1 / 128 ** 0.5), 0,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if code:
                raise RuntimeError("probe: launch failed, CUDA error %d"
                                   % code)

        turns[name].append(device_ms(run))
        err = float((out - want).abs().max())
        err_p = float((pm - pwant).abs().max())
        if err > 2e-5 or err_p > 2e-6:
            raise RuntimeError("probe: q %s off the plain version by %.3g "
                               "(pmean %.3g)" % (name, err, err_p))
    print("float32 k=3, in turns (l1, smem, smem, l1), device: q through L1 "
          "%s ms, q staged in shared memory %s ms; both within 2e-5 (pmean "
          "2e-6) of the plain version"
          % (["%.4f" % t for t in turns["l1"]],
             ["%.4f" % t for t in turns["smem"]]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
