"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided in
the fixture, at run time).  On a machine with the card and ``nvcc``:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``
(``--noconftest``: tests/conftest.py imports JAX, which that machine need
not have; this file imports none).
"""
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                 int8_attention, quant)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _lstm_counts():
    return (fused_lstm.COUNT.n, fused_lstm.COUNT_WGMMA.n,
            fused_lstm.COUNT_TF32X3.n)


def _head_counts():
    return (fused_head.COUNT.n, fused_head.COUNT_WGMMA.n,
            fused_head.COUNT_TF32X3.n)


def _moved(route):
    """How one launch on ``route`` moves (COUNT, COUNT_WGMMA,
    COUNT_TF32X3)."""
    return (1, int(route == "wgmma"), int(route == "tf32x3"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,h", [(16, 384, 128), (16, 200, 128),
                                   (37, 70, 96)])
def test_lstm_kernel_matches_plain(dev, dtype, b, e, h):
    """Aligned, unaligned K (E=200) and ragged B, E, H: bf16 on the wgmma
    route and float32 on the tf32x3 route where TMA takes the rows (the
    split made by the wrapper), both on the CUDA-core route at E=70."""
    rng = np.random.default_rng(b + e + h)
    bound = 1 / np.sqrt(h)
    w = _t(rng.uniform(-bound, bound, (e + h, 4 * h)), dev, dtype)
    bias = _t(rng.uniform(-bound, bound, 4 * h), dev, dtype)
    x, hh, c = (_t(rng.normal(size=(b, n)), dev, dtype)
                for n in (e, h, h))
    route = fused_lstm.lstm_route(w, x, hh)
    assert route == ("cuda_core" if e == 70 else
                     "wgmma" if dtype == torch.bfloat16 else "tf32x3")
    before = _lstm_counts()
    kh, kc = fused_lstm.lstm_cell_fused(w, bias, x, hh, c)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_lstm_counts(), before)) == \
        _moved(route)
    ph, pc = fused_lstm.lstm_cell_plain(w, bias, x, hh, c)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(kh, ph, **tol)
    torch.testing.assert_close(kc, pc, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(16, 1), (16, 3), (3, 3), (45, 16)])
def test_head_kernel_matches_plain(dev, dtype, m, k):
    rng = np.random.default_rng(m * 31 + k)
    hdim, v = 96, 1000
    head = {"v": _t(rng.normal(size=(hdim, v)), dev, dtype),
            "g": _t(rng.uniform(0.5, 2.0, v), dev, dtype),
            "b": _t(rng.normal(size=v), dev, dtype)}
    x = _t(rng.normal(size=(m, hdim)), dev, dtype)
    prep = fused_head.prepare_head(head, dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert fused_head.head_route(prep.w, fused_head._prepared(prep, x)[1]) \
        == route
    before = _head_counts()
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_head_counts(), before)) == \
        _moved(route)
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(kv, pv, rtol=0, atol=tol)
    torch.testing.assert_close(kl, pl, rtol=0, atol=tol)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("b,e,h,route", [(1152, 2048, 1024, "wgmma"),
                                         (256, 2048, 1024, "wgmma"),
                                         (37, 200, 128, "wgmma"),
                                         (37, 70, 128, "cuda_core"),
                                         # BUTD's attention and language
                                         # cells, greedy and beam rows
                                         (384, 4096, 1024, "wgmma"),
                                         (1152, 4096, 1024, "wgmma"),
                                         (384, 3072, 1024, "wgmma"),
                                         (1152, 3072, 1024, "wgmma"),
                                         # NIC's cell (E=512) and
                                         # AoASpatial's (E=1,024) at H=512
                                         (384, 512, 512, "wgmma"),
                                         (1152, 512, 512, "wgmma"),
                                         (384, 1024, 512, "wgmma"),
                                         (1152, 1024, 512, "wgmma")])
def test_lstm_bf16_routes_match_plain(dev, b, e, h, route):
    """K2 in bf16 at the beam shape (B=1,152: 9 row tiles), at B=256 (2) and
    ragged B=37 with a k-step that straddles E=200 (one row tile) on the
    tensor-core route; E=70 (rows of 140 bytes, which TMA cannot take)
    stays on the CUDA-core route."""
    rng = np.random.default_rng(b + e)
    bound = 1 / np.sqrt(h)
    w = _t(rng.uniform(-bound, bound, (e + h, 4 * h)), dev, torch.bfloat16)
    bias = _t(rng.uniform(-bound, bound, 4 * h), dev, torch.bfloat16)
    x, hh, c = (_t(rng.normal(size=(b, n)), dev, torch.bfloat16)
                for n in (e, h, h))
    assert fused_lstm.lstm_route(w, x, hh) == route
    before = fused_lstm.COUNT.n, fused_lstm.COUNT_WGMMA.n
    kh, kc = fused_lstm.lstm_cell_fused(w, bias, x, hh, c)
    torch.cuda.synchronize()
    assert (fused_lstm.COUNT.n, fused_lstm.COUNT_WGMMA.n) == (
        before[0] + 1, before[1] + (route == "wgmma"))
    ph, pc = fused_lstm.lstm_cell_plain(w, bias, x, hh, c)
    torch.testing.assert_close(kh, ph, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(kc, pc, rtol=1e-2, atol=1e-2)


def test_head_bf16_wgmma_route_at_beam_shape(dev):
    """K1 in bf16 on the tensor-core route at m=1,152, k=3, full width (H
    1,024, V 10,102): values and lse within 2e-3, ids exact where the
    plain logits leave a gap above 1e-3 on both sides."""
    rng = np.random.default_rng(1152)
    hdim, v, m, k = 1024, 10102, 1152, 3
    head = {"v": _t(rng.normal(size=(hdim, v)), dev, torch.bfloat16),
            "g": _t(rng.uniform(0.5, 2.0, v), dev, torch.bfloat16),
            "b": _t(rng.normal(size=v), dev, torch.bfloat16)}
    prep = fused_head.prepare_head(head, torch.bfloat16)
    x = _t(0.5 * rng.normal(size=(m, hdim)), dev, torch.bfloat16)
    assert fused_head.head_route(prep.w, x) == "wgmma"
    before = fused_head.COUNT_WGMMA.n
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert fused_head.COUNT_WGMMA.n == before + 1
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=2e-3)
    torch.testing.assert_close(kl, pl, rtol=0, atol=2e-3)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernel_ties_across_chunks_by_route(dev, dtype):
    """The cross-chunk tie on each tensor-core route (3.0 and 1.0 are exact
    in bf16 and TF32): float32 takes the tf32x3 route (128-column chunks),
    bf16 the wgmma route (256-column chunks); both have a chunk made only of
    pad columns."""
    v = 2 * fused_head.V_TILE
    w = np.zeros((8, v), np.float32)
    w[:, 7] = 3.0
    w[:, fused_head.V_TILE + 11] = 3.0
    w[:, 100] = 1.0
    head = fused_head.prepare_head({"w": _t(w[:, :700], dev, dtype)}, dtype)
    x = torch.eye(8, device=dev, dtype=dtype)
    before = _head_counts()
    vals, idx, lse = fused_head.topk_head(head, x, 3)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_head_counts(), before)) == _moved(
        "wgmma" if dtype == torch.bfloat16 else "tf32x3")
    pv, pi, pl = fused_head.topk_head_plain(head, x, 3)
    assert idx.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
    assert torch.equal(idx, pi)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, pl, rtol=0, atol=1e-4)


@pytest.mark.parametrize("m,k", [(384, 1), (384, 3), (3, 3), (45, 16)])
def test_head_bf16_cuda_core_route_matches_plain(dev, m, k):
    """K1's CUDA-core route in bf16, forced (bf16 operands that TMA cannot
    take go there), at full width (H 1,024, V 10,102), and on the
    cross-chunk tie: values and lse within 2e-3, ids exact where the plain
    logits leave a gap above 1e-3 on both sides."""
    rng = np.random.default_rng(m * 7 + k)
    hdim, v = 1024, 10102
    head = {"v": _t(rng.normal(size=(hdim, v)), dev, torch.bfloat16),
            "g": _t(rng.uniform(0.5, 2.0, v), dev, torch.bfloat16),
            "b": _t(rng.normal(size=v), dev, torch.bfloat16)}
    prep = fused_head.prepare_head(head, torch.bfloat16)
    x = _t(0.5 * rng.normal(size=(m, hdim)), dev, torch.bfloat16)
    before = fused_head.COUNT.n, fused_head.COUNT_WGMMA.n
    kv, ki, kl = fused_head._run_kernel(prep, x, k, "cuda_core")
    torch.cuda.synchronize()
    assert (fused_head.COUNT.n, fused_head.COUNT_WGMMA.n) == (
        before[0] + 1, before[1])
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=2e-3)
    torch.testing.assert_close(kl, pl, rtol=0, atol=2e-3)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0

    w = np.zeros((8, 2 * fused_head.V_TILE), np.float32)
    w[:, 7] = 3.0
    w[:, fused_head.V_TILE + 11] = 3.0
    w[:, 100] = 1.0
    tie = fused_head.prepare_head({"w": _t(w[:, :700], dev, torch.bfloat16)},
                                  torch.bfloat16)
    eye = torch.eye(8, tie.w.shape[0], device=dev, dtype=torch.bfloat16)
    _, idx, lse = fused_head._run_kernel(tie, eye, 3, "cuda_core")
    _, pi, pl = fused_head.topk_head_plain(tie, eye, 3)
    assert idx.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
    assert torch.equal(idx, pi)
    torch.testing.assert_close(lse, pl, rtol=0, atol=1e-4)


def test_head_wgmma_route_refuses_a_misaligned_x(dev):
    """The tensor-core route's C entry refuses a base TMA cannot take."""
    head = fused_head.prepare_head(
        {"w": torch.randn(128, 512, device=dev), "b": torch.zeros(512,
                                                                  device=dev)},
        torch.bfloat16)
    flat = torch.zeros(8 * 128 + 8, device=dev, dtype=torch.bfloat16)
    x = flat[1:1 + 8 * 128].view(8, 128)
    assert fused_head.head_route(head.w, x) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        fused_head._run_kernel(head, x, 1, "wgmma")


def test_head_kernel_ties_across_chunks(dev):
    """Equal winners in two vocab chunks go to the smaller id, and a chunk
    made only of pad columns neither wins nor makes NaN."""
    v = 2 * fused_head.V_TILE
    w = np.zeros((8, v), np.float32)
    w[:, 7] = 3.0
    w[:, fused_head.V_TILE + 11] = 3.0
    w[:, 100] = 1.0
    head = {"w": _t(w[:, :700], dev, torch.float32)}   # columns 700+ are pad
    x = torch.eye(8, device=dev)
    vals, idx, lse = fused_head.topk_head(head, x, 3)
    pv, pi, pl = fused_head.topk_head_plain(head, x, 3)
    assert torch.equal(idx, pi)
    assert idx.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, pl, rtol=0, atol=1e-4)


def _qdense(rng, k, n, dev):
    w = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return {t: a.to(dev) for t, a in quant.quantize_dense({"w": w, "b": b})
            .items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(16, 256, 512), (64, 1024, 1024),
                                   (37, 200, 700), (5, 3072, 130)])
def test_quant_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    """K3: aligned, and ragged m, K (Kp 256) and n (Np 1024)."""
    rng = np.random.default_rng(m + k + n)
    qp = _qdense(rng, k, n, dev)
    x = _t(rng.normal(size=(m, k)), dev, dtype)
    before = quant.COUNT.n
    got = quant.quant_matmul(x, qp)
    torch.cuda.synchronize()
    assert quant.COUNT.n == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    want = quant.quant_matmul_plain(x, qp)
    if dtype == torch.bfloat16:              # one bf16 ulp
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    else:
        # the sums run in another order: 1e-5 of the sum of |terms|, the
        # float32 rounding bound of a dot product (outputs reach ~50 here)
        terms = x.abs() @ (qp["q"][:k, :n].float().abs() * qp["s"])
        assert bool(((got - want).abs() <= 1e-5 * terms + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(16, 1), (16, 3), (3, 3), (45, 16)])
def test_head_kernel_int8_weights_match_plain(dev, dtype, m, k):
    """K1-int8: the int8 head of ops/quant.py, one scale per column."""
    rng = np.random.default_rng(m * 17 + k)
    hdim, v = 96, 1000
    head = {"v": torch.from_numpy(rng.normal(size=(hdim, v)).astype(
                np.float32)),
            "g": torch.from_numpy(rng.uniform(0.5, 2.0, v).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=v).astype(np.float32))}
    qhead = {t: a.to(dev) for t, a in quant.quantize_dense_wn(head).items()}
    prep = fused_head.prepare_head(qhead, dtype)
    assert prep.w.dtype == torch.int8
    x = _t(rng.normal(size=(m, hdim)), dev, dtype)
    before = fused_head.COUNT.n
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert fused_head.COUNT.n == before + 1
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(kv, pv, rtol=0, atol=tol)
    torch.testing.assert_close(kl, pl, rtol=0, atol=tol)
    assert torch.equal(ki, pi)


def _attention_inputs(b, k, n, d, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(b, k, d)), dev, dtype)
    kq, ks = int8_attention.quantize_rows(_t(rng.normal(size=(b, n, d)), dev,
                                             torch.float32))
    vq, vs = int8_attention.quantize_rows(_t(rng.normal(size=(b, n, d)), dev,
                                             torch.float32))
    valid = 1 + np.arange(b) % n
    mask = _t(np.arange(n)[None, :] < valid[:, None], dev, torch.float32)
    return q, kq, ks, vq, vs, mask


def _hold_attention(dtype, got, want, mask):
    """out within 2e-5 (float32) or rtol/atol 1e-2 (bf16), pmean within
    2e-6, masked boxes exactly 0."""
    (out, pm), (pout, ppm) = got, want
    assert out.dtype == dtype and pm.dtype == torch.float32
    tol = (dict(rtol=0, atol=2e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(out, pout, **tol)
    torch.testing.assert_close(pm, ppm, rtol=0, atol=2e-6)
    assert bool((pm.masked_select((mask == 0)[:, None, :].expand_as(pm))
                 == 0).all())


@pytest.mark.parametrize("route", ["tma", "cuda_core"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,d,heads", [(8, 3, 5, 256, 2),
                                           (16, 1, 36, 1024, 8),
                                           (3, 16, 2048, 256, 1),
                                           (5, 4, 37, 384, 3),
                                           (384, 1, 36, 1024, 8),
                                           (384, 3, 36, 1024, 8),
                                           (6, 2, 300, 256, 2)])
def test_int8_attention_kernel_matches_plain(dev, route, dtype, b, k, n, d,
                                             heads):
    """K4 on each route: greedy and beam query rows, the decode's shape
    (B=384, k=1 and k=3, N=36, D=1,024, 8 heads), N=300 (two TMA boxes of
    rows), N up to 2048 (two passes of query rows at k=16 on the CUDA-core
    route; beyond the "tma" route's plan, which its C entry refuses), ragged
    N; masked rows get exactly 0, and two launches give the same bits."""
    q, kq, ks, vq, vs, mask = _attention_inputs(b, k, n, d, dev, dtype,
                                                b * k + n)
    picked = int8_attention.attention_route(q, kq, vq, n, d, heads)
    assert picked == ("cuda_core" if n == 2048 else "tma")
    if route == "tma" and picked != "tma":
        with pytest.raises(RuntimeError, match="invalid value"):
            int8_attention._run_kernel(q, kq, ks, vq, vs, mask, heads, route)
        return
    before = int8_attention.COUNT.n, int8_attention.COUNT_TMA.n
    if route == picked:
        got = int8_attention.lanes_attention_int8(q, kq, ks, vq, vs, mask,
                                                  heads)
    else:
        got = int8_attention._run_kernel(q, kq, ks, vq, vs, mask, heads,
                                         route)
    again = int8_attention._run_kernel(q, kq, ks, vq, vs, mask, heads, route)
    torch.cuda.synchronize()
    assert (int8_attention.COUNT.n, int8_attention.COUNT_TMA.n) == (
        before[0] + 2, before[1] + 2 * (route == "tma"))
    want = int8_attention.lanes_attention_int8_plain(q, kq, ks, vq, vs, mask,
                                                     heads)
    _hold_attention(dtype, got, want, mask)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_attention_misaligned_kv_takes_cuda_core(dev, dtype):
    """kq (then vq) 4 bytes past a 16-byte boundary: the rule picks the
    CUDA-core route, which holds against the plain version; the "tma"
    route's C entry refuses it."""
    b, k, n, d, heads = 16, 1, 36, 1024, 8
    q, kq, ks, vq, vs, mask = _attention_inputs(b, k, n, d, dev, dtype, 7)
    for which in ("k", "v"):
        flat = torch.zeros(b * n * d + 16, dtype=torch.int8, device=dev)
        off = next(i for i in range(4, 20) if (flat.data_ptr() + i) % 16 == 4)
        view = flat[off:off + b * n * d].view(b, n, d)
        view.copy_(kq if which == "k" else vq)
        kk, vv = (view, vq) if which == "k" else (kq, view)
        assert int8_attention.attention_route(q, kk, vv, n, d, heads) == \
            "cuda_core"
        before = int8_attention.COUNT.n, int8_attention.COUNT_TMA.n
        got = int8_attention.lanes_attention_int8(q, kk, ks, vv, vs, mask,
                                                  heads)
        torch.cuda.synchronize()
        assert (int8_attention.COUNT.n, int8_attention.COUNT_TMA.n) == (
            before[0] + 1, before[1])
        _hold_attention(dtype, got, int8_attention.lanes_attention_int8_plain(
            q, kk, ks, vv, vs, mask, heads), mask)
        with pytest.raises(RuntimeError, match="invalid value"):
            int8_attention._run_kernel(q, kk, ks, vv, vs, mask, heads, "tma")


@pytest.mark.parametrize("route", ["wgmma", "cuda_core"])
@pytest.mark.parametrize("m,k,n", [(384, 3072, 4096),    # the LSTM gates
                                   (384, 1024, 1024),    # aoa_dec.q
                                   (384, 2048, 2048),    # aoa_dec.aoa
                                   (1152, 3072, 4096),   # the beam rows
                                   (37, 200, 700),       # ragged m, K, n
                                   (384, 5120, 4096),    # BUTD's cells
                                   (1152, 5120, 4096),
                                   (384, 4096, 4096),
                                   (1152, 4096, 4096),
                                   # the 512-wide models: NIC's and
                                   # AoASpatial's cells, aoa_dec.q (512)
                                   # and aoa_dec.aoa (1,024, as above at
                                   # m=384)
                                   (384, 1024, 2048), (1152, 1024, 2048),
                                   (384, 1536, 2048), (1152, 1536, 2048),
                                   (384, 512, 512), (1152, 512, 512),
                                   (1152, 1024, 1024)])
def test_quant_matmul_bf16_routes_match_plain(dev, route, m, k, n):
    """K3 in bf16 on the tensor-core route (quant_route's pick) and on the
    CUDA-core route (forced) at the int8 decode step's shapes, at the beam
    rows and ragged: within one bf16 ulp of the plain version."""
    rng = np.random.default_rng(m + k + n)
    qp = _qdense(rng, k, n, dev)
    x = _t(0.5 * rng.normal(size=(m, k)), dev, torch.bfloat16)
    assert quant.quant_route(x, qp["q"]) == "wgmma"
    before = quant.COUNT.n, quant.COUNT_WGMMA.n
    if route == "wgmma":
        got = quant.quant_matmul(x, qp)
    else:
        got = quant._run_kernel(x, qp["q"], qp["s"], qp["b"], route)
    torch.cuda.synchronize()
    assert (quant.COUNT.n, quant.COUNT_WGMMA.n) == (
        before[0] + 1, before[1] + (route == "wgmma"))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    want = quant.quant_matmul_plain(x, qp)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_quant_matmul_wgmma_route_refuses_a_misaligned_x(dev):
    """The tensor-core route's C entry refuses a base TMA cannot take."""
    qp = _qdense(np.random.default_rng(3), 128, 512, dev)
    flat = torch.zeros(8 * 128 + 8, device=dev, dtype=torch.bfloat16)
    x = flat[1:1 + 8 * 128].view(8, 128)
    assert quant.quant_route(x, qp["q"]) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        quant._run_kernel(x, qp["q"], qp["s"], qp["b"], "wgmma")


def _int8_head(rng, hdim, v, dev):
    head = {"v": torch.from_numpy(rng.normal(size=(hdim, v)).astype(
                np.float32)),
            "g": torch.from_numpy(rng.uniform(0.5, 2.0, v).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=v).astype(np.float32))}
    qhead = {t: a.to(dev) for t, a in quant.quantize_dense_wn(head).items()}
    return fused_head.prepare_head(qhead, torch.bfloat16)


@pytest.mark.parametrize("m,k", [(16, 1), (16, 3), (3, 3), (45, 16),
                                 (1152, 3)])
def test_head_int8_wgmma_route_matches_plain(dev, m, k):
    """K1-int8 in bf16 on the tensor-core route (the int8 head widened in
    shared memory) at full width (H 1,024, V 10,102): values and lse within
    2e-3, ids exact where the plain logits leave a gap above 1e-3 on both
    sides."""
    rng = np.random.default_rng(m * 13 + k)
    prep = _int8_head(rng, 1024, 10102, dev)
    assert prep.w.dtype == torch.int8
    x = _t(0.5 * rng.normal(size=(m, 1024)), dev, torch.bfloat16)
    assert fused_head.head_route(prep.w, x) == "wgmma"
    before = fused_head.COUNT.n, fused_head.COUNT_WGMMA.n
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert (fused_head.COUNT.n, fused_head.COUNT_WGMMA.n) == (
        before[0] + 1, before[1] + 1)
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=2e-3)
    torch.testing.assert_close(kl, pl, rtol=0, atol=2e-3)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0


def test_head_int8_wgmma_route_ties_across_chunks(dev):
    """The cross-chunk tie with an int8 head on the tensor-core route: equal
    winners in two 256-column chunks go to the smaller id, and a chunk made
    only of pad columns neither wins nor makes NaN."""
    vp = 2 * fused_head.V_TILE
    q = torch.zeros((128, vp), dtype=torch.int8)
    q[:8, 7] = 3
    q[:8, fused_head.V_TILE + 11] = 3
    q[:8, 100] = 1
    head = fused_head.prepare_head(
        {"q": q.to(dev), "s": torch.ones(700, device=dev),
         "b": torch.zeros(700, device=dev)}, torch.bfloat16)
    x = torch.eye(8, 128, device=dev, dtype=torch.bfloat16)
    assert fused_head.head_route(head.w, x) == "wgmma"
    before = fused_head.COUNT_WGMMA.n
    vals, idx, lse = fused_head.topk_head(head, x, 3)
    torch.cuda.synchronize()
    assert fused_head.COUNT_WGMMA.n == before + 1
    pv, pi, pl = fused_head.topk_head_plain(head, x, 3)
    assert idx.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
    assert torch.equal(idx, pi)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, pl, rtol=0, atol=1e-4)


def _lstm_weights(rng, e, h, dev):
    bound = 1 / np.sqrt(h)
    u = lambda *shape: _t(rng.uniform(-bound, bound, shape), dev,
                          torch.float32)
    return fused_lstm.prepare_lstm({"w_ih": u(e, 4 * h), "w_hh": u(h, 4 * h),
                                    "b_ih": u(4 * h), "b_hh": u(4 * h)})


@pytest.mark.parametrize("b,e,h,route", [(384, 2048, 1024, "tf32x3"),
                                         (1152, 2048, 1024, "tf32x3"),
                                         (37, 200, 128, "tf32x3"),
                                         (384, 2048, 1024, "cuda_core"),
                                         (37, 70, 128, "cuda_core"),
                                         # BUTD's attention and language
                                         # cells, greedy and beam rows
                                         (384, 4096, 1024, "tf32x3"),
                                         (1152, 4096, 1024, "tf32x3"),
                                         (384, 3072, 1024, "tf32x3"),
                                         (1152, 3072, 1024, "tf32x3"),
                                         # NIC's cell (E=512) and
                                         # AoASpatial's (E=1,024) at H=512
                                         (384, 512, 512, "tf32x3"),
                                         (1152, 512, 512, "tf32x3"),
                                         (384, 1024, 512, "tf32x3"),
                                         (1152, 1024, 512, "tf32x3")])
def test_lstm_f32_routes_match_plain(dev, b, e, h, route):
    """K2 in float32 at the decode shape (B=384), the beam shape (B=1,152)
    and ragged B=37 with a k-step that straddles E=200 on the tf32x3 route,
    with prepare_lstm's split; the CUDA-core route forced at B=384 and
    taken at E=70 (rows of 280 bytes).  h' and c' within rtol and atol
    1e-5 of the plain version, TF32 off."""
    rng = np.random.default_rng(b + e + 1)
    wt = _lstm_weights(rng, e, h, dev)
    x, hh, c = (_t(rng.normal(size=(b, n)), dev, torch.float32)
                for n in (e, h, h))
    picked = fused_lstm.lstm_route(wt.w_cat, x, hh)
    assert picked == ("cuda_core" if e == 70 else "tf32x3")
    before = _lstm_counts()
    if route == picked:
        kh, kc = fused_lstm.lstm_cell_fused(wt.w_cat, wt.b_sum, x, hh, c,
                                            wt.split)
    else:
        kh, kc = fused_lstm._run_kernel(wt.w_cat, wt.b_sum, x, hh, c, route)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_lstm_counts(), before)) == \
        _moved(route)
    ph, pc = fused_lstm.lstm_cell_plain(wt.w_cat, wt.b_sum, x, hh, c)
    torch.testing.assert_close(kh, ph, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=1e-5)


def _lstm_bwd_counts():
    return (fused_lstm.COUNT_BWD.n, fused_lstm.COUNT_BWD_WGMMA.n,
            fused_lstm.COUNT_BWD_TF32X3.n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,h,route", [(128, 2048, 1024, "tc"),
                                         (384, 2048, 1024, "tc"),
                                         (37, 200, 128, "tc"),
                                         (128, 2048, 1024, "cuda_core"),
                                         (37, 70, 96, "cuda_core")])
def test_lstm_bwd_kernel_matches_plain(dev, dtype, b, e, h, route):
    """K2's backward (gate recompute + gate gradients) at the XE training
    shape (B=128, E=2048, H=1024), at B=384, at ragged B=37 with E=200 on
    the dtype's tensor-core route ("tc": wgmma for bf16, tf32x3 for float32,
    with prepare_lstm's split), and on the CUDA-core route, forced at
    B=128 and taken at E=70.  d_gates and dc within K2's holds of
    lstm_cell_bwd_plain: 1e-5 in float32, rtol and atol 1e-2 in bf16."""
    rng = np.random.default_rng(b + e + 7)
    wt = _lstm_weights(rng, e, h, dev)
    w_cat, b_sum = wt.w_cat.to(dtype), wt.b_sum.to(dtype)
    split = wt.split if dtype == torch.float32 else None
    x, hh, c, dh, dc = (_t(rng.normal(size=(b, n)), dev, dtype)
                        for n in (e, h, h, h, h))
    tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    picked = fused_lstm.lstm_bwd_route(w_cat, x, hh, c, b_sum, dh, dc)
    assert picked == ("cuda_core" if e == 70 else tc_route)
    want_route = tc_route if route == "tc" else route
    before = _lstm_bwd_counts()
    if want_route == picked:
        dg, kdc = fused_lstm.lstm_cell_bwd(w_cat, b_sum, x, hh, c, dh, dc,
                                           split)
    else:
        dg, kdc = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, hh, c, dh, dc,
                                             want_route)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_lstm_bwd_counts(), before)) == \
        _moved(want_route)
    pdg, pdc = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, x, hh, c, dh, dc)
    assert dg.dtype == torch.float32 and dg.shape == (b, 4 * h)
    assert kdc.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dg, pdg, rtol=tol, atol=tol)
    torch.testing.assert_close(kdc, pdc, rtol=tol, atol=tol)


def test_lstm_bwd_misaligned_cotangent_takes_cuda_core(dev):
    """A cotangent that breaks the epilogue's pairs (a bf16 view at an odd
    element) sends the backward to the CUDA-core route, not to the plain
    version, and the result still holds."""
    rng = np.random.default_rng(3)
    b, e, h = 16, 256, 128
    wt = _lstm_weights(rng, e, h, dev)
    w_cat, b_sum = wt.w_cat.bfloat16(), wt.b_sum.bfloat16()
    x, hh, c, dc = (_t(rng.normal(size=(b, n)), dev, torch.bfloat16)
                    for n in (e, h, h, h))
    dh = _t(rng.normal(size=(b * h + 1,)), dev, torch.bfloat16)[1:].view(b, h)
    assert fused_lstm.lstm_bwd_route(w_cat, x, hh, c, b_sum, dh,
                                     dc) == "cuda_core"
    before = _lstm_bwd_counts()
    dg, kdc = fused_lstm.lstm_cell_bwd(w_cat, b_sum, x, hh, c, dh, dc)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_lstm_bwd_counts(), before)) == \
        _moved("cuda_core")
    pdg, pdc = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, x, hh, c, dh, dc)
    torch.testing.assert_close(dg, pdg, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(kdc, pdc, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_cell_function_grads_match_plain_autograd(dev, dtype):
    """LstmCell on the card at the XE training shape: the forward and the
    backward each launch once on the dtype's tensor-core route, the
    backward (on autograd's thread) on the stream the forward ran on, and
    every gradient agrees with autograd through
    lstm_cell_plain (float32 1e-5 of the largest gradient of the leaf;
    bf16 2e-2)."""
    rng = np.random.default_rng(5)
    b, e, h = 128, 2048, 1024
    bound = 1 / np.sqrt(h)
    leaves = {k: _t(rng.uniform(-bound, bound, shape), dev,
                    dtype).requires_grad_()
              for k, shape in (("w_ih", (e, 4 * h)), ("w_hh", (h, 4 * h)),
                               ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
    x, hh, c = (_t(rng.normal(size=(b, n)), dev, dtype).requires_grad_()
                for n in (e, h, h))
    names = list(leaves) + ["x", "h", "c"]
    ins = list(leaves.values()) + [x, hh, c]
    tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before, before_bwd = _lstm_counts(), _lstm_bwd_counts()
    streams = []
    run_bwd = fused_lstm._run_bwd_kernel

    def recording(*a, **kw):
        streams.append(torch.cuda.current_stream(dev))
        return run_bwd(*a, **kw)

    stream = torch.cuda.Stream()
    fused_lstm._run_bwd_kernel = recording
    try:
        with torch.cuda.stream(stream):
            w = fused_lstm.prepare_lstm(leaves)
            hn, cn = fused_lstm.lstm_cell_train(w, x, hh, c)
            got = torch.autograd.grad(
                (1.3 * hn.float() + 0.7 * cn.float()).sum(), ins)
    finally:
        fused_lstm._run_bwd_kernel = run_bwd
    torch.cuda.synchronize()
    # autograd ran the backward on the stream the forward ran on
    assert streams == [stream]
    assert tuple(a - b for a, b in zip(_lstm_counts(), before)) == \
        _moved(tc_route)
    assert tuple(a - b for a, b in zip(_lstm_bwd_counts(), before_bwd)) == \
        _moved(tc_route)
    ph, pc = fused_lstm.lstm_cell_plain(
        torch.cat([leaves["w_ih"], leaves["w_hh"]]),
        leaves["b_ih"] + leaves["b_hh"], x, hh, c)
    want = torch.autograd.grad((1.3 * ph.float() + 0.7 * pc.float()).sum(),
                               ins)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, g, wg in zip(names, got, want):
        assert g.dtype == dtype, name
        scale = float(wg.float().abs().max())
        err = float((g.float() - wg.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("m,k,route", [(384, 1, "tf32x3"), (384, 3, "tf32x3"),
                                       (1152, 3, "tf32x3"), (45, 16, "tf32x3"),
                                       (384, 1, "cuda_core")])
def test_head_f32_routes_match_plain(dev, m, k, route):
    """K1 in float32 at full width (H 1,024, V 10,102) on the tf32x3 route
    (greedy m=384, the beam shape m=1,152 with k=3, ragged m=45 with k=16)
    and on the CUDA-core route forced: values and lse within 1e-4 of the
    plain version (TF32 off), ids exact where the plain logits leave a gap
    above 1e-3 on both sides."""
    rng = np.random.default_rng(m * 11 + k)
    hdim, v = 1024, 10102
    head = {"v": _t(rng.normal(size=(hdim, v)), dev, torch.float32),
            "g": _t(rng.uniform(0.5, 2.0, v), dev, torch.float32),
            "b": _t(rng.normal(size=v), dev, torch.float32)}
    prep = fused_head.prepare_head(head, torch.float32)
    assert prep.split is not None
    x = _t(0.5 * rng.normal(size=(m, hdim)), dev, torch.float32)
    assert fused_head.head_route(prep.w, x) == "tf32x3"
    before = _head_counts()
    kv, ki, kl = fused_head._run_kernel(prep, x, k, route)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_head_counts(), before)) == \
        _moved(route)
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=0, atol=1e-4)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0


@pytest.mark.parametrize("m,k", [(384, 1), (1152, 3)])
@pytest.mark.parametrize("weight", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_routes_at_512_wide_match_plain(dev, dtype, weight, m, k):
    """K1 and K1-int8 at the 512-wide models' head (H 512, V 10,102),
    greedy (m=384, k=1) and beam (m=1,152, k=3), on each dtype's
    tensor-core route ("wgmma" in bf16; "tf32x3", or "tf32x2" with the
    int8 head, in float32): values and lse within 1e-4 (float32) or 2e-3
    (bf16), ids exact where the plain logits leave a gap above 1e-3 on
    both sides."""
    rng = np.random.default_rng(m * 5 + k)
    if weight == "int8":
        prep = _int8_head(rng, 512, 10102, dev)     # the same in any dtype
        assert prep.w.dtype == torch.int8
    else:
        head = {"v": _t(rng.normal(size=(512, 10102)), dev, dtype),
                "g": _t(rng.uniform(0.5, 2.0, 10102), dev, dtype),
                "b": _t(rng.normal(size=10102), dev, dtype)}
        prep = fused_head.prepare_head(head, dtype)
    x = _t(0.5 * rng.normal(size=(m, 512)), dev, dtype)
    route = ("wgmma" if dtype == torch.bfloat16 else
             "tf32x2" if weight == "int8" else "tf32x3")
    assert fused_head.head_route(prep.w, x) == route
    counter = {"wgmma": fused_head.COUNT_WGMMA,
               "tf32x3": fused_head.COUNT_TF32X3,
               "tf32x2": fused_head.COUNT_TF32X2}[route]
    before = fused_head.COUNT.n, counter.n
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert (fused_head.COUNT.n, counter.n) == (before[0] + 1, before[1] + 1)
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=tol)
    torch.testing.assert_close(kl, pl, rtol=0, atol=tol)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0


def test_tf32x3_routes_refuse_a_misaligned_x(dev):
    """The float32 tensor-core routes' C entries refuse a base TMA cannot
    take: no fallback."""
    head = fused_head.prepare_head(
        {"w": torch.randn(128, 512, device=dev), "b": torch.zeros(512,
                                                                  device=dev)},
        torch.float32)
    flat = torch.zeros(8 * 128 + 8, device=dev)
    x = flat[1:1 + 8 * 128].view(8, 128)
    assert fused_head.head_route(head.w, x) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        fused_head._run_kernel(head, x, 1, "tf32x3")
    wt = _lstm_weights(np.random.default_rng(5), 128, 64, dev)
    xs = flat[1:1 + 8 * 128].view(8, 128)
    hh, c = (torch.zeros(8, 64, device=dev) for _ in range(2))
    assert fused_lstm.lstm_route(wt.w_cat, xs, hh) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        fused_lstm._run_kernel(wt.w_cat, wt.b_sum, xs, hh, c, "tf32x3",
                               wt.split)


def _k3_f32_hold(got, want, x, qp):
    """K3's float32 hold: within 1e-5 of the sum of |x q s| (the float32
    rounding bound of a dot product summed in another order), plus 1e-6."""
    k, n = x.shape[1], want.shape[1]
    terms = x.abs() @ (qp["q"][:k, :n].float().abs() * qp["s"])
    err = (got - want).abs()
    assert bool((err <= 1e-5 * terms + 1e-6).all()), float(err.max())


@pytest.mark.parametrize("route", ["tf32x2", "cuda_core"])
@pytest.mark.parametrize("m,k,n", [(384, 3072, 4096),    # the LSTM gates
                                   (384, 1024, 1024),    # aoa_dec.q
                                   (384, 2048, 2048),    # aoa_dec.aoa
                                   (1152, 3072, 4096),   # the beam rows
                                   (1152, 1024, 1024),
                                   (1152, 2048, 2048),
                                   (37, 200, 700),       # ragged m, K, n
                                   (384, 5120, 4096),    # BUTD's cells
                                   (1152, 5120, 4096),
                                   (384, 4096, 4096),
                                   (1152, 4096, 4096),
                                   # the 512-wide models: NIC's and
                                   # AoASpatial's cells, aoa_dec.q (512)
                                   # and aoa_dec.aoa (1,024, as above)
                                   (384, 1024, 2048), (1152, 1024, 2048),
                                   (384, 1536, 2048), (1152, 1536, 2048),
                                   (384, 512, 512), (1152, 512, 512)])
def test_quant_matmul_f32_routes_match_plain(dev, route, m, k, n):
    """K3 in float32 on the 2xTF32 tensor-core route (quant_route's pick)
    at the int8 decode step's three shapes, over the greedy and the beam
    rows and ragged, and on the CUDA-core route (forced): K3's float32
    hold, x N(0, 1)."""
    rng = np.random.default_rng(m + k + n + 1)
    qp = _qdense(rng, k, n, dev)
    x = _t(rng.normal(size=(m, k)), dev, torch.float32)
    assert quant.quant_route(x, qp["q"]) == "tf32x2"
    before = quant.COUNT.n, quant.COUNT_WGMMA.n, quant.COUNT_TF32X2.n
    if route == "tf32x2":
        got = quant.quant_matmul(x, qp)
    else:
        got = quant._run_kernel(x, qp["q"], qp["s"], qp["b"], route)
    torch.cuda.synchronize()
    assert (quant.COUNT.n, quant.COUNT_WGMMA.n, quant.COUNT_TF32X2.n) == (
        before[0] + 1, before[1], before[2] + (route == "tf32x2"))
    assert got.shape == (m, n) and got.dtype == torch.float32
    _k3_f32_hold(got, quant.quant_matmul_plain(x, qp), x, qp)


def _int8_counts():
    return (fused_head.COUNT.n, fused_head.COUNT_WGMMA.n,
            fused_head.COUNT_TF32X2.n)


@pytest.mark.parametrize("m,k,route", [(16, 1, "tf32x2"), (16, 3, "tf32x2"),
                                       (3, 3, "tf32x2"), (45, 16, "tf32x2"),
                                       (384, 1, "tf32x2"), (384, 3, "tf32x2"),
                                       (1152, 3, "tf32x2"),
                                       (45, 16, "cuda_core")])
def test_head_int8_f32_routes_match_plain(dev, m, k, route):
    """K1-int8 in float32 at full width (H 1,024, V 10,102) on the 2xTF32
    route (head_route's pick) and on the CUDA-core route (forced): values
    and lse within 1e-4 of the plain version, ids exact where the plain
    logits leave a gap above 1e-3 on both sides."""
    rng = np.random.default_rng(m * 7 + k)
    prep = _int8_head(rng, 1024, 10102, dev)
    assert prep.w.dtype == torch.int8
    x = _t(rng.normal(size=(m, 1024)), dev, torch.float32)
    assert fused_head.head_route(prep.w, x) == "tf32x2"
    before = _int8_counts()
    kv, ki, kl = fused_head._run_kernel(prep, x, k, route)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_int8_counts(), before)) == (
        1, 0, int(route == "tf32x2"))
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k + 1)
    torch.testing.assert_close(kv, pv[:, :k], rtol=0, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=0, atol=1e-4)
    gaps = pv[:, :-1] - pv[:, 1:]
    lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                    gaps[:, :k - 1]], dim=1)
    sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
    assert int(((ki != pi[:, :k]) & sure).sum()) == 0


def test_head_int8_tf32x2_route_ties_across_chunks(dev):
    """The cross-chunk tie with an int8 head and float32 x on the 2xTF32
    route: equal winners in two 128-column chunks go to the smaller id, and
    a chunk made only of pad columns neither wins nor makes NaN."""
    vp = 2 * fused_head.V_TILE
    q = torch.zeros((128, vp), dtype=torch.int8)
    q[:8, 7] = 3
    q[:8, fused_head.V_TILE + 11] = 3
    q[:8, 100] = 1
    head = fused_head.prepare_head(
        {"q": q.to(dev), "s": torch.ones(700, device=dev),
         "b": torch.zeros(700, device=dev)}, torch.float32)
    x = torch.eye(8, 128, device=dev)
    assert fused_head.head_route(head.w, x) == "tf32x2"
    before = fused_head.COUNT_TF32X2.n
    vals, idx, lse = fused_head.topk_head(head, x, 3)
    torch.cuda.synchronize()
    assert fused_head.COUNT_TF32X2.n == before + 1
    pv, pi, pl = fused_head.topk_head_plain(head, x, 3)
    assert idx.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
    assert torch.equal(idx, pi)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, pl, rtol=0, atol=1e-4)


def test_tf32x2_routes_refuse_a_misaligned_x(dev):
    """The 2xTF32 routes' C entries refuse a base TMA cannot take: no
    fallback."""
    flat = torch.zeros(8 * 128 + 8, device=dev)
    x = flat[1:1 + 8 * 128].view(8, 128)
    qp = _qdense(np.random.default_rng(3), 128, 512, dev)
    assert quant.quant_route(x, qp["q"]) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        quant._run_kernel(x, qp["q"], qp["s"], qp["b"], "tf32x2")
    head = fused_head.prepare_head(qp, torch.float32)
    assert fused_head.head_route(head.w, x) == "cuda_core"
    with pytest.raises(RuntimeError, match="misaligned"):
        fused_head._run_kernel(head, x, 1, "tf32x2")


@pytest.mark.parametrize("b,k,n,d,heads", [(384, 3, 36, 1024, 8),
                                           (8, 3, 5, 256, 2),
                                           (5, 16, 37, 384, 3)])
def test_int8_attention_f32_beam_q_staging_matches_plain(dev, b, k, n, d,
                                                         heads):
    """attend_tma<float, 4> (float32 q, k >= 3), which stages q's rows in
    shared memory, holds against the plain version."""
    q, kq, ks, vq, vs, mask = _attention_inputs(b, k, n, d, dev,
                                                torch.float32, b + k + n)
    assert int8_attention.attention_route(q, kq, vq, n, d, heads) == "tma"
    got = int8_attention._run_kernel(q, kq, ks, vq, vs, mask, heads, "tma")
    torch.cuda.synchronize()
    want = int8_attention.lanes_attention_int8_plain(q, kq, ks, vq, vs, mask,
                                                     heads)
    _hold_attention(torch.float32, got, want, mask)


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8/float32",
                                  "int8/bfloat16"])
def test_beam_decode_through_the_kernels_matches_plain(dev, path,
                                                       monkeypatch):
    """A small AoADetection beam-3 decode (hidden 256, 2 heads: dh = 128,
    which K4 takes; vocab 1,000; B=16, 8 steps) through the kernels against
    the same decode through the plain versions.  Every step launches K1 at
    m = 48, k = 3, and K2 (float paths) or K3 three times and K4 at 3 query
    rows (int8 paths), each on its tensor-core or "tma" route (K1-int8 and
    K3 on "tf32x2" in float32).  Every kernel call holds against its
    plain version on the same inputs.  float32 ids are identical in all but
    at most one row; in the other paths each row's winner, rescored by the
    plain step, scores no lower than the plain run's winner minus 2 x 8
    steps x 4 x K1's value hold (1e-4 float32, 2e-3 bf16)."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    b, n_box, beam, max_steps = 16, 5, 3, 8
    cfg = dict(model_type="AoADetection", vocab_size=1000, embed_dim=256,
               hidden_dim=256, enc_dim=64, num_heads=2, num_refine_layers=1,
               max_bu_len=n_box)
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    model = get_captioner(ModelConfig(**cfg))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    if path.startswith("int8"):
        params = model.quantize_decode_params(params)
    dtype = torch.bfloat16 if path.endswith("bfloat16") else torch.float32
    valid = 1 + torch.arange(b, device=dev) % n_box
    visual = {"bu_feats": torch.relu(torch.randn(b, n_box, 64, generator=gen,
                                                 device=dev)),
              "bu_masks": (torch.arange(n_box, device=dev)[None]
                           < valid[:, None]).float()}
    fn = steps.make_beam_decode(model, beam_size=beam, max_steps=max_steps,
                                dtype=dtype, device="cuda")
    with holds.plain_versions():
        ref = fn(params, {}, visual)
    shapes, broken = [], []
    with holds.recording_shapes(shapes), holds.held_calls(broken):
        ids = fn(params, {}, visual)
    torch.cuda.synchronize()
    assert broken == []
    mk, tc = b * beam, dtype == torch.bfloat16
    r3 = "wgmma" if tc else "tf32x2"
    # K2 and K3 by the width of x: the cell's [emb, ctx] (512), K3's [x, h]
    # (768), aoa_dec.q's 256 and aoa_dec.aoa's 512
    want = {"float32": {("K1", "tf32x3", mk, beam),
                        ("K2", "tf32x3", mk, 512)},
            "bfloat16": {("K1", "wgmma", mk, beam),
                         ("K2", "wgmma", mk, 512)}}.get(
        path, {("K1", r3, mk, beam), ("K3", r3, mk, 768), ("K3", r3, mk, 256),
               ("K3", r3, mk, 512), ("K4", "tma", b, beam)})
    assert set(shapes) == want
    assert ids.shape == ref.shape == (b, max_steps + 1)
    if path == "float32":
        assert int((ids != ref).any(dim=1).sum()) <= 1
        return
    margin = holds.rescored_margin(model, params, visual, ids, ref, dtype, dev)
    assert float(margin.min()) >= -holds.beam_tol(dtype, max_steps)


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8/float32",
                                  "int8/bfloat16"])
@pytest.mark.parametrize("family", ["BUTDDetection", "BUTDSpatial"])
def test_butd_beam_decode_through_the_kernels_matches_plain(dev, family,
                                                            path):
    """A small BUTD beam-3 decode (embed 64, hidden 128, atten 32, enc 48;
    vocab 1,000; B=16, 8 steps; 5 boxes with 1-5 valid, or 9 unmasked
    regions) through the kernels against the same decode through the plain
    versions.  Every step launches K1 at m = 48, k = 3, and K2 twice (float
    paths) or K3 three times (int8 paths), never K4, each on its
    tensor-core route; every kernel call holds against its plain version.
    float32 ids are identical in all but at most one row; in the other
    paths each row's winner, rescored by the plain step, scores no lower
    than the plain run's winner minus 2 x 8 steps x 4 x K1's value hold."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    b, beam, max_steps = 16, 3, 8
    cfg = dict(model_type=family, vocab_size=1000, embed_dim=64,
               hidden_dim=128, atten_dim=32, enc_dim=48)
    model = get_captioner(ModelConfig(**cfg))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    if path.startswith("int8"):
        params = model.quantize_decode_params(params)
    dtype = torch.bfloat16 if path.endswith("bfloat16") else torch.float32
    if family == "BUTDSpatial":
        visual = {"spatial_feats": torch.relu(torch.randn(
            b, 9, 48, generator=gen, device=dev))}
    else:
        valid = 1 + torch.arange(b, device=dev) % 5
        visual = {"bu_feats": torch.relu(torch.randn(b, 5, 48, generator=gen,
                                                     device=dev)),
                  "bu_masks": (torch.arange(5, device=dev)[None]
                               < valid[:, None]).float()}
    fn = steps.make_beam_decode(model, beam_size=beam, max_steps=max_steps,
                                dtype=dtype, device="cuda")
    with holds.plain_versions():
        ref = fn(params, {}, visual)
    shapes, broken = [], []
    with holds.recording_shapes(shapes), holds.held_calls(broken):
        ids = fn(params, {}, visual)
    torch.cuda.synchronize()
    assert broken == []
    mk, tc = b * beam, dtype == torch.bfloat16
    route = "wgmma" if tc else ("tf32x2" if path.startswith("int8")
                                else "tf32x3")
    # K2 and K3 by the width of x: the attention cell's [h2, mean, emb]
    # (240) and the language cell's [attended, h1] (176); K3's [x, h] of
    # each (368, 304) and att_dec's h1 (128)
    widths = ({("K3", 368), ("K3", 304), ("K3", 128)}
              if path.startswith("int8") else {("K2", 240), ("K2", 176)})
    assert set(shapes) == {("K1", route, mk, beam)} | {
        (kn, route, mk, w) for kn, w in widths}
    n_steps = sum(s[0] == "K1" for s in shapes)
    assert all(sum(s[0] == kn and s[3] == w for s in shapes) == n_steps
               for kn, w in widths)
    assert ids.shape == ref.shape == (b, max_steps + 1)
    if path == "float32":
        assert int((ids != ref).any(dim=1).sum()) <= 1
        return
    margin = holds.rescored_margin(model, params, visual, ids, ref, dtype, dev)
    assert float(margin.min()) >= -holds.beam_tol(dtype, max_steps)


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8/float32",
                                  "int8/bfloat16"])
@pytest.mark.parametrize("family", ["NIC", "AoASpatial"])
def test_nic_and_aoa_spatial_beam_decode_through_the_kernels_matches_plain(
        dev, family, path, monkeypatch):
    """A small NIC or AoASpatial beam-3 decode (embed 64, hidden 128, enc
    48; AoASpatial 2 heads of 64, one refine layer, 9 unmasked regions;
    vocab 1,000; B=16, 8 steps) through the kernels against the same decode
    through the plain versions, SICZ_TPU_INT8_KV=auto.  Every step launches
    K1 at m = 48, k = 3, and the cell through K2 (float paths) or K3 (int8
    paths); AoASpatial's int8 step also runs aoa_dec.q and aoa_dec.aoa
    through K3; NIC's init cell is one more K2 or K3 launch over the 48
    beam rows; K4 never (64-wide heads).  Each launch on its tensor-core
    route; every kernel call holds against its plain version.  float32 ids
    are identical in all but at most one row; in the other paths each
    row's winner, rescored by the plain step, scores no lower than the
    plain run's winner minus 2 x 8 steps x 4 x K1's value hold."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    b, beam, max_steps = 16, 3, 8
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    cfg = dict(model_type=family, vocab_size=1000, embed_dim=64,
               hidden_dim=128, enc_dim=48, enc_img_size=3, num_heads=2,
               num_refine_layers=1)
    model = get_captioner(ModelConfig(**cfg))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    if path.startswith("int8"):
        params = model.quantize_decode_params(params)
    dtype = torch.bfloat16 if path.endswith("bfloat16") else torch.float32
    if family == "NIC":
        visual = {"features": torch.relu(torch.randn(
            b, 48, generator=gen, device=dev))}
    else:
        visual = {"spatial_feats": torch.relu(torch.randn(
            b, 9, 48, generator=gen, device=dev))}
    fn = steps.make_beam_decode(model, beam_size=beam, max_steps=max_steps,
                                dtype=dtype, device="cuda")
    with holds.plain_versions():
        ref = fn(params, {}, visual)
    shapes, broken = [], []
    with holds.recording_shapes(shapes), holds.held_calls(broken):
        ids = fn(params, {}, visual)
    torch.cuda.synchronize()
    assert broken == []
    mk, tc = b * beam, dtype == torch.bfloat16
    route = "wgmma" if tc else ("tf32x2" if path.startswith("int8")
                                else "tf32x3")
    # K2 and K3 by the width of x: NIC's cell [emb] (64) and its [x, h]
    # (192); AoASpatial's cell [emb, ctx] (192), its [x, h] (320),
    # aoa_dec.q's 128 and aoa_dec.aoa's 256
    widths = {("NIC", False): {("K2", 64)}, ("NIC", True): {("K3", 192)},
              ("AoASpatial", False): {("K2", 192)},
              ("AoASpatial", True): {("K3", 320), ("K3", 128),
                                     ("K3", 256)}}[
        family, path.startswith("int8")]
    assert set(shapes) == {("K1", route, mk, beam)} | {
        (kn, route, mk, w) for kn, w in widths}
    # each width once a step, NIC's cell once more (its step -1 cell)
    n_steps = sum(s[0] == "K1" for s in shapes)
    init = int(family == "NIC")
    assert all(sum(s[0] == kn and s[3] == w for s in shapes)
               == n_steps + init for kn, w in widths)
    assert ids.shape == ref.shape == (b, max_steps + 1)
    if path == "float32":
        assert int((ids != ref).any(dim=1).sum()) <= 1
        return
    margin = holds.rescored_margin(model, params, visual, ids, ref, dtype, dev)
    assert float(margin.min()) >= -holds.beam_tol(dtype, max_steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xe_step_through_kernels_matches_plain(dev, dtype):
    """One AoADetection XE step on the card (embed and hidden 256, B=16,
    T=8, dropout on, scheduled sampling at 0.25): through the kernels, K2's
    forward and backward run T-1 = 7 times each on the dtype's tensor-core
    route with every call held against its plain version, and the loss and
    the updated params agree with the same step through the plain
    versions (the same generator seeds, so the same dropout masks and
    draws), after one SGD step at lr 0.05 (a param moves by lr times its
    clamped gradient, so the params differ by lr times the gradients'
    difference): the loss within 1e-5 in float32 and 1e-2 in bf16, each
    param within 1e-6 and 1e-4 (a bf16 ulp of a gradient at the clamp,
    0.1 x 2^-8, times lr is 2e-5)."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    b, t, n = 16, 8, 6
    model = get_captioner(ModelConfig(
        model_type="AoADetection", vocab_size=300, embed_dim=256,
        hidden_dim=256, enc_dim=128, num_heads=2, num_refine_layers=2,
        max_bu_len=n))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(1)
    caps = rng.integers(4, 300, size=(b, t))
    caps[:, 0] = 1
    batch = {"visual": {"bu_feats": _t(rng.normal(size=(b, n, 128)), dev,
                                       torch.float32)},
             "captions": torch.from_numpy(caps).to(dev),
             "lengths": torch.from_numpy(rng.integers(3, t + 1,
                                                      size=(b,))).to(dev)}
    tx = optim.make_grad_transform("SGD", 0.1)
    step = steps.make_xe_train_step(
        model, tx, model.param_labels(params),
        compute_dtype=None if dtype == torch.float32 else dtype)

    def run():
        return step(TrainState.create(params, tx), batch,
                    torch.Generator(device=dev).manual_seed(3), 0.25, 0.05,
                    0.0)

    with holds.plain_versions():
        ref, ref_met = run()
    tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before, before_bwd = _lstm_counts(), _lstm_bwd_counts()
    broken = []
    with holds.held_calls(broken):
        got, met = run()
    torch.cuda.synchronize()
    assert not broken, broken[:2]
    assert tuple(a - b for a, b in zip(_lstm_counts(), before)) == \
        tuple(7 * v for v in _moved(tc_route))
    assert tuple(a - b for a, b in zip(_lstm_bwd_counts(), before_bwd)) == \
        tuple(7 * v for v in _moved(tc_route))
    f32 = dtype == torch.float32
    lt = 1e-5 if f32 else 1e-2
    assert abs(float(met["loss"]) - float(ref_met["loss"])) <= \
        lt * float(ref_met["loss"])
    for p, q in zip(optim.tree_leaves(got.params),
                    optim.tree_leaves(ref.params)):
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6 if f32 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scst_step_through_kernels_matches_plain(dev, dtype, monkeypatch):
    """One AoADetection SCST step on the card (embed and hidden 256, B=16,
    cap 6, dropout on, 3 references an image, the reward table on the
    card): every K1, K2 and K2-backward call held against its plain
    version; K1 once a greedy step taken, K2's forward that many plus 6
    times and its backward 6 times, all on the dtype's tensor-core route.
    Then the same rollout's ids replayed through the plain versions: the
    reward identical (the same ids) and the loss within 1e-5 (float32) or
    1e-2 (bf16) of the sum of |logp| |reward| over the mask."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import cider
    b, t, n, r = 16, 6, 6, 3
    model = get_captioner(ModelConfig(
        model_type="AoADetection", vocab_size=300, embed_dim=256,
        hidden_dim=256, enc_dim=128, num_heads=2, num_refine_layers=2,
        max_bu_len=n))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(2)
    lens = rng.integers(3, 10, size=(b, r))
    ref_ids = np.zeros((b, r, 10), np.int64)
    for i in range(b):
        for j in range(r):
            ref_ids[i, j, :lens[i, j]] = rng.integers(4, 300, lens[i, j])
    table = cider.CiderDTable.from_ref_corpus(
        [[list(ref_ids[i, j, :lens[i, j]]) for j in range(r)]
         for i in range(b)])
    td = table.device_arrays()
    batch = {"visual": {"bu_feats": _t(rng.normal(size=(b, n, 128)), dev,
                                       torch.float32)},
             "ref_ids": torch.from_numpy(ref_ids).to(dev),
             "ref_lens": torch.from_numpy(lens).to(dev)}
    cdtype = None if dtype == torch.float32 else dtype
    tx = optim.make_grad_transform("Adam", 0.25)
    step = steps.make_scst_train_step(
        model, tx, model.param_labels(params), td, table.probe, max_len=t,
        compute_dtype=cdtype)
    tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = (_head_counts(), _lstm_counts(), _lstm_bwd_counts())
    broken = []
    with holds.held_calls(broken):
        st, met = step(TrainState.create(params, tx), batch,
                       torch.Generator(device=dev).manual_seed(3), 2e-5, 0.0)
    torch.cuda.synchronize()
    assert not broken, broken[:2]
    n_head = fused_head.COUNT.n - before[0][0]
    assert 1 <= n_head <= t
    for now, was, n_calls in (
            (_head_counts(), before[0], n_head),
            (_lstm_counts(), before[1], n_head + t),
            (_lstm_bwd_counts(), before[2], t)):
        assert tuple(a - c for a, c in zip(now, was)) == \
            tuple(n_calls * v for v in _moved(tc_route))
    assert np.isfinite(float(met["loss"]))
    assert all(p.dtype == torch.float32
               for p in optim.tree_leaves(st.params))

    greedy = steps.greedy_baseline(model, params, {}, batch["visual"], t,
                                   cdtype)

    def loss_of(replay=None):
        return steps.scst_loss(
            model, params, {}, batch, td, table.probe, greedy,
            torch.Generator(device=dev).manual_seed(4),
            torch.Generator(device=dev).manual_seed(5), max_len=t,
            compute_dtype=cdtype, replay=replay)

    seen, crit = [], steps.reward_criterion
    monkeypatch.setattr(steps, "reward_criterion", lambda *a, **kw: (
        seen.append(a), crit(*a, **kw))[1])
    with torch.no_grad():
        loss, reward, _, seq, drawn = loss_of()
        with holds.plain_versions():
            p_loss, p_reward, _, _, _ = loss_of((seq, drawn))
    assert torch.equal(reward, p_reward)
    logp, _, _ = seen[-1][:3]
    scale = float(crit(-logp.abs(), seq, reward.abs()))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert abs(float(loss) - float(p_loss)) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["NIC", "BUTDSpatial", "AoASpatial"])
def test_from_pixels_beam_decode_through_the_kernels_matches_plain(
        dev, family, dtype, monkeypatch):
    """Beam 3 from pixels (B=16 uint8 images at 224, the ResNet at block
    counts (1, 1, 1, 1) with its running statistics set to another batch's
    own; hidden 256, vocab 1,000, 8 steps) through the kernels against the
    same decode through the plain versions on the same encode's feature
    map (the second run reads the first's).  Every kernel call holds
    against its plain version; K1 and K2 run on the dtype's tensor-core
    route; float32 ids identical in all but at most one row, bf16 winners
    rescored by the plain step within ``holds.beam_tol``."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import image
    b, beam, max_steps = 16, 3, 8
    monkeypatch.setattr(resnet, "BLOCK_COUNTS", (1, 1, 1, 1))
    extra = {"BUTDSpatial": dict(atten_dim=128),
             "AoASpatial": dict(num_heads=2, num_refine_layers=1)}
    model = get_captioner(ModelConfig(
        model_type=family, vocab_size=1000, embed_dim=256, hidden_dim=256,
        enc_dim=2048, **extra.get(family, {})))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen, include_cnn=True)
    stats = model.init_model_state()["cnn_stats"]
    images = torch.randint(0, 256, (2 * b, 224, 224, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    monkeypatch.setattr(resnet, "BN_MOMENTUM", 1.0)
    with torch.no_grad():
        _, cal = resnet.apply(params["cnn"], stats,
                              image.normalize(images[b:]),
                              dtype=torch.float32, train=True)
    ms, visual = {"cnn_stats": cal}, {"img_tensors": images[:b]}
    fmaps, apply = [], resnet.apply
    monkeypatch.setattr(resnet, "apply", lambda *a, **kw: fmaps[0] if fmaps
                        else fmaps.append(apply(*a, **kw)) or fmaps[0])
    fn = steps.make_beam_decode(model, beam_size=beam, max_steps=max_steps,
                                dtype=dtype, device="cuda")
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = (_head_counts(), _lstm_counts())
    shapes, broken = [], []
    with holds.recording_shapes(shapes), holds.held_calls(broken):
        ids = fn(params, ms, visual)
    torch.cuda.synchronize()
    assert broken == [] and len(fmaps) == 1
    assert {s[:2] for s in shapes} == {("K1", route), ("K2", route)}
    for now, was in ((_head_counts(), before[0]),
                     (_lstm_counts(), before[1])):
        moved = tuple(a - c for a, c in zip(now, was))
        assert moved[0] > 0 and moved == tuple(
            moved[0] * v for v in _moved(route))
    with holds.plain_versions():
        ref = fn(params, ms, visual)
    assert ids.shape == ref.shape == (b, max_steps + 1)
    if dtype == torch.float32:
        assert int((ids != ref).any(dim=1).sum()) <= 1
        return
    margin = holds.rescored_margin(model, params, visual, ids, ref, dtype,
                                   dev, ms)
    assert float(margin.min()) >= -holds.beam_tol(dtype, max_steps)


def _tiny_dataset(root, n_img=20, n_box=5, enc_dim=64):
    """A reference-layout dataset (Flickr8K) of ``n_img`` test images with
    fixed bottom-up features, without the JAX package."""
    import json
    from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab, save_vocab
    words = ["a", "dog", "cat", "runs", "sits", "on", "grass", "mat"]
    rng = np.random.default_rng(21)
    (root / "ann").mkdir()
    (root / "Data" / "fixed_bu_feat").mkdir(parents=True)
    images, anns = [], []
    for i in range(n_img):
        toks = [words[int(j)] for j in rng.integers(0, 8, 5)]
        anns.append({"image_id": i, "id": i, "caption": " ".join(toks),
                     "tokens": toks, "file_name": "%d.jpg" % i})
        images.append({"id": i, "file_name": "%d.jpg" % i,
                       "sentences": [{"tokens": toks}]})
        np.savez(root / "Data" / "fixed_bu_feat" / ("%d.npz" % i),
                 feat=np.abs(rng.normal(size=(n_box, enc_dim))).astype(
                     np.float32))
    with open(root / "ann" / "test.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    save_vocab(build_vocab([words], threshold=1),
               str(root / "Data" / "caption_vocab.pkl"))


@pytest.mark.parametrize("beam", [-1, 3])
def test_engine_eval_ids_match_the_plain_run(dev, tmp_path, monkeypatch,
                                             beam):
    """An eval through the Engine on the card (K1 and K2 on their
    tensor-core routes, float32) gives the ids of the same eval with the
    plain versions."""
    from simpleimagecaptionzoo_tpu_torch.config import (DataConfig,
                                                        ModelConfig,
                                                        TrainConfig)
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.engine.model_engines import \
        get_engine
    from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab
    _tiny_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    vocab = load_vocab(str(tmp_path / "Data" / "caption_vocab.pkl"))
    data = DataConfig(dataset_name="Flickr8K",
                      test_caption_path=str(tmp_path / "ann" / "test.json"),
                      data_dir=str(tmp_path / "Data"))
    eng = get_engine(
        ModelConfig(model_type="BUTDDetection", vocab_size=len(vocab),
                    embed_dim=128, hidden_dim=128, atten_dim=128, enc_dim=64,
                    max_bu_len=5),
        data, vocab, train_config=TrainConfig(eval_batch_size=8),
        use_bu="fixed", device="cuda", tqdm_visible=False)
    before = (_head_counts(), _lstm_counts())
    got = eng.eval_captions_json_generation("test", beam)
    torch.cuda.synchronize()
    assert _head_counts()[0] > before[0][0]
    assert _lstm_counts()[0] > before[1][0]
    with holds.plain_versions():
        want = eng.eval_captions_json_generation("test", beam)
    assert len(got) == 20 and got == want
