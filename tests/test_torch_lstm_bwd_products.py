"""K2's whole backward (simpleimagecaptionzoo_tpu_torch/ops/fused_lstm.py,
lstm_cell_bwd_full: the backward kernel, then the dx·dh and dW·db kernels
of csrc/lstm_bwd.cu on the tensor-core routes) on the CPU: the bf16 split
of d_gates, the plain 2xBF16 and 3xTF32 products the kernels compute
against float64, the plain whole backward against jax.grad through the JAX
package's Pallas cell (interpret mode), the routes and the split of dx·dh's
reduction, and LstmCell on CPU tensors, which launches nothing.  The
kernels themselves run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import pallas_lstm
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm, tf32

# (name, E, H): the five training cells (AoADetection E=2,048 H=1,024;
# BUTD's td 4,096 and lang 3,072, H=1,024; NIC 512, 512; AoASpatial
# 1,024, 512), each narrowed 16 times
CELLS = [("aoa", 128, 64), ("butd_td", 256, 64), ("butd_lang", 192, 64),
         ("nic", 32, 32), ("aoasp", 64, 32)]
ROWS = [3, 64 + 5]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cell(e, h, b, seed):
    """numpy: the cell's params (torch's init range), x, h, c and the
    cotangents dh', dc'."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(h)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa
    params = {"w_ih": u(e, 4 * h), "w_hh": u(h, 4 * h), "b_ih": u(4 * h),
              "b_hh": u(4 * h)}
    x, hh, c, dh, dc = (rng.normal(size=(b, n)).astype(np.float32)
                        for n in (e, h, h, h, h))
    return params, x, hh, c, dh, dc


def _d_gates(e, h, b, seed):
    params, x, hh, c, dh, dc = _cell(e, h, b, seed)
    w_cat = torch.from_numpy(np.concatenate([params["w_ih"], params["w_hh"]]))
    b_sum = torch.from_numpy(params["b_ih"] + params["b_hh"])
    t = [torch.from_numpy(a) for a in (x, hh, c, dh, dc)]
    d, _ = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, *t)
    return w_cat, t[0], t[1], d


def test_bf16_split_within_2_to_the_minus_16():
    """d = d_hi + d_lo within 2^-16 |d| over many binades and both signs;
    both parts bf16, d_hi the nearest bf16 to d."""
    rng = np.random.default_rng(0)
    d = torch.from_numpy((rng.normal(size=20000)
                          * 10.0 ** rng.integers(-20, 20, 20000))
                         .astype(np.float32))
    hi, lo = fused_lstm.split_bf16(d)
    assert hi.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(hi, d.to(torch.bfloat16), rtol=0, atol=0)
    err = (hi.double() + lo.double() - d.double()).abs()
    assert bool((err <= 2.0 ** -16 * d.double().abs()).all())


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name,e,h", CELLS)
def test_2xbf16_products_against_float64(name, e, h, b):
    """The bf16 route's two products on a cell's own d_gates and a bf16
    w_cat, x and h: dx·dh = d w_cat^T and dW = [x, h]^T d, each as
    2xBF16 (d's two bf16 parts, every product exact, summed in float32),
    within (2^-16 + K 2^-24) of sum |a||b| of the float64 product (K the
    reduction's length: 2^-16 the split, K 2^-24 the float32 sum)."""
    w_cat, x, hh, d = _d_gates(e, h, b, e + h + b)
    wb = w_cat.to(torch.bfloat16)
    xh = torch.cat([x, hh], -1).to(torch.bfloat16)
    hi, lo = fused_lstm.split_bf16(d)
    cases = [("dxh", fused_lstm.mm_2xbf16(hi, lo, wb.t()), d.double(),
              wb.double().t(), 4 * h),
             ("dW", fused_lstm.mm_2xbf16(hi.t(), lo.t(), xh).t(),
              xh.double().t(), d.double(), b)]
    for what, got, a, bm, k in cases:
        want = a @ bm
        size = a.abs() @ bm.abs()
        lim = (2.0 ** -16 + k * 2.0 ** -24) * size
        err = (got.double() - want).abs()
        assert got.dtype == torch.float32, what
        assert bool((err <= lim).all()), (what, float((err / lim).max()))


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name,e,h", CELLS)
def test_3xtf32_products_against_float64(name, e, h, b):
    """The float32 route's two products as 3xTF32 (both operands split,
    three products, summed in float32) within (2^-20 + 3K 2^-24) of
    sum |a||b| of the float64 product; a plain TF32 product (one part
    each) is not, at the same bound."""
    w_cat, x, hh, d = _d_gates(e, h, b, 7 * e + h + b)
    xh = torch.cat([x, hh], -1)
    for what, a, bm, k in (("dxh", d, w_cat.t(), 4 * h),
                           ("dW", xh.t(), d, b)):
        want = a.double() @ bm.double()
        lim = (2.0 ** -20 + 3 * k * 2.0 ** -24) * (
            a.double().abs() @ bm.double().abs())
        got = tf32.mm_3xtf32(a, bm)
        assert bool(((got.double() - want).abs() <= lim).all()), what
        one = tf32.round_tf32(a.contiguous()) @ tf32.round_tf32(
            bm.contiguous())
        assert not bool(((one.double() - want).abs() <= lim).all()), what


def _jax_vjp(params, x, h, c, dh, dc, dtype):
    """JAX's cotangents of (w_ih, w_hh, b_ih, b_hh, x, h, c) through the
    Pallas cell (interpret mode) and its custom VJP, for cotangents dh', dc'
    of h' and c'."""
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731

    def cell(p, x, h, c):
        return pallas_lstm.lstm_cell_fused(p, x, h, c, interpret=True)

    _, vjp = jax.vjp(cell, {k: cast(v) for k, v in params.items()},
                     cast(x), cast(h), cast(c))
    gp, gx, gh, gc = vjp((cast(dh), cast(dc)))
    return gp, gx, gh, gc


@pytest.mark.parametrize("dtype,b,name,e,h", [
    (torch.float32, 3, *CELLS[0]), (torch.float32, 69, *CELLS[1]),
    (torch.float32, 69, *CELLS[3]), (torch.float32, 3, *CELLS[4]),
    (torch.bfloat16, 69, *CELLS[0]), (torch.bfloat16, 3, *CELLS[2])])
def test_full_plain_matches_jax_vjp(dtype, b, name, e, h):
    """lstm_cell_bwd_full_plain's (dW, db, dx, dh, dc) against jax.vjp of
    the Pallas cell: dW's rows against w_ih's and w_hh's cotangents, db
    against b_ih's (and b_hh's, the same); float32 within 1e-5, bf16 within
    2e-2 of each leaf's largest value (JAX's bf16 recompute rounds the
    gates to bf16 first; tests/test_torch_lstm_bwd.py); each output in its
    primal's dtype; and lstm_cell_bwd_full on CPU tensors is the plain
    version, bit for bit."""
    params, x, hh, c, dh, dc = _cell(e, h, b, b + e)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    gp, gx, gh, gc = _jax_vjp(params, x, hh, c, dh, dc, jdt)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    w_cat = torch.cat([t(params["w_ih"]), t(params["w_hh"])])
    b_sum = (t(params["b_ih"]).float() + t(params["b_hh"]).float()).to(dtype)
    args = (w_cat, b_sum, t(x), t(hh), t(c), t(dh), t(dc))
    got = fused_lstm.lstm_cell_bwd_full_plain(*args)
    dw, db, gxp, ghp, gcp = got
    pairs = [("w_ih", dw[:e], gp["w_ih"]), ("w_hh", dw[e:], gp["w_hh"]),
             ("b_ih", db, gp["b_ih"]), ("b_hh", db, gp["b_hh"]),
             ("x", gxp, gx), ("h", ghp, gh), ("c", gcp, gc)]
    for what, g, j in pairs:
        assert g.dtype == dtype, what
        jn = np.asarray(j.astype(jnp.float32))
        gn = g.float().numpy()
        assert gn.shape == jn.shape, what
        if dtype == torch.float32:
            np.testing.assert_allclose(gn, jn, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
        else:
            scale = float(np.abs(jn).max())
            assert float(np.abs(gn - jn).max()) <= 2e-2 * scale, what
    again = fused_lstm.lstm_cell_bwd_full(*args)
    for g, a in zip(got, again):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def _counts():
    return tuple(cnt.n for cnt in (
        fused_lstm.COUNT, fused_lstm.COUNT_BWD, fused_lstm.COUNT_BWD_WGMMA,
        fused_lstm.COUNT_BWD_TF32X3, fused_lstm.COUNT_DXH,
        fused_lstm.COUNT_DXH_WGMMA, fused_lstm.COUNT_DXH_TF32X3,
        fused_lstm.COUNT_DW, fused_lstm.COUNT_DW_WGMMA,
        fused_lstm.COUNT_DW_TF32X3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_cell_on_cpu_counts_no_launch(dtype):
    """LstmCell's forward and backward on CPU tensors take the plain
    versions: no counter moves, and every gradient equals
    lstm_cell_bwd_full_plain's on the same cotangents."""
    params, x, hh, c, dh, dc = _cell(64, 32, 5, 1)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in
              (np.concatenate([params["w_ih"], params["w_hh"]]),
               params["b_ih"] + params["b_hh"], x, hh, c)]
    before = _counts()
    hn, cn = fused_lstm.LstmCell.apply(*leaves, None, None)
    cot = [torch.from_numpy(a).to(dtype) for a in (dh, dc)]
    got = torch.autograd.grad((hn, cn), leaves, cot)
    assert _counts() == before
    want = fused_lstm.lstm_cell_bwd_full_plain(
        *(t.detach() for t in leaves), *cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_missing_cotangent_reads_as_zero():
    """A loss through h' alone leaves c' without a cotangent: autograd
    passes None (LstmCell does not have it filled with zeros, which would
    be one more launch on the card), and the backward reads it as zero."""
    params, x, hh, c, dh, _ = _cell(64, 32, 4, 2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (np.concatenate([params["w_ih"], params["w_hh"]]),
               params["b_ih"] + params["b_hh"], x, hh, c)]
    hn, _ = fused_lstm.LstmCell.apply(*leaves, None, None)
    dht = torch.from_numpy(dh)
    got = torch.autograd.grad((hn * dht).sum(), leaves)
    want = fused_lstm.lstm_cell_bwd_full_plain(
        *(t.detach() for t in leaves), dht, torch.zeros_like(dht))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    d0, _ = fused_lstm.lstm_cell_bwd_plain(*(t.detach() for t in leaves),
                                           dht, None)
    dz, _ = fused_lstm.lstm_cell_bwd_plain(*(t.detach() for t in leaves),
                                           dht, torch.zeros_like(dht))
    torch.testing.assert_close(d0, dz, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,e,route", [
    (torch.bfloat16, 2048, "wgmma"), (torch.float32, 2048, "tf32x3"),
    (torch.bfloat16, 512, "wgmma"), (torch.float32, 4096, "tf32x3"),
    (torch.bfloat16, 200, "cuda_core"), (torch.float32, 200, "cuda_core"),
    (torch.float32, 96, "cuda_core")])
def test_products_route(dtype, e, route):
    """The products run on the tensor cores where the backward kernel does
    and E is a multiple of 64 (dW's boxes of x and h never straddle the
    two); E=200 and 96 keep the backward kernel's tensor-core route and take
    float32 torch.matmul products."""
    h = 64
    w_cat = torch.zeros(e + h, 4 * h, dtype=dtype)
    x, hh = torch.zeros(8, e, dtype=dtype), torch.zeros(8, h, dtype=dtype)
    assert fused_lstm.lstm_bwd_route(w_cat, x, hh) == (
        "wgmma" if dtype == torch.bfloat16 else "tf32x3")
    assert fused_lstm.lstm_bwd_products_route(w_cat, x, hh) == route


@pytest.mark.parametrize("b,e,h,route,want", [
    (128, 2048, 1024, "wgmma", 3), (128, 2048, 1024, "tf32x3", 5),
    (64, 2048, 1024, "wgmma", 3), (192, 2048, 1024, "wgmma", 2),
    (384, 2048, 1024, "tf32x3", 1), (128, 512, 512, "wgmma", 3),
    (128, 512, 512, "tf32x3", 8), (128, 4096, 1024, "tf32x3", 3),
    (128, 3072, 1024, "tf32x3", 4), (8, 256, 16, "wgmma", 1)])
def test_dxh_splits(b, e, h, route, want):
    """dx·dh's reduction is split so that the tiles times the splits come
    to at most one block an SM (132 on the H100), in at most 8 splits on
    the float32 route and 3 on the bf16 one, each at least 4 stages
    deep."""
    got = fused_lstm.dxh_splits(b, e, h, 132, route)
    assert got == want
    tiles = -(-(e + h) // 128) * -(-b // 128)
    assert got == 1 or tiles * got <= 132
