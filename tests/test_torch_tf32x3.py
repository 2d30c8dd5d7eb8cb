"""The 3xTF32 scheme of the float32 "tf32x3" routes of K1 and K2, on the CPU.

The weight split (simpleimagecaptionzoo_tpu_torch/ops/tf32.py), the
prepared weights the kernels read, and a numpy emulation of the kernels'
arithmetic: exact products, float32 sums every k8 step, three products a
step (a_lo b_hi, a_hi b_lo, a_hi b_hi).  The emulation holds K2 and K1 to
their float32 holds against the float64 product where plain TF32 does not.
The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py), where the JAX package's float32 Pallas kernels are the
reference through the same plain versions (tests/test_torch_fused_lstm.py,
tests/test_torch_fused_head.py).
"""
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import fused_head as JF
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, fused_lstm, tf32

LOW13 = (1 << 13) - 1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _weights(seed):
    """Values over many binades, with both signs, ties of the rounding and
    large float32 values; all at least 2^-100, so that w_lo (about 2^-11 of
    w) is a normal float: a subnormal part keeps fewer bits."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=4096) * 10.0 ** rng.integers(-25, 30, 4096)
         ).astype(np.float32)
    bits = rng.integers(0, 1 << 23, 64, dtype=np.int64)
    ties = (((bits >> 13) << 13) | 0x1000 | (0x3F800000)).astype(np.uint32)
    extra = np.concatenate([ties.view(np.float32), -ties.view(np.float32),
                            np.array([0.0, -0.0, 1.0, 3.0, 1e-30, 3e38],
                                     np.float32)])
    return torch.from_numpy(np.concatenate([w, extra]))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_leaves_the_low_13_bits_zero(seed):
    w = _weights(seed)
    hi, lo = tf32.split_tf32(w)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & LOW13).abs().sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_exact_to_2_pow_minus_22(seed):
    w = _weights(seed)
    hi, lo = tf32.split_tf32(w)
    wd, rest = w.double(), w.double() - hi.double() - lo.double()
    assert bool((rest.abs() <= 2.0 ** -22 * wd.abs()).all())
    # hi is w to the nearest TF32 value: within half a unit of its 10th bit
    assert bool(((wd - hi.double()).abs() <= 2.0 ** -11 * wd.abs()).all())


def test_round_is_cvt_rna():
    """Ties go away from zero (``cvt.rna.tf32.f32``), not to even."""
    one = 0x3F800000
    for tail, up in ((0x0FFF, False), (0x1000, True), (0x1001, True)):
        for base in (one, one | 0x2000):         # even and odd last bit
            for sign in (1.0, -1.0):
                x = torch.tensor([base | tail], dtype=torch.int32).view(
                    torch.float32) * sign
                got = int(tf32.round_tf32(x).abs().view(torch.int32))
                assert got == base + (0x2000 if up else 0)
    with pytest.raises(TypeError):
        tf32.round_tf32(torch.zeros(2, dtype=torch.bfloat16))


def _tf32(a):
    return tf32.round_tf32(torch.from_numpy(np.ascontiguousarray(
        a, np.float32))).numpy()


def _emulate(a, b, three):
    """a (m, K) @ b (K, n) as the kernels sum it: per k8 step, exact
    products (float64 holds a product of two 11-bit mantissas exactly)
    summed and added into a float32 accumulator; three=True takes the
    three products of 3xTF32 in the kernels' order, three=False plain TF32
    (a_hi b_hi alone)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = ([(al, bh), (ah, bl), (ah, bh)] if three else [(ah, bh)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            part = x[:, k0:k0 + 8].astype(np.float64) @ \
                y[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _gate_math64(z, c):
    i, f, g, o = np.split(z, 4, axis=-1)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    c_new = sig(f) * c + sig(i) * np.tanh(g)
    return sig(o) * np.tanh(c_new), c_new


def _close(got, want, rtol, atol):
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def test_emulated_lstm_products_meet_the_float32_hold():
    """K2's hold (h', c' within rtol and atol 1e-5) at a small cell,
    weights U(+-1/sqrt(H)) and x, h, c N(0, 1) as chip_smoke.py draws them:
    3xTF32 meets it against the float64 cell, plain TF32 does not."""
    rng = np.random.default_rng(7)
    b, e, h = 16, 192, 64
    bound = 1 / np.sqrt(h)
    w = rng.uniform(-bound, bound, (e + h, 4 * h)).astype(np.float32)
    bias = rng.uniform(-bound, bound, 4 * h).astype(np.float32)
    xh = rng.normal(size=(b, e + h)).astype(np.float32)
    c = rng.normal(size=(b, h)).astype(np.float32)
    want = _gate_math64(xh.astype(np.float64) @ w.astype(np.float64) + bias,
                        c.astype(np.float64))
    for three, holds in ((True, True), (False, False)):
        got = _gate_math64(_emulate(xh, w, three).astype(np.float64) + bias,
                           c.astype(np.float64))
        assert all(_close(g, v, 1e-5, 1e-5)
                   for g, v in zip(got, want)) == holds


def test_emulated_head_products_meet_the_float32_hold():
    """K1's hold (values and lse within 1e-4) at a small head, x N(0, 0.25)
    and a weight-norm head with column norms U(0.5, 2) as chip_smoke.py's:
    3xTF32 meets it against the float64 logits, plain TF32 does not."""
    rng = np.random.default_rng(11)
    m, k, v = 16, 512, 640
    vv = rng.normal(size=(k, v))
    w = (vv * rng.uniform(0.5, 2.0, v) / np.linalg.norm(vv, axis=0)
         ).astype(np.float32)
    x = (0.5 * rng.normal(size=(m, k))).astype(np.float32)
    want = x.astype(np.float64) @ w.astype(np.float64)

    def summary(logits):
        lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
            + logits.max(1)
        return np.sort(logits, axis=1)[:, ::-1][:, :3], lse

    ref = summary(want)
    for three, holds in ((True, True), (False, False)):
        got = summary(_emulate(x, w, three).astype(np.float64))
        assert all(np.abs(g - r).max() <= 1e-4
                   for g, r in zip(got, ref)) == holds


def test_prepared_lstm_split_holds_w_cat_transposed():
    rng = np.random.default_rng(3)
    e, h = 40, 24
    params = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for n, s in (("w_ih", (e, 4 * h)), ("w_hh", (h, 4 * h)),
                           ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
    w_cat, _, split = fused_lstm.prepare_lstm(params)
    assert split.hi.shape == split.lo.shape == (4 * h, e + h)
    assert split.hi.is_contiguous() and split.lo.is_contiguous()
    assert torch.equal(split.hi, tf32.round_tf32(w_cat.t().contiguous()))
    rest = w_cat.t().double() - split.hi.double() - split.lo.double()
    assert bool((rest.abs() <= 2.0 ** -22 * w_cat.t().double().abs()).all())


def test_prepared_head_split_holds_w_transposed():
    rng = np.random.default_rng(4)
    head = {"v": torch.from_numpy(rng.normal(size=(96, 1000)).astype(
                np.float32)),
            "g": torch.from_numpy(rng.uniform(0.5, 2, 1000).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=1000).astype(np.float32))}
    prep = fused_head.prepare_head(head, torch.float32)
    kp, vp = prep.w.shape
    assert prep.split.hi.shape == prep.split.lo.shape == (vp, kp)
    assert prep.split.hi.is_contiguous() and prep.split.lo.is_contiguous()
    wt = prep.w.t().double()
    rest = wt - prep.split.hi.double() - prep.split.lo.double()
    assert bool((rest.abs() <= 2.0 ** -22 * wt.abs()).all())
    # pad columns (and pad rows of K) stay exactly zero in both parts
    assert not bool(prep.split.hi[1000:].any() or prep.split.lo[:, 96:].any())
    assert fused_head.prepare_head(head, torch.bfloat16).split is None


def test_cpu_float32_takes_the_plain_versions_on_the_unsplit_weights():
    """float32 on the CPU would be the tf32x3 route on the card; here the
    wrappers take their plain versions, on the unsplit weights, and count
    no launch.  The plain head agrees with the JAX package's float32 head."""
    rng = np.random.default_rng(5)
    e, h, b = 64, 32, 8
    params = {n: torch.from_numpy(rng.uniform(-0.2, 0.2, s).astype(
        np.float32)) for n, s in (("w_ih", (e, 4 * h)), ("w_hh", (h, 4 * h)),
                                  ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
    wt = fused_lstm.prepare_lstm(params)
    x, hh, c = (torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
                for n in (e, h, h))
    assert fused_lstm.lstm_route(wt.w_cat, x, hh) == "tf32x3"
    head = {"w": rng.normal(size=(h, 600)).astype(np.float32),
            "b": rng.normal(size=600).astype(np.float32)}
    prep = fused_head.prepare_head({n: torch.from_numpy(a)
                                    for n, a in head.items()}, torch.float32)
    xh = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
    assert fused_head.head_route(prep.w, fused_head._prepared(prep, xh)[1]) \
        == "tf32x3"
    counters = (fused_lstm.COUNT, fused_lstm.COUNT_TF32X3, fused_head.COUNT,
                fused_head.COUNT_TF32X3)
    counts = [cn.n for cn in counters]
    got = fused_lstm.lstm_cell_fused(wt.w_cat, wt.b_sum, x, hh, c, wt.split)
    want = fused_lstm.lstm_cell_plain(wt.w_cat, wt.b_sum, x, hh, c)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    got = fused_head.topk_head(prep, xh, 3)
    want = fused_head.topk_head_plain(prep, xh, 3)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert counts == [cn.n for cn in counters]
    import jax.numpy as jnp
    jv, ji, jl = JF.topk_head({n: jnp.asarray(a) for n, a in head.items()},
                              jnp.asarray(xh.numpy()), 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
