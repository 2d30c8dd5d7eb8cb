"""The 2xTF32 scheme of K3's and K1-int8's float32 "tf32x2" routes, on the CPU.

With an int8 weight q the float32 product needs only two TF32 products,
x_lo q + x_hi q: every int8 value is exact in TF32, so q_lo = 0.  The
kernels (csrc/quant_matmul.cu, csrc/fused_head.cu, hopper.cuh's tf32x2)
widen q to float32 in shared memory with a float trick, split x in
registers (cvt.rna.tf32.f32, whose rounding ops/tf32.round_tf32
reproduces) and sum each 32-value stage in a fresh accumulator added into
the float32 result.  Here: q's exactness, the widening's arithmetic, and a
numpy emulation of the kernels' sums, which meets K3's and K1's float32
holds where one TF32 product does not.  The route rule and the wrappers'
plain versions on CPU tensors are held against the JAX package's Pallas
kernels in interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import fused_head as JF
from simpleimagecaptionzoo_tpu.ops import quant as JQ
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, quant, tf32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_every_int8_value_is_exact_in_tf32():
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).float()
    assert torch.equal(tf32.round_tf32(q), q)
    hi, lo = tf32.split_tf32(q)
    assert torch.equal(hi, q) and not bool(lo.any())


def test_the_widening_float_trick_is_exact():
    """widen4_f32: the float with bits 0x4B000000 | (q + 128) is 2^23 + q +
    128; subtracting 8388736 (2^23 + 128) in float32 leaves q."""
    q = np.arange(-128, 128, dtype=np.int32)
    bits = (np.uint32(0x4B000000) | ((q + 128) & 0xFF).astype(np.uint32))
    widened = bits.view(np.float32) - np.float32(8388736.0)
    assert widened.dtype == np.float32
    np.testing.assert_array_equal(widened, q.astype(np.float32))


def _tf32(a):
    return tf32.round_tf32(torch.from_numpy(np.ascontiguousarray(
        a, np.float32))).numpy()


def _emulate(x, q, two):
    """x (m, K) float32 @ q (K, n) as the kernels sum it: per k8 step the
    exact products (float64 holds a product of an 11-bit and a 7-bit
    mantissa exactly) summed and added into the stage's float32 partial,
    fresh every 32 values of K, which is then added into the float32
    result.  two=True takes 2xTF32's products in the kernels' order (x_lo
    q, then x_hi q), two=False one TF32 product (x_hi q)."""
    xh = _tf32(x)
    xl = _tf32(x - xh)
    qf = q.astype(np.float64)
    terms = [xl, xh] if two else [xh]
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for s0 in range(0, x.shape[1], 32):
        part = np.zeros_like(acc)
        for k0 in range(s0, min(s0 + 32, x.shape[1]), 8):
            for a in terms:
                step = a[:, k0:k0 + 8].astype(np.float64) @ qf[k0:k0 + 8]
                part = (part.astype(np.float64) + step).astype(np.float32)
        acc = acc + part
    return acc


def _quantized(rng, k, n):
    """quant._quantize of weights U(+-1/sqrt(k)), as numpy: q (k, n) int8,
    s and b (n,) float32."""
    bound = 1 / np.sqrt(k)
    w = torch.from_numpy(rng.uniform(-bound, bound, (k, n)).astype(
        np.float32))
    b = torch.from_numpy(rng.uniform(-bound, bound, n).astype(np.float32))
    qp = quant._quantize(w, b)
    return qp["q"][:k, :n].numpy(), qp["s"].numpy(), qp["b"].numpy()


@pytest.mark.parametrize("two,holds", [(True, True), (False, False)])
def test_emulated_k3_products_meet_the_float32_hold(two, holds):
    """K3's hold (within 1e-5 of the sum of |x q s|, plus 1e-6) against the
    float64 product, x N(0, 1): 2xTF32 meets it, one TF32 product does
    not."""
    rng = np.random.default_rng(21)
    m, k, n = 16, 192, 96
    q, s, b = _quantized(rng, k, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    got = _emulate(x, q, two) * s + b
    want = x.astype(np.float64) @ (q.astype(np.float64) * s) + b
    lim = 1e-5 * (np.abs(x).astype(np.float64) @ (np.abs(q) * s)) + 1e-6
    assert bool(np.all(np.abs(got - want) <= lim)) == holds


@pytest.mark.parametrize("two,holds", [(True, True), (False, False)])
def test_emulated_head_products_meet_the_float32_hold(two, holds):
    """K1-int8's hold (top-3 values and lse within 1e-4, ids exact where
    the float64 logits leave a gap above 1e-3 on both sides) at a small
    int8 head, x N(0, 1): 2xTF32 meets it, one TF32 product does not."""
    rng = np.random.default_rng(23)
    m, k, v = 16, 512, 640
    q, s, b = _quantized(rng, k, v)
    x = rng.normal(size=(m, k)).astype(np.float32)
    want = x.astype(np.float64) @ (q.astype(np.float64) * s) + b
    got = (_emulate(x, q, two) * s + b).astype(np.float64)

    def summary(logits):
        mx = logits.max(1)
        lse = np.log(np.exp(logits - mx[:, None]).sum(1)) + mx
        order = np.argsort(-logits, axis=1, kind="stable")[:, :4]
        return np.take_along_axis(logits, order, 1), order, lse

    rv, ri, rl = summary(want)
    gv, gi, gl = summary(got)
    gaps = rv[:, :-1] - rv[:, 1:]
    lo = np.concatenate([np.full((m, 1), np.inf), gaps[:, :2]], axis=1)
    sure = (gaps[:, :3] > 1e-3) & (lo > 1e-3)
    ok = (np.abs(gv[:, :3] - rv[:, :3]).max() <= 1e-4
          and np.abs(gl - rl).max() <= 1e-4
          and not np.any((gi[:, :3] != ri[:, :3]) & sure))
    assert ok == holds


@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (37, 200, 700)])
def test_cpu_float32_k3_takes_the_plain_version(m, k, n, monkeypatch):
    """float32 x with an int8 layer would be the tf32x2 route on the card;
    here the wrapper takes its plain version and counts no launch, and
    agrees with the JAX package's Pallas kernel (interpret) within K3's
    float32 hold."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")
    rng = np.random.default_rng(m + k)
    w = rng.uniform(-0.1, 0.1, (k, n)).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qp = quant.quantize_dense({"w": torch.from_numpy(w),
                               "b": torch.from_numpy(bias)})
    xt = torch.from_numpy(x)
    assert quant.quant_route(xt, qp["q"]) == "tf32x2"
    counts = quant.COUNT.n, quant.COUNT_TF32X2.n
    got = quant.quant_matmul(xt, qp)
    assert (quant.COUNT.n, quant.COUNT_TF32X2.n) == counts
    assert torch.equal(got, quant.quant_matmul_plain(xt, qp))
    want = np.asarray(JQ.quant_matmul(
        jnp.asarray(x), JQ.quantize_dense({"w": jnp.asarray(w),
                                           "b": jnp.asarray(bias)})))
    lim = 1e-5 * (np.abs(x) @ (np.abs(qp["q"][:k, :n].numpy())
                               * qp["s"].numpy())) + 1e-6
    assert bool(np.all(np.abs(got.numpy() - want) <= lim))


@pytest.mark.parametrize("k", [1, 3])
def test_cpu_float32_int8_head_takes_the_plain_version(k, monkeypatch):
    """float32 x with an int8 head would be the tf32x2 route on the card;
    here topk_head takes its plain version and counts no launch, and
    agrees with the JAX package's fused head (interpret): ids identical,
    values and lse within 1e-5."""
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    rng = np.random.default_rng(31 + k)
    hdim, v = 96, 1000
    head = {"v": rng.normal(size=(hdim, v)).astype(np.float32),
            "g": rng.uniform(0.5, 2.0, v).astype(np.float32),
            "b": rng.normal(size=v).astype(np.float32)}
    x = rng.normal(size=(8, hdim)).astype(np.float32)
    qhead = quant.quantize_dense_wn({n: torch.from_numpy(a)
                                     for n, a in head.items()})
    prep = fused_head.prepare_head(qhead, torch.float32)
    xt = torch.from_numpy(x)
    assert fused_head.head_route(prep.w, fused_head._prepared(prep, xt)[1]) \
        == "tf32x2"
    counts = fused_head.COUNT.n, fused_head.COUNT_TF32X2.n
    got = fused_head.topk_head(prep, xt, k)
    assert (fused_head.COUNT.n, fused_head.COUNT_TF32X2.n) == counts
    want = fused_head.topk_head_plain(prep, xt, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jq = {n: jnp.asarray(a.numpy()) for n, a in qhead.items()}
    jv, ji, jl = JF.topk_head(jq, jnp.asarray(x), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)

