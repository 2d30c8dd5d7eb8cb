"""K1's plain version (simpleimagecaptionzoo_tpu_torch/ops/fused_head.py)
against the JAX package's fused head, whose Pallas kernel runs in interpret
mode: ids exact, values and logsumexp within 1e-5.  The CUDA kernel is held
against the same plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import fused_head as JF
from simpleimagecaptionzoo_tpu.ops import quant as JQ
from simpleimagecaptionzoo_tpu_torch.ops import fused_head as TF

H, V, M = 64, 1000, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _head(seed=0):
    rng = np.random.default_rng(seed)
    return {"v": rng.normal(size=(H, V)).astype(np.float32),
            "g": rng.uniform(0.5, 2.0, V).astype(np.float32),
            "b": rng.normal(size=V).astype(np.float32)}


def _run_both(head, x, k):
    jv, ji, jl = JF.topk_head({n: jnp.asarray(a) for n, a in head.items()},
                              jnp.asarray(x), k)
    tv, ti, tl = TF.topk_head_plain(
        {n: torch.from_numpy(a) for n, a in head.items()},
        torch.from_numpy(x), k)
    return (np.asarray(jv), np.asarray(ji), np.asarray(jl),
            tv.numpy(), ti.numpy(), tl.numpy())


@pytest.mark.parametrize("k", [1, 3, 16])
def test_plain_matches_jax_kernel(k, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    head = _head()
    x = np.random.default_rng(1).normal(size=(M, H)).astype(np.float32)
    assert JF.enabled({n: jnp.asarray(a) for n, a in head.items()}, M, k,
                      jnp.float32)
    jv, ji, jl, tv, ti, tl = _run_both(head, x, k)
    assert ti.dtype == np.int32 and ti.shape == (M, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_int8_head_matches_jax_kernel(k, monkeypatch):
    """K1's int8-weight case: the JAX package's int8 head (ops/quant.py)
    through its Pallas kernel and through the port's plain version."""
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    qhead = {n: np.array(a) for n, a in JQ.quantize_dense_wn(
        {n: jnp.asarray(a) for n, a in _head(6).items()}).items()}
    x = np.random.default_rng(7).normal(size=(M, H)).astype(np.float32)
    assert JF.enabled({n: jnp.asarray(a) for n, a in qhead.items()}, M, k,
                      jnp.float32)
    jv, ji, jl, tv, ti, tl = _run_both(qhead, x, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    prep = TF.prepare_head({n: torch.from_numpy(a) for n, a in qhead.items()},
                           torch.bfloat16)
    assert prep.w.dtype == torch.int8 and prep.v == V
    assert float(prep.s[V:].abs().max()) == 0.0
    assert float(prep.b[V:].max()) == float(np.float32(-1e30))


def test_dispatch_takes_plain_version_on_cpu(monkeypatch):
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    head = {n: torch.from_numpy(a) for n, a in _head().items()}
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(M, H)).astype(np.float32))
    before = TF.COUNT.n
    got = TF.topk_head(head, x, 3)
    want = TF.topk_head_plain(head, x, 3)
    assert TF.COUNT.n == before            # no kernel launch on the CPU
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tie_resolution_matches_lax_top_k(monkeypatch):
    """Equal winning values in two vocab tiles resolve to the smaller id,
    like lax.top_k (the case of tests/test_fused_head.py)."""
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    v = 2 * JF.V_TILE
    w = np.zeros((8, v), np.float32)
    w[:, 7] = 3.0
    w[:, JF.V_TILE + 11] = 3.0
    w[:, 100] = 1.0
    x = np.eye(8, dtype=np.float32)
    jv, ji, jl, tv, ti, tl = _run_both({"w": w}, x, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[:, :2], np.tile([7, JF.V_TILE + 11],
                                                     (8, 1)))
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("m", [3, 13])
def test_rows_not_a_multiple_of_eight(m, monkeypatch):
    """The TPU kernel's m % 8 gate is the TPU's own; the JAX side falls back
    to its jnp path here, and the port takes any m."""
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    head = _head(4)
    x = np.random.default_rng(5).normal(size=(m, H)).astype(np.float32)
    jv, ji, jl, tv, ti, tl = _run_both(head, x, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_prepare_head_pads_and_masks():
    head = {n: torch.from_numpy(a) for n, a in _head().items()}
    prep = TF.prepare_head(head, torch.bfloat16)
    assert prep.w.shape == (128, 1024) and prep.w.dtype == torch.bfloat16
    assert prep.v == V
    assert float(prep.s[V:].abs().max()) == 0.0
    assert float(prep.b[V:].max()) == float(np.float32(-1e30))
    assert float(prep.w[H:].abs().max()) == 0.0
