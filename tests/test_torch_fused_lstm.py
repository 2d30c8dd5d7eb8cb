"""K2's plain version (simpleimagecaptionzoo_tpu_torch/ops/fused_lstm.py)
against the JAX package's Pallas cell in interpret mode, at the shapes of
tests/test_pallas_lstm.py, within 1e-5.  The CUDA kernel is held against the
same plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import pallas_lstm
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm

B, H = 16, 128
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(e, seed, zero_c=False):
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(H)
    u = lambda *s: rng.uniform(-bound, bound, size=s).astype(np.float32)
    params = {"w_ih": u(e, 4 * H), "w_hh": u(H, 4 * H), "b_ih": u(4 * H),
              "b_hh": u(4 * H)}
    x = rng.normal(size=(B, e)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = (np.zeros((B, H), np.float32) if zero_c
         else rng.normal(size=(B, H)).astype(np.float32))
    return params, x, h, c


@pytest.mark.parametrize("e,zero_c", [(384, False), (200, True)])
def test_plain_matches_jax_kernel(e, zero_c):
    """E=200 makes K = E + H unaligned (the zero-padding path on the TPU)."""
    params, x, h, c = _inputs(e, seed=e, zero_c=zero_c)
    jh, jc = pallas_lstm.lstm_cell_fused(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x),
        jnp.asarray(h), jnp.asarray(c), interpret=True)
    w_cat, b_sum, split = fused_lstm.prepare_lstm(
        {n: torch.from_numpy(a) for n, a in params.items()})
    assert w_cat.shape == (e + H, 4 * H) and b_sum.shape == (4 * H,)
    assert split.hi.shape == split.lo.shape == (4 * H, e + H)
    th, tc = fused_lstm.lstm_cell_plain(w_cat, b_sum, torch.from_numpy(x),
                                        torch.from_numpy(h),
                                        torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    # the dispatching wrapper takes the plain version for CPU tensors
    before = fused_lstm.COUNT.n
    fh, fc = fused_lstm.lstm_cell_fused(w_cat, b_sum, torch.from_numpy(x),
                                        torch.from_numpy(h),
                                        torch.from_numpy(c), split)
    assert fused_lstm.COUNT.n == before
    torch.testing.assert_close(fh, th, rtol=0, atol=0)
    torch.testing.assert_close(fc, tc, rtol=0, atol=0)


def test_bf16_follows_the_kernel_float32_epilogue():
    """In bf16 the gates and the epilogue stay float32 and only h', c' are
    rounded: the Pallas kernel's semantics, not the jnp fallback's bf16
    gates."""
    params, x, h, c = _inputs(64, seed=7)
    tp = {n: torch.from_numpy(a).to(torch.bfloat16)
          for n, a in params.items()}
    xs = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, h, c)]
    w_cat, b_sum, split = fused_lstm.prepare_lstm(tp)
    assert split is None                  # the TF32 split is float32's alone
    bh, bc = fused_lstm.lstm_cell_plain(w_cat, b_sum, *xs)
    assert bh.dtype == torch.bfloat16 and bc.dtype == torch.bfloat16
    fh, fc = fused_lstm.lstm_cell_plain(w_cat.float(), b_sum.float(),
                                        *[a.float() for a in xs])
    torch.testing.assert_close(bh, fh.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(bc, fc.to(torch.bfloat16), rtol=0, atol=0)
