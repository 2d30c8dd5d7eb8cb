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

from simpleimagecaptionzoo_tpu_torch.ops import fused_head, fused_lstm

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,h", [(16, 384, 128), (16, 200, 128),
                                   (37, 70, 96)])
def test_lstm_kernel_matches_plain(dev, dtype, b, e, h):
    """Aligned, unaligned K (E=200) and ragged B, E, H."""
    rng = np.random.default_rng(b + e + h)
    bound = 1 / np.sqrt(h)
    w = _t(rng.uniform(-bound, bound, (e + h, 4 * h)), dev, dtype)
    bias = _t(rng.uniform(-bound, bound, 4 * h), dev, dtype)
    x, hh, c = (_t(rng.normal(size=(b, n)), dev, dtype)
                for n in (e, h, h))
    before = fused_lstm.COUNT.n
    kh, kc = fused_lstm.lstm_cell_fused(w, bias, x, hh, c)
    torch.cuda.synchronize()
    assert fused_lstm.COUNT.n == before + 1
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
    before = fused_head.COUNT.n
    kv, ki, kl = fused_head.topk_head(prep, x, k)
    torch.cuda.synchronize()
    assert fused_head.COUNT.n == before + 1
    pv, pi, pl = fused_head.topk_head_plain(prep, x, k)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(kv, pv, rtol=0, atol=tol)
    torch.testing.assert_close(kl, pl, rtol=0, atol=tol)
    assert torch.equal(ki, pi)


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
