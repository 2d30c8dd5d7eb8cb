"""Int8 K/V attention (simpleimagecaptionzoo_tpu_torch/ops/int8_attention.py,
kernel K4's plain version) against the JAX package's ops/int8_attention.py:
the row quantizer bit for bit, the attention against the JAX Pallas kernel
in interpret mode on the fixture of tests/test_int8_attention.py (D=256, 2
heads, dh 128) within 2e-5 (out) and 2e-6 (mean-head p), and the gates
switch by switch.  The CUDA kernel is held against the same plain version on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import int8_attention as JA
from simpleimagecaptionzoo_tpu_torch.ops import int8_attention as TA

B, N, D, H = 8, 5, 256, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_quantize_rows_is_bit_identical():
    x = np.random.default_rng(0).normal(size=(4, 7, 64)).astype(np.float32)
    x[1, 2] = 0.0                                    # an all-zero row
    x[3, 0, :3] = [0.5, 1.5, -2.5]                   # (scaled) half steps
    jq, js = JA.quantize_rows(jnp.asarray(x))
    tq, ts = TA.quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[1, 2] == 0).all()


def _inputs(k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, k, D)).astype(np.float32)
    kv = rng.normal(size=(B, N, D)).astype(np.float32)
    vv = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 3:] = 0.0
    mask[2, 4:] = 0.0
    kq, ks = JA.quantize_rows(jnp.asarray(kv))
    vq, vs = JA.quantize_rows(jnp.asarray(vv))
    return [q] + [np.array(a) for a in (kq, ks, vq, vs)] + [mask]


@pytest.mark.parametrize("k", [1, 3])
def test_plain_matches_jax_kernel(k, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    args = _inputs(k)
    assert JA.supported(B, k, N, D, H)               # the Pallas kernel runs
    jout, jp = JA.lanes_attention_int8(*map(jnp.asarray, args), H)
    tout, tp = TA.lanes_attention_int8_plain(*map(torch.from_numpy, args), H)
    assert tout.shape == (B, k, D) and tp.shape == (B, k, N)
    assert tp.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-6)
    assert (tp.numpy()[0, :, 3:] == 0.0).all()       # masked rows: exactly 0
    assert (tp.numpy()[2, :, 4:] == 0.0).all()


def test_no_mask_and_bf16_query(monkeypatch):
    """mask=None attends over every row; a bf16 q gives a bf16 out and a
    float32 mean-head p."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    q, kq, ks, vq, vs, _ = _inputs(1, seed=1)
    jout, jp = JA.lanes_attention_int8(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                       None, H)
    tout, tp = TA.lanes_attention_int8_plain(
        *map(torch.from_numpy, (q, kq, ks, vq, vs)), None, H)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-6)
    bout, bp = TA.lanes_attention_int8(
        torch.from_numpy(q).to(torch.bfloat16),
        *map(torch.from_numpy, (kq, ks, vq, vs)), None, H)
    assert bout.dtype == torch.bfloat16 and bp.dtype == torch.float32


def test_dispatch_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(3, seed=2)]
    before = TA.COUNT.n
    got = TA.lanes_attention_int8(*args, H)
    want = TA.lanes_attention_int8_plain(*args, H)
    assert TA.COUNT.n == before            # no kernel launch on the CPU
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SHAPES = [(B, 1, N, D, H), (B, 3, N, D, H), (B, 4, N, D, H),
          (384, 1, 36, 1024, 8), (B, 1, N, 192, 2), (B, 1, N, 256, 3),
          (B, 1, 2048, D, H), (B, 1, 2049, D, H), (B, 1, N, D, 0)]


@pytest.mark.parametrize("switch", ["off", "0", "false", "interpret", "auto",
                                    None])
def test_gates_decide_as_jax(switch, monkeypatch):
    """``supported`` decides as the JAX package's for every switch.  Encode's
    decision does too, except that the JAX package's ``auto`` also needs a
    TPU: the port's ``auto`` decides as the JAX package's ``auto`` on its
    TPU, which is its ``interpret`` here (ops/dispatch.py)."""
    if switch is None:
        monkeypatch.delenv("SICZ_TPU_INT8_KV", raising=False)
    else:
        monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
    for b, k, n, d, heads in SHAPES:
        assert TA.supported(b, k, n, d, heads) == JA.supported(
            b, k, n, d, heads), (switch, b, k, n, d, heads)
    if switch == "auto":
        monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
        want = [JA.encode_should_quantize(b, n, d, heads)
                for b, _, n, d, heads in SHAPES]
        monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    else:
        want = [JA.encode_should_quantize(b, n, d, heads)
                for b, _, n, d, heads in SHAPES]
    got = [TA.encode_should_quantize(b, n, d, heads)
           for b, _, n, d, heads in SHAPES]
    assert got == want, switch
    assert any(got) == (switch in ("interpret", "auto"))


def test_unknown_switch_warns_once_and_stays_off(monkeypatch):
    from simpleimagecaptionzoo_tpu_torch.ops import dispatch
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "sometimes")
    monkeypatch.setattr(dispatch, "_WARNED", set())
    with pytest.warns(UserWarning, match="not recognized"):
        assert not TA.encode_should_quantize(B, N, D, H)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not TA.supported(B, 1, N, D, H)
