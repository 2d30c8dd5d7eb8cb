"""Weight-only int8 (simpleimagecaptionzoo_tpu_torch/ops/quant.py, kernel K3's
plain version) against the JAX package's ops/quant.py on the same numpy
weights, float32: the quantizers bit for bit, the product against the JAX
Pallas kernel in interpret mode within 1e-5, and the int8 LSTM cell.  The
CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.models import layers as JL
from simpleimagecaptionzoo_tpu.ops import quant as JQ
from simpleimagecaptionzoo_tpu_torch.models import layers as TL
from simpleimagecaptionzoo_tpu_torch.ops import quant as TQ

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("k,n,bias", [(256, 512, True), (100, 130, True),
                                      (384, 640, False), (7, 3, True)])
def test_quantize_dense_is_bit_identical(k, n, bias):
    p = {"w": _np(k + n, k, n, scale=0.2)}
    if bias:
        p["b"] = _np(k * n, n)
    p["w"][:, 0] = 0.0                      # an all-zero column: scale 1e-8/127
    jq = JQ.quantize_dense(_jax(p))
    tq = TQ.quantize_dense(_torch(p))
    assert tq["q"].dtype == torch.int8 and tq["q"].shape == jq["q"].shape
    assert tq["q"].shape[0] % 128 == 0 and tq["q"].shape[1] % 512 == 0
    assert tq["s"].dtype == tq["b"].dtype == torch.float32
    for name in ("q", "s", "b"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]),
                                      err_msg=name)


def test_round_half_to_even_like_jnp():
    """A weight at exactly half a step rounds to the even int8 value."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32).T
    w = np.concatenate([w, -w], axis=1)
    jq = JQ.quantize_dense({"w": jnp.asarray(w)})
    tq = TQ.quantize_dense({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    assert tq["q"][:6, 0].tolist() == [127, 0, 2, 2, 0, -2]


def test_quantize_lstm_is_bit_identical():
    e, h = 40, 64
    p = {"w_ih": _np(0, e, 4 * h, scale=0.1), "w_hh": _np(1, h, 4 * h, scale=0.1),
         "b_ih": _np(2, 4 * h, scale=0.1), "b_hh": _np(3, 4 * h, scale=0.1)}
    jq = JQ.quantize_lstm(_jax(p))
    tq = TQ.quantize_lstm(_torch(p))
    for name in ("q", "s", "b"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]),
                                      err_msg=name)


def test_quantize_dense_wn_within_one_step():
    """The column norm is a float32 sum taken in another order: q within
    +-1, s within 1e-6 relative."""
    p = {"v": _np(0, 96, 700), "g": np.abs(_np(1, 700)) + 0.5,
         "b": _np(2, 700)}
    jq = JQ.quantize_dense_wn(_jax(p))
    tq = TQ.quantize_dense_wn(_torch(p))
    dq = np.abs(tq["q"].numpy().astype(np.int32)
                - np.asarray(jq["q"]).astype(np.int32))
    assert dq.max() <= 1
    np.testing.assert_allclose(tq["s"].numpy(), np.asarray(jq["s"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tq["b"].numpy(), np.asarray(jq["b"]))


@pytest.mark.parametrize("m,k,n", [(16, 256, 512), (16, 100, 130),
                                   (24, 384, 640)])
def test_quant_matmul_plain_matches_jax_kernel(m, k, n, monkeypatch):
    """Against the JAX Pallas kernel (interpret), aligned and ragged K/N."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")
    p = {"w": _np(k, k, n, scale=0.1), "b": _np(n, n)}
    x = _np(m, m, k)
    jq = JQ.quantize_dense(_jax(p))
    assert JQ.supported(jnp.asarray(x), jq)        # the kernel path runs
    want = np.asarray(JQ.quant_matmul(jnp.asarray(x), jq))
    got = TQ.quant_matmul_plain(torch.from_numpy(x), _torch(jq))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quant_matmul_keeps_leading_axes_and_rounds_once():
    """x (..., K) keeps its leading axes; a bf16 x is summed in float32 and
    rounded to bf16 once, after the scale and the bias."""
    p = {"w": _np(0, 48, 70, scale=0.1), "b": _np(1, 70)}
    tq = TQ.quantize_dense(_torch(p))
    x = torch.from_numpy(_np(2, 2, 3, 48)).to(torch.bfloat16)
    got = TQ.quant_matmul(x, tq)
    assert got.shape == (2, 3, 70) and got.dtype == torch.bfloat16
    exact = (x.float().reshape(6, 48) @ (tq["q"][:48, :70].float())
             * tq["s"] + tq["b"])
    torch.testing.assert_close(got.reshape(6, 70), exact.to(torch.bfloat16),
                               rtol=0, atol=0)


def test_dispatch_takes_plain_version_on_cpu():
    tq = TQ.quantize_dense(_torch({"w": _np(0, 32, 40), "b": _np(1, 40)}))
    x = torch.from_numpy(_np(2, 5, 32))
    before = TQ.COUNT.n
    torch.testing.assert_close(TQ.quant_matmul(x, tq),
                               TQ.quant_matmul_plain(x, tq), rtol=0, atol=0)
    assert TQ.COUNT.n == before            # no kernel launch on the CPU


def test_quantize_tree_does_not_mutate():
    params = {"lstm": _torch({"w_ih": _np(0, 8, 16), "w_hh": _np(1, 4, 16),
                              "b_ih": _np(2, 16), "b_hh": _np(3, 16)}),
              "blk": {"q": _torch({"w": _np(4, 4, 4), "b": _np(5, 4)}),
                      "k": _torch({"w": _np(6, 4, 4)})},
              "head": _torch({"v": _np(7, 4, 9), "g": _np(8, 9) + 2.0,
                              "b": _np(9, 9)})}
    before = {k: v.clone() for k, v in params["lstm"].items()}
    out = TQ.quantize_tree(params, [("lstm",), ("blk", "q"), ("head",)])
    assert set(params["lstm"]) == set(before)
    for k, v in before.items():
        assert torch.equal(params["lstm"][k], v)
    assert "w" in params["blk"]["q"] and "v" in params["head"]
    assert TQ.is_quantized(out["lstm"]) and TQ.is_quantized(out["blk"]["q"])
    assert TQ.is_quantized(out["head"]) and not TQ.is_quantized(out["blk"]["k"])
    assert out["blk"]["k"] is params["blk"]["k"]          # shared, not copied


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_int8_lstm_cell_matches_jax(mode, monkeypatch):
    """The int8 cell (K3 gates, then the gate math) on quantized params
    against JAX's layers.lstm_cell on the same quantized params."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", mode)
    e, h = 40, 128
    p = {"w_ih": _np(0, e, 4 * h, scale=0.1), "w_hh": _np(1, h, 4 * h, scale=0.1),
         "b_ih": _np(2, 4 * h, scale=0.1), "b_hh": _np(3, 4 * h, scale=0.1)}
    jq = JQ.quantize_lstm(_jax(p))
    x, hh, c = _np(4, 16, e), _np(5, 16, h), _np(6, 16, h)
    jh, jc = JL.lstm_cell(jq, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(c))
    th, tc = TL.lstm_cell(_torch(jq), torch.from_numpy(x),
                          torch.from_numpy(hh), torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("layer", ["dense", "dense_wn"])
def test_int8_dense_layers_match_jax(layer, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")
    if layer == "dense":
        jq = JQ.quantize_dense(_jax({"w": _np(0, 64, 96), "b": _np(1, 96)}))
    else:
        jq = JQ.quantize_dense_wn(_jax({"v": _np(0, 64, 96),
                                        "g": _np(1, 96) + 2.0,
                                        "b": _np(2, 96)}))
    x = _np(3, 8, 64)
    want = np.asarray(getattr(JL, layer)(jq, jnp.asarray(x)))
    got = getattr(TL, layer)(_torch(jq), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
