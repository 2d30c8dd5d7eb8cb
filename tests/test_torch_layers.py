"""Port layers (simpleimagecaptionzoo_tpu_torch/models/layers.py) against the
JAX package's on the same numpy inputs, in float32, within 1e-5."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.models import layers as JL
from simpleimagecaptionzoo_tpu_torch.models import layers as TL
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, quant

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def test_dense():
    p = {"w": _np(0, 24, 40), "b": _np(1, 40)}
    x = _np(2, 5, 24)
    jp, tp = _both(p)
    np.testing.assert_allclose(TL.dense(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.dense(jp, jnp.asarray(x))), **TOL)


def test_dense_wn():
    p = {"v": _np(0, 24, 40), "g": np.abs(_np(1, 40)) + 0.5, "b": _np(2, 40)}
    x = _np(3, 5, 24)
    jp, tp = _both(p)
    np.testing.assert_allclose(TL.dense_wn(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.dense_wn(jp, jnp.asarray(x))),
                               **TOL)


def test_embedding():
    p = {"table": _np(0, 30, 8)}
    ids = np.random.default_rng(1).integers(0, 30, size=(4, 6))
    jp, tp = _both(p)
    np.testing.assert_array_equal(
        TL.embedding(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(JL.embedding(jp, jnp.asarray(ids))))


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_lstm_cell(mode, monkeypatch):
    """The JAX cell by its jnp path and by its Pallas kernel (interpret)."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    e, h = 40, 128
    p = {"w_ih": _np(0, e, 4 * h, scale=0.1), "w_hh": _np(1, h, 4 * h, scale=0.1),
         "b_ih": _np(2, 4 * h, scale=0.1), "b_hh": _np(3, 4 * h, scale=0.1)}
    x, hh, c = _np(4, 16, e), _np(5, 16, h), _np(6, 16, h)
    jp, tp = _both(p)
    jh, jc = JL.lstm_cell(jp, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(c))
    th, tc = TL.lstm_cell(tp, torch.from_numpy(x), torch.from_numpy(hh),
                          torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_layer_norm_std():
    p = {"gain": _np(0, 32) + 1.0, "bias": _np(1, 32)}
    x = _np(2, 3, 7, 32, scale=3.0)
    jp, tp = _both(p)
    np.testing.assert_allclose(
        TL.layer_norm_std(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JL.layer_norm_std(jp, jnp.asarray(x))), **TOL)


def test_layer_norm_std_bf16_keeps_dtype():
    p = TL.layer_norm_std_init(16)
    x = torch.from_numpy(_np(0, 4, 16)).to(torch.bfloat16)
    assert TL.layer_norm_std(p, x).dtype == torch.bfloat16


def test_masked_softmax():
    s = _np(0, 4, 9, scale=2.0)
    mask = (np.random.default_rng(1).uniform(size=(4, 9)) > 0.3).astype(
        np.float32)
    mask[:, 0] = 1
    np.testing.assert_allclose(
        TL.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask)).numpy(),
        np.asarray(JL.masked_softmax(jnp.asarray(s), jnp.asarray(mask))),
        **TOL)


def test_dropout_eval_is_identity_and_train_is_inverted():
    x = torch.ones(64, 64)
    assert TL.dropout(x, 0.5, train=False) is x
    g = torch.Generator().manual_seed(0)
    y = TL.dropout(x, 0.25, train=True, generator=g)
    vals = set(torch.unique(y).tolist())
    assert vals <= {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs(float((y != 0).float().mean()) - 0.75) < 0.05


def test_initializer_bounds():
    g = torch.Generator().manual_seed(0)
    d = TL.dense_init(g, 64, 300)
    bound = 1 / math.sqrt(64)
    for t in d.values():
        assert t.dtype == torch.float32
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound        # spans the range
    assert d["w"].shape == (64, 300)
    wn = TL.dense_wn_init(g, 64, 300, zero_bias=True)
    torch.testing.assert_close(wn["g"], torch.linalg.vector_norm(wn["v"],
                                                                 dim=0))
    assert float(wn["b"].abs().max()) == 0.0
    lstm = TL.lstm_cell_init(g, 48, 32)
    assert lstm["w_ih"].shape == (48, 128) and lstm["w_hh"].shape == (32, 128)
    for t in lstm.values():
        assert float(t.abs().max()) <= 1 / math.sqrt(32)
    emb = TL.embedding_init(g, 100, 16, scale=0.1)["table"]
    assert float(emb.abs().max()) <= 0.1
    normal = TL.embedding_init(g, 200, 64)["table"]
    assert abs(float(normal.std()) - 1.0) < 0.05


def test_int8_params_raise():
    """Int8 layer dicts dispatch to K3 (its plain version on the CPU) and to
    K1's int8 case; only a dict that is no layer raises, and so does an x
    wider than q."""
    rng = np.random.default_rng(0)
    q = {"q": torch.from_numpy(rng.integers(-127, 128, (128, 512)).astype(
             np.int8)),
         "s": torch.from_numpy(rng.uniform(0.01, 0.02, 8).astype(np.float32)),
         "b": torch.from_numpy(_np(1, 8))}
    x = torch.from_numpy(_np(2, 2, 8))
    want = (x @ (q["q"][:8, :8].float() * q["s"])) + q["b"]
    torch.testing.assert_close(TL.dense(q, x), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(TL.dense_wn(q, x), want, rtol=1e-6, atol=1e-6)
    h, c = TL.lstm_cell(q, x[:, :4], x[:, 4:6], x[:, 6:])   # 4 gates of 2
    assert h.shape == c.shape == (2, 2)
    assert fused_head.prepare_head(q, torch.float32).w.dtype == torch.int8
    with pytest.raises(ValueError, match="not a quantizable"):
        quant.quantize_tree({"layer": {"table": x}}, [("layer",)])
    with pytest.raises(ValueError, match="q only 128 rows"):
        TL.dense(q, torch.zeros((2, 200)))
