"""The int8 serving slice as a whole: AoADetection quantized decode params,
int8 K/V encode, one decoder step and greedy decode in
simpleimagecaptionzoo_tpu_torch against the JAX package, float32, on the same
numpy params and inputs.  The JAX side runs its three Pallas kernels of this
path (K1 with the int8 head, K3, K4) in interpret mode, with
SICZ_TPU_INT8_KV=interpret; the port reads SICZ_TPU_INT8_KV=auto, which
means the same there (ops/dispatch.py).  Greedy ids must be identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import (decode, fused_head,
                                                 fused_lstm, int8_attention,
                                                 quant)

CFG = dict(model_type="AoADetection", vocab_size=61, embed_dim=32,
           hidden_dim=256, enc_dim=24, num_heads=2, num_refine_layers=2,
           max_bu_len=5)
B, N, MAX_LEN = 8, 5, 8
TOL = dict(rtol=1e-5, atol=1e-5)
PATHS = (("lstm",), ("aoa_dec", "q"), ("aoa_dec", "aoa"), ("predict",))


@pytest.fixture(autouse=True)
def _kernels(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")


@pytest.fixture(scope="module")
def setup():
    jm = jax_get(JaxModelConfig(**CFG))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_q = jax.tree_util.tree_map(np.asarray,
                                  jm.quantize_decode_params(jparams))
    tm = get_captioner(ModelConfig(**CFG))
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(B, N, CFG["enc_dim"])).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 3:] = 0                   # some rows padded ('adaptive' boxes)
    mask[5, 1:] = 0
    return jm, tm, np_params, np_q, {"bu_feats": feats, "bu_masks": mask}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_quantized_params_carry_across(setup):
    """The port quantizes the carried float params to the same int8 as the
    JAX package (the head's column norm may move a value by one step)."""
    _, tm, np_params, np_q, _ = setup
    tq = tm.quantize_decode_params(from_jax(np_params))
    assert tm.decode_quant_paths == PATHS
    for path in PATHS:
        got, want = _at(tq, path), _at(np_q, path)
        assert set(got) == {"q", "s", "b"}
        dq = np.abs(got["q"].numpy().astype(np.int32)
                    - want["q"].astype(np.int32))
        assert dq.max() <= (1 if path == ("predict",) else 0), path
        np.testing.assert_allclose(got["s"].numpy(), want["s"], rtol=1e-6,
                                   atol=0, err_msg=str(path))
    assert tq["embed"]["table"].dtype == torch.float32
    assert "w" in from_jax(np_params)["aoa_dec"]["k"]


@pytest.mark.parametrize("switch,key", [("auto", "k_q"), ("interpret", "k_q"),
                                        ("off", "k_proj")])
def test_encode_kv_representation(setup, switch, key, monkeypatch):
    jm, tm, _, np_q, vis = setup
    monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
    tenc, _ = tm.encode(from_jax(np_q), from_jax(vis))
    assert key in tenc.extras and "lstm_cat" not in tenc.extras
    if key == "k_q":
        assert tenc.extras["k_q"].dtype == torch.int8
        assert tenc.extras["k_s"].dtype == torch.float32
        monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")   # JAX needs it
        jenc, _ = jm.encode(_jax_tree(np_q), _jax_tree(vis))
        for name in ("k_q", "v_q"):
            dq = np.abs(tenc.extras[name].numpy().astype(np.int32)
                        - np.asarray(jenc.extras[name]).astype(np.int32))
            assert dq.max() <= 1, name          # float32 K/V in another order
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(tenc.extras[name].numpy(),
                                       np.asarray(jenc.extras[name]), **TOL)


def test_one_step_matches_jax(setup, monkeypatch):
    jm, tm, _, np_q, vis = setup
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    jenc, _ = jm.encode(_jax_tree(np_q), _jax_tree(vis))
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tenc, _ = tm.encode(from_jax(np_q), from_jax(vis))
    # the same int8 K/V on both sides, so the step alone is compared
    tenc = dataclasses.replace(tenc, extras=from_jax(
        jax.tree_util.tree_map(np.asarray, jenc.extras)))
    rng = np.random.default_rng(12)
    state = {k: (0.5 * rng.normal(size=(B, CFG["hidden_dim"]))).astype(
        np.float32) for k in ("h", "m", "ctx")}
    toks = rng.integers(4, CFG["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = jm.step_core(_jax_tree(np_q), jenc, _jax_tree(state),
                                  jnp.asarray(toks))
    tpre, tst, tal = tm.step_core(from_jax(np_q), tenc, from_jax(state),
                                  torch.from_numpy(toks).long())
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    for k in ("h", "m", "ctx"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **TOL)


def _jax_greedy(setup, np_tree):
    jm, _, _, _, vis = setup
    jids, jal = JS.make_greedy_decode(jm, max_len=MAX_LEN,
                                      return_alphas=True)(
        _jax_tree(np_tree), {}, _jax_tree(vis))
    return np.asarray(jids), np.asarray(jal)


@pytest.mark.parametrize("quantized_by", ["jax", "port"])
def test_int8_greedy_matches_jax(setup, quantized_by, monkeypatch):
    """Ids identical to the JAX package's int8 greedy decode, on the JAX
    package's int8 tree carried across and on the port's own quantization
    of the carried float params."""
    _, tm, np_params, np_q, vis = setup
    jids, jal = _jax_greedy(setup, np_q)
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tparams = (from_jax(np_q) if quantized_by == "jax"
               else tm.quantize_decode_params(from_jax(np_params)))
    counts = [c.n for c in (quant.COUNT, int8_attention.COUNT,
                            fused_head.COUNT, fused_lstm.COUNT)]
    tids, tal = TS.make_greedy_decode(tm, max_len=MAX_LEN, return_alphas=True,
                                      device="cpu")(tparams, {},
                                                    from_jax(vis))
    assert tids.shape == (B, MAX_LEN) and tal.shape == (B, MAX_LEN, N)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tal.numpy(), jal, **TOL)
    # on the CPU every wrapper takes its plain version: no launch counted
    assert [c.n for c in (quant.COUNT, int8_attention.COUNT,
                          fused_head.COUNT, fused_lstm.COUNT)] == counts


def test_dequantize_once_branch_equals_dequantized_extras(setup,
                                                          monkeypatch):
    """A query axis K4 does not take (``supported`` forced False after
    encode) dequantizes the int8 K/V once to the query dtype: the ids equal
    a decode over pre-dequantized float extras (the hold of
    tests/test_int8_attention.py::test_aoa_int8_extras_wide_beam_dequant_
    fallback, with greedy)."""
    _, tm, _, np_q, vis = setup
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tq = from_jax(np_q)
    enc, _ = tm.encode(tq, from_jax(vis))
    ex = enc.extras
    assert "k_q" in ex
    deq = {"k_proj": ex["k_q"].float() * ex["k_s"][..., None],
           "v_proj": ex["v_q"].float() * ex["v_s"][..., None]}
    enc_deq = dataclasses.replace(enc, extras=deq)
    ids_kernel, _ = decode.greedy(tm, tq, enc, MAX_LEN)
    monkeypatch.setattr(int8_attention, "supported", lambda *a, **kw: False)
    before = int8_attention.COUNT.n
    ids_once, al_once = decode.greedy(tm, tq, enc, MAX_LEN)
    ids_deq, al_deq = decode.greedy(tm, tq, enc_deq, MAX_LEN)
    np.testing.assert_array_equal(ids_once.numpy(), ids_deq.numpy())
    torch.testing.assert_close(al_once, al_deq, rtol=0, atol=0)
    np.testing.assert_array_equal(ids_once.numpy(), ids_kernel.numpy())
    assert int8_attention.COUNT.n == before


def test_bf16_int8_decode_casts_inputs_and_keeps_int8_types(setup,
                                                            monkeypatch):
    _, tm, _, np_q, vis = setup
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tq = from_jax(np_q)
    cast = TS._cast_floats(tq, torch.bfloat16)
    for path in PATHS:
        layer = _at(cast, path)
        assert layer["q"].dtype == torch.int8, path
        assert layer["s"].dtype == layer["b"].dtype == torch.float32, path
    assert cast["embed"]["table"].dtype == torch.bfloat16
    assert cast["aoa_dec"]["k"]["w"].dtype == torch.bfloat16
    ids = TS.make_greedy_decode(tm, max_len=4, dtype=torch.bfloat16,
                                device="cpu")(tq, {}, from_jax(vis))
    assert ids.shape == (B, 4) and ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < CFG["vocab_size"]
    assert tq["embed"]["table"].dtype == torch.float32      # not in place
