"""The int8 serving beam decode: AoADetection beam-3 decode over the
quantized decode params with int8 K/V, in simpleimagecaptionzoo_tpu_torch
against the JAX package, float32, on the config and fixture of
tests/test_torch_aoa_int8_greedy.py (hidden 256, 2 heads: dh = 128, which
K4 takes).  The JAX side runs K1 with the int8 head, K3 and K4 in interpret
mode (SICZ_TPU_INT8_KV=interpret); the port reads SICZ_TPU_INT8_KV=auto,
which means the same there.  Ids must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu_torch import END_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                 int8_attention, quant)

CFG = dict(model_type="AoADetection", vocab_size=61, embed_dim=32,
           hidden_dim=256, enc_dim=24, num_heads=2, num_refine_layers=2,
           max_bu_len=5)
B, N, STEPS = 8, 5, 8
# float32 on both sides, sums in other orders (the int8 greedy holds')
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _ending(tm, np_q, vis):
    """np_q with the int8 head's ``<end>`` bias raised to the midpoint of
    the two middle first-step margins: beams end at every step."""
    q = jax.tree_util.tree_map(np.copy, np_q)
    tq = from_jax(q)
    enc, _ = tm.encode(tq, from_jax(vis))
    with torch.no_grad():
        tok = torch.full((B,), STA_ID, dtype=torch.long)
        hidden, _, _ = tm.step_core(tq, enc, tm.init_state(tq, enc), tok)
        logits = fused_head.logits_plain(
            fused_head.prepare_head(tq["predict"], torch.float32),
            hidden)[:, :CFG["vocab_size"]]
    margin = np.sort((logits.max(dim=1).values - logits[:, END_ID]).numpy())
    q["predict"]["b"][END_ID] += 0.5 * (margin[B // 2 - 1] + margin[B // 2])
    return q


@pytest.mark.parametrize("ending", [False, True])
@pytest.mark.parametrize("quantized_by", ["jax", "port"])
def test_int8_beam3_matches_jax(setup, quantized_by, ending, monkeypatch):
    """Beam-3 ids identical to the JAX package's int8 beam decode (and its
    alphas within 1e-5), on the JAX package's int8 tree carried across and
    on the port's own quantization of the carried float params; on the
    random params and on params whose ``<end>`` bias ends beams at every
    step.  The port's step runs K4 with 3 query rows, never the
    dequantizing fallback, and no wrapper launches on the CPU."""
    jm, tm, np_params, np_q, vis = setup
    if quantized_by == "port":
        np_q = jax.tree_util.tree_map(
            lambda t: t.numpy(), tm.quantize_decode_params(from_jax(
                np_params)))
    if ending:
        np_q = _ending(tm, np_q, vis)
    jids, jal = JS.make_beam_decode(jm, beam_size=3, max_steps=STEPS,
                                    return_alphas=True)(
        jax.tree_util.tree_map(jnp.asarray, np_q), {},
        jax.tree_util.tree_map(jnp.asarray, vis))
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    shapes = []
    plain = int8_attention.lanes_attention_int8_plain
    monkeypatch.setattr(int8_attention, "lanes_attention_int8_plain",
                        lambda q, *a: shapes.append(tuple(q.shape))
                        or plain(q, *a))
    counts = [c.n for c in (quant.COUNT, int8_attention.COUNT,
                            fused_head.COUNT, fused_lstm.COUNT)]
    tids, tal = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS,
                                    return_alphas=True, device="cpu")(
        from_jax(np_q), {}, from_jax(vis))
    assert tids.shape == (B, STEPS + 1) and tal.shape == (B, STEPS, N)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    assert shapes and set(shapes) == {(B, 3, CFG["hidden_dim"])}
    assert [c.n for c in (quant.COUNT, int8_attention.COUNT,
                          fused_head.COUNT, fused_lstm.COUNT)] == counts
    if ending:
        assert (tids[:, 1:] == END_ID).any(dim=1).sum() >= B // 4


def test_bf16_int8_beam_decode_runs(setup, monkeypatch):
    """The int8 serving beam decode as served: bf16 activations over the
    int8 hot set, int8 K/V; ids in range, ``<sta>`` first."""
    _, tm, _, np_q, vis = setup
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    ids = TS.make_beam_decode(tm, beam_size=3, max_steps=4,
                              dtype=torch.bfloat16, device="cpu")(
        from_jax(np_q), {}, from_jax(vis))
    assert ids.shape == (B, 5) and ids.dtype == torch.long
    assert (ids[:, 0] == STA_ID).all()
    assert int(ids.min()) >= 0 and int(ids.max()) < CFG["vocab_size"]
