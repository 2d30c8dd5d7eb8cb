"""The int8 serving form of BUTDDetection and BUTDSpatial: quantized decode
params, one decoder step, greedy and beam-3 decode in
simpleimagecaptionzoo_tpu_torch against the JAX package, float32, on the
same numpy params and inputs (the config of tests/test_torch_butd_greedy.py).
Both cells, ``att_dec`` and the head are weight-only int8; the JAX side runs
K3 and K1's int8 case in interpret mode.  BUTD has no K/V, so
``SICZ_TPU_INT8_KV`` changes nothing.  Ids must be identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import quant as jax_quant
from simpleimagecaptionzoo_tpu_torch import END_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                 int8_attention, quant)

FAMILIES = ("BUTDDetection", "BUTDSpatial")
DIMS = dict(vocab_size=50, embed_dim=64, hidden_dim=128, atten_dim=32,
            enc_dim=48, enc_img_size=3)
B, N_BOX, STEPS = 8, 5, 8
N_OF = {"BUTDDetection": N_BOX, "BUTDSpatial": 9}
TOL = dict(rtol=1e-5, atol=1e-5)
PATHS = (("lstm_td",), ("lstm_lang",), ("att_dec",), ("predict",))


def _visual(family, b, seed=11):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, N_OF[family], DIMS["enc_dim"])).astype(
        np.float32)
    if family == "BUTDSpatial":
        return {"spatial_feats": feats}
    mask = np.ones((b, N_BOX), np.float32)
    mask[0, 3:] = 0                  # ragged boxes ('adaptive' features)
    mask[5 % b, 1:] = 0
    mask[b - 1, 4:] = 0
    return {"bu_feats": feats, "bu_masks": mask}


@pytest.fixture(autouse=True)
def _kernels(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    family = request.param
    cfg = dict(DIMS, model_type=family)
    jm = jax_get(JaxModelConfig(**cfg))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_q = jax.tree_util.tree_map(np.asarray,
                                  jm.quantize_decode_params(jparams))
    tm = get_captioner(ModelConfig(**cfg))
    return family, jm, tm, np_params, np_q, _visual(family, B)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _counts():
    return [c.n for c in (quant.COUNT, int8_attention.COUNT,
                          fused_head.COUNT, fused_lstm.COUNT)]


def test_quantized_params_carry_across(setup):
    """The port quantizes the carried float params to the same int8 as the
    JAX package (the weight-norm layers' column norm may move a value by
    one step): both cells at K = embed + enc + 2 hidden and enc + 2 hidden,
    ``att_dec``, the head; ``att_affine`` stays float."""
    _, jm, tm, np_params, np_q, _ = setup
    tq = tm.quantize_decode_params(from_jax(np_params))
    assert tm.decode_quant_paths == jm.decode_quant_paths == PATHS
    for path in PATHS:
        got, want = _at(tq, path), _at(np_q, path)
        assert set(got) == {"q", "s", "b"}
        assert tuple(got["q"].shape) == want["q"].shape
        dq = np.abs(got["q"].numpy().astype(np.int32)
                    - want["q"].astype(np.int32))
        assert dq.max() <= (0 if path[0].startswith("lstm") else 1), path
        np.testing.assert_allclose(got["s"].numpy(), want["s"], rtol=1e-6,
                                   atol=0, err_msg=str(path))
    d, e, h = DIMS["embed_dim"], DIMS["enc_dim"], DIMS["hidden_dim"]
    assert tq["lstm_td"]["q"].shape[0] >= d + e + 2 * h
    assert "v" in tq["att_affine"] and "v" in tq["att_enc"]


def test_one_step_matches_jax(setup):
    """One int8 step on the same state and tokens: both cells take the int8
    branch (K3 over [x, h], gate math in x's dtype; K2 never runs)."""
    _, jm, tm, _, np_q, vis = setup
    jenc, _ = jm.encode(_jax_tree(np_q), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(np_q), from_jax(vis))
    assert set(tenc.extras) == {"att_keys"}
    rng = np.random.default_rng(12)
    state = {k: (0.5 * rng.normal(size=(B, DIMS["hidden_dim"]))).astype(
        np.float32) for k in ("h1", "c1", "h2", "c2")}
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = jm.step_core(_jax_tree(np_q), jenc, _jax_tree(state),
                                  jnp.asarray(toks))
    tpre, tst, tal = tm.step_core(from_jax(np_q), tenc, from_jax(state),
                                  torch.from_numpy(toks).long())
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=1e-6,
                               atol=1e-6)
    for k in ("h1", "c1", "h2", "c2"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **TOL)


def _spy(monkeypatch):
    """Records the K of every K3 call of the port and counts the JAX
    package's Pallas K3 traces; K2 must not be called."""
    ks, jax_calls = [], []
    plain = quant.quant_matmul_plain
    monkeypatch.setattr(quant, "quant_matmul_plain",
                        lambda x, qp: ks.append(x.shape[-1]) or plain(x, qp))
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused", None)
    jfn = jax_quant._matmul_pallas
    monkeypatch.setattr(jax_quant, "_matmul_pallas",
                        lambda *a, **kw: jax_calls.append(1) or jfn(*a, **kw))
    return ks, jax_calls


@pytest.mark.parametrize("quantized_by", ["jax", "port"])
def test_int8_greedy_matches_jax(setup, quantized_by, monkeypatch):
    """Ids identical to the JAX package's int8 greedy decode (its K3 and
    K1-int8 in interpret mode), on its int8 tree carried across and on the
    port's own quantization of the carried float params.  Each step calls
    K3 three times (the two cells' [x, h], att_dec's h1) and never K2; the
    CPU launches nothing."""
    _, jm, tm, np_params, np_q, vis = setup
    ks, jax_calls = _spy(monkeypatch)
    jids, jal = JS.make_greedy_decode(jm, max_len=STEPS, return_alphas=True)(
        _jax_tree(np_q), {}, _jax_tree(vis))
    assert jax_calls
    tparams = (from_jax(np_q) if quantized_by == "jax"
               else tm.quantize_decode_params(from_jax(np_params)))
    counts = _counts()
    tids, tal = TS.make_greedy_decode(tm, max_len=STEPS, return_alphas=True,
                                      device="cpu")(tparams, {},
                                                    from_jax(vis))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    d, e, h = DIMS["embed_dim"], DIMS["enc_dim"], DIMS["hidden_dim"]
    assert ks and len(ks) % 3 == 0
    assert ks[:3] == [d + e + 2 * h, h, e + 2 * h]
    assert _counts() == counts


@pytest.mark.parametrize("ending", [False, True])
def test_int8_beam3_matches_jax(setup, ending, monkeypatch):
    """Beam-3 ids identical to the JAX package's int8 beam decode, on the
    random params and on params whose int8 head's ``<end>`` bias ends beams
    at every step; K3 runs over B*3 rows and K2 never."""
    _, jm, tm, _, np_q, vis = setup
    if ending:
        q = jax.tree_util.tree_map(np.copy, np_q)
        tq = from_jax(q)
        enc, _ = tm.encode(tq, from_jax(vis))
        with torch.no_grad():
            tok = torch.full((B,), STA_ID, dtype=torch.long)
            hidden, _, _ = tm.step_core(tq, enc, tm.init_state(tq, enc), tok)
            logits = fused_head.logits_plain(
                fused_head.prepare_head(tq["predict"], torch.float32),
                hidden)[:, :DIMS["vocab_size"]]
        margin = np.sort((logits.max(dim=1).values
                          - logits[:, END_ID]).numpy())
        q["predict"]["b"][END_ID] += 0.5 * (margin[B // 2 - 1]
                                            + margin[B // 2])
        np_q = q
    rows = []
    plain = quant.quant_matmul_plain
    monkeypatch.setattr(quant, "quant_matmul_plain",
                        lambda x, qp: rows.append(x.reshape(
                            -1, x.shape[-1]).shape[0]) or plain(x, qp))
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused", None)
    jids, jal = JS.make_beam_decode(jm, beam_size=3, max_steps=STEPS,
                                    return_alphas=True)(
        _jax_tree(np_q), {}, _jax_tree(vis))
    tids, tal = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS,
                                    return_alphas=True, device="cpu")(
        from_jax(np_q), {}, from_jax(vis))
    assert tids.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    assert set(rows) == {B * 3}
    if ending:
        assert (tids[:, 1:] == END_ID).any(dim=1).sum() >= B // 4


@pytest.mark.parametrize("switch", ["off", "auto", "interpret"])
def test_int8_kv_switch_changes_nothing(setup, switch, monkeypatch):
    """``SICZ_TPU_INT8_KV`` is AoA's switch: BUTD's encode stores the same
    float attention keys and the decode gives the same ids whatever it
    says, and K4 is never called."""
    _, _, tm, _, np_q, vis = setup
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "off")
    ref = TS.make_beam_decode(tm, beam_size=3, max_steps=4, device="cpu")(
        from_jax(np_q), {}, from_jax(vis))
    monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
    enc, _ = tm.encode(from_jax(np_q), from_jax(vis))
    assert set(enc.extras) == {"att_keys"}
    assert enc.extras["att_keys"].dtype == torch.float32
    ids = TS.make_beam_decode(tm, beam_size=3, max_steps=4, device="cpu")(
        from_jax(np_q), {}, from_jax(vis))
    assert torch.equal(ids, ref)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_bf16_int8_decode_casts_inputs_and_keeps_int8_types(setup, decode):
    """The int8 serving decode as served: bf16 activations over the int8
    hot set (q int8, s and b float32 through the cast; att_affine and the
    encode layers bf16); ids in range, the params not changed in place."""
    family, _, tm, _, np_q, vis = setup
    tq = from_jax(np_q)
    cast = TS._cast_floats(tq, torch.bfloat16)
    for path in PATHS:
        layer = _at(cast, path)
        assert layer["q"].dtype == torch.int8, path
        assert layer["s"].dtype == layer["b"].dtype == torch.float32, path
    assert cast["att_affine"]["v"].dtype == torch.bfloat16
    assert cast["att_enc"]["v"].dtype == torch.bfloat16
    if family == "BUTDDetection":
        assert TS._cast_floats(from_jax(vis), torch.bfloat16)[
            "bu_masks"].dtype == torch.bfloat16
    make = (TS.make_greedy_decode if decode == "greedy"
            else TS.make_beam_decode)
    kw = dict(max_len=4) if decode == "greedy" else dict(beam_size=3,
                                                         max_steps=4)
    ids = make(tm, dtype=torch.bfloat16, device="cpu", **kw)(
        tq, {}, from_jax(vis))
    assert ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < DIMS["vocab_size"]
    if decode == "beam":
        assert (ids[:, 0] == STA_ID).all()
    assert tq["embed"]["table"].dtype == torch.float32      # not in place


def test_bf16_int8_step_rounds_the_gates_as_jax(setup):
    """A bf16 int8 step against the JAX package's on the same bf16 encoding
    (the int8 cell rounds K3's gates to bf16 and runs the gate math in
    bf16, both sides): within one bf16 ulp."""
    _, jm, tm, _, np_q, vis = setup
    jp = JS._cast_floats(_jax_tree(np_q), jnp.bfloat16)
    jenc, _ = jm.encode(jp, JS._cast_floats(_jax_tree(vis), jnp.bfloat16))
    tp = TS._cast_floats(from_jax(np_q), torch.bfloat16)
    tenc, _ = tm.encode(tp, TS._cast_floats(from_jax(vis), torch.bfloat16))
    f = lambda x: np.array(jnp.asarray(x, jnp.float32))       # noqa: E731
    same = dataclasses.replace(
        tenc, features=torch.from_numpy(f(jenc.features)).bfloat16(),
        mean=torch.from_numpy(f(jenc.mean)).bfloat16(),
        extras={"att_keys": torch.from_numpy(
            f(jenc.extras["att_keys"])).bfloat16()})
    rng = np.random.default_rng(14)
    state = {k: (0.5 * rng.normal(size=(B, DIMS["hidden_dim"]))).astype(
        np.float32) for k in ("h1", "c1", "h2", "c2")}
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,))
    jpre, jst, _ = jm.step_core(
        jp, jenc, JS._cast_floats(_jax_tree(state), jnp.bfloat16),
        jnp.asarray(toks, jnp.int32))
    tpre, tst, _ = tm.step_core(
        tp, same, TS._cast_floats(from_jax(state), torch.bfloat16),
        torch.from_numpy(toks).long())
    assert tpre.dtype == tst["c1"].dtype == torch.bfloat16
    for name, got, want in [("pre", tpre, jpre)] + [
            (k, tst[k], jst[k]) for k in ("h1", "c1", "h2", "c2")]:
        np.testing.assert_allclose(got.float().numpy(), f(want), rtol=1e-2,
                                   atol=1e-2, err_msg=name)
