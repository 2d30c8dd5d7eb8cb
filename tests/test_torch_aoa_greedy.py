"""The ported slice as a whole: AoADetection encode, one decoder step and
greedy decode in simpleimagecaptionzoo_tpu_torch against the JAX package,
same params (carried by convert.from_jax) and same numpy inputs, float32.
The JAX side runs both of its Pallas kernels (fused head, fused LSTM cell)
in interpret mode.  Greedy ids must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner

CFG = dict(model_type="AoADetection", vocab_size=1000, embed_dim=128,
           hidden_dim=128, enc_dim=64, num_heads=4, num_refine_layers=2,
           max_bu_len=5)
B, N = 16, 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _kernels(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")


@pytest.fixture(scope="module")
def setup():
    jm = jax_get(JaxModelConfig(**CFG))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tm = get_captioner(ModelConfig(**CFG))
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(B, N, CFG["enc_dim"])).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 3:] = 0                   # some rows padded ('adaptive' boxes)
    mask[5, 1:] = 0
    mask[9, 4:] = 0
    return jm, tm, np_params, {"bu_feats": feats, "bu_masks": mask}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _encode_both(setup):
    jm, tm, p, vis = setup
    jenc, _ = jm.encode(_jax_tree(p), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(p), from_jax(vis))
    return jenc, tenc


def test_encode_matches_jax(setup):
    jenc, tenc = _encode_both(setup)
    for name, j, t in (("features", jenc.features, tenc.features),
                       ("mean", jenc.mean, tenc.mean),
                       ("k_proj", jenc.extras["k_proj"], tenc.extras["k_proj"]),
                       ("v_proj", jenc.extras["v_proj"], tenc.extras["v_proj"])):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_one_step_matches_jax(setup):
    jm, tm, p, _ = setup
    jenc, tenc = _encode_both(setup)
    rng = np.random.default_rng(12)
    state = {k: (0.5 * rng.normal(size=(B, CFG["hidden_dim"]))).astype(
        np.float32) for k in ("h", "m", "ctx")}
    toks = rng.integers(4, CFG["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = jm.step_core(_jax_tree(p), jenc, _jax_tree(state),
                                  jnp.asarray(toks))
    tpre, tst, tal = tm.step_core(from_jax(p), tenc, from_jax(state),
                                  torch.from_numpy(toks).long())
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    for k in ("h", "m", "ctx"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **TOL)


def _greedy_both(setup, params, max_len):
    jm, tm, _, vis = setup
    jids, jal = JS.make_greedy_decode(jm, max_len=max_len,
                                      return_alphas=True)(
        _jax_tree(params), {}, _jax_tree(vis))
    tids, tal = TS.make_greedy_decode(tm, max_len=max_len,
                                      return_alphas=True, device="cpu")(
        from_jax(params), {}, from_jax(vis))
    return np.asarray(jids), np.asarray(jal), tids.numpy(), tal.numpy()


def test_greedy_matches_jax(setup):
    jids, jal, tids, tal = _greedy_both(setup, setup[2], 8)
    assert tids.shape == (B, 8) and tal.shape == (B, 8, N)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, **TOL)


def test_greedy_early_exit_and_padding(setup):
    """Half the lanes emit <end> at step 0 (the <end> bias is raised to the
    midpoint of the two middle first-step margins): the loop runs on for the
    rest, the finished lanes are padded with <pad> and their alphas are 0,
    and the ids equal the JAX package's.  Then every lane ends at step 0 and
    the loop stops after one step (tests/test_models_decode.py:205)."""
    jm, tm, p, vis = setup
    params = jax.tree_util.tree_map(np.copy, p)
    tparams = from_jax(params)
    enc, _ = tm.encode(tparams, from_jax(vis))
    with torch.no_grad():
        tok = torch.full((B,), STA_ID, dtype=torch.long)
        logits, _, _ = tm.step(tparams, enc, tm.init_state(tparams, enc), tok)
    margin = np.sort((logits.max(dim=1).values - logits[:, END_ID]).numpy())
    params["predict"]["b"][END_ID] += 0.5 * (margin[B // 2 - 1]
                                             + margin[B // 2])
    jids, jal, tids, tal = _greedy_both(setup, params, 15)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, **TOL)
    ended = tids[:, 0] == END_ID
    assert ended.sum() == B // 2
    assert (tids[ended, 1:] == PAD_ID).all()
    assert (tal[ended, 1:] == 0).all()
    for row in tids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()

    params["predict"]["b"][END_ID] += 1e3
    calls = []
    step_core = tm.step_core

    def counting_step_core(*a, **kw):
        calls.append(1)
        return step_core(*a, **kw)

    tm.step_core = counting_step_core
    try:
        tids = TS.make_greedy_decode(tm, max_len=15, device="cpu")(
            from_jax(params), {}, from_jax(vis)).numpy()
    finally:
        del tm.step_core
    assert len(calls) == 1
    assert (tids[:, 0] == END_ID).all() and (tids[:, 1:] == PAD_ID).all()


def test_entry_point_defaults_to_the_gpu(setup):
    """With no CUDA device the default entry point raises; it never falls
    back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_greedy_decode(setup[1])


def test_bf16_decode_runs_and_casts_inputs(setup):
    _, tm, p, vis = setup
    tparams = from_jax(p)
    tvis = from_jax(vis)
    cast = TS._cast_floats(tvis, torch.bfloat16)
    assert cast["bu_masks"].dtype == torch.bfloat16
    ids = TS.make_greedy_decode(tm, max_len=4, dtype=torch.bfloat16,
                                device="cpu")(tparams, {}, tvis)
    assert ids.shape == (B, 4) and ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < CFG["vocab_size"]
    assert tparams["lstm"]["w_ih"].dtype == torch.float32   # not in place
