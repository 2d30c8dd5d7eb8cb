"""Beam search of BUTDDetection and BUTDSpatial in feature mode: the
grouped-lanes step and batched beam decode in simpleimagecaptionzoo_tpu_torch
against the JAX package, same params (carried by convert.from_jax) and same
numpy inputs, on the config of tests/test_torch_butd_greedy.py.

Float32 cases run in both of the JAX package's modes (``auto``: the
attention cell's mean rows hoisted, every layer jnp, the full-logits beam
branch; ``interpret``: both cells and the fused head through its Pallas
kernels in interpret mode).  Ids must be identical at beam 1, 2, 3 and 5.
bf16 (B = 16) under the rule of tests/test_torch_aoa_bf16.py: ids
identical, or a differing row's two winners, rescored by the port, within
``GAP_TOL``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models import base as jax_base
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import fused_head as jax_fused_head
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models import base as torch_base
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode

FAMILIES = ("BUTDDetection", "BUTDSpatial")
DIMS = dict(vocab_size=50, embed_dim=64, hidden_dim=128, atten_dim=32,
            enc_dim=48, enc_img_size=3)
B, N_BOX, STEPS = 8, 5, 8
N_OF = {"BUTDDetection": N_BOX, "BUTDSpatial": 9}
TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16
B_BF16 = 16
GAP_TOL = 1e-2                   # tests/test_torch_aoa_bf16.py's rule


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


def _ending(tm, p, vis, b):
    """p with the ``<end>`` bias raised to the midpoint of the two middle
    first-step margins, so beams end at every step: the finished pool,
    shrinking k and the pick all take part."""
    params = jax.tree_util.tree_map(np.copy, p)
    tparams = from_jax(params)
    enc, _ = tm.encode(tparams, from_jax(vis))
    with torch.no_grad():
        tok = torch.full((b,), STA_ID, dtype=torch.long)
        logits, _, _ = tm.step(tparams, enc, tm.init_state(tparams, enc), tok)
    margin = np.sort((logits.max(dim=1).values - logits[:, END_ID]).numpy())
    params["predict"]["b"][END_ID] += 0.5 * (margin[b // 2 - 1]
                                             + margin[b // 2])
    return params


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    family = request.param
    cfg = dict(DIMS, model_type=family)
    jm = jax_get(JaxModelConfig(**cfg))
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), include_cnn=False))
    tm = get_captioner(ModelConfig(**cfg))
    vis = _visual(family, B)
    return (family, jm, tm, np_params, vis,
            _ending(tm, np_params, vis, B))


@pytest.fixture(params=["auto", "interpret"])
def mode(request, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", request.param)
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", request.param)
    return request.param


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _encode_both(setup):
    _, jm, tm, p, vis, _ = setup
    jenc, _ = jm.encode(_jax_tree(p), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(p), from_jax(vis))
    return jenc, tenc


def _lane_inputs(k):
    rng = np.random.default_rng(12 + k)
    state = {n: (0.5 * rng.normal(size=(B, k, DIMS["hidden_dim"]))).astype(
        np.float32) for n in ("h1", "c1", "h2", "c2")}
    toks = rng.integers(4, DIMS["vocab_size"], size=(B, k)).astype(np.int32)
    return state, toks


@pytest.mark.parametrize("which", ["butd", "default"])
def test_step_lanes_core_matches_jax(setup, mode, which):
    """BUTD's shared-keys lanes step, and the base class's default (lanes
    flattened into the batch, the encoding broadcast), against the JAX
    package's same method: pre-logits and state within 1e-5, attention
    within 1e-6; the state contiguous (B, k, H)."""
    family, jm, tm, p, _, _ = setup
    jenc, tenc = _encode_both(setup)
    k = 3
    state, toks = _lane_inputs(k)
    if which == "butd":
        jfn, tfn = jm.step_lanes_core, tm.step_lanes_core
    else:
        jfn = lambda *a, **kw: jax_base.Captioner.step_lanes_core(  # noqa
            jm, *a, **kw)
        tfn = lambda *a, **kw: torch_base.Captioner.step_lanes_core(  # noqa
            tm, *a, **kw)
    jpre, jst, jal = jfn(_jax_tree(p), jenc, _jax_tree(state),
                         jnp.asarray(toks))
    tpre, tst, tal = tfn(from_jax(p), tenc, from_jax(state),
                         torch.from_numpy(toks).long())
    assert tpre.shape == (B, k, DIMS["hidden_dim"])
    assert tal.shape == (B, k, N_OF[family])
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=1e-6,
                               atol=1e-6)
    for n in ("h1", "c1", "h2", "c2"):
        assert tst[n].shape == (B, k, DIMS["hidden_dim"])
        assert tst[n].is_contiguous(), n
        np.testing.assert_allclose(tst[n].numpy(), np.asarray(jst[n]),
                                   err_msg=n, **TOL)


def test_step_lanes_matches_the_flat_step(setup):
    """Lane j of sample i of the lanes step (with the head) is the flat
    step on the broadcast encoding (tests/test_models_decode.py:222)."""
    _, _, tm, p, _, _ = setup
    _, tenc = _encode_both(setup)
    k = 3
    state, toks = _lane_inputs(k)
    tp, tstate = from_jax(p), from_jax(state)
    ttoks = torch.from_numpy(toks).long()
    logits, new_state, alpha = tm.step_lanes(tp, tenc, tstate, ttoks)
    assert logits.shape == (B, k, DIMS["vocab_size"])
    enc_flat = torch_base._flatten_lanes(torch_base._broadcast_lanes(tenc, k))
    state_flat = {n: s.reshape(B * k, -1) for n, s in tstate.items()}
    logits_f, state_f, alpha_f = tm.step(tp, enc_flat, state_flat,
                                         ttoks.reshape(-1))
    np.testing.assert_allclose(logits.reshape(B * k, -1).numpy(),
                               logits_f.numpy(), rtol=2e-5, atol=2e-5)
    for n in ("h1", "c1", "h2", "c2"):
        np.testing.assert_allclose(new_state[n].reshape(B * k, -1).numpy(),
                                   state_f[n].numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=n)
    np.testing.assert_allclose(alpha.reshape(B * k, -1).numpy(),
                               alpha_f.numpy(), rtol=2e-5, atol=2e-5)


def test_init_lane_state_matches_the_default(setup):
    _, _, tm, p, _, _ = setup
    _, tenc = _encode_both(setup)
    tp = from_jax(p)
    own = tm.init_lane_state(tp, tenc, 3)
    default = torch_base.Captioner.init_lane_state(tm, tp, tenc, 3)
    for n in ("h1", "c1", "h2", "c2"):
        assert own[n].shape == default[n].shape == (B, 3, DIMS["hidden_dim"])
        assert torch.equal(own[n], default[n])


def _jax_beam(setup, params, beam, steps, alphas=False):
    _, jm, _, _, vis, _ = setup
    out = JS.make_beam_decode(jm, beam_size=beam, max_steps=steps,
                              return_alphas=alphas)(
        _jax_tree(params), {}, _jax_tree(vis))
    return (tuple(np.asarray(o) for o in out) if alphas
            else np.asarray(out))


def _port_beam(setup, params, beam, steps, alphas=False):
    _, _, tm, _, vis, _ = setup
    out = TS.make_beam_decode(tm, beam_size=beam, max_steps=steps,
                              return_alphas=alphas, device="cpu")(
        from_jax(params), {}, from_jax(vis))
    return (tuple(o.numpy() for o in out) if alphas else out.numpy())


def _check_rows(ids, steps):
    assert ids.shape == (B, steps + 1) and ids.dtype == np.int64
    assert (ids[:, 0] == STA_ID).all()
    for row in ids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()


@pytest.mark.parametrize("beam", [1, 2, 3, 5])
def test_beam_matches_jax(setup, mode, beam):
    """Beam 1, 2, 3 and 5 on the params whose ``<end>`` bias ends beams at
    every step (early exit, padding, the finished pool and the pick):
    ids identical to the JAX package's in both of its modes (its fused
    head in ``interpret``, its full logits in ``auto``)."""
    params = setup[5]
    assert jax_fused_head.enabled(_jax_tree(params)["predict"], B * beam,
                                  beam, jnp.float32) == (mode == "interpret")
    jids = _jax_beam(setup, params, beam, STEPS)
    tids = _port_beam(setup, params, beam, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)
    assert (tids[:, 1:] == END_ID).any(axis=1).sum() >= B // 4


def test_beam3_random_params_matches_jax(setup, mode):
    """Beam 3 on the random params, where no beam ends before the cap."""
    jids = _jax_beam(setup, setup[3], 3, STEPS)
    tids = _port_beam(setup, setup[3], 3, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)


def test_return_alphas_matches_jax(setup, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    family, params = setup[0], setup[5]
    jids, jal = _jax_beam(setup, params, 3, STEPS, alphas=True)
    tids, tal = _port_beam(setup, params, 3, STEPS, alphas=True)
    assert tal.shape == (B, STEPS, N_OF[family]) and tal.dtype == np.float32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    if family == "BUTDDetection":
        # the padded boxes get no attention
        assert (tal[0, :, 3:] == 0).all() and (tal[5, :, 1:] == 0).all()


def _trim(row):
    out = []
    for t in row:
        out.append(int(t))
        if t == END_ID:
            break
    return out


@pytest.mark.parametrize("ending", [False, True])
def test_beam1_equals_greedy(setup, ending):
    """tests/test_decode_consistency.py:55: beam 1 reproduces greedy up to
    the first ``<end>``."""
    _, _, tm, p, vis, ending_params = setup
    params = from_jax(ending_params if ending else p)
    enc, _ = tm.encode(params, from_jax(vis))
    g_ids, _ = decode.greedy(tm, params, enc, max_len=12)
    b_ids = decode.beam_search(tm, params, enc, beam_size=1, max_steps=12)
    g, b = g_ids.numpy(), b_ids.numpy()[:, 1:]
    for i in range(B):
        gt = _trim(g[i])
        assert _trim(b[i][:len(gt)]) == gt, i


def test_every_beam_ends_stops_the_loop(setup):
    """With ``<end>`` far ahead, every beam ends as soon as it may: the loop
    stops after two steps and every row is ``<sta> <end> <pad>...``."""
    _, _, tm, _, vis, ending_params = setup
    params = jax.tree_util.tree_map(np.copy, ending_params)
    params["predict"]["b"][END_ID] += 1e3
    calls = []
    step = tm.step_lanes_core
    tm.step_lanes_core = lambda *a, **kw: calls.append(1) or step(*a, **kw)
    try:
        ids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS,
                                  device="cpu")(from_jax(params), {},
                                                from_jax(vis)).numpy()
    finally:
        del tm.step_lanes_core
    assert len(calls) == 2
    assert (ids[:, 1] == END_ID).all() and (ids[:, 2:] == PAD_ID).all()


def test_entry_point_defaults_to_the_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_beam_decode(setup[2])


def test_bf16_lanes_step_matches_jax(setup, monkeypatch):
    """One bf16 lanes step (k = 3, B = 16) on the same bf16 encoding, state
    and tokens as the JAX package's interpret-mode step: pre-logits, state
    and attention within one bf16 ulp (rtol = atol = 1e-2)."""
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    family, jm, tm, p, _, _ = setup
    vis = _visual(family, B_BF16, seed=21)
    jp = JS._cast_floats(_jax_tree(p), jnp.bfloat16)
    jenc, _ = jm.encode(jp, JS._cast_floats(_jax_tree(vis), jnp.bfloat16))
    tp = TS._cast_floats(from_jax(p), BF)
    tenc, _ = tm.encode(tp, TS._cast_floats(from_jax(vis), BF))
    rng = np.random.default_rng(13)
    state = {n: (0.5 * rng.normal(size=(B_BF16, 3, DIMS["hidden_dim"])))
             .astype(np.float32) for n in ("h1", "c1", "h2", "c2")}
    toks = rng.integers(4, DIMS["vocab_size"], size=(B_BF16, 3))
    jpre, jst, jal = jm.step_lanes_core(
        jp, jenc, JS._cast_floats(_jax_tree(state), jnp.bfloat16),
        jnp.asarray(toks, jnp.int32))
    tpre, tst, tal = tm.step_lanes_core(
        tp, tenc, TS._cast_floats(from_jax(state), BF),
        torch.from_numpy(toks).long())
    assert tpre.dtype == tst["h1"].dtype == tal.dtype == BF
    f = lambda x: np.asarray(jnp.asarray(x, jnp.float32))    # noqa: E731
    for name, got, want in [("pre", tpre, jpre), ("alpha", tal, jal)] + [
            (n, tst[n], jst[n]) for n in ("h1", "c1", "h2", "c2")]:
        np.testing.assert_allclose(got.float().numpy(), f(want), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def test_bf16_beam3_matches_jax_or_differs_at_a_near_tie(setup,
                                                        monkeypatch):
    """bf16 beam 3 (B = 16) against the JAX package's interpret-mode
    kernels: ids identical, or, where a row differs, the two winners
    rescored by the port (``decode.sequence_logprob``, float32 log-probs of
    the bf16 step) within ``GAP_TOL``."""
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    family, jm, tm, p, _, _ = setup
    vis = _visual(family, B_BF16, seed=21)
    assert jax_fused_head.enabled(
        JS._cast_floats(_jax_tree(p), jnp.bfloat16)["predict"], B_BF16 * 3,
        3, jnp.bfloat16)
    jids = np.asarray(JS.make_beam_decode(jm, beam_size=3, max_steps=STEPS,
                                          dtype=jnp.bfloat16)(
        _jax_tree(p), {}, _jax_tree(vis)))
    tids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS, dtype=BF,
                               device="cpu")(from_jax(p), {},
                                             from_jax(vis)).numpy()
    assert tids.shape == jids.shape == (B_BF16, STEPS + 1)
    differ = (tids != jids).any(axis=1)
    assert differ.sum() <= B_BF16 // 4, differ
    params = TS._cast_floats(from_jax(p), BF)
    enc, _ = tm.encode(params, TS._cast_floats(from_jax(vis), BF))
    with torch.no_grad():
        s_port = decode.sequence_logprob(tm, params, enc,
                                         torch.from_numpy(tids))
        s_jax = decode.sequence_logprob(
            tm, params, enc, torch.from_numpy(np.array(jids)).long())
    diff = (s_port - s_jax).abs().numpy()
    assert (diff[~differ] == 0).all()
    assert (diff < GAP_TOL).all(), diff
