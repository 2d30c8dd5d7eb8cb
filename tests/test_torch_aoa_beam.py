"""Beam search, the main path: the grouped-lanes step and batched beam
decode of AoADetection in simpleimagecaptionzoo_tpu_torch against the JAX
package, same params (carried by convert.from_jax) and same numpy inputs,
float32, on the config and fixture of tests/test_torch_aoa_greedy.py.  The
JAX side runs its Pallas kernels (fused head, fused LSTM cell) in interpret
mode.  Ids must be identical, through both branches of each package's beam
search (the fused head, and the full logits)."""
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
from simpleimagecaptionzoo_tpu_torch.ops import decode, fused_head

CFG = dict(model_type="AoADetection", vocab_size=1000, embed_dim=128,
           hidden_dim=128, enc_dim=64, num_heads=4, num_refine_layers=2,
           max_bu_len=5)
B, N, STEPS = 16, 5, 8
# float32 on both sides, sums in other orders: the tolerance of the greedy
# holds (tests/test_torch_aoa_greedy.py)
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


@pytest.fixture(scope="module")
def ending_params(setup):
    """The params with the ``<end>`` bias raised to the midpoint of the two
    middle first-step margins (as in tests/test_torch_aoa_greedy.py), so
    beams end at every step: the finished pool, shrinking k and the pick
    all take part."""
    _, tm, p, vis = setup
    params = jax.tree_util.tree_map(np.copy, p)
    tparams = from_jax(params)
    enc, _ = tm.encode(tparams, from_jax(vis))
    with torch.no_grad():
        tok = torch.full((B,), STA_ID, dtype=torch.long)
        logits, _, _ = tm.step(tparams, enc, tm.init_state(tparams, enc), tok)
    margin = np.sort((logits.max(dim=1).values - logits[:, END_ID]).numpy())
    params["predict"]["b"][END_ID] += 0.5 * (margin[B // 2 - 1]
                                             + margin[B // 2])
    return params


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _encode_both(setup):
    jm, tm, p, vis = setup
    jenc, _ = jm.encode(_jax_tree(p), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(p), from_jax(vis))
    return jenc, tenc


def _lane_inputs(k):
    rng = np.random.default_rng(12 + k)
    state = {n: (0.5 * rng.normal(size=(B, k, CFG["hidden_dim"]))).astype(
        np.float32) for n in ("h", "m", "ctx")}
    toks = rng.integers(4, CFG["vocab_size"], size=(B, k)).astype(np.int32)
    return state, toks


@pytest.mark.parametrize("which", ["aoa", "default"])
def test_step_lanes_core_matches_jax(setup, which):
    """AoA's shared-K/V lanes step, and the base class's default (lanes
    flattened into the batch, the encoding broadcast), against the JAX
    package's same method on the same state and tokens."""
    jm, tm, p, _ = setup
    jenc, tenc = _encode_both(setup)
    k = 3
    state, toks = _lane_inputs(k)
    if which == "aoa":
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
    assert tpre.shape == (B, k, CFG["hidden_dim"]) and tal.shape == (B, k, N)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    for n in ("h", "m", "ctx"):
        assert tst[n].shape == (B, k, CFG["hidden_dim"])
        assert tst[n].is_contiguous(), n
        np.testing.assert_allclose(tst[n].numpy(), np.asarray(jst[n]),
                                   err_msg=n, **TOL)


def test_step_lanes_matches_jax_and_the_flat_step(setup):
    """step_lanes (the lanes step and the head) against the JAX package's,
    and against the port's own flat step per lane
    (tests/test_models_decode.py:222): lane j of sample i is the flat step
    on the broadcast encoding."""
    jm, tm, p, _ = setup
    jenc, tenc = _encode_both(setup)
    k = 3
    state, toks = _lane_inputs(k)
    tp, tstate = from_jax(p), from_jax(state)
    ttoks = torch.from_numpy(toks).long()
    logits, new_state, alpha = tm.step_lanes(tp, tenc, tstate, ttoks)
    assert logits.shape == (B, k, CFG["vocab_size"])
    jlogits, _, _ = jm.step_lanes(_jax_tree(p), jenc, _jax_tree(state),
                                  jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)

    enc_flat = torch_base._flatten_lanes(torch_base._broadcast_lanes(tenc, k))
    state_flat = {n: s.reshape(B * k, -1) for n, s in tstate.items()}
    logits_f, state_f, alpha_f = tm.step(tp, enc_flat, state_flat,
                                         ttoks.reshape(-1))
    np.testing.assert_allclose(logits.reshape(B * k, -1).numpy(),
                               logits_f.numpy(), rtol=2e-5, atol=2e-5)
    for n in ("h", "m", "ctx"):
        np.testing.assert_allclose(new_state[n].reshape(B * k, -1).numpy(),
                                   state_f[n].numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=n)
    np.testing.assert_allclose(alpha.reshape(B * k, -1).numpy(),
                               alpha_f.numpy(), rtol=2e-5, atol=2e-5)


def test_init_lane_state_matches_the_default(setup):
    _, tm, p, _ = setup
    _, tenc = _encode_both(setup)
    tp = from_jax(p)
    own = tm.init_lane_state(tp, tenc, 3)
    default = torch_base.Captioner.init_lane_state(tm, tp, tenc, 3)
    for n in ("h", "m", "ctx"):
        assert own[n].shape == default[n].shape == (B, 3, CFG["hidden_dim"])
        assert torch.equal(own[n], default[n])


def _jax_beam(setup, params, beam, steps, alphas=False):
    jm, _, _, vis = setup
    out = JS.make_beam_decode(jm, beam_size=beam, max_steps=steps,
                              return_alphas=alphas)(
        _jax_tree(params), {}, _jax_tree(vis))
    return (tuple(np.asarray(o) for o in out) if alphas
            else np.asarray(out))


def _port_beam(setup, params, beam, steps, alphas=False):
    _, tm, _, vis = setup
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


@pytest.mark.parametrize("ending", [False, True])
@pytest.mark.parametrize("beam", [1, 2, 3, 5])
def test_beam_fused_branch_matches_jax(setup, ending_params, beam, ending):
    """Beam 1, 2, 3 and 5 through the fused-head branch on both sides (the
    JAX package's K1 in interpret mode), on the random params and on the
    params whose ``<end>`` bias makes beams finish at every step."""
    params = ending_params if ending else setup[2]
    assert fused_head.enabled(beam)
    jids = _jax_beam(setup, params, beam, STEPS)
    tids = _port_beam(setup, params, beam, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)
    if ending:
        # some rows pick a finished beam before the step cap
        assert (tids[:, 1:] == END_ID).any(axis=1).sum() >= B // 4


@pytest.mark.parametrize("jax_branch", ["fused", "full"])
@pytest.mark.parametrize("port_branch", ["fused", "full"])
def test_beam3_each_branch_matches_each_jax_branch(setup, ending_params,
                                                   port_branch, jax_branch,
                                                   monkeypatch):
    """Beam 3 with either branch forced on either side: the JAX package's
    full-logits branch by turning its fused head off, the port's by
    ``fused_head.enabled``."""
    if jax_branch == "full":
        monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "off")
    assert jax_fused_head.enabled(_jax_tree(ending_params)["predict"], B * 3,
                                  3, jnp.float32) == (jax_branch == "fused")
    jids = _jax_beam(setup, ending_params, 3, STEPS)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    if port_branch == "full":
        monkeypatch.setattr(fused_head, "enabled", lambda k: False)
    before = fused_head.COUNT.n
    calls = []
    topk = fused_head.topk_head
    monkeypatch.setattr(fused_head, "topk_head",
                        lambda *a: calls.append(1) or topk(*a))
    tids = _port_beam(setup, ending_params, 3, STEPS)
    assert bool(calls) == (port_branch == "fused")
    assert fused_head.COUNT.n == before        # the CPU launches nothing
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)


def test_beam17_takes_the_full_logits_branch_and_matches_jax(setup):
    """Beam 17 is wider than K1 takes (MAX_K 16): both packages run the
    full-logits branch.  The fixture's vocab (1000) is above 17."""
    assert not fused_head.enabled(17) and fused_head.MAX_K == 16
    jids = _jax_beam(setup, setup[2], 17, 5)
    tids = _port_beam(setup, setup[2], 17, 5)
    _check_rows(tids, 5)
    np.testing.assert_array_equal(tids, jids)


def test_return_alphas_matches_jax(setup, ending_params):
    jids, jal = _jax_beam(setup, ending_params, 3, STEPS, alphas=True)
    tids, tal = _port_beam(setup, ending_params, 3, STEPS, alphas=True)
    assert tal.shape == (B, STEPS, N) and tal.dtype == np.float32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-5, atol=1e-5)
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
def test_beam1_equals_greedy(setup, ending_params, ending):
    """tests/test_decode_consistency.py:55: beam 1 reproduces greedy up to
    the first ``<end>``."""
    _, tm, p, vis = setup
    params = from_jax(ending_params if ending else p)
    enc, _ = tm.encode(params, from_jax(vis))
    g_ids, _ = decode.greedy(tm, params, enc, max_len=12)
    b_ids = decode.beam_search(tm, params, enc, beam_size=1, max_steps=12)
    g, b = g_ids.numpy(), b_ids.numpy()[:, 1:]
    for i in range(B):
        gt = _trim(g[i])
        assert _trim(b[i][:len(gt)]) == gt, i


def test_beam_decode_deterministic(setup, ending_params):
    """tests/test_decode_consistency.py:68."""
    _, tm, _, vis = setup
    params = from_jax(ending_params)
    enc, _ = tm.encode(params, from_jax(vis))
    b1 = decode.beam_search(tm, params, enc, beam_size=3, max_steps=10,
                            return_alphas=True)
    b2 = decode.beam_search(tm, params, enc, beam_size=3, max_steps=10,
                            return_alphas=True)
    assert torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])


def test_every_beam_ends_stops_the_loop(setup, ending_params):
    """With ``<end>`` far ahead, every beam ends as soon as it may: the loop
    stops after two steps and every row is ``<sta> <end> <pad>...``."""
    _, tm, _, vis = setup
    params = jax.tree_util.tree_map(np.copy, ending_params)
    params["predict"]["b"][END_ID] += 1e3
    calls = []
    step = tm.step_lanes_core

    def counting(*a, **kw):
        calls.append(1)
        return step(*a, **kw)

    tm.step_lanes_core = counting
    try:
        ids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS,
                                  device="cpu")(from_jax(params), {},
                                                from_jax(vis)).numpy()
    finally:
        del tm.step_lanes_core
    # step 0 has one live lane: its <end> finishes and its next two tokens
    # stay live; at step 1 both of those end, and no beam is left open
    assert len(calls) == 2
    assert (ids[:, 1] == END_ID).all() and (ids[:, 2:] == PAD_ID).all()


def test_entry_point_defaults_to_the_gpu(setup):
    """With no CUDA device the default entry point raises; it never falls
    back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_beam_decode(setup[1])
