"""NIC in feature mode: config, init tree, encode, the step -1 cell, one
decoder step, greedy and beam decode (float32, int8 serving, bf16) in
simpleimagecaptionzoo_tpu_torch against the JAX package, same params
(carried by convert.from_jax) and same numpy inputs.

Float32 cases run in both of the JAX package's modes: ``auto`` (off the TPU
every layer is jnp, and beam search takes its full-logits branch) and
``interpret`` (the LSTM cell and the fused head through its Pallas kernels
in interpret mode).  Float32 and int8: ids identical, pre-logits and state
within 1e-5.  bf16 (B = 16, which the JAX package's bf16 kernel gates
need), under the rule of tests/test_torch_aoa_bf16.py: greedy ids
identical, or each row's first difference at an id whose float32 logit is
within ``GAP_TOL`` of the port's pick; a differing beam row's two winners,
rescored by the port, within ``GAP_TOL``.

NIC has no attention (alpha None) and no lanes step of its own: beam
search runs the base class's default lanes step and lane state on both
sides, so ``init_state``'s cell runs over B*k identical rows."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu import config as jax_config
from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import fused_head as jax_fused_head
from simpleimagecaptionzoo_tpu.ops import pallas_lstm as jax_pallas_lstm
from simpleimagecaptionzoo_tpu.ops import quant as jax_quant
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch import config as port_config
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models import base as torch_base
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import (decode, fused_head,
                                                 fused_lstm, int8_attention,
                                                 quant)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(model_type="NIC", vocab_size=50, embed_dim=64, hidden_dim=128,
            enc_dim=48)
B, STEPS = 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16
B_BF16 = 16
GAP_TOL = 1e-2                   # tests/test_torch_aoa_bf16.py's rule
PATHS = (("lstm",), ("predict",))


def _visual(b, seed=11):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(b, DIMS["enc_dim"])).astype(
        np.float32)}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _raise_end(tm, p, vis, b, quantized=False):
    """p with the ``<end>`` bias raised to the midpoint of the two middle
    first-step margins: half the lanes end at step 0, and beams end at
    every step (the finished pool, shrinking k and the pick take part)."""
    params = jax.tree_util.tree_map(np.copy, p)
    tp = from_jax(params)
    enc, _ = tm.encode(tp, from_jax(vis))
    with torch.no_grad():
        tok = torch.full((b,), STA_ID, dtype=torch.long)
        hidden, _, _ = tm.step_core(tp, enc, tm.init_state(tp, enc), tok)
        logits = fused_head.logits_plain(
            fused_head.prepare_head(tp["predict"], torch.float32),
            hidden)[:, :DIMS["vocab_size"]]
    margin = np.sort((logits.max(dim=1).values - logits[:, END_ID]).numpy())
    params["predict"]["b"][END_ID] += 0.5 * (margin[b // 2 - 1]
                                             + margin[b // 2])
    return params


@pytest.fixture(scope="module")
def setup():
    jm = jax_get(JaxModelConfig(**DIMS))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_q = jax.tree_util.tree_map(np.asarray,
                                  jm.quantize_decode_params(jparams))
    tm = get_captioner(ModelConfig(**DIMS))
    vis = _visual(B)
    return dict(jm=jm, tm=tm, p=np_params, q=np_q, vis=vis,
                ending=_raise_end(tm, np_params, vis, B))


@pytest.fixture(params=["auto", "interpret"])
def mode(request, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", request.param)
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", request.param)
    return request.param


@pytest.fixture()
def kernels(monkeypatch):
    """The JAX package's kernels of this path in interpret mode."""
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_QUANT", "interpret")


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _encode_both(s, params=None):
    p = s["p"] if params is None else params
    jenc, _ = s["jm"].encode(_jax_tree(p), _jax_tree(s["vis"]))
    tenc, _ = s["tm"].encode(from_jax(p), from_jax(s["vis"]))
    return jenc, tenc


# ---------------------------------------------------------------------------
# config, params, encode, one step
# ---------------------------------------------------------------------------

def test_model_config_loads_as_jax():
    """``load_model_config`` reads Configs/Models/NIC.json into the port's
    ModelConfig field for field as the JAX package does (widths 512), and
    ``get_captioner`` builds NIC from it."""
    path = os.path.join(ROOT, "Configs", "Models", "NIC.json")
    got = port_config.load_model_config(path, vocab_size=10102)
    want = jax_config.load_model_config(path, vocab_size=10102)
    names = list(JaxModelConfig.__dataclass_fields__)
    assert {f: getattr(got, f) for f in names} == {
        f: getattr(want, f) for f in names}
    assert (got.embed_dim, got.hidden_dim, got.enc_dim) == (512, 512, 2048)
    assert type(get_captioner(got)).__name__ == "NICCaptioner"


def test_init_params_tree_matches_jax(setup):
    """The port's init_params draws the JAX package's tree (without
    ``cnn``) and shapes; the embedding is N(0, 1), the head's bias drawn."""
    mine = setup["tm"].init_params(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(setup["p"])[0]
    want = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]
    assert {jax.tree_util.keystr(k): v.shape for k, v in flat_t} == want
    assert set(mine) == {"img_embed", "embed", "lstm", "predict"}
    assert float(mine["predict"]["b"].abs().max()) > 0.0
    assert float(mine["embed"]["table"].abs().max()) > 1.0


def test_encode_matches_jax(setup, mode):
    """Encode is the weight-norm image embedding: features (B, 1, E), mean
    (B, E), no mask; the cell's prepared weights in extras."""
    jenc, tenc = _encode_both(setup)
    e = DIMS["embed_dim"]
    assert tenc.mask is None and jenc.mask is None
    assert set(tenc.extras) == {"lstm_cat"}
    assert tenc.features.shape == jenc.features.shape == (B, 1, e)
    _close(tenc.features, jenc.features, 1e-5, "features")
    _close(tenc.mean, jenc.mean, 1e-5, "mean")


def test_init_state_matches_jax(setup, mode):
    """Step -1: the image embedding through the cell from zeros."""
    jenc, tenc = _encode_both(setup)
    jst = setup["jm"].init_state(_jax_tree(setup["p"]), jenc)
    tst = setup["tm"].init_state(from_jax(setup["p"]), tenc)
    assert set(tst) == {"h", "c"}
    for n in ("h", "c"):
        assert tst[n].shape == (B, DIMS["hidden_dim"])
        assert float(tst[n].abs().max()) > 0.0
        _close(tst[n], jst[n], 1e-5, n)


def _state(rng, shape):
    return {n: (0.5 * rng.normal(size=shape + (DIMS["hidden_dim"],))).astype(
        np.float32) for n in ("h", "c")}


def test_one_step_matches_jax(setup, mode):
    """One step on the same state and tokens: pre-logits and state within
    1e-5; no alpha on either side."""
    jenc, tenc = _encode_both(setup)
    rng = np.random.default_rng(12)
    state = _state(rng, (B,))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = setup["jm"].step_core(_jax_tree(setup["p"]), jenc,
                                           _jax_tree(state), jnp.asarray(toks))
    tpre, tst, tal = setup["tm"].step_core(from_jax(setup["p"]), tenc,
                                           from_jax(state),
                                           torch.from_numpy(toks).long())
    assert tal is None and jal is None
    _close(tpre, jpre, 1e-5, "pre-logits")
    for n in ("h", "c"):
        _close(tst[n], jst[n], 1e-5, n)


def test_no_lanes_step_of_its_own(setup):
    """NIC runs the base class's lanes step and lane state, as in the JAX
    package (no override that the JAX package lacks)."""
    cls = type(setup["tm"])
    for name in ("init_lane_state", "step_lanes_core"):
        assert getattr(cls, name) is getattr(torch_base.Captioner, name)
        assert name not in type(setup["jm"]).__dict__


def test_step_lanes_core_matches_jax(setup, mode):
    """The default lanes step (lanes flattened into the batch, the encoding
    broadcast) against the JAX package's: pre-logits and state within
    1e-5, (B, k, H) and contiguous; alpha None."""
    jenc, tenc = _encode_both(setup)
    k = 3
    rng = np.random.default_rng(15)
    state = _state(rng, (B, k))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B, k)).astype(np.int32)
    jpre, jst, jal = setup["jm"].step_lanes_core(
        _jax_tree(setup["p"]), jenc, _jax_tree(state), jnp.asarray(toks))
    tpre, tst, tal = setup["tm"].step_lanes_core(
        from_jax(setup["p"]), tenc, from_jax(state),
        torch.from_numpy(toks).long())
    assert tal is None and jal is None
    assert tpre.shape == (B, k, DIMS["hidden_dim"])
    _close(tpre, jpre, 1e-5, "pre-logits")
    for n in ("h", "c"):
        assert tst[n].shape == (B, k, DIMS["hidden_dim"])
        assert tst[n].is_contiguous(), n
        _close(tst[n], jst[n], 1e-5, n)


def test_init_lane_state_matches_jax(setup, mode):
    """The lane state: ``init_state`` over the B*k rows of the broadcast
    embedding, each lane its sample's step -1 state."""
    jenc, tenc = _encode_both(setup)
    jst = setup["jm"].init_lane_state(_jax_tree(setup["p"]), jenc, 3)
    tp = from_jax(setup["p"])
    tst = setup["tm"].init_lane_state(tp, tenc, 3)
    flat = setup["tm"].init_state(tp, tenc)
    for n in ("h", "c"):
        assert tst[n].shape == (B, 3, DIMS["hidden_dim"])
        _close(tst[n], jst[n], 1e-5, n)
        for j in range(3):
            _close(tst[n][:, j], flat[n].numpy(), 1e-6, n)


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

def _spy_jax_kernels(monkeypatch):
    """Counts the JAX package's calls into its Pallas LSTM cell and fused
    head (made while it traces a decode): which of its paths ran."""
    seen = {"lstm": 0, "head": 0}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    spy(jax_pallas_lstm, "lstm_cell_fused", "lstm")
    spy(jax_fused_head, "_run_kernel", "head")
    return seen


def _greedy_both(setup, params, max_len):
    jids, jal = JS.make_greedy_decode(setup["jm"], max_len=max_len,
                                      return_alphas=True)(
        _jax_tree(params), {}, _jax_tree(setup["vis"]))
    tids, tal = TS.make_greedy_decode(setup["tm"], max_len=max_len,
                                      return_alphas=True, device="cpu")(
        from_jax(params), {}, from_jax(setup["vis"]))
    assert jal is None and tal is None
    return np.asarray(jids), tids.numpy()


def test_greedy_matches_jax(setup, mode, monkeypatch):
    """Greedy ids identical to the JAX package's; in ``interpret`` mode its
    decode runs the cell (init and step) and the head through its Pallas
    kernels, in ``auto`` none of them.  No alphas: NIC has no attention."""
    traced = _spy_jax_kernels(monkeypatch)
    jids, tids = _greedy_both(setup, setup["p"], STEPS)
    if mode == "interpret":
        assert traced["lstm"] >= 2 and traced["head"] >= 1, traced
    else:
        assert traced == {"lstm": 0, "head": 0}
    assert tids.shape == (B, STEPS)
    np.testing.assert_array_equal(tids, jids)


def test_greedy_early_exit_and_padding(setup, mode):
    """Half the lanes emit ``<end>`` at step 0: the loop runs on for the
    rest, finished lanes are padded with ``<pad>``, and the ids equal the
    JAX package's.  Then every lane ends at step 0 and the loop stops after
    one step."""
    params = setup["ending"]
    jids, tids = _greedy_both(setup, params, 12)
    np.testing.assert_array_equal(tids, jids)
    ended = tids[:, 0] == END_ID
    assert ended.sum() == B // 2
    assert (tids[ended, 1:] == PAD_ID).all()
    for row in tids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()

    params = jax.tree_util.tree_map(np.copy, params)
    params["predict"]["b"][END_ID] += 1e3
    tm, calls = setup["tm"], []
    step_core = tm.step_core
    tm.step_core = lambda *a, **kw: calls.append(1) or step_core(*a, **kw)
    try:
        tids = TS.make_greedy_decode(tm, max_len=12, device="cpu")(
            from_jax(params), {}, from_jax(setup["vis"])).numpy()
    finally:
        del tm.step_core
    assert len(calls) == 1
    assert (tids[:, 0] == END_ID).all() and (tids[:, 1:] == PAD_ID).all()


def _spy_k2(monkeypatch):
    seen = []
    fused = fused_lstm.lstm_cell_fused
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused",
                        lambda w, b, x, h, c, split=None: seen.append(
                            (tuple(w.shape), tuple(x.shape)))
                        or fused(w, b, x, h, c, split))
    return seen


def test_greedy_runs_the_cell_through_k2_each_step_and_at_init(setup,
                                                               monkeypatch):
    """K2's wrapper runs once in ``init_state`` (x = the image embedding)
    and once a step (x = the word embedding), all at B rows and width E
    with encode's prepared weights; the CPU launches nothing."""
    seen = _spy_k2(monkeypatch)
    before = fused_lstm.COUNT.n, fused_head.COUNT.n
    ids = TS.make_greedy_decode(setup["tm"], max_len=3, device="cpu")(
        from_jax(setup["p"]), {}, from_jax(setup["vis"]))
    e, h = DIMS["embed_dim"], DIMS["hidden_dim"]
    steps = int((ids != PAD_ID).any(dim=0).sum())
    assert seen == [((e + h, 4 * h), (B, e))] * (steps + 1)
    assert (fused_lstm.COUNT.n, fused_head.COUNT.n) == before


# ---------------------------------------------------------------------------
# beam
# ---------------------------------------------------------------------------

def _jax_beam(setup, params, beam, steps, alphas=False, vis=None):
    out = JS.make_beam_decode(setup["jm"], beam_size=beam, max_steps=steps,
                              return_alphas=alphas)(
        _jax_tree(params), {}, _jax_tree(vis or setup["vis"]))
    return (tuple(np.asarray(o) for o in out) if alphas
            else np.asarray(out))


def _port_beam(setup, params, beam, steps, alphas=False, vis=None):
    out = TS.make_beam_decode(setup["tm"], beam_size=beam, max_steps=steps,
                              return_alphas=alphas, device="cpu")(
        from_jax(params), {}, from_jax(vis or setup["vis"]))
    return (tuple(o.numpy() for o in out) if alphas else out.numpy())


def _check_rows(ids, steps, b=B):
    assert ids.shape == (b, steps + 1) and ids.dtype == np.int64
    assert (ids[:, 0] == STA_ID).all()
    for row in ids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()


@pytest.mark.parametrize("beam", [1, 2, 3, 5])
def test_beam_matches_jax(setup, mode, beam):
    """Beam 1, 2, 3 and 5 on the params whose ``<end>`` bias ends beams at
    every step: ids identical to the JAX package's in both of its modes
    (its fused head in ``interpret``, its full logits in ``auto``)."""
    params = setup["ending"]
    assert jax_fused_head.enabled(_jax_tree(params)["predict"], B * beam,
                                  beam, jnp.float32) == (mode == "interpret")
    jids = _jax_beam(setup, params, beam, STEPS)
    tids = _port_beam(setup, params, beam, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)
    assert (tids[:, 1:] == END_ID).any(axis=1).sum() >= B // 4


def test_beam3_random_params_matches_jax(setup, mode):
    """Beam 3 on the random params, where few beams end before the cap."""
    jids = _jax_beam(setup, setup["p"], 3, STEPS)
    tids = _port_beam(setup, setup["p"], 3, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)


def test_return_alphas_are_zeros_of_width_one(setup, kernels):
    """NIC's step returns no alpha: beam search's alphas are zeros over its
    one feature row, as the JAX package's are."""
    jids, jal = _jax_beam(setup, setup["ending"], 3, STEPS, alphas=True)
    tids, tal = _port_beam(setup, setup["ending"], 3, STEPS, alphas=True)
    assert tal.shape == jal.shape == (B, STEPS, 1)
    assert tal.dtype == np.float32
    np.testing.assert_array_equal(tids, jids)
    assert (tal == 0).all() and (jal == 0).all()


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
    tm = setup["tm"]
    params = from_jax(setup["ending"] if ending else setup["p"])
    enc, _ = tm.encode(params, from_jax(setup["vis"]))
    g_ids, _ = decode.greedy(tm, params, enc, max_len=12)
    b_ids = decode.beam_search(tm, params, enc, beam_size=1, max_steps=12)
    g, b = g_ids.numpy(), b_ids.numpy()[:, 1:]
    for i in range(B):
        gt = _trim(g[i])
        assert _trim(b[i][:len(gt)]) == gt, i


def test_every_beam_ends_stops_the_loop(setup):
    """With ``<end>`` far ahead, every beam ends as soon as it may: the loop
    stops after two steps and every row is ``<sta> <end> <pad>...``."""
    params = jax.tree_util.tree_map(np.copy, setup["ending"])
    params["predict"]["b"][END_ID] += 1e3
    tm, calls = setup["tm"], []
    step = tm.step_lanes_core
    tm.step_lanes_core = lambda *a, **kw: calls.append(1) or step(*a, **kw)
    try:
        ids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS,
                                  device="cpu")(from_jax(params), {},
                                                from_jax(setup["vis"]))
    finally:
        del tm.step_lanes_core
    assert len(calls) == 2
    assert (ids[:, 1] == END_ID).all() and (ids[:, 2:] == PAD_ID).all()


def test_beam_runs_the_init_cell_over_the_beam_rows(setup, monkeypatch):
    """Beam 3: K2's wrapper runs once at init over the B*3 rows of the
    broadcast image embedding, then once a step over B*3 rows."""
    seen = _spy_k2(monkeypatch)
    _port_beam(setup, setup["p"], 3, 4)
    e, h = DIMS["embed_dim"], DIMS["hidden_dim"]
    n_steps = len(seen) - 1
    assert n_steps >= 1
    assert seen == [((e + h, 4 * h), (B * 3, e))] * (n_steps + 1)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_entry_points_default_to_the_gpu(setup, decoder):
    """With no CUDA device the default entry point raises; it never falls
    back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = (TS.make_greedy_decode if decoder == "greedy"
            else TS.make_beam_decode)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(setup["tm"])


def test_from_pixels_is_not_ported(setup):
    """Pixels need the ResNet: the port's default ``init_params`` is
    feature mode (no ``cnn``), and encoding ``img_tensors`` with it fails
    for want of ``cnn``.  (The name is older than encode from pixels,
    which tests/test_torch_pixels.py holds.)"""
    p = setup["tm"].init_params(torch.Generator().manual_seed(0))
    assert "cnn" not in p and setup["tm"].has_cnn
    with pytest.raises(KeyError, match="cnn"):
        setup["tm"].encode(p, {"img_tensors": torch.zeros(
            2, 8, 8, 3, dtype=torch.uint8)},
            model_state={"cnn_stats": None})


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_quantized_params_carry_across(setup):
    """The port quantizes the carried float params to the JAX package's
    int8 (the head's column norm may move a value by one step): the cell
    at K = embed + hidden, the head; ``img_embed`` and ``embed`` stay
    float."""
    tq = setup["tm"].quantize_decode_params(from_jax(setup["p"]))
    assert setup["tm"].decode_quant_paths == setup["jm"].decode_quant_paths \
        == PATHS
    for path in PATHS:
        got, want = _at(tq, path), _at(setup["q"], path)
        assert set(got) == {"q", "s", "b"}
        assert tuple(got["q"].shape) == want["q"].shape
        dq = np.abs(got["q"].numpy().astype(np.int32)
                    - want["q"].astype(np.int32))
        assert dq.max() <= (0 if path == ("lstm",) else 1), path
        np.testing.assert_allclose(got["s"].numpy(), want["s"], rtol=1e-6,
                                   atol=0, err_msg=str(path))
    assert tq["lstm"]["q"].shape[0] >= DIMS["embed_dim"] + DIMS["hidden_dim"]
    assert "v" in tq["img_embed"] and "table" in tq["embed"]


def test_int8_init_and_step_match_jax(setup, kernels):
    """The int8 step -1 cell and one int8 step: K3 over [x, h], the gate
    math in x's dtype; encode prepares no K2 weights."""
    jm, tm, np_q = setup["jm"], setup["tm"], setup["q"]
    jenc, tenc = _encode_both(setup, np_q)
    assert tenc.extras == {}
    for n, got in setup["tm"].init_state(from_jax(np_q), tenc).items():
        _close(got, jm.init_state(_jax_tree(np_q), jenc)[n], 1e-5, n)
    rng = np.random.default_rng(12)
    state = _state(rng, (B,))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, _ = jm.step_core(_jax_tree(np_q), jenc, _jax_tree(state),
                                jnp.asarray(toks))
    tpre, tst, tal = tm.step_core(from_jax(np_q), tenc, from_jax(state),
                                  torch.from_numpy(toks).long())
    assert tal is None
    _close(tpre, jpre, 1e-5, "pre-logits")
    for n in ("h", "c"):
        _close(tst[n], jst[n], 1e-5, n)


def _spy_k3(monkeypatch):
    """Records (rows, K) of every K3 call of the port and counts the JAX
    package's Pallas K3 traces; K2 must not be called."""
    seen, jax_calls = [], []
    plain = quant.quant_matmul_plain
    monkeypatch.setattr(quant, "quant_matmul_plain",
                        lambda x, qp: seen.append(
                            x.reshape(-1, x.shape[-1]).shape)
                        or plain(x, qp))
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused", None)
    jfn = jax_quant._matmul_pallas
    monkeypatch.setattr(jax_quant, "_matmul_pallas",
                        lambda *a, **kw: jax_calls.append(1) or jfn(*a, **kw))
    return seen, jax_calls


@pytest.mark.parametrize("quantized_by", ["jax", "port"])
def test_int8_greedy_matches_jax(setup, kernels, quantized_by, monkeypatch):
    """Ids identical to the JAX package's int8 greedy decode (its K3 and
    K1-int8 in interpret mode), on its int8 tree carried across and on the
    port's own quantization of the carried float params.  K3 runs once at
    init and once a step, at B rows and K = embed + hidden; K2 never; the
    CPU launches nothing."""
    seen, jax_calls = _spy_k3(monkeypatch)
    jids, _ = JS.make_greedy_decode(setup["jm"], max_len=STEPS,
                                    return_alphas=True)(
        _jax_tree(setup["q"]), {}, _jax_tree(setup["vis"]))
    assert jax_calls
    tm = setup["tm"]
    tparams = (from_jax(setup["q"]) if quantized_by == "jax"
               else tm.quantize_decode_params(from_jax(setup["p"])))
    counts = [c.n for c in (quant.COUNT, fused_head.COUNT)]
    tids, tal = TS.make_greedy_decode(tm, max_len=STEPS, return_alphas=True,
                                      device="cpu")(tparams, {},
                                                    from_jax(setup["vis"]))
    assert tal is None
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    steps = int((tids != PAD_ID).any(dim=0).sum())
    k = DIMS["embed_dim"] + DIMS["hidden_dim"]
    assert seen == [(B, k)] * (steps + 1)
    assert [c.n for c in (quant.COUNT, fused_head.COUNT)] == counts


@pytest.mark.parametrize("ending", [False, True])
def test_int8_beam3_matches_jax(setup, kernels, ending, monkeypatch):
    """Beam-3 ids identical to the JAX package's int8 beam decode, on the
    random params and on params whose int8 head's ``<end>`` bias ends beams
    at every step; K3 runs over B*3 rows (the init cell too) and K2
    never."""
    np_q = (_raise_end(setup["tm"], setup["q"], setup["vis"], B) if ending
            else setup["q"])
    seen, _ = _spy_k3(monkeypatch)
    jids, jal = _jax_beam(setup, np_q, 3, STEPS, alphas=True)
    tids, tal = _port_beam(setup, np_q, 3, STEPS, alphas=True)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)
    assert (tal == 0).all() and tal.shape == jal.shape == (B, STEPS, 1)
    assert {s[0] for s in seen} == {B * 3}
    if ending:
        assert (tids[:, 1:] == END_ID).any(axis=1).sum() >= B // 4


@pytest.mark.parametrize("switch", ["off", "auto", "interpret"])
def test_int8_kv_switch_changes_nothing(setup, switch, monkeypatch):
    """``SICZ_TPU_INT8_KV`` is AoA's switch: NIC has no K/V, the decode
    gives the same ids whatever it says, and K4 is never called."""
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "off")
    fn = TS.make_beam_decode(setup["tm"], beam_size=3, max_steps=4,
                             device="cpu")
    ref = fn(from_jax(setup["q"]), {}, from_jax(setup["vis"]))
    monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
    assert torch.equal(fn(from_jax(setup["q"]), {}, from_jax(setup["vis"])),
                       ref)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_bf16_int8_decode_casts_inputs_and_keeps_int8_types(setup, decoder):
    """The int8 serving decode as served: bf16 activations over the int8
    hot set (q int8, s and b float32 through the cast; ``img_embed`` and
    ``embed`` bf16); ids in range, the params not changed in place."""
    tq = from_jax(setup["q"])
    cast = TS._cast_floats(tq, BF)
    for path in PATHS:
        layer = _at(cast, path)
        assert layer["q"].dtype == torch.int8, path
        assert layer["s"].dtype == layer["b"].dtype == torch.float32, path
    assert cast["img_embed"]["v"].dtype == cast["embed"]["table"].dtype == BF
    make = (TS.make_greedy_decode if decoder == "greedy"
            else TS.make_beam_decode)
    kw = (dict(max_len=4) if decoder == "greedy"
          else dict(beam_size=3, max_steps=4))
    ids = make(setup["tm"], dtype=BF, device="cpu", **kw)(
        tq, {}, from_jax(setup["vis"]))
    assert ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < DIMS["vocab_size"]
    assert tq["embed"]["table"].dtype == torch.float32      # not in place


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def test_bf16_step_matches_jax(setup, kernels):
    """A bf16 init cell and one bf16 lanes step (k = 3, B = 16) against the
    JAX package's interpret-mode cell: within one bf16 ulp."""
    jm, tm, p = setup["jm"], setup["tm"], setup["p"]
    vis = _visual(B_BF16, seed=21)
    jp = JS._cast_floats(_jax_tree(p), jnp.bfloat16)
    jenc, _ = jm.encode(jp, JS._cast_floats(_jax_tree(vis), jnp.bfloat16))
    tp = TS._cast_floats(from_jax(p), BF)
    tenc, _ = tm.encode(tp, TS._cast_floats(from_jax(vis), BF))
    f = lambda x: np.asarray(jnp.asarray(x, jnp.float32))    # noqa: E731
    jl, tl = jm.init_lane_state(jp, jenc, 3), tm.init_lane_state(tp, tenc, 3)
    rng = np.random.default_rng(13)
    toks = rng.integers(4, DIMS["vocab_size"], size=(B_BF16, 3))
    jpre, jst, _ = jm.step_lanes_core(jp, jenc, jl,
                                      jnp.asarray(toks, jnp.int32))
    tpre, tst, _ = tm.step_lanes_core(tp, tenc, tl,
                                      torch.from_numpy(toks).long())
    assert tpre.dtype == tst["h"].dtype == tl["c"].dtype == BF
    for name, got, want in [("pre", tpre, jpre)] + [
            (n, tst[n], jst[n]) for n in ("h", "c")] + [
            ("init " + n, tl[n], jl[n]) for n in ("h", "c")]:
        np.testing.assert_allclose(got.float().numpy(), f(want), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def test_bf16_greedy_matches_jax_or_differs_at_a_near_tie(setup, kernels):
    """bf16 greedy against the JAX package's interpret-mode kernels (B =
    16): ids identical, or each differing row's first difference at an id
    whose float32 logit (the port's step after the common prefix) is
    within ``GAP_TOL`` of the port's pick."""
    jm, tm, p = setup["jm"], setup["tm"], setup["p"]
    vis = _visual(B_BF16, seed=21)
    jids = np.asarray(JS.make_greedy_decode(jm, max_len=STEPS,
                                            dtype=jnp.bfloat16)(
        _jax_tree(p), {}, _jax_tree(vis)))
    tids = TS.make_greedy_decode(tm, max_len=STEPS, dtype=BF,
                                 device="cpu")(from_jax(p), {},
                                               from_jax(vis)).numpy()
    assert tids.shape == jids.shape == (B_BF16, STEPS)
    differ = np.flatnonzero((tids != jids).any(axis=1))
    assert len(differ) <= B_BF16 // 4, differ
    if not len(differ):
        return
    params = TS._cast_floats(from_jax(p), BF)
    enc, _ = tm.encode(params, TS._cast_floats(from_jax(vis), BF))
    head = fused_head.prepare_head(params["predict"], BF)
    first = {int(i): int(np.flatnonzero(tids[i] != jids[i])[0])
             for i in differ}
    state = tm.init_state(params, enc)
    tok = torch.full((B_BF16,), STA_ID, dtype=torch.long)
    with torch.no_grad():
        for t in range(max(first.values()) + 1):
            hidden, state, _ = tm.step_core(params, enc, state, tok)
            logits = fused_head.logits_plain(head, hidden)
            for i, ti in first.items():
                if ti == t:
                    gap = float(logits[i, tids[i, t]] - logits[i, jids[i, t]])
                    assert 0 <= gap < GAP_TOL, (i, t, gap)
            tok = torch.from_numpy(tids[:, t]).long()


def test_bf16_beam3_matches_jax_or_differs_at_a_near_tie(setup, kernels):
    """bf16 beam 3 (B = 16) against the JAX package's interpret-mode
    kernels: ids identical, or, where a row differs, the two winners
    rescored by the port (``decode.sequence_logprob``, float32 log-probs of
    the bf16 step) within ``GAP_TOL``."""
    jm, tm, p = setup["jm"], setup["tm"], setup["p"]
    vis = _visual(B_BF16, seed=21)
    assert jax_fused_head.enabled(
        JS._cast_floats(_jax_tree(p), jnp.bfloat16)["predict"], B_BF16 * 3,
        3, jnp.bfloat16)
    jids = np.asarray(JS.make_beam_decode(jm, beam_size=3, max_steps=STEPS,
                                          dtype=jnp.bfloat16)(
        _jax_tree(p), {}, _jax_tree(vis)))
    tids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS, dtype=BF,
                               device="cpu")(from_jax(p), {},
                                             from_jax(vis)).numpy()
    _check_rows(tids, STEPS, B_BF16)
    assert tids.shape == jids.shape
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
