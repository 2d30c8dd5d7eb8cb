"""AoASpatial in feature mode: config, init tree, encode, one decoder step,
greedy and beam decode (float32, int8 serving, bf16) in
simpleimagecaptionzoo_tpu_torch against the JAX package, same params
(carried by convert.from_jax; the JAX tree built with ``include_cnn=False``)
and same numpy inputs: a 3 x 3 grid of features, no mask, 2 refine layers.

The heads are 64 wide (hidden 128, 2 heads), as at the published width
(hidden 512, 8 heads): the int8 K/V gate (dh % 128) refuses them on both
sides, so int8 serving attends over float K/V and K4 never runs, whatever
``SICZ_TPU_INT8_KV`` says.

Float32 cases run in both of the JAX package's modes (``auto``: every
layer jnp, beam search's full-logits branch; ``interpret``: the LSTM cell
and the fused head through its Pallas kernels in interpret mode).  Float32
and int8: ids identical, pre-logits within 1e-5, alphas within 1e-6.  bf16
(B = 16) under the rule of tests/test_torch_aoa_bf16.py: ids identical, or
a greedy row's first difference at a logit gap below ``GAP_TOL``, a beam
row's two winners, rescored by the port, within ``GAP_TOL``."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu import config as jax_config
from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models import base as jax_base
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import fused_head as jax_fused_head
from simpleimagecaptionzoo_tpu.ops import int8_attention as jax_ia
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
DIMS = dict(model_type="AoASpatial", vocab_size=50, embed_dim=64,
            hidden_dim=128, enc_dim=48, enc_img_size=3, num_heads=2,
            num_refine_layers=2)
B, N, STEPS = 8, 9, 8
TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16
B_BF16 = 16
GAP_TOL = 1e-2                   # tests/test_torch_aoa_bf16.py's rule
PATHS = (("lstm",), ("aoa_dec", "q"), ("aoa_dec", "aoa"), ("predict",))


def _visual(b, seed=11):
    rng = np.random.default_rng(seed)
    return {"spatial_feats": rng.normal(
        size=(b, N, DIMS["enc_dim"])).astype(np.float32)}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _raise_end(tm, p, vis, b):
    """p with the ``<end>`` bias raised to the midpoint of the two middle
    first-step margins: half the lanes end at step 0, and beams end at
    every step."""
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
    """``load_model_config`` reads Configs/Models/AoASpatial.json into the
    port's ModelConfig field for field as the JAX package does (widths 512,
    8 heads, 6 refine layers, a 7 x 7 grid), and ``get_captioner`` builds
    AoASpatial from it."""
    path = os.path.join(ROOT, "Configs", "Models", "AoASpatial.json")
    got = port_config.load_model_config(path, vocab_size=10102)
    want = jax_config.load_model_config(path, vocab_size=10102)
    names = list(JaxModelConfig.__dataclass_fields__)
    assert {f: getattr(got, f) for f in names} == {
        f: getattr(want, f) for f in names}
    assert (got.embed_dim, got.hidden_dim, got.enc_dim, got.num_heads,
            got.num_refine_layers, got.num_pixels) == (512, 512, 2048, 8, 6,
                                                       49)
    assert type(get_captioner(got)).__name__ == "AoASpatialCaptioner"


def test_init_params_tree_matches_jax(setup):
    """The port's init_params draws the JAX package's tree without
    ``cnn`` (``include_cnn=False``; JAX's AoASpatial adds it by
    default)."""
    cfg = JaxModelConfig(**DIMS)
    assert "cnn" in jax.eval_shape(
        lambda k: jax_get(cfg).init_params(k), jax.random.PRNGKey(0))
    mine = setup["tm"].init_params(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(setup["p"])[0]
    want = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]
    assert {jax.tree_util.keystr(k): v.shape for k, v in flat_t} == want
    assert float(mine["predict"]["b"].abs().max()) == 0.0
    assert float(mine["embed"]["table"].abs().max()) <= 0.1


def test_encode_matches_jax(setup, mode):
    """Encode over the unmasked grid: the refined features, their plain
    mean and the hoisted float K/V; the cell's prepared weights."""
    jenc, tenc = _encode_both(setup)
    assert tenc.mask is None and jenc.mask is None
    assert set(tenc.extras) == {"k_proj", "v_proj", "lstm_cat"}
    assert tenc.features.shape == (B, N, DIMS["hidden_dim"])
    _close(tenc.mean, tenc.features.mean(dim=1).numpy(), 1e-6, "plain mean")
    for name, j, t in (("features", jenc.features, tenc.features),
                       ("mean", jenc.mean, tenc.mean),
                       ("k_proj", jenc.extras["k_proj"],
                        tenc.extras["k_proj"]),
                       ("v_proj", jenc.extras["v_proj"],
                        tenc.extras["v_proj"])):
        assert t.shape == j.shape, name
        _close(t, j, 1e-5, name)


def _state(rng, shape):
    return {n: (0.5 * rng.normal(size=shape + (DIMS["hidden_dim"],))).astype(
        np.float32) for n in ("h", "m", "ctx")}


def test_one_step_matches_jax(setup, mode, monkeypatch):
    """One step on the same state and tokens: pre-logits and state within
    1e-5, attention within 1e-6 and summing to 1 over the 9 regions; the
    float branch of ``_attend`` runs (K4 never)."""
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    jenc, tenc = _encode_both(setup)
    rng = np.random.default_rng(12)
    state = _state(rng, (B,))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = setup["jm"].step_core(_jax_tree(setup["p"]), jenc,
                                           _jax_tree(state), jnp.asarray(toks))
    tpre, tst, tal = setup["tm"].step_core(from_jax(setup["p"]), tenc,
                                           from_jax(state),
                                           torch.from_numpy(toks).long())
    assert tal.shape == (B, N)
    _close(tpre, jpre, 1e-5, "pre-logits")
    _close(tal, jal, 1e-6, "alpha")
    _close(tal.sum(-1), np.ones(B), 1e-6, "alpha sums")
    for n in ("h", "m", "ctx"):
        _close(tst[n], jst[n], 1e-5, n)


@pytest.mark.parametrize("which", ["aoa", "default"])
def test_step_lanes_core_matches_jax(setup, mode, which):
    """AoA's shared-K/V lanes step, and the base class's default, against
    the JAX package's same method: pre-logits and state within 1e-5,
    attention within 1e-6; the state contiguous (B, k, H)."""
    jenc, tenc = _encode_both(setup)
    k = 3
    rng = np.random.default_rng(15)
    state = _state(rng, (B, k))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B, k)).astype(np.int32)
    jm, tm = setup["jm"], setup["tm"]
    if which == "aoa":
        jfn, tfn = jm.step_lanes_core, tm.step_lanes_core
    else:
        jfn = lambda *a, **kw: jax_base.Captioner.step_lanes_core(  # noqa
            jm, *a, **kw)
        tfn = lambda *a, **kw: torch_base.Captioner.step_lanes_core(  # noqa
            tm, *a, **kw)
    jpre, jst, jal = jfn(_jax_tree(setup["p"]), jenc, _jax_tree(state),
                         jnp.asarray(toks))
    tpre, tst, tal = tfn(from_jax(setup["p"]), tenc, from_jax(state),
                         torch.from_numpy(toks).long())
    assert tpre.shape == (B, k, DIMS["hidden_dim"]) and tal.shape == (B, k, N)
    _close(tpre, jpre, 1e-5, "pre-logits")
    _close(tal, jal, 1e-6, "alpha")
    for n in ("h", "m", "ctx"):
        assert tst[n].shape == (B, k, DIMS["hidden_dim"])
        assert tst[n].is_contiguous(), n
        _close(tst[n], jst[n], 1e-5, n)


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

def _greedy_both(setup, params, max_len):
    jids, jal = JS.make_greedy_decode(setup["jm"], max_len=max_len,
                                      return_alphas=True)(
        _jax_tree(params), {}, _jax_tree(setup["vis"]))
    tids, tal = TS.make_greedy_decode(setup["tm"], max_len=max_len,
                                      return_alphas=True, device="cpu")(
        from_jax(params), {}, from_jax(setup["vis"]))
    return np.asarray(jids), np.asarray(jal), tids.numpy(), tal.numpy()


def test_greedy_matches_jax(setup, mode, monkeypatch):
    """Greedy ids identical to the JAX package's, alphas within 1e-6; in
    ``interpret`` mode its step runs the cell and the head through its
    Pallas kernels, in ``auto`` neither."""
    seen = {"lstm": 0, "head": 0}
    for mod, name, key in ((jax_pallas_lstm, "lstm_cell_fused", "lstm"),
                           (jax_fused_head, "_run_kernel", "head")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **kw: (
            seen.__setitem__(_k, seen[_k] + 1) or _f(*a, **kw)))
    jids, jal, tids, tal = _greedy_both(setup, setup["p"], STEPS)
    if mode == "interpret":
        assert seen["lstm"] >= 1 and seen["head"] >= 1, seen
    else:
        assert seen == {"lstm": 0, "head": 0}
    assert tids.shape == (B, STEPS) and tal.shape == (B, STEPS, N)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    live = tal.sum(-1) > 0
    np.testing.assert_allclose(tal.sum(-1)[live], 1.0, atol=1e-5)


def test_greedy_early_exit_and_padding(setup, mode):
    """Half the lanes emit ``<end>`` at step 0: the loop runs on, finished
    lanes are padded with ``<pad>`` and their alphas are 0, ids and alphas
    as the JAX package's.  Then every lane ends at step 0 and the loop
    stops after one step."""
    params = setup["ending"]
    jids, jal, tids, tal = _greedy_both(setup, params, 12)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    ended = tids[:, 0] == END_ID
    assert ended.sum() == B // 2
    assert (tids[ended, 1:] == PAD_ID).all() and (tal[ended, 1:] == 0).all()

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


def test_greedy_runs_the_cell_through_k2_each_step(setup, monkeypatch):
    """Each float step calls K2's wrapper once, at x = [emb, ctx] (embed +
    hidden), with encode's prepared weights; no call at init (AoA's state
    starts at zeros); the CPU launches nothing."""
    seen = []
    fused = fused_lstm.lstm_cell_fused
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused",
                        lambda w, b, x, h, c, split=None: seen.append(
                            (tuple(w.shape), tuple(x.shape)))
                        or fused(w, b, x, h, c, split))
    before = fused_lstm.COUNT.n, fused_head.COUNT.n
    ids = TS.make_greedy_decode(setup["tm"], max_len=3, device="cpu")(
        from_jax(setup["p"]), {}, from_jax(setup["vis"]))
    e, h = DIMS["embed_dim"] + DIMS["hidden_dim"], DIMS["hidden_dim"]
    steps = int((ids != PAD_ID).any(dim=0).sum())
    assert seen == [((e + h, 4 * h), (B, e))] * steps
    assert (fused_lstm.COUNT.n, fused_head.COUNT.n) == before


# ---------------------------------------------------------------------------
# beam
# ---------------------------------------------------------------------------

def _jax_beam(setup, params, beam, steps, alphas=False):
    out = JS.make_beam_decode(setup["jm"], beam_size=beam, max_steps=steps,
                              return_alphas=alphas)(
        _jax_tree(params), {}, _jax_tree(setup["vis"]))
    return (tuple(np.asarray(o) for o in out) if alphas
            else np.asarray(out))


def _port_beam(setup, params, beam, steps, alphas=False):
    out = TS.make_beam_decode(setup["tm"], beam_size=beam, max_steps=steps,
                              return_alphas=alphas, device="cpu")(
        from_jax(params), {}, from_jax(setup["vis"]))
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
    jids = _jax_beam(setup, setup["p"], 3, STEPS)
    tids = _port_beam(setup, setup["p"], 3, STEPS)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)


def test_return_alphas_matches_jax(setup, kernels):
    """Beam alphas as the JAX package's within 1e-6, summing to 1 over the
    grid on live steps."""
    jids, jal = _jax_beam(setup, setup["ending"], 3, STEPS, alphas=True)
    tids, tal = _port_beam(setup, setup["ending"], 3, STEPS, alphas=True)
    assert tal.shape == (B, STEPS, N) and tal.dtype == np.float32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    live = tal.sum(-1) > 0
    assert live.any()
    np.testing.assert_allclose(tal.sum(-1)[live], 1.0, atol=1e-5)


def _trim(row):
    out = []
    for t in row:
        out.append(int(t))
        if t == END_ID:
            break
    return out


@pytest.mark.parametrize("ending", [False, True])
def test_beam1_equals_greedy(setup, ending):
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


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_entry_points_default_to_the_gpu(setup, decoder):
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
# int8 serving: float K/V (dh = 64), K3 three times a step, no K4
# ---------------------------------------------------------------------------

def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_int8_kv_gate_refuses_64_wide_heads_on_both_sides(monkeypatch):
    """At the published width (hidden 512, 8 heads, 49 regions, B=384) and
    at this file's (hidden 128, 2 heads, 9 regions) a head is 64 wide: both
    packages' encode gate refuses int8 K/V with the switch on; 128-wide
    heads pass it on both sides."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    for b, n, d, heads, want in ((384, 49, 512, 8, False),
                                 (B, N, DIMS["hidden_dim"], 2, False),
                                 (384, 49, 512, 4, True)):
        assert jax_ia.encode_should_quantize(b, n, d, heads) == want
        for switch in ("auto", "interpret"):
            monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
            assert int8_attention.encode_should_quantize(b, n, d,
                                                         heads) == want
        monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")


def test_quantized_params_carry_across(setup):
    """The port quantizes the carried float params to the JAX package's
    int8 (the head's column norm may move a value by one step)."""
    tq = setup["tm"].quantize_decode_params(from_jax(setup["p"]))
    assert setup["tm"].decode_quant_paths == setup["jm"].decode_quant_paths \
        == PATHS
    for path in PATHS:
        got, want = _at(tq, path), _at(setup["q"], path)
        assert set(got) == {"q", "s", "b"}
        assert tuple(got["q"].shape) == want["q"].shape
        dq = np.abs(got["q"].numpy().astype(np.int32)
                    - want["q"].astype(np.int32))
        assert dq.max() <= (1 if path == ("predict",) else 0), path
        np.testing.assert_allclose(got["s"].numpy(), want["s"], rtol=1e-6,
                                   atol=0, err_msg=str(path))


@pytest.mark.parametrize("switch", ["off", "auto"])
def test_int8_encode_keeps_float_kv(setup, kernels, switch, monkeypatch):
    """With the int8 params, encode stores the float K/V whatever the
    switch says (JAX: its ``interpret``, which stores int8 K/V for 128-wide
    heads), and no K2 weights."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", switch)
    tenc, _ = setup["tm"].encode(from_jax(setup["q"]), from_jax(setup["vis"]))
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    jenc, _ = setup["jm"].encode(_jax_tree(setup["q"]),
                                 _jax_tree(setup["vis"]))
    assert set(tenc.extras) == set(jenc.extras) == {"k_proj", "v_proj"}
    for name in ("k_proj", "v_proj"):
        assert tenc.extras[name].dtype == torch.float32
        _close(tenc.extras[name], jenc.extras[name], 1e-5, name)


def test_int8_one_step_matches_jax(setup, kernels, monkeypatch):
    """One int8 step (switch on): the cell, aoa_dec.q and aoa_dec.aoa
    through K3, the attention over the float K/V (K4 never)."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    jenc, tenc = _encode_both(setup, setup["q"])
    rng = np.random.default_rng(12)
    state = _state(rng, (B,))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = setup["jm"].step_core(_jax_tree(setup["q"]), jenc,
                                           _jax_tree(state), jnp.asarray(toks))
    tpre, tst, tal = setup["tm"].step_core(from_jax(setup["q"]), tenc,
                                           from_jax(state),
                                           torch.from_numpy(toks).long())
    _close(tpre, jpre, 1e-5, "pre-logits")
    _close(tal, jal, 1e-6, "alpha")
    for n in ("h", "m", "ctx"):
        _close(tst[n], jst[n], 1e-5, n)


def _spy_k3(monkeypatch):
    """Records (rows, K) of every K3 call of the port and counts the JAX
    package's Pallas K3 traces; K2 and K4 must not be called."""
    seen, jax_calls = [], []
    plain = quant.quant_matmul_plain
    monkeypatch.setattr(quant, "quant_matmul_plain",
                        lambda x, qp: seen.append(
                            x.reshape(-1, x.shape[-1]).shape)
                        or plain(x, qp))
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused", None)
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    jfn = jax_quant._matmul_pallas
    monkeypatch.setattr(jax_quant, "_matmul_pallas",
                        lambda *a, **kw: jax_calls.append(1) or jfn(*a, **kw))
    return seen, jax_calls


@pytest.mark.parametrize("quantized_by", ["jax", "port"])
def test_int8_greedy_matches_jax(setup, kernels, quantized_by, monkeypatch):
    """Ids identical to the JAX package's int8 greedy decode (its K3 and
    K1-int8 in interpret mode, ``SICZ_TPU_INT8_KV=interpret``; the port's
    switch ``auto``), on its int8 tree and on the port's quantization of
    the carried float params.  Each step calls K3 three times (the cell's
    [x, h], aoa_dec.q, aoa_dec.aoa), never K2 or K4."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    seen, jax_calls = _spy_k3(monkeypatch)
    jids, jal = JS.make_greedy_decode(setup["jm"], max_len=STEPS,
                                      return_alphas=True)(
        _jax_tree(setup["q"]), {}, _jax_tree(setup["vis"]))
    assert jax_calls
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tm = setup["tm"]
    tparams = (from_jax(setup["q"]) if quantized_by == "jax"
               else tm.quantize_decode_params(from_jax(setup["p"])))
    counts = [c.n for c in (quant.COUNT, fused_head.COUNT)]
    tids, tal = TS.make_greedy_decode(tm, max_len=STEPS, return_alphas=True,
                                      device="cpu")(tparams, {},
                                                    from_jax(setup["vis"]))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
    e, h = DIMS["embed_dim"], DIMS["hidden_dim"]
    steps = int((tids != PAD_ID).any(dim=0).sum())
    assert seen == [(B, e + 2 * h), (B, h), (B, 2 * h)] * steps
    assert [c.n for c in (quant.COUNT, fused_head.COUNT)] == counts


@pytest.mark.parametrize("ending", [False, True])
def test_int8_beam3_matches_jax(setup, kernels, ending, monkeypatch):
    """Beam-3 ids identical to the JAX package's int8 beam decode (switch
    on), on the random params and on params whose int8 head's ``<end>``
    bias ends beams at every step; K3 over B*3 rows, K2 and K4 never."""
    np_q = (_raise_end(setup["tm"], setup["q"], setup["vis"], B) if ending
            else setup["q"])
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "interpret")
    seen, _ = _spy_k3(monkeypatch)
    jids, jal = _jax_beam(setup, np_q, 3, STEPS, alphas=True)
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    tids, tal = _port_beam(setup, np_q, 3, STEPS, alphas=True)
    _check_rows(tids, STEPS)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, **TOL)
    assert {s[0] for s in seen} == {B * 3}
    if ending:
        assert (tids[:, 1:] == END_ID).any(axis=1).sum() >= B // 4


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_bf16_int8_decode_casts_inputs_and_keeps_int8_types(setup, decoder,
                                                            monkeypatch):
    """The int8 serving decode as served (bf16 activations, switch on):
    the int8 layers keep their types, the float K/V are bf16, K4 never
    runs; ids in range, the params not changed in place."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    monkeypatch.setattr(int8_attention, "lanes_attention_int8", None)
    tq = from_jax(setup["q"])
    cast = TS._cast_floats(tq, BF)
    for path in PATHS:
        layer = _at(cast, path)
        assert layer["q"].dtype == torch.int8, path
        assert layer["s"].dtype == layer["b"].dtype == torch.float32, path
    enc, _ = setup["tm"].encode(cast, TS._cast_floats(from_jax(setup["vis"]),
                                                      BF))
    assert enc.extras["k_proj"].dtype == BF and "k_q" not in enc.extras
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

def test_bf16_lanes_step_matches_jax(setup, kernels):
    """One bf16 lanes step (k = 3, B = 16) on the same bf16 encoding, state
    and tokens as the JAX package's interpret-mode step: pre-logits, state
    and attention within one bf16 ulp (rtol = atol = 1e-2)."""
    jm, tm, p = setup["jm"], setup["tm"], setup["p"]
    vis = _visual(B_BF16, seed=21)
    jp = JS._cast_floats(_jax_tree(p), jnp.bfloat16)
    jenc, _ = jm.encode(jp, JS._cast_floats(_jax_tree(vis), jnp.bfloat16))
    tp = TS._cast_floats(from_jax(p), BF)
    tenc, _ = tm.encode(tp, TS._cast_floats(from_jax(vis), BF))
    f = lambda x: np.array(jnp.asarray(x, jnp.float32))      # noqa: E731
    # the same bf16 encoding on both sides (the refiner's sums differ by an
    # ulp; a step is held here, encode in tests/test_torch_aoa_bf16.py)
    tenc = dataclasses.replace(
        tenc, features=torch.from_numpy(f(jenc.features)).to(BF),
        mean=torch.from_numpy(f(jenc.mean)).to(BF),
        extras=dict(tenc.extras, **{
            n: torch.from_numpy(f(jenc.extras[n])).to(BF)
            for n in ("k_proj", "v_proj")}))
    rng = np.random.default_rng(13)
    state = {n: (0.5 * rng.normal(size=(B_BF16, 3, DIMS["hidden_dim"])))
             .astype(np.float32) for n in ("h", "m", "ctx")}
    toks = rng.integers(4, DIMS["vocab_size"], size=(B_BF16, 3))
    jpre, jst, jal = jm.step_lanes_core(
        jp, jenc, JS._cast_floats(_jax_tree(state), jnp.bfloat16),
        jnp.asarray(toks, jnp.int32))
    tpre, tst, tal = tm.step_lanes_core(
        tp, tenc, TS._cast_floats(from_jax(state), BF),
        torch.from_numpy(toks).long())
    assert tpre.dtype == tst["h"].dtype == BF
    for name, got, want in [("pre", tpre, jpre), ("alpha", tal, jal)] + [
            (n, tst[n], jst[n]) for n in ("h", "m", "ctx")]:
        np.testing.assert_allclose(got.float().numpy(), f(want), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def test_bf16_greedy_matches_jax_or_differs_at_a_near_tie(setup, kernels):
    """bf16 greedy against the JAX package's interpret-mode kernels (B =
    16): ids identical, or each differing row's first difference at an id
    whose float32 logit (the port's step after the common prefix) is within
    ``GAP_TOL`` of the port's pick."""
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
    rescored by the port within ``GAP_TOL``."""
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
