"""BUTDDetection and BUTDSpatial in feature mode: config, encode, one
decoder step and greedy decode in simpleimagecaptionzoo_tpu_torch against
the JAX package, same params (carried by convert.from_jax) and same numpy
inputs.

Each float32 case runs in both of the JAX package's modes: ``auto``, where
off the TPU its encode hoists the attention cell's ``mean`` rows
(``td_mean_gates``) and every layer is jnp, and ``interpret``, where both
cells and the head run its Pallas kernels in interpret mode over the full
concat.  The port runs one function in both (the cell over the full
concat).  Float32: ids identical, pre-logits within 1e-5, attention within
1e-6.  bf16 (B = 16, which the JAX package's bf16 kernel gates need), under
the rule of tests/test_torch_aoa_bf16.py: greedy ids identical, or each
row's first difference at an id whose float32 logit is within
``GAP_TOL`` of the port's pick."""
import glob
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
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch import config as port_config
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, fused_lstm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("BUTDDetection", "BUTDSpatial")
DIMS = dict(vocab_size=50, embed_dim=64, hidden_dim=128, atten_dim=32,
            enc_dim=48, enc_img_size=3)
B, N_BOX, MAX_LEN = 8, 5, 8
N_OF = {"BUTDDetection": N_BOX, "BUTDSpatial": 9}     # 3 x 3 grid
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


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    family = request.param
    cfg = dict(DIMS, model_type=family)
    jm = jax_get(JaxModelConfig(**cfg))
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), include_cnn=False))
    tm = get_captioner(ModelConfig(**cfg))
    return family, jm, tm, np_params, _visual(family, B)


@pytest.fixture(params=["auto", "interpret"])
def mode(request, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", request.param)
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", request.param)
    return request.param


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


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


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("family", FAMILIES)
def test_model_config_loads_as_jax(family):
    """``load_model_config`` reads Configs/Models/<family>.json into the
    port's ModelConfig field for field as the JAX package does, and
    ``get_captioner`` builds the family from it."""
    path = os.path.join(ROOT, "Configs", "Models", family + ".json")
    got = port_config.load_model_config(path, vocab_size=10102)
    want = jax_config.load_model_config(path, vocab_size=10102)
    names = [f for f in JaxModelConfig.__dataclass_fields__]
    assert {f: getattr(got, f) for f in names} == {
        f: getattr(want, f) for f in names}
    assert (got.embed_dim, got.hidden_dim, got.atten_dim, got.enc_dim) == (
        1024, 1024, 1024, 2048)
    assert type(get_captioner(got)).__name__ == family + "Captioner"


def test_every_family_config_the_port_serves_is_registered():
    """All five families of Configs/Models/*.json build through
    ``get_captioner``."""
    served = []
    for path in sorted(glob.glob(os.path.join(ROOT, "Configs", "Models",
                                              "*.json"))):
        cfg = port_config.load_model_config(path, vocab_size=50)
        served.append(type(get_captioner(cfg)).__name__)
    assert sorted(served) == ["AoADetectionCaptioner",
                              "AoASpatialCaptioner",
                              "BUTDDetectionCaptioner",
                              "BUTDSpatialCaptioner", "NICCaptioner"]


def test_init_params_tree_matches_jax(setup):
    """The port's init_params draws the JAX package's tree and shapes."""
    _, _, tm, p, _ = setup
    gen = torch.Generator().manual_seed(0)
    mine = tm.init_params(gen)
    flat_j = jax.tree_util.tree_flatten_with_path(p)[0]
    want = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]
    got = {jax.tree_util.keystr(k): v.shape for k, v in flat_t}
    assert got == want
    assert float(mine["predict"]["b"].abs().max()) == 0.0
    assert float(mine["embed"]["table"].abs().max()) <= 0.1


def test_encode_matches_jax(setup, mode):
    family, jm, tm, p, vis = setup
    jenc, _ = jm.encode(_jax_tree(p), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(p), from_jax(vis))
    assert ("td_mean_gates" in jenc.extras) == (mode == "auto")
    assert set(tenc.extras) == {"att_keys", "td_cat", "lang_cat"}
    assert (tenc.mask is None) == (family == "BUTDSpatial")
    for name, j, t in (("features", jenc.features, tenc.features),
                       ("mean", jenc.mean, tenc.mean),
                       ("att_keys", jenc.extras["att_keys"],
                        tenc.extras["att_keys"])):
        assert t.shape == j.shape, name
        _close(t, j, 1e-5, name)


def _state(rng, shape):
    return {n: (0.5 * rng.normal(size=shape + (DIMS["hidden_dim"],))).astype(
        np.float32) for n in ("h1", "c1", "h2", "c2")}


def test_one_step_matches_jax(setup, mode):
    """One step on the same state and tokens: pre-logits and the four state
    tensors within 1e-5, attention within 1e-6."""
    _, jm, tm, p, vis = setup
    jenc, _ = jm.encode(_jax_tree(p), _jax_tree(vis))
    tenc, _ = tm.encode(from_jax(p), from_jax(vis))
    rng = np.random.default_rng(12)
    state = _state(rng, (B,))
    toks = rng.integers(4, DIMS["vocab_size"], size=(B,)).astype(np.int32)
    jpre, jst, jal = jm.step_core(_jax_tree(p), jenc, _jax_tree(state),
                                  jnp.asarray(toks))
    tpre, tst, tal = tm.step_core(from_jax(p), tenc, from_jax(state),
                                  torch.from_numpy(toks).long())
    _close(tpre, jpre, 1e-5, "pre-logits")
    _close(tal, jal, 1e-6, "alpha")
    for n in ("h1", "c1", "h2", "c2"):
        _close(tst[n], jst[n], 1e-5, n)


def _greedy_both(setup, params, max_len):
    _, jm, tm, _, vis = setup
    jids, jal = JS.make_greedy_decode(jm, max_len=max_len,
                                      return_alphas=True)(
        _jax_tree(params), {}, _jax_tree(vis))
    tids, tal = TS.make_greedy_decode(tm, max_len=max_len,
                                      return_alphas=True, device="cpu")(
        from_jax(params), {}, from_jax(vis))
    return np.asarray(jids), np.asarray(jal), tids.numpy(), tal.numpy()


def test_greedy_matches_jax(setup, mode, monkeypatch):
    """Greedy ids identical to the JAX package's; in ``interpret`` mode its
    step runs both cells and the head through its Pallas kernels, in
    ``auto`` none of them."""
    family = setup[0]
    traced = _spy_jax_kernels(monkeypatch)
    jids, jal, tids, tal = _greedy_both(setup, setup[3], MAX_LEN)
    if mode == "interpret":
        assert traced["lstm"] >= 2 and traced["head"] >= 1, traced
    else:
        assert traced == {"lstm": 0, "head": 0}
    assert tids.shape == (B, MAX_LEN) and tal.shape == (B, MAX_LEN,
                                                        N_OF[family])
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    if family == "BUTDDetection":
        assert (tal[0, :, 3:] == 0).all()          # the padded boxes


def _ending_params(setup):
    """The params with the ``<end>`` bias raised to the midpoint of the two
    middle first-step margins: half the lanes end at step 0."""
    _, _, tm, p, vis = setup
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


def test_greedy_early_exit_and_padding(setup, mode):
    """Half the lanes emit ``<end>`` at step 0: the loop runs on for the
    rest, finished lanes are padded with ``<pad>`` and their alphas are 0,
    and the ids equal the JAX package's.  Then every lane ends at step 0 and
    the loop stops after one step."""
    _, _, tm, _, vis = setup
    params = _ending_params(setup)
    jids, jal, tids, tal = _greedy_both(setup, params, 12)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tal, jal, rtol=1e-6, atol=1e-6)
    ended = tids[:, 0] == END_ID
    assert ended.sum() == B // 2
    assert (tids[ended, 1:] == PAD_ID).all() and (tal[ended, 1:] == 0).all()
    for row in tids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()

    params["predict"]["b"][END_ID] += 1e3
    calls = []
    step_core = tm.step_core
    tm.step_core = lambda *a, **kw: calls.append(1) or step_core(*a, **kw)
    try:
        tids = TS.make_greedy_decode(tm, max_len=12, device="cpu")(
            from_jax(params), {}, from_jax(vis)).numpy()
    finally:
        del tm.step_core
    assert len(calls) == 1
    assert (tids[:, 0] == END_ID).all() and (tids[:, 1:] == PAD_ID).all()


def test_greedy_runs_both_cells_through_k2_each_step(setup, monkeypatch):
    """Each float step calls K2's wrapper twice, at the attention cell's
    and the language cell's widths (x of embed + enc + hidden and of enc +
    hidden), with encode's prepared weights; the CPU launches nothing."""
    _, _, tm, p, vis = setup
    seen = []
    fused = fused_lstm.lstm_cell_fused
    monkeypatch.setattr(fused_lstm, "lstm_cell_fused",
                        lambda w, b, x, h, c, split=None: seen.append(
                            (tuple(w.shape), x.shape[1]))
                        or fused(w, b, x, h, c, split))
    before = fused_lstm.COUNT.n, fused_head.COUNT.n
    ids = TS.make_greedy_decode(tm, max_len=3, device="cpu")(
        from_jax(p), {}, from_jax(vis))
    d, e, h = DIMS["embed_dim"], DIMS["enc_dim"], DIMS["hidden_dim"]
    steps = int((ids != PAD_ID).any(dim=0).sum())
    assert seen == [((d + e + 2 * h, 4 * h), d + e + h),
                    ((e + 2 * h, 4 * h), e + h)] * steps
    assert (fused_lstm.COUNT.n, fused_head.COUNT.n) == before


def test_spatial_from_pixels_is_not_ported():
    """Pixels need the ResNet: the port's default ``init_params`` is
    feature mode (no ``cnn``), and encoding ``img_tensors`` with it fails
    for want of ``cnn``.  (The name is older than encode from pixels,
    which tests/test_torch_pixels.py holds.)"""
    tm = get_captioner(ModelConfig(model_type="BUTDSpatial", **DIMS))
    p = tm.init_params(torch.Generator().manual_seed(0))
    assert "cnn" not in p and tm.has_cnn
    with pytest.raises(KeyError, match="cnn"):
        tm.encode(p, {"img_tensors": torch.zeros(2, 8, 8, 3,
                                                 dtype=torch.uint8)},
                  model_state={"cnn_stats": None})


def test_entry_point_defaults_to_the_gpu(setup):
    """With no CUDA device the default entry point raises; it never falls
    back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_greedy_decode(setup[2])


def test_bf16_greedy_matches_jax_or_differs_at_a_near_tie(setup,
                                                         monkeypatch):
    """bf16 greedy against the JAX package's interpret-mode kernels (B = 16):
    ids identical, or each differing row's first difference at an id whose
    float32 logit (the port's step after the common prefix) is within
    ``GAP_TOL`` of the port's pick.  ``bu_masks`` is cast to bf16 on both
    sides."""
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    family, jm, tm, p, _ = setup
    vis = _visual(family, B_BF16, seed=21)
    if family == "BUTDDetection":
        assert TS._cast_floats(from_jax(vis), BF)["bu_masks"].dtype == BF
    jids = np.asarray(JS.make_greedy_decode(jm, max_len=MAX_LEN,
                                            dtype=jnp.bfloat16)(
        _jax_tree(p), {}, _jax_tree(vis)))
    tids = TS.make_greedy_decode(tm, max_len=MAX_LEN, dtype=BF,
                                 device="cpu")(from_jax(p), {},
                                               from_jax(vis)).numpy()
    assert tids.shape == jids.shape == (B_BF16, MAX_LEN)
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
