"""The JAX default mode's LSTM input hoists in simpleimagecaptionzoo_tpu_torch
against the JAX package: K2 with a per-row gate term (its plain version on
the CPU) against the JAX package's ``lstm_cell_gates``, BUTD's
``td_mean_gates`` and every family's ``tf_inputs``, decode, XE and SCST in
each ``SICZ_TPU_PALLAS_LSTM`` mode against the JAX package in the same mode,
the dropout stream with and without the hoist, the int8 cells (never
hoisted), and K2's routes with a term and at E = 0.  Small widths, float32,
the same numpy inputs on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.models import layers as JLay
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import decode as JD
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch import PAD_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models import layers as TLay
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode as TD
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
from simpleimagecaptionzoo_tpu_torch.ops import losses as TL

NO_DROPOUT = dict(dropout=0.0, dropout_aoa=0.0, dropout_sc=0.0,
                  dropout_dot_atten=0.0)
DIMS = {
    "AoADetection": dict(vocab_size=40, embed_dim=64, hidden_dim=64,
                         enc_dim=48, num_heads=2, num_refine_layers=1,
                         max_bu_len=5),
    "AoASpatial": dict(vocab_size=40, embed_dim=64, hidden_dim=64,
                       enc_dim=48, enc_img_size=3, num_heads=2,
                       num_refine_layers=1),
    "BUTDDetection": dict(vocab_size=40, embed_dim=32, hidden_dim=64,
                          atten_dim=32, enc_dim=48, max_bu_len=5),
    "BUTDSpatial": dict(vocab_size=40, embed_dim=32, hidden_dim=64,
                        atten_dim=32, enc_dim=48, enc_img_size=3),
    "NIC": dict(vocab_size=40, embed_dim=32, hidden_dim=64, enc_dim=48),
}
FAMILIES = tuple(DIMS)
B, T = 6, 7
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _visual(family, rng, b=B):
    enc = DIMS[family]["enc_dim"]
    if family == "NIC":
        return {"features": rng.normal(size=(b, enc)).astype(np.float32)}
    if family.endswith("Detection"):
        n = DIMS[family]["max_bu_len"]
        return {"bu_feats": rng.normal(size=(b, n, enc)).astype(np.float32),
                "bu_masks": np.ones((b, n), np.float32)}
    return {"spatial_feats": rng.normal(size=(b, 9, enc)).astype(
        np.float32)}


def _batch(family, seed=1):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, DIMS[family]["vocab_size"],
                        size=(B, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=(B,)).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    return {"visual": _visual(family, rng), "captions": caps,
            "lengths": lens}


_SETUPS = {}


def _setup(family, dropout=False):
    """(JAX model, port model, numpy params): dropout 0 unless ``dropout``
    (the published rates, for the port alone)."""
    key = (family, dropout)
    if key not in _SETUPS:
        cfg = dict(DIMS[family], model_type=family,
                   **({} if dropout else NO_DROPOUT))
        jm = jax_get(JaxModelConfig(**cfg))
        jp = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
        _SETUPS[key] = (jm, get_captioner(ModelConfig(**cfg)),
                        jax.tree_util.tree_map(np.asarray, jp))
    return _SETUPS[key]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(batch):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), batch)


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=err_msg, **TOL)


# ---------------------------------------------------------------------------
# K2 with a gate term
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,lanes", [(24, 1), (24, 3), (0, 1), (0, 3)])
def test_k2_with_a_term_matches_jax_lstm_cell_gates(e, lanes):
    """K2's plain version with a term (through LstmCell, as a training step
    runs it) against ``layers.lstm_cell_gates`` fed x @ w_kept + the term's
    rows: h' and c' within 1e-6, and the gradients of x, h, c, the term
    (each term row's lanes summed), the kept rows of w_ih, w_hh and b_hh
    within 1e-6."""
    rng = np.random.default_rng(e + lanes)
    hd, rows = 16, 6
    f = lambda *s: (0.5 * rng.normal(size=s)).astype(np.float32)  # noqa
    w_x, w_hh, b_hh = f(e, 4 * hd), f(hd, 4 * hd), f(4 * hd)
    x, h, c, term = f(rows, e), f(rows, hd), f(rows, hd), f(rows // lanes,
                                                            4 * hd)
    r_h, r_c = f(rows, hd), f(rows, hd)

    def jax_loss(w_x, w_hh, b_hh, x, h, c, term):
        gx = x @ w_x + jnp.repeat(term, lanes, axis=0)
        hn, cn = JLay.lstm_cell_gates({"w_hh": w_hh, "b_hh": b_hh}, gx, h, c)
        return jnp.sum(hn * r_h) + jnp.sum(cn * r_c), (hn, cn)

    args = [jnp.asarray(a) for a in (w_x, w_hh, b_hh, x, h, c, term)]
    (_, (jh, jc)), jg = jax.value_and_grad(
        jax_loss, argnums=tuple(range(7)), has_aux=True)(*args)

    ts = [torch.from_numpy(a).requires_grad_()
          for a in (w_x, w_hh, b_hh, x, h, c, term)]
    w_cat = torch.cat([ts[0], ts[1]])
    th, tc = fused_lstm.LstmCell.apply(w_cat, ts[2], ts[3], ts[4], ts[5],
                                       None, None, ts[6], lanes)
    loss = (th * torch.from_numpy(r_h)).sum() + (tc * torch.from_numpy(
        r_c)).sum()
    tg = torch.autograd.grad(loss, ts)
    tol = dict(rtol=1e-6, atol=1e-6)
    for got, want in ((th, jh), (tc, jc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)
    names = ("w_x", "w_hh", "b_hh", "x", "h", "c", "term")
    for name, got, want in zip(names, tg, jg):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **tol)


def test_k2_term_grad_is_d_gates_with_lanes_summed():
    """lstm_cell_bwd_full's d_term: d_gates of lstm_cell_bwd_plain (its
    lanes summed), in the term's dtype; no term, no sixth output."""
    g = torch.Generator().manual_seed(2)
    hd, rows, lanes = 8, 6, 3
    w = torch.randn(8 + hd, 4 * hd, generator=g)
    b = torch.randn(4 * hd, generator=g)
    x, h, c, dh, dc = (torch.randn(rows, n, generator=g)
                       for n in (8, hd, hd, hd, hd))
    term = torch.randn(rows // lanes, 4 * hd, generator=g)
    out = fused_lstm.lstm_cell_bwd_full(w, b, x, h, c, dh, dc, term=term,
                                        lanes=lanes)
    d, dcc = fused_lstm.lstm_cell_bwd_plain(w, b, x, h, c, dh, dc, term,
                                            lanes)
    assert len(out) == 6 and torch.equal(out[4], dcc)
    assert torch.allclose(out[5], d.reshape(-1, lanes, 4 * hd).sum(1),
                          rtol=0, atol=1e-6)
    assert len(fused_lstm.lstm_cell_bwd_full(w, b, x, h, c, dh, dc)) == 5


# ---------------------------------------------------------------------------
# BUTD's td_mean_gates and every family's tf_inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["BUTDDetection", "BUTDSpatial"])
def test_butd_td_mean_gates_and_tf_inputs_match_jax(monkeypatch, family):
    """Leaf for leaf in the default mode: encode's td_mean_gates (mean @
    the mean rows of w_ih + b_ih) within 1e-5 of JAX's, the kept weights
    the JAX package's h2 and emb rows then w_hh exactly (with its TF32
    split), b_sum b_hh; and
    tf_inputs' term JAX's emb_gates + td_mean_gates within 1e-5, its cell
    the h2 rows then w_hh."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p = _setup(family)
    batch = _batch(family)
    jenc, _ = jm.encode(_j(p), _j(batch["visual"]))
    params = from_jax(p)
    tenc, _ = tm.encode(params, _t(batch["visual"]))
    _close(tenc.extras["td_mean_gates"], jenc.extras["td_mean_gates"],
           "td_mean_gates")
    td = params["lstm_td"]
    hd, e = DIMS[family]["hidden_dim"], DIMS[family]["enc_dim"]
    w = tenc.extras["td_cat"]
    assert torch.equal(w.w_cat, torch.cat([td["w_ih"][:hd],
                                           td["w_ih"][hd + e:], td["w_hh"]]))
    assert torch.equal(w.b_sum, td["b_hh"]) and w.split is not None
    toks = batch["captions"][:, :-1].T
    jtf = jm.tf_inputs(_j(p), jenc, jnp.asarray(toks), None)
    ttf = tm.tf_inputs(params, tenc, torch.from_numpy(toks).long(), None)
    _close(ttf["term"], np.asarray(jtf["emb_gates"])
           + np.asarray(jenc.extras["td_mean_gates"]), "tf term")
    assert torch.equal(ttf["cell"].w_cat, torch.cat([td["w_ih"][:hd],
                                                     td["w_hh"]]))


@pytest.mark.parametrize("family", ["AoADetection", "NIC"])
def test_tf_inputs_match_jax(monkeypatch, family):
    """AoA's and NIC's tf_inputs in the default mode: the term JAX's
    gates within 1e-5 (AoA: emb @ w_emb + b_ih, the cell keeping the ctx
    rows; NIC: emb @ w_ih + b_ih, the cell w_hh alone, E = 0)."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p = _setup(family)
    batch = _batch(family)
    jenc, _ = jm.encode(_j(p), _j(batch["visual"]))
    params = from_jax(p)
    tenc, _ = tm.encode(params, _t(batch["visual"]))
    toks = batch["captions"][:, :-1].T
    jtf = jm.tf_inputs(_j(p), jenc, jnp.asarray(toks), None)
    ttf = tm.tf_inputs(params, tenc, torch.from_numpy(toks).long(), None)
    key = "gates_x" if family == "NIC" else "emb_gates"
    _close(ttf["term"], jtf[key], "tf term")
    lstm = params["lstm"]
    kept = ([] if family == "NIC"
            else [lstm["w_ih"][DIMS[family]["embed_dim"]:]])
    assert torch.equal(ttf["cell"].w_cat, torch.cat(kept + [lstm["w_hh"]]))
    assert torch.equal(ttf["cell"].b_sum, lstm["b_hh"])


@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_tf_inputs_follow_the_mode(monkeypatch, mode):
    """tf_inputs is None under interpret for every family, and BUTD's
    encode keeps the whole cell there."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    for family in FAMILIES:
        _, tm, p = _setup(family)
        batch = _batch(family)
        params = from_jax(p)
        enc, _ = tm.encode(params, _t(batch["visual"]))
        toks = torch.from_numpy(batch["captions"][:, :-1].T).long()
        tf = tm.tf_inputs(params, enc, toks, None)
        assert (tf is None) == (mode == "interpret"), family
        if family.startswith("BUTD"):
            assert ("td_mean_gates" in enc.extras) == (mode == "auto")


# ---------------------------------------------------------------------------
# decode, XE and SCST against the JAX package in the same mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_butd_greedy_and_beam_ids_match_jax(monkeypatch, mode):
    """BUTDDetection's greedy and beam-3 ids equal to the JAX package's in
    the same mode (auto: the attention cell over [h2, emb] with
    td_mean_gates as its term, read in place by the beam's lanes)."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", mode)
    jm, tm, p = _setup("BUTDDetection")
    vis = _batch("BUTDDetection")["visual"]
    jenc, _ = jm.encode(_j(p), _j(vis))
    params = from_jax(p)
    tenc, _ = tm.encode(params, _t(vis))
    jg, _ = JD.greedy(jm, _j(p), jenc, max_len=6)
    tg, _ = TD.greedy(tm, params, tenc, max_len=6)
    jg = np.asarray(jg)
    got = tg.numpy()
    # JAX stops writing at a lane's <end>; the port pads after it
    np.testing.assert_array_equal(np.where(got == PAD_ID, 0, got),
                                  np.where(jg == PAD_ID, 0, jg))
    jb = np.asarray(JD.beam_search(jm, _j(p), jenc, beam_size=3,
                                   max_steps=6))
    tb = TD.beam_search(tm, params, tenc, beam_size=3, max_steps=6).numpy()
    np.testing.assert_array_equal(tb, jb)


def _jax_xe_loss_fn(jm, batch, ss):
    captions = jnp.asarray(batch["captions"])
    mask = JL.xe_mask_from_lengths(jnp.asarray(batch["lengths"]) - 1,
                                   captions.shape[1] - 1)
    visual = _j(batch["visual"])

    def loss_fn(params):
        r_enc, r_dec = jax.random.split(jax.random.PRNGKey(3))
        enc, _ = jm.encode(params, visual, train=True, rng=r_enc,
                           model_state={})
        logits = JD.teacher_forced_logits(jm, params, enc, captions, 0.0,
                                          r_dec, train=True, ss_active=ss)
        return JL.label_smoothing_loss(logits, captions[:, 1:], mask, 0.1)
    return loss_fn


@pytest.mark.parametrize("ss", [False, True], ids=["ss_off", "ss_on"])
@pytest.mark.parametrize("mode", ["auto", "interpret"])
@pytest.mark.parametrize("family", FAMILIES)
def test_xe_loss_and_every_gradient_match_jax(monkeypatch, family, mode, ss):
    """XE in each mode against JAX's in the same mode: the loss within 1e-5
    (relative), every leaf's gradient within 1e-5, scheduled sampling off
    (auto: every family's tf_inputs, BUTD's td_mean_gates) and on at
    probability 0 (auto: BUTD's td_mean_gates alone); the port's cell gets
    a gate term exactly where the JAX package hoists."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p = _setup(family)
    batch = _batch(family)
    jloss, jgrads = jax.value_and_grad(_jax_xe_loss_fn(jm, batch, ss))(
        _j(p))
    params = from_jax(p)
    leaves = [x.requires_grad_() for x in TO.tree_leaves(params)]
    terms = []
    train = fused_lstm.lstm_cell_train

    def spy(w, x, h, c, term=None, lanes=1):
        terms.append(term is not None)
        return train(w, x, h, c, term, lanes)

    monkeypatch.setattr(fused_lstm, "lstm_cell_train", spy)
    loss, _, _ = TS.xe_loss(tm, params, {}, _t(batch),
                            torch.Generator().manual_seed(0), 0.0,
                            ss_active=ss,
                            ss_generator=torch.Generator().manual_seed(1))
    grads = TO.tree_unflatten(params,
                              list(torch.autograd.grad(loss, leaves)))
    hoisted = mode == "auto" and (not ss or family.startswith("BUTD"))
    cells = 2 if family.startswith("BUTD") else 1
    # BUTD's language cell never takes a term; NIC's step -1 cell (the
    # image embedding) is not hoisted
    assert sum(terms) == (T - 1 if hoisted else 0)
    assert len(terms) == cells * (T - 1) + (family == "NIC")
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(TO.tree_leaves(grads))
    for path, want in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(),
                                   np.asarray(want), err_msg=str(path),
                                   **TOL)


def _jax_draws(monkeypatch, jm, params, enc, key):
    rec, orig = [], JD._categorical

    def recording(k, logits):
        d = orig(k, logits)
        jax.debug.callback(lambda x: rec.append(np.asarray(x)), d,
                           ordered=True)
        return d

    with monkeypatch.context() as m:
        m.setattr(JD, "_categorical", recording)
        seq, _ = JD.sample_rl(jm, params, enc, T, key, train=True)
        jax.effects_barrier()
    return (np.asarray(seq).astype(np.int64),
            np.stack(rec, axis=1).astype(np.int64))


@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_butd_scst_matches_jax_with_its_draws_replayed(monkeypatch, mode):
    """BUTDDetection's SCST loss (the rollout's logprobs through
    reward_criterion) and every gradient against jax.grad of JAX's rollout
    in the same mode, the port replaying JAX's draws through its own
    rollout: seq identical, the loss within 1e-5, every leaf within
    1e-5."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p = _setup("BUTDDetection")
    vis = _batch("BUTDDetection")["visual"]
    reward = np.random.default_rng(5).normal(size=(B,)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def enc_of(params):
        return jm.encode(params, _j(vis), train=True,
                         rng=jax.random.PRNGKey(2), model_state={})[0]

    seq, drawn = _jax_draws(monkeypatch, jm, _j(p), enc_of(_j(p)), key)

    def loss_fn(params):
        jseq, logp = JD.sample_rl(jm, params, enc_of(params), T, key,
                                  train=True)
        return JL.reward_criterion(logp, jseq, jnp.asarray(reward))

    jloss, jgrads = jax.value_and_grad(loss_fn)(_j(p))
    params = from_jax(p)
    leaves = [x.requires_grad_() for x in TO.tree_leaves(params)]
    enc, _ = tm.encode(params, _t(vis), train=True,
                       generator=torch.Generator().manual_seed(0))
    cols = iter(torch.from_numpy(drawn).unbind(1))
    monkeypatch.setattr(TD, "_categorical", lambda gen, logits: next(cols))
    tseq, logp, _ = TD.sample_rl(tm, params, enc, T,
                                 torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tseq.numpy(), seq)
    loss = TL.reward_criterion(logp, tseq, torch.from_numpy(reward))
    grads = TO.tree_unflatten(params,
                              list(torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(_at(grads, path).numpy(),
                                   np.asarray(want), err_msg=str(path),
                                   **TOL)


# ---------------------------------------------------------------------------
# the dropout stream
# ---------------------------------------------------------------------------

def _xe_with_masks(monkeypatch, tm, params, batch, mode, ss):
    """(loss, gradients, every dropout mask drawn, in order) of one XE
    loss through the port in ``mode``, dropout at the published rates,
    one generator for the masks (and another for scheduled sampling's
    draws)."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    masks = []
    draw = TLay.dropout_mask

    def recording(*a, **kw):
        m = draw(*a, **kw)
        if m is not None:
            masks.append(m.clone())
        return m

    monkeypatch.setattr(TLay, "dropout_mask", recording)
    leaves = [x.detach().requires_grad_() for x in TO.tree_leaves(params)]
    loss, _, _ = TS.xe_loss(tm, TO.tree_unflatten(params, leaves), {}, batch,
                            torch.Generator().manual_seed(11), 0.0,
                            ss_active=ss,
                            ss_generator=torch.Generator().manual_seed(12))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.setattr(TLay, "dropout_mask", draw)
    return float(loss.detach()), grads, masks


@pytest.mark.parametrize("family", FAMILIES)
def test_dropout_masks_are_the_same_with_and_without_the_hoist(monkeypatch,
                                                                family):
    """Dropout 0.5 (the published rates) and one generator: teacher forcing
    in auto (hoisted) and in interpret (not) draws the same masks in the
    same order (the embedding's of every step first, then each step's), so
    the losses agree within 1e-6 and every gradient within 1e-5; with
    scheduled sampling on the same holds."""
    _, tm, p = _setup(family, dropout=True)
    params = from_jax(p)
    batch = _t(_batch(family))
    for ss in (False, True):
        la, ga, ma = _xe_with_masks(monkeypatch, tm, params, batch, "auto",
                                    ss)
        li, gi, mi = _xe_with_masks(monkeypatch, tm, params, batch,
                                    "interpret", ss)
        assert len(ma) == len(mi) > 0
        assert all(torch.equal(a, b) for a, b in zip(ma, mi))
        assert abs(la - li) <= 1e-6 * abs(li)
        for a, b in zip(ga, gi):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_ss_at_prob_0_and_tf_inputs_agree_in_the_default_mode(monkeypatch):
    """AoADetection with dropout on: scheduled sampling active at
    probability 0 (no hoist) and left out (tf_inputs) in the default mode,
    each draw generator its own: the same masks, the loss within 1e-6 and
    every gradient within 1e-5 (the hoist changes the rounding alone)."""
    _, tm, p = _setup("AoADetection", dropout=True)
    params = from_jax(p)
    batch = _t(_batch("AoADetection"))
    la, ga, ma = _xe_with_masks(monkeypatch, tm, params, batch, "auto", True)
    lb, gb, mb = _xe_with_masks(monkeypatch, tm, params, batch, "auto", False)
    assert len(ma) == len(mb) and all(torch.equal(a, b)
                                      for a, b in zip(ma, mb))
    assert abs(la - lb) <= 1e-6 * abs(lb)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("family", ["BUTDDetection", "AoADetection"])
def test_rollout_draws_its_embedding_masks_first(monkeypatch, family):
    """SCST's rollout draws every step's embedding mask before its loop,
    as teacher forcing does, so the replay of its ids in the default mode
    (teacher forcing, hoisted) sees the same masks and reproduces its
    logprobs within 1e-6."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    _, tm, p = _setup(family, dropout=True)
    params = from_jax(p)
    vis = _t(_batch(family)["visual"])
    out = []
    for replay in (False, True):
        gen = torch.Generator().manual_seed(3)
        enc, _ = tm.encode(params, vis, train=True, generator=gen)
        if not replay:
            seq, logp, drawn = TD.sample_rl(tm, params, enc, T, gen,
                                            torch.Generator().manual_seed(8))
            out.append(logp)
        else:
            out.append(TD.replay_logprobs(tm, params, enc, seq, drawn, gen))
    np.testing.assert_allclose(out[1].detach().numpy(),
                               out[0].detach().numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the guard, int8, routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,hoist", [(None, True), ("auto", True),
                                         ("off", True), ("0", True),
                                         ("interpret", False)])
def test_hoist_guard_follows_the_jax_package(monkeypatch, value, hoist):
    """layers.hoist_lstm_inputs: on under auto (the default) and off, off
    under interpret and for an int8 cell, as JAX's guard decides."""
    if value is None:
        monkeypatch.delenv("SICZ_TPU_PALLAS_LSTM", raising=False)
    else:
        monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", value)
    cell = {"w_ih": 0, "w_hh": 0, "b_ih": 0, "b_hh": 0}
    assert TLay.hoist_lstm_inputs(cell) is hoist
    assert JLay.hoist_lstm_inputs(cell) is hoist
    assert not TLay.hoist_lstm_inputs({"q": 0, "s": 0, "b": 0})
    assert not JLay.hoist_lstm_inputs({"q": 0, "s": 0, "b": 0})


def test_int8_butd_cells_are_not_hoisted(monkeypatch):
    """Int8 decode params in the default mode: encode makes no
    td_mean_gates and no prepared attention cell, and greedy's ids equal
    interpret's (both run the whole concat through K3's plain version)."""
    jm, tm, p = _setup("BUTDDetection")
    vis = _t(_batch("BUTDDetection")["visual"])
    qp = tm.quantize_decode_params(from_jax(p))
    ids = {}
    for mode in ("auto", "interpret"):
        monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
        enc, _ = tm.encode(qp, vis)
        assert "td_mean_gates" not in enc.extras
        assert "td_cat" not in enc.extras
        ids[mode] = TD.greedy(tm, qp, enc, max_len=6)[0]
    assert torch.equal(ids["auto"], ids["interpret"])


def _cell(b, e, h, dtype, lanes=1):
    return (torch.zeros(e + h, 4 * h, dtype=dtype),
            torch.zeros(b, e, dtype=dtype), torch.zeros(b, h, dtype=dtype),
            torch.zeros(b // lanes, 4 * h, dtype=dtype))


@pytest.mark.parametrize("b,e,h,lanes", [
    (384, 2048, 1024, 1),      # BUTD's hoisted attention cell, greedy
    (1152, 2048, 1024, 3),     # ... beam 3, the term read by 3 lanes
    (128, 1024, 1024, 1),      # BUTD's and AoA's teacher-forced cells
    (128, 512, 512, 1),        # AoASpatial's
    (128, 0, 512, 1),          # NIC's: E = 0
    (384, 0, 512, 1),
])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_hoisted_cells_take_the_tensor_core_routes(b, e, h, lanes, dtype,
                                                   route):
    """The forward, the backward kernel and the backward's products of each
    hoisted shape, E = 0 included, take the dtype's tensor-core route,
    never "cuda_core" or a library product."""
    w, x, hh, term = _cell(b, e, h, dtype, lanes)
    c = torch.zeros_like(hh)
    assert fused_lstm.lstm_route(w, x, hh) == route
    epi = (c, w[0], term, c, c)
    assert fused_lstm.lstm_bwd_route(w, x, hh, *epi) == route
    assert fused_lstm.lstm_bwd_products_route(w, x, hh, *epi) == route


def test_a_misaligned_term_breaks_the_epilogue_pairs():
    """A term that starts off the epilogue's pairs (2 bytes in bf16) sends
    the backward to the CUDA-core route, as any epilogue operand does."""
    w, x, hh, term = _cell(16, 64, 64, torch.bfloat16)
    flat = torch.zeros(term.numel() + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(term.shape)
    c = torch.zeros_like(hh)
    assert fused_lstm.lstm_bwd_route(w, x, hh, c, w[0], term) == "wgmma"
    assert fused_lstm.lstm_bwd_route(w, x, hh, c, w[0], odd) == "cuda_core"


@pytest.mark.parametrize("bad", ["rows", "lanes", "dtype", "strided",
                                 "width"])
def test_the_term_is_checked(bad):
    """The term must be (rows / lanes, 4H), contiguous, x's dtype, with
    lanes dividing the rows: each wrapper refuses anything else, on the
    CPU too."""
    g = torch.Generator().manual_seed(0)
    hd, rows = 8, 6
    w, bs = torch.randn(4 + hd, 4 * hd, generator=g), torch.zeros(4 * hd)
    x, h, c = (torch.randn(rows, n, generator=g) for n in (4, hd, hd))
    term, lanes = torch.zeros(rows // 2, 4 * hd), 2
    if bad == "rows":
        term = torch.zeros(rows, 4 * hd)
    elif bad == "lanes":
        term, lanes = torch.zeros(1, 4 * hd), 4
    elif bad == "dtype":
        term = term.double()
    elif bad == "strided":
        term = torch.zeros(4 * hd, rows // 2).t()
    else:
        term = torch.zeros(rows // 2, 4 * hd + 1)
    with pytest.raises(ValueError, match="gate term"):
        fused_lstm.lstm_cell_fused(w, bs, x, h, c, term=term, lanes=lanes)
    with pytest.raises(ValueError, match="gate term"):
        fused_lstm.lstm_cell_bwd(w, bs, x, h, c, None, None, term=term,
                                 lanes=lanes)


def test_a_term_launches_nothing_on_the_cpu():
    """With a term, at E = 0 and with lanes, the wrappers take the plain
    version on CPU tensors: no counter moves."""
    counters = (fused_lstm.COUNT, fused_lstm.COUNT_BWD, fused_lstm.COUNT_DXH,
                fused_lstm.COUNT_DW)
    before = [c.n for c in counters]
    g = torch.Generator().manual_seed(1)
    hd = 8
    w, bs = torch.randn(hd, 4 * hd, generator=g), torch.zeros(4 * hd)
    x = torch.zeros(6, 0)
    h, c = torch.randn(6, hd, generator=g), torch.randn(6, hd, generator=g)
    term = torch.randn(2, 4 * hd, generator=g)
    hn, cn = fused_lstm.lstm_cell_fused(w, bs, x, h, c, term=term, lanes=3)
    want = fused_lstm.lstm_cell_plain(w, bs, x, h, c, term, 3)
    assert torch.equal(hn, want[0]) and torch.equal(cn, want[1])
    out = fused_lstm.lstm_cell_bwd_full(w, bs, x, h, c, h, c, term=term,
                                        lanes=3)
    assert out[2].shape == (6, 0) and out[5].shape == term.shape
    assert [c.n for c in counters] == before


def test_greedy_cells_with_steps_counted(monkeypatch):
    """In the default mode a BUTD greedy step calls K2's wrapper with the
    term once (the attention cell, lanes 1) and without once (the language
    cell); NIC's decode (which JAX does not hoist) never passes one."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    fused = fused_lstm.lstm_cell_fused
    for family, want in (("BUTDDetection", [True, False]), ("NIC", [False])):
        _, tm, p = _setup(family)
        seen = []

        def spy(*a, **kw):
            seen.append(kw.get("term") is not None)
            return fused(*a, **kw)

        monkeypatch.setattr(fused_lstm, "lstm_cell_fused", spy)
        ids = TS.make_greedy_decode(tm, max_len=4, device="cpu")(
            from_jax(p), {}, _t(_batch(family)["visual"]))
        steps = int((ids != PAD_ID).any(dim=0).sum())
        init = [False] if family == "NIC" else []
        assert seen == init + want * steps, family
        monkeypatch.setattr(fused_lstm, "lstm_cell_fused", fused)


@pytest.mark.parametrize("family", ["BUTDDetection", "NIC"])
def test_held_calls_see_the_term_of_a_hoisted_step(monkeypatch, family):
    """engine/holds' held calls over a hoisted XE step (sampling off) and
    a hoisted greedy decode: every K2 call, forward and whole backward,
    reaches its hold with its gate term (the port passes it by keyword),
    so each holds against its plain version with that term."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    _, tm, p = _setup(family, dropout=True)
    params = from_jax(p)
    batch = _t(_batch(family))
    broken, terms = [], []
    fused = fused_lstm.lstm_cell_fused

    def spy(*a, **kw):
        terms.append(kw.get("term") is not None)
        return fused(*a, **kw)

    monkeypatch.setattr(fused_lstm, "lstm_cell_fused", spy)
    leaves = [x.detach().requires_grad_() for x in TO.tree_leaves(params)]
    with holds.held_calls(broken):
        loss, _, _ = TS.xe_loss(tm, TO.tree_unflatten(params, leaves), {},
                                batch, torch.Generator().manual_seed(2), 0.0,
                                ss_active=False)
        torch.autograd.grad(loss, leaves, allow_unused=True)
        if family.startswith("BUTD"):
            TS.make_greedy_decode(tm, max_len=4, device="cpu")(
                params, {}, batch["visual"])
    assert broken == [] and any(terms)
