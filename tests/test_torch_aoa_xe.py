"""XE training of AoADetection in simpleimagecaptionzoo_tpu_torch against
the JAX package: teacher-forced logits, the loss and the gradient of every
leaf (JAX in its auto mode, where its scan runs the jnp cell over the
hoisted embedding rows, and in interpret mode, where it runs the Pallas K2
with its custom VJP), params after one SGD and one Adam step, the eval
loss, scheduled sampling, the entry points' GPU default, and a bf16
mixed-precision step.  Same params (convert.from_jax), same numpy inputs,
float32, dropout rates 0 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import optim as JO
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.engine.state import TrainState as JState
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import decode as JD
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode as TD
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm

NO_DROPOUT = dict(dropout=0.0, dropout_aoa=0.0, dropout_sc=0.0,
                  dropout_dot_atten=0.0)
CFG = dict(model_type="AoADetection", vocab_size=50, embed_dim=128,
           hidden_dim=128, enc_dim=64, num_heads=2, num_refine_layers=2,
           max_bu_len=6)
B, N, T = 8, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _batch(seed, b=B, t=T, padded=False):
    """Features, box masks (all boxes valid, as in the training bench; or
    ``padded``: some rows' last boxes padded), captions <sta> .. <end>
    <pad>.. of random lengths."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, N, CFG["enc_dim"])).astype(np.float32)
    mask = np.ones((b, N), np.float32)
    if padded:
        mask[0, 4:] = 0
        mask[3, 2:] = 0
    caps = rng.integers(4, CFG["vocab_size"], size=(b, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=(b,)).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    return {"visual": {"bu_feats": feats, "bu_masks": mask},
            "captions": caps, "lengths": lens}


@pytest.fixture(scope="module")
def setup():
    cfg = dict(CFG, **NO_DROPOUT)
    jm = jax_get(JaxModelConfig(**cfg))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jm, get_captioner(ModelConfig(**cfg)), np_params, _batch(1)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(batch):
    out = from_jax(batch)
    out["captions"] = out["captions"].long()
    out["lengths"] = out["lengths"].long()
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _jax_loss_fn(jm, batch, ss_prob=0.0, dtype=None):
    captions = jnp.asarray(batch["captions"])
    mask = JL.xe_mask_from_lengths(jnp.asarray(batch["lengths"]) - 1,
                                   captions.shape[1] - 1)
    visual = _j(batch["visual"])
    if dtype is not None:
        visual = jax.tree_util.tree_map(lambda a: a.astype(dtype), visual)

    def loss_fn(params):
        if dtype is not None:
            params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
        r_enc, r_dec = jax.random.split(jax.random.PRNGKey(3))
        enc, _ = jm.encode(params, visual, train=True, rng=r_enc,
                           model_state={})
        logits = JD.teacher_forced_logits(jm, params, enc, captions, ss_prob,
                                          r_dec, train=True, ss_active=False)
        return JL.label_smoothing_loss(logits, captions[:, 1:], mask, 0.1)
    return loss_fn


def _port_loss_and_grads(tm, np_params, batch, **kw):
    params = from_jax(np_params)
    leaves = [p.requires_grad_() for p in TO.tree_leaves(params)]
    loss, tokens, _ = TS.xe_loss(tm, params, {}, _t(batch),
                                 torch.Generator().manual_seed(0), 0.0,
                                 ss_active=False, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, tokens, TO.tree_unflatten(params, list(grads))


@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_teacher_forced_logits_match_jax(setup, monkeypatch, mode):
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p, batch = setup
    batch = _batch(1, padded=True)
    jenc, _ = jm.encode(_j(p), _j(batch["visual"]), train=True,
                        rng=jax.random.PRNGKey(2), model_state={})
    want = JD.teacher_forced_logits(jm, _j(p), jenc,
                                    jnp.asarray(batch["captions"]), 0.0,
                                    jax.random.PRNGKey(4), train=True,
                                    ss_active=False)
    tb = _t(batch)
    with torch.no_grad():
        tenc, _ = tm.encode(from_jax(p), tb["visual"], train=True)
        got = TD.teacher_forced_logits(tm, from_jax(p), tenc, tb["captions"],
                                       0.0, torch.Generator(), train=True,
                                       ss_active=False)
    assert got.shape == (B, T - 1, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_xe_loss_and_every_gradient_match_jax(setup, monkeypatch, mode):
    """The loss within 1e-5, and the gradient of every leaf within 1e-5
    (rtol and atol) of jax.value_and_grad of the JAX package's loss."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p, batch = setup
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jm, batch))(_j(p))
    loss, tokens, grads = _port_loss_and_grads(tm, p, batch)
    assert float(tokens) == float(np.sum(batch["lengths"] - 1))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(TO.tree_leaves(grads))
    for path, want in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(),
                                   np.asarray(want), err_msg=str(path),
                                   equal_nan=False, **TOL)


def test_padded_boxes_give_finite_gradients_where_jax_gives_nan(setup):
    """With padded boxes (all-zero rows in the refiner) the JAX package's
    LayerNorm takes sqrt's infinite gradient at a zero variance, and the
    feature projection's gradients come out NaN; the port clamps the
    variance (layers.layer_norm_std), and its gradients are finite.  Every
    other leaf agrees within 1e-5, and so does the loss."""
    jm, tm, p, _ = setup
    batch = _batch(1, padded=True)
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jm, batch))(_j(p))
    loss, _, grads = _port_loss_and_grads(tm, p, batch)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    assert all(bool(torch.isfinite(g).all())
               for g in TO.tree_leaves(grads))
    nan_paths = []
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        want = np.asarray(want)
        if np.isnan(want).any():
            nan_paths.append(jax.tree_util.keystr(path))
            continue
        np.testing.assert_allclose(_at(grads, path).numpy(), want,
                                   err_msg=str(path), **TOL)
    assert nan_paths == ["['proj']['b']", "['proj']['w']"], nan_paths


def _jax_step(jm, p, batch, name, dtype=None, lr=2e-4):
    tx = JO.make_grad_transform(name, 0.1)
    params = _j(p)
    labels = jm.param_labels(params)
    step = JS.make_xe_train_step(jm, tx, labels, compute_dtype=dtype,
                                 ss_active=False)
    st, met = step(JState.create(params, tx), _j(batch),
                   jax.random.PRNGKey(5), 0.0, lr, 0.0)
    return st, met


def _port_step(tm, p, batch, name, dtype=None, lr=2e-4):
    tx = TO.make_grad_transform(name, 0.1)
    params = from_jax(p)
    step = TS.make_xe_train_step(tm, tx, tm.param_labels(params),
                                 compute_dtype=dtype, ss_active=False,
                                 device="cpu")
    return step(TrainState.create(params, tx), _t(batch),
                torch.Generator().manual_seed(5), 0.0, lr, 0.0)


def test_sgd_step_params_match_jax(setup, monkeypatch):
    """One SGD step at lr 0.05 (large enough that the update shows): every
    param within 1e-6 of the JAX step's, the loss and token count equal."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, batch = setup
    jst, jmet = _jax_step(jm, p, batch, "SGD", lr=0.05)
    st, met = _port_step(tm, p, batch, "SGD", lr=0.05)
    assert st.step == 1 and int(jst.step) == 1
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-5 * float(jmet["loss"])
    assert float(met["tokens"]) == float(jmet["tokens"])
    moved = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jst.params):
        got = _at(st.params, path)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=str(path))
        moved += int(not np.array_equal(got.numpy(), _at(p, path)))
    assert moved == len(TO.tree_leaves(st.params))


def test_adam_step_params_match_jax(setup, monkeypatch):
    """One Adam step at lr 2e-4.  Adam's first update is g / (|g| + 1e-8),
    about sign(g): a leaf entry whose gradient is within the two sides'
    gradient difference (1e-5 of the largest, test above) of 0 may move by
    up to lr either way.  So entries with |g| >= 1e-4 are held to 1e-7
    (a float32 rounding of the step), and every entry to lr."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, batch = setup
    jst, _ = _jax_step(jm, p, batch, "Adam")
    st, _ = _port_step(tm, p, batch, "Adam")
    _, grads = jax.value_and_grad(_jax_loss_fn(jm, batch))(_j(p))
    for path, want in jax.tree_util.tree_leaves_with_path(jst.params):
        got, want = _at(st.params, path).numpy(), np.asarray(want)
        g = np.abs(np.asarray(_at(grads, path)))
        sure = g >= 1e-4
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-7,
                                   err_msg=str(path))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 + 1e-7,
                                   err_msg=str(path))


def test_xe_eval_loss_matches_jax(setup, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, batch = setup
    jb = _j(batch)
    jb["sample_weight"] = jnp.asarray(np.array([1, 1, 1, 0, 1, 1, 0, 1],
                                               np.float32))
    want = float(JS.make_xe_eval_loss(jm)(_j(p), {}, jb))
    tb = _t(batch)
    tb["sample_weight"] = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1.0])
    got = TS.make_xe_eval_loss(tm, device="cpu")(from_jax(p), {}, tb)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_ss_active_at_prob_0_equals_ss_inactive(monkeypatch):
    """With dropout on (the published rates), scheduled sampling active at
    ss_prob 0 gives exactly the loss and gradients of sampling left out:
    the draws take their own generator, so the dropout masks agree.  Under
    ``interpret``, where teacher forcing does not hoist the embedding's
    projection, both run the same cell; in the default mode sampling left
    out hoists it, which changes the rounding alone
    (tests/test_torch_hoists.py holds that within 1e-6)."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")
    tm = get_captioner(ModelConfig(**CFG))
    params = tm.init_params(torch.Generator().manual_seed(7))
    tb = _t(_batch(2, padded=True))
    out = []
    for active in (True, False):
        leaves = [p.detach().requires_grad_() for p in
                  TO.tree_leaves(params)]
        prm = TO.tree_unflatten(params, leaves)
        loss, _, _ = TS.xe_loss(tm, prm, {}, tb,
                                torch.Generator().manual_seed(3), 0.0,
                                ss_active=active,
                                ss_generator=torch.Generator().manual_seed(9))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l1, g1), (l2, g2) = out
    assert float(l1.detach()) == float(l2.detach())
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_scheduled_sampling_draws_follow_the_softmax(setup):
    """ss_prob 1: steps 0 and 1 take the ground truth, every later step a
    draw.  2,000 identical rows make the step-2 logits identical, so their
    2,000 draws are one sample of softmax(logits): a chi-square test over
    the vocabulary (bins pooled to an expected count of at least 5) passes
    at the 0.001 level."""
    from scipy import stats
    _, tm, p, batch = setup
    rows = 2000
    one = {k: v[:1] for k, v in batch.items() if k != "visual"}
    tb = {"captions": torch.from_numpy(one["captions"]).long().repeat(rows,
                                                                      1),
          "visual": {k: torch.from_numpy(v[:1]).repeat(rows, 1, 1)
                     .reshape(rows, *v.shape[1:])
                     for k, v in batch["visual"].items()}}
    tb["captions"] = tb["captions"][:, :4]
    params = from_jax(p)
    seen, hiddens = [], []
    step_core = tm.step_core

    def recording(*a, **kw):
        seen.append(a[3].clone())
        out = step_core(*a, **kw)
        hiddens.append(out[0])
        return out

    tm.step_core = recording
    try:
        with torch.no_grad():
            enc, _ = tm.encode(params, tb["visual"], train=True)
            TD.teacher_forced_logits(tm, params, enc, tb["captions"], 1.0,
                                     torch.Generator().manual_seed(0),
                                     ss_active=True,
                                     ss_generator=torch.Generator()
                                     .manual_seed(11))
    finally:
        del tm.step_core
    assert len(seen) == 3
    for t in (0, 1):
        assert torch.equal(seen[t], tb["captions"][:, t])
    assert not torch.equal(seen[2], tb["captions"][:, 2])
    probs = torch.softmax(tm.predict(params, hiddens[1][:1]).double(),
                          dim=-1)[0].numpy()
    counts = np.bincount(seen[2].numpy(), minlength=probs.size)
    order = np.argsort(probs)
    exp, obs, e_acc, o_acc = [], [], 0.0, 0
    for i in order:
        e_acc += rows * probs[i]
        o_acc += counts[i]
        if e_acc >= 5:
            exp.append(e_acc)
            obs.append(o_acc)
            e_acc, o_acc = 0.0, 0
    exp[-1] += e_acc
    obs[-1] += o_acc
    chi2 = sum((o - e) ** 2 / e for o, e in zip(obs, exp))
    assert len(exp) >= 5
    assert stats.chi2.sf(chi2, len(exp) - 1) > 1e-3, (chi2, len(exp))


def test_categorical_never_draws_a_zero_probability_id(monkeypatch):
    """Ids whose logit is -inf are never drawn, even where torch.rand
    gives its extremes (0 and 1 - 2^-24): the uniform is kept inside
    (0, 1), so the Gumbel noise stays finite."""
    logits = torch.full((64, 50), float("-inf"))
    logits[:, 7] = 0.0
    logits[:, 30] = 3.0
    got = TD._categorical(torch.Generator().manual_seed(0), logits)
    assert set(got.tolist()) <= {7, 30}
    for extreme in (0.0, 1.0 - 2.0 ** -24):
        monkeypatch.setattr(torch, "rand", lambda shape, **kw:
                            torch.full(shape, extreme))
        u = TD._uniform_open((5, 50), None, "cpu")
        assert bool(((u > 0) & (u < 1)).all())
        got = TD._categorical(None, logits)
        assert set(got.tolist()) <= {7, 30}


def test_k2_function_runs_once_a_step_each_way(setup):
    """One XE step runs the LSTM cell's Function T-1 times: T-1 forwards
    and T-1 backwards, and nothing else reaches K2."""
    _, tm, p, batch = setup
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fused_lstm.lstm_cell_fused, fused_lstm.lstm_cell_bwd

    def count(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    fused_lstm.lstm_cell_fused = count("fwd", fwd)
    fused_lstm.lstm_cell_bwd = count("bwd", bwd)
    try:
        _port_step(tm, p, batch, "Adam")
    finally:
        fused_lstm.lstm_cell_fused, fused_lstm.lstm_cell_bwd = fwd, bwd
    assert calls == {"fwd": T - 1, "bwd": T - 1}


def test_entry_points_default_to_the_gpu(setup):
    """Both entry points run on "cuda" unless the caller asks for the CPU:
    without a card they raise; on the CPU a state elsewhere or a generator
    elsewhere raises too."""
    _, tm, p, _ = setup
    tx = TO.make_grad_transform("Adam", 0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.make_xe_train_step(tm, tx, tm.param_labels(p))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.make_xe_eval_loss(tm)
    step = TS.make_xe_train_step(tm, tx, tm.param_labels(p), device="cpu")
    gen = torch.Generator()
    state = TrainState.create(from_jax(p), tx)
    state.params["proj"]["w"] = state.params["proj"]["w"].to("meta")
    with pytest.raises(ValueError, match="lies on"):
        step(state, _t(_batch(1)), gen, 0.0, 2e-4, 0.0)


def test_bf16_mixed_precision_step(setup, monkeypatch):
    """bf16 compute over float32 master params: the params and optimizer
    moments stay float32, the first loss is within 1e-2 (relative) of the
    JAX package's bf16 step (bf16 rounds at other places on the two sides:
    JAX's cell rounds its gates to bf16, the port's does not), and 20 Adam
    steps at lr 2e-3 on one batch lower the loss by a tenth."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, batch = setup
    _, jmet = _jax_step(jm, p, batch, "Adam", dtype=jnp.bfloat16)
    tx = TO.make_grad_transform("Adam", 0.1)
    params = from_jax(p)
    step = TS.make_xe_train_step(tm, tx, tm.param_labels(params),
                                 compute_dtype=torch.bfloat16,
                                 ss_active=False, device="cpu")
    st = TrainState.create(params, tx)
    gen = torch.Generator().manual_seed(1)
    tb = _t(batch)
    losses = []
    for _ in range(20):
        st, met = step(st, tb, gen, 0.0, 2e-3, 0.0)
        assert met["loss"].dtype == torch.float32
        losses.append(float(met["loss"]))
    assert all(t.dtype == torch.float32 for t in TO.tree_leaves(st.params))
    assert all(t.dtype == torch.float32 for t in
               TO.tree_leaves(st.opt_state["mu"]))
    assert abs(losses[0] - float(jmet["loss"])) <= 1e-2 * losses[0]
    assert losses[-1] < 0.9 * losses[0], losses
