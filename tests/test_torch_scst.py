"""SCST training in simpleimagecaptionzoo_tpu_torch against the JAX
package: the rollout (ops/decode.sample_rl), its replay
(decode.replay_logprobs), the loss and every leaf's gradient, one SGD step
through both packages' make_scst_train_step, the step's K2 launches and
its GPU default.

The two packages draw different random bits, so a hold against JAX feeds
the port JAX's draws: the JAX rollout's ids are recorded at each draw
(jax.debug.callback around its ``_categorical``) and the port replays them
(teacher forcing, or its sampler handing them back in the step).
Tolerances: the loss within 1e-5 (relative), each gradient within 1e-5
(rtol and atol), as tests/test_torch_aoa_xe.py; an SGD step's params
within 1e-6; the replay of the port's own rollout within 1e-6 (it runs the
same operations on the same inputs).  Same params (convert.from_jax), same
numpy inputs, float32, dropout 0 against JAX, every box valid."""
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
from simpleimagecaptionzoo_tpu.ops import cider as JC
from simpleimagecaptionzoo_tpu.ops import decode as JD
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch import END_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import cider as TC
from simpleimagecaptionzoo_tpu_torch.ops import decode as TD
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, fused_lstm
from simpleimagecaptionzoo_tpu_torch.ops import losses as TL

NO_DROPOUT = dict(dropout=0.0, dropout_aoa=0.0, dropout_sc=0.0,
                  dropout_dot_atten=0.0)
DIMS = {
    "AoADetection": dict(vocab_size=50, embed_dim=128, hidden_dim=128,
                         enc_dim=64, num_heads=2, num_refine_layers=2,
                         max_bu_len=6),
    "NIC": dict(vocab_size=50, embed_dim=64, hidden_dim=128, enc_dim=48),
    "BUTDDetection": dict(vocab_size=50, embed_dim=64, hidden_dim=128,
                          atten_dim=32, enc_dim=48, max_bu_len=5),
    "BUTDSpatial": dict(vocab_size=50, embed_dim=64, hidden_dim=128,
                        atten_dim=32, enc_dim=48, enc_img_size=3),
    "AoASpatial": dict(vocab_size=50, embed_dim=64, hidden_dim=128,
                       enc_dim=48, enc_img_size=3, num_heads=2,
                       num_refine_layers=2),
}
FAMILIES = tuple(DIMS)
B, T, R, LR = 8, 8, 3, 10
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


_SETUPS = {}


def _setup(family, dropout=False):
    """(JAX model, port model, numpy params, numpy visual), dropout 0
    unless ``dropout`` (the published rates, port only)."""
    key = (family, dropout)
    if key not in _SETUPS:
        cfg = dict(DIMS[family], model_type=family,
                   **({} if dropout else NO_DROPOUT))
        jm = jax_get(JaxModelConfig(**cfg))
        jp = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
        _SETUPS[key] = (jm, get_captioner(ModelConfig(**cfg)),
                        jax.tree_util.tree_map(np.asarray, jp),
                        _visual(family, np.random.default_rng(1)))
    return _SETUPS[key]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _jax_draws(monkeypatch, jm, params, enc, key, max_len=T):
    """JAX's rollout with its draws recorded: (seq, drawn), (B, max_len)
    int64 numpy."""
    rec, orig = [], JD._categorical

    def recording(k, logits):
        d = orig(k, logits)
        jax.debug.callback(lambda x: rec.append(np.asarray(x)), d,
                           ordered=True)
        return d

    with monkeypatch.context() as m:
        m.setattr(JD, "_categorical", recording)
        seq, _ = JD.sample_rl(jm, params, enc, max_len, key, train=True)
        jax.effects_barrier()
    assert len(rec) == max_len
    return (np.asarray(seq).astype(np.int64),
            np.stack(rec, axis=1).astype(np.int64))


@pytest.mark.parametrize("mode", ["auto", "interpret"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scst_loss_and_every_gradient_match_jax(monkeypatch, family, mode):
    """jax.grad of reward_criterion(sample_rl(...)[1], seq, reward) at a
    fixed key against the port's replay of JAX's drawn ids: the loss within
    1e-5 (relative), every leaf's gradient within 1e-5."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p, visual = _setup(family)
    reward = np.random.default_rng(5).normal(size=(B,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jvis = _j(visual)

    def enc_of(params):
        return jm.encode(params, jvis, train=True, rng=jax.random.PRNGKey(2),
                         model_state={})[0]

    seq, drawn = _jax_draws(monkeypatch, jm, _j(p), enc_of(_j(p)), key)

    def loss_fn(params):
        jseq, logp = JD.sample_rl(jm, params, enc_of(params), T, key,
                                  train=True)
        return JL.reward_criterion(logp, jseq, jnp.asarray(reward)), jseq

    (jloss, jseq), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(_j(p))
    np.testing.assert_array_equal(np.asarray(jseq), seq)

    params = from_jax(p)
    leaves = [x.requires_grad_() for x in TO.tree_leaves(params)]
    gen = torch.Generator().manual_seed(0)
    enc, _ = tm.encode(params, from_jax(visual), train=True, generator=gen)
    logp = TD.replay_logprobs(tm, params, enc, torch.from_numpy(seq),
                              torch.from_numpy(drawn), gen)
    loss = TL.reward_criterion(logp, torch.from_numpy(seq),
                               torch.from_numpy(reward))
    grads = TO.tree_unflatten(params,
                              list(torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(TO.tree_leaves(grads))
    for path, want in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(),
                                   np.asarray(want), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_rollout_logprobs_equal_the_replay_of_its_own_ids(family):
    """With dropout on (the published rates) and the dropout generator in
    the same state, teacher forcing the rollout's ids reproduces its
    logprobs within 1e-6: the draws take their own generator, so the
    dropout masks are the same."""
    _, tm, p, visual = _setup(family, dropout=True)
    params = from_jax(p)
    out = []
    for replay in (None, True):
        gen = torch.Generator().manual_seed(3)
        enc, _ = tm.encode(params, from_jax(visual), train=True,
                           generator=gen)
        if replay is None:
            seq, logp, drawn = TD.sample_rl(
                tm, params, enc, T, gen, torch.Generator().manual_seed(8))
            out.append(logp)
        else:
            out.append(TD.replay_logprobs(tm, params, enc, seq, drawn, gen))
    assert out[0].dtype == torch.float32 and out[0].shape == (B, T)
    np.testing.assert_allclose(out[1].detach().numpy(),
                               out[0].detach().numpy(), rtol=0, atol=1e-6)


def test_rollout_zeroes_ids_from_end_and_feeds_them_back():
    """seq is the draws with everything from the <end> step on zeroed,
    the <end> included; each step consumes <sta>, then the previous step's
    seq id (0 after the end), not its draw."""
    _, tm, p, visual = _setup("AoADetection", dropout=True)
    params = from_jax(p)
    params["predict"]["b"][END_ID] += 3.0      # rows end inside T steps
    seen, step_core = [], tm.step_core

    def recording(*a, **kw):
        seen.append(a[3].clone())
        return step_core(*a, **kw)

    tm.step_core = recording
    try:
        with torch.no_grad():
            gen = torch.Generator().manual_seed(1)
            enc, _ = tm.encode(params, from_jax(visual), train=True,
                               generator=gen)
            seq, _, drawn = TD.sample_rl(tm, params, enc, T, gen,
                                         torch.Generator().manual_seed(2))
    finally:
        del tm.step_core
    ended = torch.cumsum((drawn == END_ID).long(), dim=1) > 0
    # some rows end at step 0, some later, some never
    assert bool(ended[:, 0].any()) and not bool(ended[:, 0].all())
    assert not bool(ended[:, -1].all())
    assert torch.equal(seq, torch.where(ended, 0, drawn))
    assert len(seen) == T and bool((seen[0] == 1).all())
    for t in range(1, T):
        assert torch.equal(seen[t], seq[:, t - 1])


def test_rollout_first_draws_follow_the_softmax():
    """2,000 identical rows: the first step's 2,000 draws are one sample of
    softmax(logits); a chi-square test over the vocabulary (bins pooled to
    an expected count of at least 5) passes at the 0.001 level."""
    from scipy import stats
    _, tm, p, visual = _setup("AoADetection")
    params = from_jax(p)
    rows = 2000
    vis = {k: torch.from_numpy(v[:1]).repeat((rows,) + (1,) * (v.ndim - 1))
           for k, v in visual.items()}
    with torch.no_grad():
        enc, _ = tm.encode(params, vis, train=True)
        _, _, drawn = TD.sample_rl(tm, params, enc, 1,
                                   torch.Generator().manual_seed(0),
                                   torch.Generator().manual_seed(11))
        enc1, _ = tm.encode(params, {k: v[:1] for k, v in vis.items()})
        hidden, _, _ = tm.step_core(params, enc1,
                                    tm.init_state(params, enc1),
                                    torch.ones(1, dtype=torch.long))
        probs = torch.softmax(tm.predict(params, hidden).double(),
                              dim=-1)[0].numpy()
    counts = np.bincount(drawn[:, 0].numpy(), minlength=probs.size)
    exp, obs, e_acc, o_acc = [], [], 0.0, 0
    for i in np.argsort(probs):
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


def _scst_batch(visual, weighted=False):
    """References (R per image, 3-9 ids over the first 30 of the
    vocabulary, so that rollouts hit them), their tables (JAX's and the
    port's, from the same references plus random keys) and the
    precomputed norms."""
    rng = np.random.default_rng(6)
    refs = [[list(rng.integers(4, 30, int(rng.integers(3, LR))))
             for _ in range(R)] for _ in range(B)]
    ref_ids = np.zeros((B, R, LR), np.int32)
    ref_lens = np.zeros((B, R), np.int32)
    for i, rr in enumerate(refs):
        for r, ref in enumerate(rr):
            ref_ids[i, r, :len(ref)] = ref
            ref_lens[i, r] = len(ref)
    base = JC.CiderDTable.from_ref_corpus(refs)
    h = rng.integers(0, 2 ** 32, size=(2, 3000), dtype=np.uint64)
    args = (np.concatenate([base.h1, h[0].astype(np.uint32)]),
            np.concatenate([base.h2, h[1].astype(np.uint32)]),
            np.concatenate([base.df, np.full(3000, 2.0, np.float32)]),
            float(np.log(1000.0)))
    jt, tt = JC.CiderDTable(*args), TC.CiderDTable(*args)
    batch = {"visual": visual, "ref_ids": ref_ids, "ref_lens": ref_lens}
    if weighted:
        batch["sample_weight"] = np.array([1, 1, 1, 0, 1, 1, 1, 0],
                                          np.float32)
    jbatch = _j(batch)
    jd = jt.device_arrays()
    jbatch["ref_norms"] = JC.ref_norms_device(jd, jt.probe,
                                              jbatch["ref_ids"],
                                              jbatch["ref_lens"])
    td = tt.device_arrays("cpu")
    tbatch = from_jax(batch)
    tbatch["ref_ids"] = tbatch["ref_ids"].long()
    tbatch["ref_lens"] = tbatch["ref_lens"].long()
    tbatch["ref_norms"] = TC.ref_norms_device(td, tt.probe,
                                              tbatch["ref_ids"],
                                              tbatch["ref_lens"])
    return (jd, jt.probe, jbatch), (td, tt.probe, tbatch)


def _replaying(drawn):
    """A stand-in for the port's sampler that hands back ``drawn``'s
    columns in turn."""
    cols = iter(torch.from_numpy(drawn).unbind(1))
    return lambda gen, logits: next(cols)


@pytest.mark.parametrize("family", ["AoADetection", "BUTDDetection", "NIC"])
def test_sgd_scst_step_params_match_jax(monkeypatch, family):
    """One SGD step at lr 0.05 through both packages' make_scst_train_step
    (greedy baseline, rollout, CIDEr-D reward with precomputed reference
    norms, REINFORCE, the clamp 0.25), two filler rows of the batch
    weighted out, the port given JAX's draws: the mean reward within 1e-6,
    the loss within 1e-5, every param within 1e-6."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, visual = _setup(family)
    (jd, jprobe, jbatch), (td, tprobe, tbatch) = _scst_batch(
        visual, weighted=True)
    rng_key = jax.random.PRNGKey(5)
    jparams = _j(p)
    # the JAX step's rollout key and encoding (dropout 0: the encoding is
    # the same under any key)
    r_enc, r_roll = jax.random.split(rng_key)
    enc, _ = jm.encode(jparams, jbatch["visual"], train=True, rng=r_enc,
                       model_state={})
    _, drawn = _jax_draws(monkeypatch, jm, jparams, enc, r_roll)
    jtx = JO.make_grad_transform("SGD", 0.25)
    jstep = JS.make_scst_train_step(jm, jtx, jm.param_labels(jparams), jd,
                                    jprobe, max_len=T)
    jst, jmet = jstep(JState.create(jparams, jtx), jbatch, rng_key, 0.05,
                      0.0)

    tx = TO.make_grad_transform("SGD", 0.25)
    params = from_jax(p)
    step = TS.make_scst_train_step(tm, tx, tm.param_labels(params), td,
                                   tprobe, max_len=T, device="cpu")
    monkeypatch.setattr(TD, "_categorical", _replaying(drawn))
    st, met = step(TrainState.create(params, tx), tbatch,
                   torch.Generator().manual_seed(5), 0.05, 0.0)
    assert st.step == 1 and met["loss"].dtype == torch.float32
    assert abs(float(met["reward"]) - float(jmet["reward"])) <= 1e-6
    assert float(jmet["loss"]) != 0.0
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-5 * abs(float(jmet["loss"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jst.params):
        got = _at(st.params, path)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("family,cells", [("AoADetection", 1),
                                          ("BUTDDetection", 2)])
def test_k2_calls_of_one_step(family, cells):
    """One SCST step: the greedy baseline calls K1 once a step it takes and
    K2's forward directly (no gradient) once a step per cell; the rollout
    runs every cell T times through LstmCell, T forwards and T backwards
    per cell."""
    _, tm, p, visual = _setup(family, dropout=True)
    _, (td, probe, tbatch) = _scst_batch(visual)
    calls = {"head": 0, "fwd": 0, "bwd": 0, "train": 0}
    saved = (fused_head.topk_head, fused_lstm.lstm_cell_fused,
             fused_lstm.lstm_cell_bwd, fused_lstm.lstm_cell_train)

    def count(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    (fused_head.topk_head, fused_lstm.lstm_cell_fused,
     fused_lstm.lstm_cell_bwd, fused_lstm.lstm_cell_train) = (
        count(k, f) for k, f in zip(("head", "fwd", "bwd", "train"), saved))
    try:
        tx = TO.make_grad_transform("Adam", 0.25)
        params = from_jax(p)
        step = TS.make_scst_train_step(tm, tx, tm.param_labels(params), td,
                                       probe, max_len=T, device="cpu")
        _, met = step(TrainState.create(params, tx), tbatch,
                      torch.Generator().manual_seed(1), 2e-5, 0.0)
    finally:
        (fused_head.topk_head, fused_lstm.lstm_cell_fused,
         fused_lstm.lstm_cell_bwd, fused_lstm.lstm_cell_train) = saved
    assert 1 <= calls["head"] <= T
    assert calls == {"head": calls["head"],
                     "fwd": cells * (calls["head"] + T),
                     "bwd": cells * T, "train": cells * T}
    assert np.isfinite(float(met["loss"])) and \
        np.isfinite(float(met["reward"]))


def test_bf16_mixed_precision_scst_step():
    """bf16 compute over float32 master params: params and Adam's moments
    stay float32, the loss and reward are finite float32, and the rollout's
    logprobs are float32."""
    _, tm, p, visual = _setup("AoADetection", dropout=True)
    _, (td, probe, tbatch) = _scst_batch(visual)
    tx = TO.make_grad_transform("Adam", 0.25)
    params = from_jax(p)
    step = TS.make_scst_train_step(tm, tx, tm.param_labels(params), td,
                                   probe, max_len=T,
                                   compute_dtype=torch.bfloat16,
                                   device="cpu")
    st = TrainState.create(params, tx)
    for i in range(2):
        st, met = step(st, tbatch, torch.Generator().manual_seed(i), 2e-5,
                       0.0)
        assert met["loss"].dtype == torch.float32
        assert np.isfinite(float(met["loss"])) and \
            np.isfinite(float(met["reward"]))
    assert all(t.dtype == torch.float32 for t in TO.tree_leaves(st.params))
    assert all(t.dtype == torch.float32 for t in
               TO.tree_leaves(st.opt_state["mu"]))
    loss, reward, _, seq, drawn = TS.scst_loss(
        tm, TS._cast_floats(params, None), {}, tbatch, td, probe,
        torch.zeros((B, T), dtype=torch.long), torch.Generator(),
        compute_dtype=torch.bfloat16, max_len=T)
    assert loss.dtype == torch.float32 and reward.shape == (B,)
    assert seq.shape == drawn.shape == (B, T)


def test_entry_point_defaults_to_the_gpu():
    """make_scst_train_step runs on "cuda" unless the caller asks for the
    CPU: without a card it raises; on the CPU a table elsewhere raises
    too."""
    _, tm, p, visual = _setup("AoADetection")
    _, (td, probe, tbatch) = _scst_batch(visual)
    tx = TO.make_grad_transform("Adam", 0.25)
    labels = tm.param_labels(p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.make_scst_train_step(tm, tx, labels, td, probe)
    state = TrainState.create(from_jax(p), tx)
    meta = dict(td, df=td["df"].to("meta"))
    step = TS.make_scst_train_step(tm, tx, labels, meta, probe,
                                   device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        step(state, tbatch, torch.Generator(), 2e-5, 0.0)
