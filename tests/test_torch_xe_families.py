"""XE training of NIC, BUTDDetection, BUTDSpatial and AoASpatial in
simpleimagecaptionzoo_tpu_torch against the JAX package, the cases of
tests/test_torch_aoa_xe.py for the other four families: the loss and the
gradient of every leaf within 1e-5 (rtol and atol) of jax.value_and_grad of
the JAX package's loss, in its auto mode (where BUTD hoists its attention
cell's mean rows and every family its ground-truth inputs,
``Captioner.tf_inputs``) and in interpret mode (the Pallas K2 with its
custom VJP), and one SGD step's params within 1e-6.  Same params
(convert.from_jax), same numpy inputs, float32, dropout 0, every box
valid (padded boxes give NaN gradients in the JAX package, ROADMAP
Queue 3)."""
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

NO_DROPOUT = dict(dropout=0.0, dropout_aoa=0.0, dropout_sc=0.0,
                  dropout_dot_atten=0.0)
# small widths; BUTD and AoASpatial over a 3 x 3 grid or 5 boxes
DIMS = {
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
B, T = 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _visual(family, rng, b=B):
    enc = DIMS[family]["enc_dim"]
    if family == "NIC":
        return {"features": rng.normal(size=(b, enc)).astype(np.float32)}
    if family == "BUTDDetection":
        return {"bu_feats": rng.normal(size=(b, 5, enc)).astype(np.float32),
                "bu_masks": np.ones((b, 5), np.float32)}
    return {"spatial_feats": rng.normal(size=(b, 9, enc)).astype(
        np.float32)}


def _batch(family, seed):
    rng = np.random.default_rng(seed)
    visual = _visual(family, rng)
    caps = rng.integers(4, 50, size=(B, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=(B,)).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    return {"visual": visual, "captions": caps, "lengths": lens}


_SETUPS = {}


def _setup(family):
    if family not in _SETUPS:
        cfg = dict(DIMS[family], model_type=family, **NO_DROPOUT)
        jm = jax_get(JaxModelConfig(**cfg))
        jp = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
        _SETUPS[family] = (jm, get_captioner(ModelConfig(**cfg)),
                           jax.tree_util.tree_map(np.asarray, jp),
                           _batch(family, 1))
    return _SETUPS[family]


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


def _jax_loss_fn(jm, batch):
    captions = jnp.asarray(batch["captions"])
    mask = JL.xe_mask_from_lengths(jnp.asarray(batch["lengths"]) - 1,
                                   captions.shape[1] - 1)
    visual = _j(batch["visual"])

    def loss_fn(params):
        r_enc, r_dec = jax.random.split(jax.random.PRNGKey(3))
        enc, _ = jm.encode(params, visual, train=True, rng=r_enc,
                           model_state={})
        logits = JD.teacher_forced_logits(jm, params, enc, captions, 0.0,
                                          r_dec, train=True, ss_active=False)
        return JL.label_smoothing_loss(logits, captions[:, 1:], mask, 0.1)
    return loss_fn


@pytest.mark.parametrize("mode", ["auto", "interpret"])
@pytest.mark.parametrize("family", FAMILIES)
def test_xe_loss_and_every_gradient_match_jax(monkeypatch, family, mode):
    """The loss within 1e-5 (relative) and every leaf's gradient within
    1e-5 (rtol and atol) of the JAX package's, the token count equal."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", mode)
    jm, tm, p, batch = _setup(family)
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jm, batch))(_j(p))
    params = from_jax(p)
    leaves = [x.requires_grad_() for x in TO.tree_leaves(params)]
    loss, tokens, _ = TS.xe_loss(tm, params, {}, _t(batch),
                                 torch.Generator().manual_seed(0), 0.0,
                                 ss_active=False)
    grads = TO.tree_unflatten(params,
                              list(torch.autograd.grad(loss, leaves)))
    assert float(tokens) == float(np.sum(batch["lengths"] - 1))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(TO.tree_leaves(grads))
    for path, want in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(),
                                   np.asarray(want), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_sgd_step_params_match_jax(monkeypatch, family):
    """One SGD step at lr 0.05 through both packages' make_xe_train_step:
    every param within 1e-6 of the JAX step's, the losses within 1e-5."""
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, tm, p, batch = _setup(family)
    jtx = JO.make_grad_transform("SGD", 0.1)
    jparams = _j(p)
    jstep = JS.make_xe_train_step(jm, jtx, jm.param_labels(jparams),
                                  ss_active=False)
    jst, jmet = jstep(JState.create(jparams, jtx), _j(batch),
                      jax.random.PRNGKey(5), 0.0, 0.05, 0.0)
    tx = TO.make_grad_transform("SGD", 0.1)
    params = from_jax(p)
    step = TS.make_xe_train_step(tm, tx, tm.param_labels(params),
                                 ss_active=False, device="cpu")
    st, met = step(TrainState.create(params, tx), _t(batch),
                   torch.Generator().manual_seed(5), 0.0, 0.05, 0.0)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-5 * float(jmet["loss"])
    for path, want in jax.tree_util.tree_leaves_with_path(jst.params):
        np.testing.assert_allclose(_at(st.params, path).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=str(path))
