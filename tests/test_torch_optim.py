"""The optimizer layer of simpleimagecaptionzoo_tpu_torch against the JAX
package's (optax): Adam and SGD after the value clamp, three steps with
two learning rates over 'main', 'cnn' and 'cnn_frozen' leaves, the labels
of Captioner.param_labels, and TrainState's optimizer reset."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.engine import optim as JO
from simpleimagecaptionzoo_tpu.engine.state import TrainState as JState
from simpleimagecaptionzoo_tpu.models.base import Captioner as JCaptioner
from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models.base import Captioner


def _tree(rng, scale=1.0):
    n = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)  # noqa
    return {"proj": {"w": n(6, 5), "b": n(5)},
            "refine": [{"w": n(5, 5)}, {"w": n(5, 5), "g": n(5)}],
            "cnn": {"layer4": {"w": n(4, 3)}, "stem": {"w": n(3, 3)},
                    "layer1": {"b": n(3)}}}


def _to_torch(tree):
    return TO.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _at(tree, path):
    """The leaf of ``tree`` at a JAX key path (JAX orders dict leaves by
    key, the port by insertion)."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def test_param_labels_match_jax():
    params = _tree(np.random.default_rng(0))
    want = JCaptioner.param_labels(None, params)
    got = Captioner.param_labels(None, _to_torch(params))
    assert got == want
    assert sorted(set(TO.tree_leaves(got))) == ["cnn", "cnn_frozen", "main"]


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_three_steps_match_optax(name):
    """Three steps on the same grads (a tenth of them beyond the clamp of
    0.1), lr_main 2e-3 and lr_cnn 5e-4: params within 1e-6 of optax's (a
    float32 rounding of each step's few operations), 'cnn_frozen' leaves
    bit for bit unchanged."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.07) for _ in range(3)]
    labels = JCaptioner.param_labels(None, params)
    jtx = JO.make_grad_transform(name, 0.1)
    ttx = TO.make_grad_transform(name, 0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _to_torch(params)
    jst, tst = jtx.init(jp), ttx.init(tp)
    for g in grads:
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        ju, jst = jtx.update(jg, jst, jp)
        jp = JO.apply_updates_partitioned(jp, ju, labels, 2e-3, 5e-4)
        tu, tst = ttx.update(_to_torch(g), tst, tp)
        tp = TO.apply_updates_partitioned(tp, tu, labels, 2e-3, 5e-4)
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        got, lbl, p0 = (_at(t, path) for t in (tp, labels, params))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=str(path))
        if lbl == "cnn_frozen":
            np.testing.assert_array_equal(got.numpy(), p0)
        else:
            assert not np.array_equal(got.numpy(), p0), path


def test_clamp_is_a_value_clamp():
    """SGD's first direction is the clamped gradient plus weight decay:
    an entry of 5 moves by lr x (0.1 + 1e-5 p), not by a rescaled norm."""
    tx = TO.make_grad_transform("sgd", 0.1)
    p = {"w": torch.tensor([1.0, 2.0, 3.0])}
    u, _ = tx.update({"w": torch.tensor([5.0, -0.05, -7.0])}, tx.init(p), p)
    torch.testing.assert_close(
        u["w"], torch.tensor([0.1 + 1e-5, -0.05 + 2e-5, -0.1 + 3e-5]))


def test_reset_optimizer_zeroes_the_moments():
    """reset_optimizer keeps params, model_state and step and gives fresh
    moments (Adam's count 0), as JAX's TrainState does."""
    rng = np.random.default_rng(2)
    params = _to_torch(_tree(rng))
    tx = TO.make_grad_transform("Adam", 0.1)
    st = TrainState.create(params, tx)
    assert st.step == 0 and st.model_state == {}
    _, opt = tx.update(_to_torch(_tree(rng)), st.opt_state, params)
    st = st.replace(opt_state=opt, step=7)
    assert opt["count"] == 1
    assert any(float(m.abs().max()) > 0 for m in TO.tree_leaves(opt["mu"]))
    fresh = st.reset_optimizer(tx)
    assert fresh.step == 7 and fresh.params is params
    assert fresh.opt_state["count"] == 0
    assert all(float(m.abs().max()) == 0 for m in
               TO.tree_leaves(fresh.opt_state["mu"])
               + TO.tree_leaves(fresh.opt_state["nu"]))
    jtx = JO.make_grad_transform("Adam", 0.1)
    jst = JState.create(jax.tree_util.tree_map(jnp.asarray, _tree(rng)), jtx)
    assert int(jst.reset_optimizer(jtx).opt_state[1].count) == 0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        TO.make_grad_transform("rmsprop", 0.1)
