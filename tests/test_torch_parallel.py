"""Data parallelism of the port (``parallel/``, the steps' all-reduce, the
losses' global count, the global draws, the ResNet's global batch
statistics) on the CPU: two gloo processes started through a FileStore
(tests/_torch_dist_worker.py, tests/torch_dist.py), each process feeding
its half of the batch.

Holds: the collectives (host_read and host_allgather in process order,
barrier, processes_agree on raw bytes, all_reduce_sum and its autograd,
global_rand, replicate_tree, the mesh); the XE and SCST step at 2 x B/2
against JAX's one-process step on the whole batch (JAX's draws replayed in
SCST, as tests/test_torch_scst.py does; padded captions whose token counts
differ between the halves; a filler row): the loss within 1e-6 of JAX's,
the gradient within 1e-6 of JAX's gradient's norm (over every leaf); with dropout and
scheduled sampling on, the port's two processes against its own one
process on the whole batch (the same draws: the loss within 1e-6, the
gradient within 1e-6 of its norm, the generators left in step); from pixels
(BUTDSpatial, the ResNet at block counts (1, 1, 1, 1), float32 trunks,
train-mode BN) against JAX: every BN layer's batch mean and variance within
1e-5 and the running statistics within 1e-6 (as the port's one process on
the whole batch), identical on both processes, the loss within 1e-6 and
every gradient within tests/test_torch_pixels.py's 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.engine.state import TrainState as JState
from simpleimagecaptionzoo_tpu.models import resnet as JR
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch import parallel
from simpleimagecaptionzoo_tpu_torch.convert import from_jax, to_numpy
from simpleimagecaptionzoo_tpu_torch.models import resnet as TR
from simpleimagecaptionzoo_tpu_torch.ops import cider as TC
import torch_dist
from test_torch_pixels import FAMILIES as PX_FAMILIES
from test_torch_pixels import check_grads, photos
from test_torch_scst import (B, DIMS, NO_DROPOUT, T, _jax_draws, _scst_batch,
                             _setup)

GRAD_TOL = 1e-6              # of each leaf's gradient norm
LOSS_TOL = 1e-6              # relative


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], "%s/%s" % (prefix, k)).items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, "%s/%d" % (prefix, i)).items()}
    return {prefix: np.asarray(tree)}


def check_grads_norm(got, want, tol=GRAD_TOL):
    """The gradient ``got`` within ``tol`` of the norm of the gradient
    ``want`` (over every leaf): the difference's norm, and each leaf's.
    (A leaf's own norm is no yardstick: the AoA keys' bias gradient is zero
    but for rounding.)  -> the difference over the norm."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    norm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                       for w in want.values()))
    total = 0.0
    for k in want:
        d = float(np.sum((got[k].astype(np.float64)
                          - want[k].astype(np.float64)) ** 2))
        total += d
        assert np.sqrt(d) <= tol * norm, (k, np.sqrt(d), norm)
    assert np.sqrt(total) <= tol * norm, (np.sqrt(total), norm)
    return np.sqrt(total) / norm


def recording_optax():
    """An optax transform that keeps the gradient it is handed (in its
    state) and moves nothing."""
    def init(p):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}

    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), {"g": g}
    return optax.GradientTransformation(init, update)


def port_one_process(case):
    """The worker's step case run here, in one process without a group."""
    import _torch_dist_worker as W
    return W.step_case(case, 0, 1)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_on_two_processes(tmp_path):
    r0, r1 = torch_dist.run(tmp_path, {"mode": "collectives"})
    for rank, r in enumerate((r0, r1)):
        assert r["mesh"] == (2, rank, "gloo") and r["local_rows"] == 4
        assert "ROADMAP" in r["model_axis"]
        np.testing.assert_array_equal(r["host_read"], np.concatenate(
            [np.arange(6).reshape(3, 2), np.arange(6).reshape(3, 2) + 100]))
        np.testing.assert_array_equal(r["host_read_np"], np.concatenate(
            [np.zeros((2, 3), np.int32), np.ones((2, 3), np.int32)]))
        np.testing.assert_array_equal(r["allgather"], [[0, 0], [1, 2]])
        assert r["agree_same"] and not r["agree_tiny"] and \
            not r["agree_rank"]
        np.testing.assert_array_equal(r["all_reduce"][0], [3.0, 3.0, 3.0])
        assert r["all_reduce"][1] == 2.0 and \
            r["all_reduce"][1].dtype == np.float64
        np.testing.assert_array_equal(r["all_reduce"][2], np.full((2, 2),
                                                                  2.0))
        assert r["global_sum"] == 3.0
        # the global draw's rows of this process
        want = torch.rand((4, 3), generator=torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(r["global_rand"],
                                      want[2 * rank:2 * rank + 2].numpy())
        y, g = r["autograd"]
        np.testing.assert_array_equal(y, [3.0, 6.0, 9.0])
        # d/dx of sum_p (y * w * (p + 1)) = w * (1 + 2)
        np.testing.assert_array_equal(g, [3.0, 30.0, 300.0])
        a, none, b, c = r["replicate"]
        np.testing.assert_array_equal(a, [0.0, 0.0])       # process 0's
        assert none is None and c == 3 and b.tolist() == [0]
    # without a group every collective is the identity
    t = torch.arange(3.0)
    assert parallel.all_reduce_sum([t])[0] is t
    assert parallel.global_sum(t) is t
    assert parallel.all_reduce_sum_autograd(t) is t
    np.testing.assert_array_equal(parallel.host_read(t), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(parallel.host_allgather(np.ones(2)),
                                  [[1.0, 1.0]])
    assert parallel.processes_agree(np.ones(3))
    g = torch.Generator().manual_seed(7)
    assert torch.equal(parallel.global_rand((2, 3), g, "cpu"), torch.rand(
        (2, 3), generator=torch.Generator().manual_seed(7)))


# ---------------------------------------------------------------------------
# XE and SCST at 2 x B/2 against JAX's one process x B
# ---------------------------------------------------------------------------

def xe_batch(visual):
    """Captions of 8 / 8 / 7 / 8 tokens in the first half and 3 / 4 / 3 / 2
    in the second, whose last row is a filler (weight 0): the halves'
    token counts differ (27 against 7)."""
    rng = np.random.default_rng(7)
    caps = rng.integers(4, 50, size=(B, T)).astype(np.int32)
    caps[:, 0] = STA_ID
    lens = np.array([8, 8, 7, 8, 3, 4, 3, 2], np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = END_ID
        caps[i, n:] = PAD_ID
    weight = np.ones((B,), np.float32)
    weight[-1] = 0.0
    return {"visual": visual, "captions": caps, "lengths": lens,
            "sample_weight": weight}


@pytest.mark.parametrize("family", ["AoADetection", "BUTDDetection", "NIC"])
def test_xe_step_on_two_processes_matches_jax_on_the_whole_batch(
        tmp_path, family, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, _, p, visual = _setup(family)
    batch = xe_batch(visual)
    jtx = recording_optax()
    jstep = JS.make_xe_train_step(jm, jtx, jm.param_labels(_j(p)), 0.1,
                                  ss_active=False)
    jst, jmet = jstep(JState.create(_j(p), jtx), _j(batch),
                      jax.random.PRNGKey(0), 0.0, 0.0, 0.0)
    jgrads = jax.tree_util.tree_map(np.asarray, jst.opt_state["g"])
    case = dict(mode="step", kind="xe", params=p, batch=batch,
                cfg=dict(DIMS[family], model_type=family, **NO_DROPOUT))
    r0, r1 = torch_dist.run(tmp_path, case)
    assert r0["loss"] == r1["loss"] and r0["tokens"] == r1["tokens"] == 34
    assert float(jmet["tokens"]) == 34
    assert abs(r0["loss"] - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    for k, v in _flat(r0["grads"]).items():
        np.testing.assert_array_equal(v, _flat(r1["grads"])[k], err_msg=k)
    check_grads_norm(r0["grads"], jgrads)
    # the port's one process on the whole batch takes the same step
    one = port_one_process(case)
    assert abs(one["loss"] - r0["loss"]) <= LOSS_TOL * abs(one["loss"])
    check_grads_norm(r0["grads"], one["grads"])


@pytest.mark.parametrize("family", ["AoADetection", "BUTDDetection"])
def test_scst_step_on_two_processes_matches_jax_on_the_whole_batch(
        tmp_path, family, monkeypatch):
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "auto")
    jm, _, p, visual = _setup(family)
    (jd, jprobe, jbatch), (td, _, tbatch) = _scst_batch(visual,
                                                        weighted=True)
    key = jax.random.PRNGKey(5)
    r_enc, r_roll = jax.random.split(key)
    enc, _ = jm.encode(_j(p), jbatch["visual"], train=True, rng=r_enc,
                       model_state={})
    _, drawn = _jax_draws(monkeypatch, jm, _j(p), enc, r_roll)
    jtx = recording_optax()
    jstep = JS.make_scst_train_step(jm, jtx, jm.param_labels(_j(p)), jd,
                                    jprobe, max_len=T)
    jst, jmet = jstep(JState.create(_j(p), jtx), jbatch, key, 0.0, 0.0)
    jgrads = jax.tree_util.tree_map(np.asarray, jst.opt_state["g"])
    table = TC.CiderDTable(*_scst_table_args(td))
    batch = {"visual": visual, "ref_ids": tbatch["ref_ids"].numpy(),
             "ref_lens": tbatch["ref_lens"].numpy(),
             "ref_norms": tbatch["ref_norms"].numpy(),
             "sample_weight": tbatch["sample_weight"].numpy()}
    case = dict(mode="step", kind="scst", params=p, batch=batch, max_len=T,
                cfg=dict(DIMS[family], model_type=family, **NO_DROPOUT),
                draws=drawn, table=_scst_table_args(td))
    assert table.probe == jprobe
    r0, r1 = torch_dist.run(tmp_path, case)
    assert r0["loss"] == r1["loss"] and r0["reward"] == r1["reward"]
    assert float(jmet["loss"]) != 0.0
    assert abs(r0["reward"] - float(jmet["reward"])) <= 1e-6
    assert abs(r0["loss"] - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    check_grads_norm(r0["grads"], jgrads)
    one = port_one_process(case)
    assert abs(one["loss"] - r0["loss"]) <= LOSS_TOL * abs(one["loss"])
    check_grads_norm(r0["grads"], one["grads"])


def _scst_table_args(td):
    """The (h1, h2, df, log_ref_len) the port's table of _scst_batch was
    made from, read back from its device arrays."""
    t = to_numpy(td)
    return (t["h1"], t["h2"], t["df"], float(t["log_ref_len"]))


@pytest.mark.parametrize("kind", ["xe", "scst"])
def test_two_processes_draw_what_one_process_draws(tmp_path, kind):
    """Dropout at the published rates, scheduled sampling at 0.5 (XE) or
    the rollout's own draws (SCST): every draw takes the global batch's
    shape, so two processes take the one-process step on the whole batch;
    the dropout generators end in the same state."""
    family = "AoADetection"
    _, _, p, visual = _setup(family, dropout=True)
    if kind == "xe":
        case = dict(mode="step", kind="xe", params=p, batch=xe_batch(visual),
                    ss_prob=0.5, step=3, seed=11,
                    cfg=dict(DIMS[family], model_type=family))
    else:
        _, (td, _, tbatch) = _scst_batch(visual, weighted=True)
        batch = {"visual": visual, "ref_ids": tbatch["ref_ids"].numpy(),
                 "ref_lens": tbatch["ref_lens"].numpy(),
                 "ref_norms": tbatch["ref_norms"].numpy(),
                 "sample_weight": tbatch["sample_weight"].numpy()}
        case = dict(mode="step", kind="scst", params=p, batch=batch,
                    max_len=T, step=3, seed=11,
                    cfg=dict(DIMS[family], model_type=family),
                    table=_scst_table_args(td))
    r0, r1 = torch_dist.run(tmp_path, case)
    one = port_one_process(case)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["gen_state"], one["gen_state"])
    assert abs(one["loss"] - r0["loss"]) <= LOSS_TOL * abs(one["loss"])
    if kind == "scst":
        assert abs(one["reward"] - r0["reward"]) <= 1e-6
    check_grads_norm(r0["grads"], one["grads"])


# ---------------------------------------------------------------------------
# from pixels: the train-mode trunk's statistics over both processes
# ---------------------------------------------------------------------------

PX_B, PX_T, PX_SIDE = 4, 6, 64


@pytest.mark.parametrize("momentum", [1.0, 0.1])
def test_pixels_xe_batch_statistics_over_two_processes_match_jax(
        tmp_path, momentum, monkeypatch):
    """BUTDSpatial XE from pixels at 2 x 2 against JAX's 4: with
    BN_MOMENTUM 1 the new running statistics are every BN layer's batch
    mean and unbiased variance (1.0), with 0.1 the running update."""
    for mod, val in ((JR, (1, 1, 1, 1)), (TR, (1, 1, 1, 1))):
        monkeypatch.setattr(mod, "BLOCK_COUNTS", val)
    monkeypatch.setattr(JR, "BN_MOMENTUM", momentum)
    monkeypatch.setattr(JR.apply, "__defaults__", (jnp.float32, False))
    family = "BUTDSpatial"
    dims = dict(PX_FAMILIES[family], model_type=family, **NO_DROPOUT)
    jm = jax_get(JaxModelConfig(**dims))
    p = jax.tree_util.tree_map(np.asarray, jm.init_params(
        jax.random.PRNGKey(1), include_cnn=True))
    stats = jax.tree_util.tree_map(np.asarray,
                                   jm.init_model_state()["cnn_stats"])
    rng = np.random.default_rng(4)
    caps = rng.integers(4, 50, size=(PX_B, PX_T)).astype(np.int32)
    caps[:, 0] = STA_ID
    lens = np.array([6, 5, 3, 2], np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = END_ID
        caps[i, n:] = PAD_ID
    batch = {"visual": {"img_tensors": photos(PX_B, PX_SIDE, 9)},
             "captions": caps, "lengths": lens,
             "sample_weight": np.ones((PX_B,), np.float32)}
    jtx = recording_optax()
    jstep = JS.make_xe_train_step(jm, jtx, jm.param_labels(_j(p)), 0.1,
                                  ss_active=False)
    jst, jmet = jstep(JState.create(_j(p), jtx, {"cnn_stats": _j(stats)}),
                      _j(batch), jax.random.PRNGKey(0), 0.0, 0.0, 0.0)
    case = dict(mode="step", kind="xe", params=p, batch=batch, cfg=dims,
                model_state={"cnn_stats": stats}, block_counts=(1, 1, 1, 1),
                f32_trunk=True, bn_momentum=momentum)
    r0, r1 = torch_dist.run(tmp_path, case)
    s0, s1 = _flat(r0["model_state"]), _flat(r1["model_state"])
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    want = _flat(jax.tree_util.tree_map(np.asarray, jst.model_state))
    assert sorted(want) == sorted(s0) and len(want) == 2 * (1 + 3 * 4 + 4)
    # the batch statistics (momentum 1) within 1e-5, the running update
    # (0.1 of them) within 1e-6, as the one-process hold
    # (tests/test_torch_pixels.py)
    tol = 1e-5 if momentum == 1.0 else 1e-6
    one = _flat(port_one_process(case)["model_state"])
    for k, w in want.items():
        np.testing.assert_allclose(s0[k], w, rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_allclose(one[k], w, rtol=tol, atol=tol, err_msg=k)
    assert abs(r0["loss"] - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    jgrads = jst.opt_state["g"]
    check_grads(jgrads, from_jax(r0["grads"]))
    assert np.abs(_flat(r0["grads"])["/cnn/layer4/0/conv3"]).max() > 0
