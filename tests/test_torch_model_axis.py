"""The mesh's ``model`` axis of the port (``parallel/mesh.py``'s
(data, model) layout and ``place_params``, ``parallel/vocab_shard.py``)
against the JAX package's, on the CPU: gloo processes started through a
FileStore (tests/_torch_dist_worker.py, tests/torch_dist.py).

The recipe is tests/test_train_steps.py:202's (BUTDDetection, V=30, B=8,
T=9, a padded box; Adam with the value clamp 0.1, lr 1e-2; greedy to 6
tokens, beam 3 to 7 steps), with dropout off so that the port and JAX draw
nothing.  JAX runs it on its 8-device CPU mesh at model_parallel 1 and 2;
the port at world 2 (model 2) and world 4 (data 2 x model 2), and in one
process.  Holds: the XE loss within 1e-5 relative of JAX's at both mp;
greedy and beam-3 ids identical, and beam 17 (the full-logits branch)
identical; the updated predict.v (the shards side by side) within 1e-5 of
JAX's, absolute; the int8 serving form's greedy and beam-3 ids identical to
the port's one process's; every replicated leaf bit-identical on every
process; each
fused-head call of a decode on the process's shard (V/mp = 15 columns,
padded to 512); the layout rank r -> (r // mp, r % mp).  And
``vocab_shard.topk_merge`` over two shards against
``fused_head.topk_head_plain`` on the whole head: values and ids
identical, ties across the shards' boundary included (the lower id first),
the logsumexp within 1e-6 relative; the int8 head's shard equal to the
whole int8 head's columns; the refusals (a vocabulary or a world the model
axis does not divide, a head left whole on a model axis)."""
import jax
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.engine.optim import make_grad_transform
from simpleimagecaptionzoo_tpu.engine.state import TrainState as JState
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.parallel import get_mesh as jax_mesh
from simpleimagecaptionzoo_tpu.parallel import place_params as jax_place
from simpleimagecaptionzoo_tpu.parallel import shard_batch as jax_shard
from simpleimagecaptionzoo_tpu_torch import parallel
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import fused_head, quant
from simpleimagecaptionzoo_tpu_torch.parallel import vocab_shard
import torch_dist
import _torch_dist_worker as W

V, B, T = 30, 8, 9
MAX_LEN = 6
CFG = dict(model_type="BUTDDetection", vocab_size=V, embed_dim=16,
           hidden_dim=16, atten_dim=12, enc_dim=10, enc_img_size=3,
           num_heads=4, num_refine_layers=2, dropout=0.0, dropout_aoa=0.0,
           dropout_sc=0.0, dropout_dot_atten=0.0)
LOSS_TOL = 1e-5              # relative
V_TOL = 1e-5                 # absolute, the updated predict.v
LSE_TOL = 1e-6               # relative, the merged logsumexp


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def xe_batch():
    """tests/test_train_steps.py's xe_batch."""
    rng = np.random.default_rng(0)
    caps = rng.integers(4, V, size=(B, T)).astype(np.int32)
    caps[:, 0] = 1
    lengths = rng.integers(4, T, size=(B,)).astype(np.int32)
    for i, n in enumerate(lengths):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    mask = np.ones((B, 6), np.float32)
    mask[0, 4:] = 0
    return {"visual": {"bu_feats": rng.normal(size=(B, 6, 10)).astype(
        np.float32), "bu_masks": mask}, "captions": caps, "lengths": lengths}


def heads():
    """Heads (w (H, V), b) with x and k for the merged top-k: V=1,200
    (600 a shard, each padded to 1,024), columns 100 and 700 (one in each
    shard) equal, and 3 and 5 in shard 0 equal, so the top ids tie within
    and across the shards; k = 1, 3 and 16."""
    rng = np.random.default_rng(3)
    h, v = 24, 1200
    w = rng.normal(size=(h, v)).astype(np.float32)
    b = rng.normal(size=(v,)).astype(np.float32)
    x = rng.normal(size=(7, h)).astype(np.float32)
    w[:, 700], b[700] = w[:, 100], b[100]
    w[:, 5], b[5] = w[:, 3], b[3]
    # make the tied columns the rows' largest logits
    w[:, [3, 5, 100, 700]] *= 6.0
    x[:2] = w[:, 100] / np.linalg.norm(w[:, 100])
    return [({"w": w, "b": b}, x, k) for k in (1, 3, 16)]


@pytest.fixture(scope="module")
def jax_results():
    """JAX's recipe at model_parallel 1 and 2 -> {mp: (loss, greedy ids,
    beam-3 ids, beam-17 ids, updated predict.v)}, and the init params."""
    batch = xe_batch()
    out, params0 = {}, None
    for mp in (1, 2):
        model = jax_get(JModelConfig(**CFG))
        params = model.init_params(jax.random.PRNGKey(0), include_cnn=False)
        if params0 is None:
            params0 = jax.tree_util.tree_map(np.asarray, params)
        mesh = jax_mesh(jax.devices()[:8], model_parallel=mp)
        placed = jax_place(mesh, params)
        tx = make_grad_transform("Adam", 0.1)
        state = JState.create(placed, tx)
        step = JS.make_xe_train_step(model, tx, model.param_labels(params),
                                     0.1, ss_active=False)
        state, m = step(state, jax_shard(mesh, batch), jax.random.PRNGKey(0),
                        0.0, 1e-2, 0.0)
        vis = jax_shard(mesh, batch["visual"])
        greedy = np.asarray(JS.make_greedy_decode(model, max_len=MAX_LEN)(
            state.params, {}, vis))
        beam = np.asarray(JS.make_beam_decode(
            model, beam_size=3, max_steps=MAX_LEN + 1)(state.params, {},
                                                       vis))
        beam17 = np.asarray(JS.make_beam_decode(
            model, beam_size=17, max_steps=MAX_LEN + 1)(state.params, {},
                                                        vis))
        out[mp] = (float(m["loss"]), greedy, beam, beam17,
                   np.asarray(state.params["predict"]["v"]))
    return out, params0


def _case(params0):
    return dict(mode="model_axis", mp=2, cfg=CFG, params=params0,
                batch=xe_batch(), max_len=MAX_LEN,
                heads=[(h, x, k) for h, x, k in heads()])


@pytest.fixture(scope="module")
def port_runs(jax_results, tmp_path_factory):
    """The port at world 2 (model 2) and world 4 (data 2 x model 2)."""
    _, params0 = jax_results
    case = _case(params0)
    runs = {}
    for world in (2, 4):
        runs[world] = torch_dist.run(tmp_path_factory.mktemp("w%d" % world),
                                     case, world=world, timeout=60)
    return runs


def _v_of(results, mp):
    """The updated predict.v of a model group: its shards side by side."""
    return np.concatenate([r["v"] for r in sorted(
        results, key=lambda r: r["mesh"][3])[:mp]], axis=1)


@pytest.fixture(scope="module")
def one_process(jax_results):
    """The same case in this process, without a group (model_parallel
    1)."""
    _, params0 = jax_results
    return W.model_axis_case(dict(_case(params0), mp=1, heads=[]), 0, 1)


@pytest.mark.parametrize("world", [2, 4])
def test_xe_step_and_decodes_on_the_model_axis_match_jax(
        jax_results, port_runs, one_process, world):
    want, _ = jax_results
    results = port_runs[world]
    mp, data = 2, world // 2
    for rank, r in enumerate(results):
        assert r["mesh"] == (data, rank // mp, mp, rank % mp)
        assert r["v_shape"] == (CFG["hidden_dim"], V // mp)
        assert r["replicated_agree"]
        for jmp in (1, 2):
            jl = want[jmp][0]
            assert abs(r["loss"] - jl) <= LOSS_TOL * abs(jl), (r["loss"], jl)
            np.testing.assert_array_equal(r["greedy"], want[jmp][1])
            np.testing.assert_array_equal(r["beam"], want[jmp][2])
            np.testing.assert_array_equal(r["beam_full"], want[jmp][3])
        # every fused-head call on this process's shard: 15 columns,
        # padded to 512; K1 once a greedy step, at k=1, once a beam step
        # at k=3
        assert r["greedy_calls"] and all(
            c == ((128, 512), V // mp, 1) for c in r["greedy_calls"])
        assert r["beam_calls"] and all(
            c == ((128, 512), V // mp, 3) for c in r["beam_calls"])
        assert len(r["greedy_calls"]) <= MAX_LEN
    # the int8 serving form on the shards: the one process's ids
    one = one_process
    for r in results:
        np.testing.assert_array_equal(r["greedy_int8"], one["greedy_int8"])
        np.testing.assert_array_equal(r["beam_int8"], one["beam_int8"])
    # a model group's processes computed the same loss; the data groups'
    # shards of one model index equal
    assert len({r["loss"] for r in results}) == 1
    for d in range(data):
        got = _v_of(results[d * mp:(d + 1) * mp], mp)
        for jmp in (1, 2):
            np.testing.assert_allclose(got, want[jmp][4], rtol=0,
                                       atol=V_TOL)
        np.testing.assert_array_equal(got, _v_of(results[:mp], mp))


def test_one_process_of_the_port_matches_jax(jax_results, one_process):
    """The same case in this process, without a group (model_parallel 1):
    the reference the model axis is held to."""
    want, _ = jax_results
    r = one_process
    assert r["mesh"] == (1, 0, 1, 0) and r["v_shape"] == (16, V)
    assert abs(r["loss"] - want[1][0]) <= LOSS_TOL * abs(want[1][0])
    np.testing.assert_array_equal(r["greedy"], want[1][1])
    np.testing.assert_array_equal(r["beam"], want[1][2])
    np.testing.assert_allclose(r["v"], want[1][4], rtol=0, atol=V_TOL)
    assert all(c == ((128, 512), V, 1) for c in r["greedy_calls"])


@pytest.mark.parametrize("i", range(3))
def test_topk_merge_matches_the_whole_heads_top_k(port_runs, i):
    """K1 on each shard, merged, against topk_head_plain on the whole head
    (ties within a shard and across the shards' boundary)."""
    head, x, k = heads()[i]
    vals, idx, lse = fused_head.topk_head_plain(
        {"w": torch.from_numpy(head["w"]), "b": torch.from_numpy(head["b"])},
        torch.from_numpy(x), k)
    # the planted tie across the shards leads rows 0-1: the lower id first
    assert idx[:2, 0].tolist() == [100, 100]
    if k > 1:
        assert idx[:2, 1].tolist() == [700, 700]
        assert torch.equal(vals[:2, 0], vals[:2, 1])
    for world in (2, 4):
        for r in port_runs[world]:
            gv, gi, gl = r["topk"][i]
            np.testing.assert_array_equal(gi, idx.numpy())
            np.testing.assert_array_equal(gv, vals.numpy())
            np.testing.assert_allclose(gl, lse.numpy(), rtol=LSE_TOL, atol=0)


def test_int8_head_shard_is_the_whole_int8_heads_columns():
    """quantize_decode_params on a shard (per-column scales) gives the
    columns of the whole head's int8 form."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn(40, 1200, generator=g)
    head = {"v": v, "g": v.norm(dim=0) * 1.3, "b": torch.randn(1200,
                                                                generator=g)}
    whole = quant.quantize_dense_wn(head)
    for lo in (0, 600):
        part = quant.quantize_dense_wn({k: t[..., lo:lo + 600]
                                        for k, t in head.items()})
        assert torch.equal(part["s"], whole["s"][lo:lo + 600])
        assert torch.equal(part["b"], whole["b"][lo:lo + 600])
        assert torch.equal(part["q"][:40, :600], whole["q"][:40, lo:lo + 600])


def test_the_model_axis_refuses_what_it_cannot_split():
    with pytest.raises(ValueError, match="model_parallel=2"):
        parallel.get_mesh("cpu", model_parallel=2)     # one process
    assert parallel.active_mesh() is None
    mesh = parallel.Mesh(torch.device("cpu"), None, 1, 0, 2, 1)
    model = get_captioner(ModelConfig(**dict(CFG, vocab_size=31)))
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="31 is not divisible"):
        parallel.place_params(mesh, params)
    # V=30 splits: model index 1 keeps columns 15-29 of v, g and b
    model = get_captioner(ModelConfig(**CFG))
    params = model.init_params(torch.Generator().manual_seed(0))
    placed = parallel.place_params(mesh, params)
    for k in ("v", "g", "b"):
        assert torch.equal(placed["predict"][k],
                           params["predict"][k][..., 15:])
    # a head left whole is refused on a model axis
    saved = parallel.mesh._active
    parallel.mesh._active = mesh
    try:
        with pytest.raises(ValueError, match="holds 30 columns"):
            vocab_shard.check_shard(params["predict"], V)
        vocab_shard.check_shard(placed["predict"], V)
    finally:
        parallel.mesh._active = saved
