"""One process of a data-parallel run of the port on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_midepoch.py.

    python tests/_torch_dist_worker.py CASE RANK WORLD STORE OUT

starts a gloo process group of WORLD processes through a FileStore at STORE
(no TCP port, so parallel test workers cannot collide), runs the case
pickled at CASE (``case["mode"]``) as process RANK and pickles its results
to OUT.  Modes:

* ``collectives``: host_read, host_allgather, barrier, processes_agree,
  all_reduce_sum, global_rand, replicate_tree and the mesh;
* ``step``: one XE or SCST step (``make_xe_train_step`` /
  ``make_scst_train_step``) on this process's rows of ``case["batch"]``,
  the gradient the step hands its optimizer recorded (``case["draws"]``,
  when given, replaces the sampler with those ids' rows: JAX's draws);
* ``engine``: the Engine's XE training on the dataset at
  ``case["root"]``; with ``case["kill"] = (rank, epoch, steps_done)`` that
  process SIGKILLs itself once that mid-epoch resume point has committed;
* ``model_axis``: the mesh of ``case["mp"]`` processes a model group
  (``get_mesh(model_parallel=...)``): one XE step (Adam) on this process's
  data rows of ``case["batch"]`` with its vocab shard of the head, greedy
  and beam decodes of the updated params, the fused head's top-k merged
  over the shards (``vocab_shard.topk_merge``) on ``case["heads"]``, and
  the int8 serving form's greedy and beam decodes.

The worker imports the port only (no JAX), and its collectives time out
after 60 s, so a hang fails the test instead of the run.
"""
import os
import pickle
import signal
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simpleimagecaptionzoo_tpu_torch import parallel  # noqa: E402
from simpleimagecaptionzoo_tpu_torch.convert import (from_jax,  # noqa: E402
                                                     to_numpy)


def rows_of(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: rows_of(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def collectives(case, rank, world):
    mesh = parallel.get_mesh("cpu")
    out = {"mesh": (mesh.size, mesh.index, mesh.backend),
           "local_rows": parallel.local_batch_slice(8, mesh)}
    out["host_read"] = parallel.host_read(
        torch.arange(6).reshape(3, 2) + 100 * rank)
    out["host_read_np"] = parallel.host_read(np.full((2, 3), rank, np.int32))
    out["allgather"] = parallel.host_allgather(np.array([rank, 2 * rank]))
    parallel.barrier("test")
    out["agree_same"] = parallel.processes_agree(np.array([1.0, 2.5]))
    # differs from process 0's below float32 precision
    out["agree_tiny"] = parallel.processes_agree(
        np.array([1.0 + rank * 2.0 ** -40], np.float64))
    out["agree_rank"] = parallel.processes_agree(np.array([rank]))
    red = parallel.all_reduce_sum([
        torch.ones(3) * (rank + 1), torch.tensor(2.0 * rank, dtype=torch.float64),
        torch.full((2, 2), rank + 0.5)])
    out["all_reduce"] = [t.numpy() for t in red]
    out["global_sum"] = float(parallel.global_sum(torch.tensor(rank + 1.0)))
    out["global_rand"] = parallel.global_rand(
        (2, 3), torch.Generator().manual_seed(7), "cpu").numpy()
    x = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    x.requires_grad_(True)
    y = parallel.all_reduce_sum_autograd(x)
    (y * torch.tensor([1.0, 10.0, 100.0]) * (rank + 1)).sum().backward()
    out["autograd"] = (y.detach().numpy(), x.grad.numpy())
    rep = parallel.replicate_tree(mesh, {
        "a": torch.full((2,), float(rank)), "b": [None, torch.tensor([rank])],
        "c": 3})
    out["replicate"] = (rep["a"].numpy(), rep["b"][0], rep["b"][1].numpy(),
                        rep["c"])
    # the model axis over both processes: the layout, then the data axis's
    # collectives over a data group of one; then back to no model axis
    try:
        parallel.get_mesh("cpu", model_parallel=world + 1)
    except ValueError as e:
        out["model_refused"] = str(e)
    m = parallel.get_mesh("cpu", model_parallel=world)
    out["model_axis"] = dict(
        mesh=(m.size, m.index, m.model_size, m.model_index, m.backend),
        local_rows=parallel.local_batch_slice(8, m),
        all_reduce=parallel.all_reduce_sum([torch.ones(2) * rank])[0].numpy(),
        global_rand=parallel.global_rand(
            (2, 3), torch.Generator().manual_seed(7), "cpu").numpy(),
        host_read=parallel.host_read(torch.tensor([rank])),
        agree_rank=parallel.processes_agree(np.array([rank])))
    parallel.get_mesh("cpu")
    out["after"] = (parallel.active_mesh(), parallel.data_count(),
                    parallel.global_sum(torch.tensor(1.0)).item())
    return out


def _int_batch(tb):
    for k in ("captions", "lengths", "ref_ids", "ref_lens"):
        if k in tb:
            tb[k] = tb[k].long()
    return tb


def step_case(case, rank, world):
    """This process's rows of the case's batch through one step, with the
    case's patches (block counts, a float32 trunk, BN momentum, replayed
    draws) in place for the step alone."""
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.ops import decode as TD

    batch = case["batch"]
    b = len(batch["sample_weight"] if "sample_weight" in batch
            else next(iter(batch["visual"].values()))) // world
    batch = rows_of(batch, rank * b, (rank + 1) * b)
    patches = []
    if case.get("block_counts"):
        patches.append((resnet, "BLOCK_COUNTS", tuple(case["block_counts"])))
    if case.get("f32_trunk"):
        patches.append((resnet.apply, "__defaults__", (torch.float32, False)))
    if case.get("bn_momentum") is not None:
        patches.append((resnet, "BN_MOMENTUM", case["bn_momentum"]))
    if case.get("draws") is not None:
        cols = iter(torch.from_numpy(
            case["draws"][rank * b:(rank + 1) * b]).unbind(1))
        patches.append((TD, "_categorical", lambda gen, logits: next(cols)))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, val in patches:
        setattr(obj, name, val)
    try:
        return _step(case, batch)
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)


def _step(case, batch):
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
    from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import cider as TC

    tm = get_captioner(ModelConfig(**case["cfg"]))
    params = from_jax(case["params"])
    handed = []

    def update(grads, state, p):
        handed.append(grads)
        return TO.tree_map(torch.zeros_like, grads), state

    tx = TO.GradientTransformation(lambda p: (), update)
    ms = from_jax(case.get("model_state") or {})
    state = TrainState.create(params, tx, ms).replace(step=case.get("step", 0))
    tb = _int_batch(from_jax(batch))
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    if case["kind"] == "xe":
        step = TS.make_xe_train_step(
            tm, tx, tm.param_labels(params), 0.1,
            freeze_cnn=case.get("freeze_cnn", False),
            ss_active=case.get("ss_prob", 0.0) > 0, device="cpu")
        new, met = step(state, tb, gen, case.get("ss_prob", 0.0), 0.0, 0.0)
        extra = {"tokens": float(met["tokens"])}
    else:
        table = TC.CiderDTable(*case["table"])
        step = TS.make_scst_train_step(
            tm, tx, tm.param_labels(params), table.device_arrays("cpu"),
            table.probe, max_len=case["max_len"], device="cpu")
        new, met = step(state, tb, gen, 0.0, 0.0)
        extra = {"reward": float(met["reward"])}
    return dict(loss=float(met["loss"]), grads=to_numpy(handed[0]),
                model_state=to_numpy(new.model_state),
                gen_state=gen.get_state().numpy(), **extra)


def _crc(tree):
    import zlib
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    return zlib.crc32(b"".join(t.detach().contiguous().numpy().tobytes()
                               for t in tree_leaves(tree)))


def model_axis_case(case, rank, world):
    """The case's params placed on a (data, model) mesh, one Adam XE step
    on this process's data rows, greedy and beam-3 decodes of the updated
    params (the ids gathered over the data axis), and the merged top-k of
    each head of ``case["heads"]`` split over the model axis; every fused
    head call's shard width recorded."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
    from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head
    from simpleimagecaptionzoo_tpu_torch.parallel import vocab_shard

    mesh = parallel.get_mesh("cpu", model_parallel=case["mp"])
    out = {"mesh": (mesh.size, mesh.index, mesh.model_size,
                    mesh.model_index)}
    tm = get_captioner(ModelConfig(**case["cfg"]))
    params = parallel.place_params(mesh, from_jax(case["params"]))
    out["v_shape"] = tuple(params["predict"]["v"].shape)
    batch = case["batch"]
    b = len(batch["captions"]) // mesh.size
    batch = rows_of(batch, mesh.index * b, (mesh.index + 1) * b)
    widths, topk = [], fused_head.topk_head

    def recording(head, x, k):
        widths.append((tuple(head.w.shape), head.v, k))
        return topk(head, x, k)
    fused_head.topk_head = recording
    try:
        tx = TO.make_grad_transform("Adam", 0.1)
        state = TrainState.create(params, tx)
        step = TS.make_xe_train_step(tm, tx, tm.param_labels(params), 0.1,
                                     ss_active=False, device="cpu")
        state, met = step(state, _int_batch(from_jax(batch)),
                          torch.Generator().manual_seed(0), 0.0, 1e-2, 0.0)
        out["loss"] = float(met["loss"])
        out["tokens"] = float(met["tokens"])
        p = state.params
        out["v"] = p["predict"]["v"].numpy()
        out["g"] = p["predict"]["g"].numpy()
        rest = {k: v for k, v in p.items() if k != "predict"}
        out["replicated_agree"] = parallel.processes_agree(
            np.array([_crc(rest)], np.int64))
        visual = from_jax(batch["visual"])
        n = len(widths)
        out["greedy"] = parallel.host_read(TS.make_greedy_decode(
            tm, max_len=case["max_len"], device="cpu")(p, {}, visual))
        out["greedy_calls"] = widths[n:]
        n = len(widths)
        out["beam"] = parallel.host_read(TS.make_beam_decode(
            tm, beam_size=3, max_steps=case["max_len"] + 1,
            device="cpu")(p, {}, visual))
        out["beam_calls"] = widths[n:]
        out["beam_full"] = parallel.host_read(TS.make_beam_decode(
            tm, beam_size=fused_head.MAX_K + 1,
            max_steps=case["max_len"] + 1, device="cpu")(p, {}, visual))
        # the int8 serving form of the shard: per-column scales, so the
        # shard's int8 head is the whole int8 head's columns
        q = tm.quantize_decode_params(p)
        out["greedy_int8"] = parallel.host_read(TS.make_greedy_decode(
            tm, max_len=case["max_len"], device="cpu")(q, {}, visual))
        out["beam_int8"] = parallel.host_read(TS.make_beam_decode(
            tm, beam_size=3, max_steps=case["max_len"] + 1,
            device="cpu")(q, {}, visual))
    finally:
        fused_head.topk_head = topk
    # the merged top-k of each head, split over the model axis as
    # place_params splits predict
    out["topk"] = []
    for head, x, k in case["heads"]:
        per = head["w"].shape[1] // mesh.model_size
        lo = mesh.model_index * per
        shard = {"w": torch.from_numpy(head["w"][:, lo:lo + per]),
                 "b": torch.from_numpy(head["b"][lo:lo + per])}
        vals, idx, lse = vocab_shard.topk_merge(
            fused_head.prepare_head(shard, torch.float32),
            torch.from_numpy(x), k)
        out["topk"].append((vals.numpy(), idx.numpy(), lse.numpy()))
    return out


def engine_case(case, rank, world):
    from simpleimagecaptionzoo_tpu_torch.config import (DataConfig,
                                                        ModelConfig,
                                                        SsOpts, TrainConfig)
    from simpleimagecaptionzoo_tpu_torch.engine.model_engines import \
        get_engine
    from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab

    root = case["root"]
    os.chdir(case["cwd"])
    vocab = load_vocab(os.path.join(root, "Data", "caption_vocab.pkl"))
    data = DataConfig.from_data_file(
        os.path.join(root, "Configs", "Datasets", "Flickr8K.data"),
        base_dir=root, dataset_name="Flickr8K")
    tc = dict(case["train"])
    if "ss" in tc:
        tc["ss_opts"] = SsOpts(**tc.pop("ss"))
    eng = get_engine(ModelConfig(vocab_size=len(vocab), **case["cfg"]), data,
                     vocab, train_config=TrainConfig(**tc), use_bu="fixed",
                     device="cpu", tqdm_visible=False, verbose=False,
                     checkpoint_root=case["ckpt_root"])
    kill = case.get("kill")
    if kill is not None and kill[0] == rank:
        save = eng._save_midepoch

        def save_then_die(state, epoch, steps_done, **kw):
            save(state, epoch, steps_done, **kw)      # committed (barrier)
            if (epoch, steps_done) == tuple(kill[1:]):
                os.kill(os.getpid(), signal.SIGKILL)
        eng._save_midepoch = save_then_die
    cider = eng.training(start_from=case["start_from"],
                         num_epochs=case["epochs"])
    return {"cider": cider, "params": to_numpy(eng.tree["params"]),
            "losses": list(eng.epoch_losses),
            "gen_state": eng._gen.get_state().numpy()}


def main():
    case_path, rank, world, store_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    parallel.configure_collective_timeout(60)
    parallel.init_process_group(
        "gloo", world, rank, store=torch.distributed.FileStore(store_path,
                                                               world))
    run = {"collectives": collectives, "step": step_case,
           "engine": engine_case, "model_axis": model_axis_case}[
               case["mode"]]
    out = run(case, rank, world)
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
