"""The port's Engine (``engine/engine.py``, ``model_engines.py``,
``sample.py``, ``observe.py``) on the CPU, on the tiny dataset
tests/test_cli.py writes.

Parity: JAX's get_engine and the port's, BUTDDetection at width 16 with 5
fixed boxes, dropout 0, no scheduled sampling, SGD, the port's tree set from
JAX's init (convert.from_jax): one XE epoch of 2 steps and the greedy val
give identical captions, cider_his within 1e-9 and saved params within
1e-5.  Port only: the resume, bf16 training, one SCST epoch, beam-2 and
int8 eval, sample (the matplotlib line), the mid-epoch resume points, and
NIC from pixels (ResNet at block counts (1, 1, 1, 1), cnn_finetune_start 1):
epoch 1 leaves ``cnn`` as it was, epoch 2 changes only ``layer4``."""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import DataConfig as JDataConfig
from simpleimagecaptionzoo_tpu.config import ModelConfig as JModelConfig
from simpleimagecaptionzoo_tpu.config import TrainConfig as JTrainConfig
from simpleimagecaptionzoo_tpu.engine.model_engines import \
    get_engine as jget_engine
from simpleimagecaptionzoo_tpu.vocab import load_vocab as jload_vocab
from simpleimagecaptionzoo_tpu_torch.config import (DataConfig, LrOpts,
                                                    ModelConfig, TrainConfig)
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import model_engines
from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
    CheckpointManager
from simpleimagecaptionzoo_tpu_torch.engine.model_engines import get_engine
from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_map
from simpleimagecaptionzoo_tpu_torch.models import resnet
from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab
from test_cli import _write_dataset

BUTD = dict(model_type="BUTDDetection", embed_dim=16, hidden_dim=16,
            atten_dim=12, enc_dim=8, max_bu_len=5, dropout=0.0)
DATA = "/Configs/Datasets/Flickr8K.data"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture()
def ds(tmp_path, monkeypatch):
    _write_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _port_engine(root, model=BUTD, device="cpu", **train):
    vocab = load_vocab(str(root / "Data" / "caption_vocab.pkl"))
    data = DataConfig.from_data_file(str(root) + DATA, base_dir=str(root),
                                     dataset_name="Flickr8K")
    kw = dict(train_batch_size=8, eval_batch_size=8,
              scst_train_batch_size=8)
    kw.update(train)
    return get_engine(ModelConfig(vocab_size=len(vocab), **model), data,
                      vocab, train_config=TrainConfig(**kw), use_bu="fixed",
                      device=device, tqdm_visible=False,
                      checkpoint_root=str(root / "CheckPoints"))


def _saved_params(root, model_type, engine, scst=False):
    tree, _, _ = CheckpointManager(model_type, "Flickr8K", root=str(
        root / "CheckPoints")).load(engine.tree, scst=scst)
    return tree["params"]


def test_engine_defaults_to_cuda_and_raises_without_a_card(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vocab = load_vocab(str(ds / "Data" / "caption_vocab.pkl"))
        get_engine(ModelConfig(vocab_size=len(vocab), **BUTD),
                   DataConfig(dataset_name="Flickr8K"), vocab)


def test_xe_epoch_matches_the_jax_engine(ds):
    """2 XE steps (40 captions at B=24) and the greedy val (2 images)."""
    tc = dict(num_epochs=1, train_batch_size=24, eval_batch_size=8,
              optimizer="SGD")
    jvocab = jload_vocab(str(ds / "Data" / "caption_vocab.pkl"))
    jdata = JDataConfig.from_data_file(str(ds) + DATA, base_dir=str(ds),
                                       dataset_name="Flickr8K")
    from simpleimagecaptionzoo_tpu.config import LrOpts as JLrOpts
    jeng = jget_engine(
        JModelConfig(vocab_size=len(jvocab), **BUTD), jdata, jvocab,
        train_config=JTrainConfig(**dict(tc, lr_opts=JLrOpts(
            learning_rate=0.05))), use_bu="fixed", tqdm_visible=False,
        checkpoint_root=str(ds / "jax_ckpt"))
    teng = _port_engine(ds, **dict(tc, lr_opts=LrOpts(learning_rate=0.05)))
    init = jax.tree_util.tree_map(np.asarray, jeng.tree["params"])
    teng.tree = {"params": from_jax(init),
                 "model_state": teng.tree["model_state"]}
    jcid = jeng.training()
    tcid = teng.training()
    assert len(tcid) == len(jcid) == 1
    assert abs(tcid[0] - jcid[0]) <= 1e-9
    assert teng.last_epoch["steps"] == 2
    # the saved params: the port's file against JAX's
    tparams = _saved_params(ds, "BUTDDetection", teng)
    jtree = jax.tree_util.tree_map(np.asarray, jeng.tree)
    jparams = from_jax(jtree["params"])
    moved = tree_map(lambda a, b: float((a - b).abs().max()),
                     from_jax(init), tparams)
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-4   # training moved
    diff = tree_map(lambda a, b: float((a - b).abs().max()), tparams,
                    {k: jparams[k] for k in tparams})
    assert max(jax.tree_util.tree_leaves(diff)) <= 1e-5
    # the val captions: both engines decode the split again
    tres = teng.eval_captions_json_generation("val", -1, full_precision=True)
    jres = jeng.eval_captions_json_generation("val", -1, full_precision=True)
    assert tres == jres and len(tres) == 2
    assert all(r["caption"] for r in tres)


def test_scst_epoch_matches_the_jax_engine(ds, monkeypatch):
    """One SCST epoch through both engines from JAX's init (2 steps: 8
    train images at B=4, JAX's engine on a mesh of one device; SGD at 0.05;
    dropout 0), the port fed JAX's draws:
    the JAX engine's rollout ids are recorded at each draw (a
    jax.debug.callback around its ``_categorical``, as
    tests/test_torch_scst.py does) and the port's sampler hands them back
    in order.  cider_his within 1e-9, the val captions identical, the saved
    params within 1e-5."""
    from simpleimagecaptionzoo_tpu.ops import decode as JD
    from simpleimagecaptionzoo_tpu_torch.ops import decode as TD
    from simpleimagecaptionzoo_tpu.parallel import get_mesh as jget_mesh
    tc = dict(scst_num_epochs=1, scst_train_batch_size=4,
              eval_batch_size=8, optimizer="SGD", scst_learning_rate=0.05,
              decode_max_len=8)
    jvocab = jload_vocab(str(ds / "Data" / "caption_vocab.pkl"))
    jdata = JDataConfig.from_data_file(str(ds) + DATA, base_dir=str(ds),
                                       dataset_name="Flickr8K")
    jeng = jget_engine(
        JModelConfig(vocab_size=len(jvocab), **BUTD), jdata, jvocab,
        train_config=JTrainConfig(**tc), use_bu="fixed", tqdm_visible=False,
        checkpoint_root=str(ds / "jax_ckpt"),
        mesh=jget_mesh(jax.devices()[:1]))
    teng = _port_engine(ds, **tc)
    init = jax.tree_util.tree_map(np.asarray, jeng.tree["params"])
    teng.tree = {"params": from_jax(init),
                 "model_state": teng.tree["model_state"]}
    drawn, orig = [], JD._categorical

    def recording(key, logits):
        d = orig(key, logits)
        jax.debug.callback(lambda x: drawn.append(np.asarray(x)), d,
                           ordered=True)
        return d
    monkeypatch.setattr(JD, "_categorical", recording)
    jcid = jeng.scst_training(num_epochs=1)
    jax.effects_barrier()
    monkeypatch.setattr(JD, "_categorical", orig)
    assert len(drawn) == 2 * tc["decode_max_len"]
    replay = iter(torch.from_numpy(d.astype(np.int64)) for d in drawn)
    monkeypatch.setattr(TD, "_categorical", lambda gen, logits: next(replay))
    tcid = teng.scst_training(num_epochs=1)
    assert next(replay, None) is None            # every draw replayed
    assert teng.last_epoch["steps"] == 2
    assert len(tcid) == len(jcid) == 1 and abs(tcid[0] - jcid[0]) <= 1e-9
    tparams = _saved_params(ds, "BUTDDetection", teng, scst=True)
    jparams = from_jax(jax.tree_util.tree_map(np.asarray,
                                              jeng.tree["params"]))
    moved = tree_map(lambda a, b: float((a - b).abs().max()),
                     from_jax(init), tparams)
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-4   # training moved
    diff = tree_map(lambda a, b: float((a - b).abs().max()), tparams,
                    {k: jparams[k] for k in tparams})
    assert max(jax.tree_util.tree_leaves(diff)) <= 1e-5
    tres = teng.eval_captions_json_generation("val", -1, full_precision=True)
    jres = jeng.eval_captions_json_generation("val", -1, full_precision=True)
    assert tres == jres and len(tres) == 2


def test_resume_continues_from_the_history(ds):
    eng = _port_engine(ds, num_epochs=1)
    assert eng.training() and os.path.exists(
        "CheckPoints/Model_BUTDDetection_Dataset_Flickr8K/cp/"
        "Captioner_cp.msgpack")
    saved = _saved_params(ds, "BUTDDetection", eng)
    eng2 = _port_engine(ds, num_epochs=2)
    seen = []
    orig = eng2._load_into_tree

    def spy(**kw):
        out = orig(**kw)
        seen.append(((list(out[0]), out[1]),
                     tree_map(lambda t: t.clone(), eng2.tree["params"])))
        return out
    eng2._load_into_tree = spy
    cider = eng2.training(start_from="checkpoint")
    (his, start), loaded = seen[0]
    assert start == 2 and len(his) == 1 and len(cider) == 2
    assert all(jax.tree_util.tree_leaves(tree_map(
        lambda a, b: bool(torch.equal(a, b)), loaded, saved)))
    with open("CheckPoints/Model_BUTDDetection_Dataset_Flickr8K/cp/"
              "state_histories.json") as f:
        assert len(json.load(f)["cider_his"]) == 2
    with open("CheckPoints/Model_BUTDDetection_Dataset_Flickr8K/"
              "metrics.jsonl") as f:
        epochs = [json.loads(x)["epoch"] for x in f]
    assert epochs == [1, 2]


def test_bf16_training_saves_float32_masters(ds):
    eng = _port_engine(ds, num_epochs=1, train_dtype="bfloat16")
    eng.training()
    assert all(np.isfinite(eng.epoch_losses))
    params = _saved_params(ds, "BUTDDetection", eng)
    leaves = jax.tree_util.tree_leaves(tree_map(lambda t: t, params))
    assert all(t.dtype == torch.float32 for t in leaves)
    assert all(bool(torch.isfinite(t).all()) for t in leaves)


def test_scst_epoch_after_xe(ds):
    _port_engine(ds, num_epochs=1).training()
    eng = _port_engine(ds)
    cache = str(ds / "Data" / "cider_idf_table.npz")
    cider = eng.scst_training(num_epochs=1, idf_cache=cache)
    assert len(cider) == 1 and os.path.exists(cache)
    assert all(np.isfinite(eng.epoch_rewards)) and eng.last_epoch[
        "steps"] == 1
    root = ds / "CheckPoints" / "Model_BUTDDetection_Dataset_Flickr8K"
    assert (root / "cp" / "Captioner_scst_cp.msgpack").exists()
    assert (root / "cp" / "scst_state_histories.json").exists()


@pytest.mark.parametrize("beam,dtype", [(2, "float32"), (-1, "int8"),
                                        (3, "int8"), (2, "bfloat16")])
def test_eval_after_xe(ds, beam, dtype):
    _port_engine(ds, num_epochs=1).training()
    eng = _port_engine(ds, decode_dtype=dtype)
    score = eng.eval(split="test", eval_beam_size=beam)
    assert np.isfinite(score) and eng.last_eval["captions"] == 2
    with open("coco_caption/results/captions-generate.json") as f:
        res = json.load(f)
    assert sorted(r["image_id"] for r in res) == [10, 11]


@pytest.mark.parametrize("beam", [-1, 2])
def test_sample_without_matplotlib_says_so(ds, monkeypatch, capsys, beam):
    _port_engine(ds, num_epochs=1).training()
    eng = _port_engine(ds)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    sentence = eng.test("img_0.jpg", eval_beam_size=beam)
    out = capsys.readouterr().out
    assert "Generated caption:\n" + sentence in out
    assert model_engines.NO_MATPLOTLIB in out
    assert "ground-truth captions:" in out


def test_midepoch_save_steps_saves_and_clears_a_resume_point(ds):
    """--midepoch_save_steps 2 over an epoch of 5 steps: resume points
    after steps 2 and 4 (each committed with its weights, the older one
    pruned), then cleared once the epoch's checkpoint is written."""
    eng = _port_engine(ds, num_epochs=1, midepoch_save_steps=2)
    cp = ds / "CheckPoints" / "Model_BUTDDetection_Dataset_Flickr8K" / "cp"
    seen = []
    save = eng.ckpt.save_midepoch

    def spy(tree, meta, scst=False):
        out = save(tree, meta, scst=scst)
        with open(cp / "midepoch_state.json") as f:
            seen.append((json.load(f), sorted(
                p.name for p in cp.glob("midepoch_cp.*"))))
        return out
    eng.ckpt.save_midepoch = spy
    eng.training()
    assert [m["steps_done"] for m, _ in seen] == [2, 4]
    for (meta, files), step in zip(seen, (2, 4)):
        assert meta["epoch"] == 1 and meta["step"] == step
        assert meta["package"] == "simpleimagecaptionzoo_tpu_torch"
        assert files == ["midepoch_cp.e1s%d.msgpack" % step]
        assert meta["weights"] == files[0]
    assert [r["steps_done"] for r in eng.midepoch_saves] == [2, 4]
    assert all(r["bytes"] > 0 and r["loop_ms"] >= 0
               for r in eng.midepoch_saves)
    assert not (cp / "midepoch_state.json").exists()
    assert not list(cp.glob("midepoch_cp.*"))
    assert (cp / "Captioner_cp.msgpack").exists()


def _write_packed_images(root, size):
    """Every image of the dataset as one uint8 shard (the layout of
    preprocess/pack_images.py), random pixels from a seed."""
    names = ["img_%d.jpg" % i for i in range(12)]
    rng = np.random.default_rng(9)
    np.save(root / "Data" / ("images_%d_packed.npy" % size),
            rng.integers(0, 256, (12, size, size, 3), dtype=np.uint8))
    with open(root / "Data" / ("images_%d_index.json" % size), "w") as f:
        json.dump({"order": names, "size": size, "dataset": "Flickr8K"}, f)


def test_nic_from_pixels_fine_tunes_only_layer4_from_epoch_2(ds,
                                                            monkeypatch):
    monkeypatch.setattr(resnet, "BLOCK_COUNTS", (1, 1, 1, 1))
    _write_packed_images(ds, 64)
    nic = dict(model_type="NIC", embed_dim=16, hidden_dim=16)
    kw = dict(img_size=64, lr_opts=LrOpts(cnn_finetune_start=1,
                                          cnn_finetune_learning_rate=1e-2,
                                          learning_rate=1e-2))
    eng = _port_engine(ds, model=nic, num_epochs=1, **kw)
    init = tree_map(lambda t: t.clone(), eng.tree["params"]["cnn"])
    assert eng.tree["model_state"]["cnn_stats"] is not None
    eng.training()
    after1 = _saved_params(ds, "NIC", eng)["cnn"]
    assert all(jax.tree_util.tree_leaves(tree_map(
        lambda a, b: bool(torch.equal(a, b)), after1, init)))
    eng2 = _port_engine(ds, model=nic, num_epochs=2, **kw)
    eng2.training(start_from="checkpoint")
    after2 = _saved_params(ds, "NIC", eng2)["cnn"]
    for stage in init:
        same = jax.tree_util.tree_leaves(tree_map(
            lambda a, b: bool(torch.equal(a, b)), after2[stage],
            init[stage]))
        if stage == "layer4":
            assert not all(same), stage
        else:
            assert all(same), stage
    with open("CheckPoints/Model_NIC_Dataset_Flickr8K/metrics.jsonl") as f:
        rec = [json.loads(x) for x in f]
    assert [r["cnn_lr"] > 0 for r in rec] == [False, True]


def test_profile_dir_writes_one_chrome_trace(ds):
    """--profile_dir: one torch.profiler trace of steps 3-7 of the first
    epoch (5 steps here, so steps 3-5), written as a Chrome trace."""
    eng = _port_engine(ds, num_epochs=1)
    eng.profile_dir = str(ds / "prof")
    eng.training()
    with open(ds / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert eng._profile_done and eng._profiler is None
