"""Mid-epoch resume of the port (``engine/midepoch.py``, the mid-epoch
methods of ``engine/checkpoint.py``), mirroring tests/test_midepoch_resume.py
on the dataset tests/test_cli.py writes (BUTDDetection at width 16, 8 train
images of 5 captions: 5 XE steps an epoch at B=8).

Holds: the batcher's skip equals its tail (and the JAX package's batches);
an XE run interrupted in epoch 2 and resumed from its last resume point ends
bit-identical to an uninterrupted run (params, val CIDEr, the dropout
generator), with dropout and scheduled sampling on; a point saved under
another configuration, or by the JAX package, is discarded and the log says
why; an interrupted SCST run resumes and ends bit-identical too; with two
processes (gloo, tests/_torch_dist_worker.py), one SIGKILLed after a
committed save, the resumed pair ends bit-identical to the uninterrupted
pair."""
import json
import os
import signal

import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu_torch.config import (DataConfig, ModelConfig,
                                                    SsOpts, TrainConfig)
from simpleimagecaptionzoo_tpu_torch.convert import to_numpy
from simpleimagecaptionzoo_tpu_torch.engine import steps as S
from simpleimagecaptionzoo_tpu_torch.engine.model_engines import get_engine
from simpleimagecaptionzoo_tpu_torch.engine.optim import make_grad_transform
from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab
import torch_dist
from test_cli import _write_dataset

BUTD = dict(model_type="BUTDDetection", embed_dim=16, hidden_dim=16,
            atten_dim=12, enc_dim=8, max_bu_len=5)
TAG = "Model_BUTDDetection_Dataset_Flickr8K"
SS = dict(ss_start_epoch=1, ss_inc_every=1, ss_inc_prob=0.2)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture()
def ds(tmp_path, monkeypatch):
    _write_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _engine(root, ckpt="cp", verbose=False, **train):
    vocab = load_vocab(str(root / "Data" / "caption_vocab.pkl"))
    data = DataConfig.from_data_file(
        str(root / "Configs" / "Datasets" / "Flickr8K.data"),
        base_dir=str(root), dataset_name="Flickr8K")
    kw = dict(num_epochs=2, train_batch_size=8, eval_batch_size=8,
              scst_train_batch_size=4, midepoch_save_steps=2,
              ss_opts=SsOpts(**SS))
    kw.update(train)
    return get_engine(ModelConfig(vocab_size=len(vocab), **BUTD), data,
                      vocab, train_config=TrainConfig(**kw), use_bu="fixed",
                      device="cpu", tqdm_visible=False, verbose=verbose,
                      checkpoint_root=str(root / ckpt))


def _bits(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + "/" + str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, "%s/%d" % (path, i))
        else:
            out[path] = np.asarray(t)
    walk(tree, "")
    return out


def assert_bit_identical(a, b):
    a, b = _bits(a), _bits(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _crashing(monkeypatch, name, after):
    """``steps.<name>``'s steps raise KeyboardInterrupt from call
    ``after`` + 1 on (a crash inside a step)."""
    orig = getattr(S, name)
    calls = {"n": 0}

    def make(*a, **k):
        fn = orig(*a, **k)

        def step(*sa, **sk):
            calls["n"] += 1
            if calls["n"] > after:
                raise KeyboardInterrupt("simulated crash")
            return fn(*sa, **sk)
        return step
    monkeypatch.setattr(S, name, make)
    return orig


def test_batcher_skip_matches_tail_and_the_jax_batches(ds):
    from simpleimagecaptionzoo_tpu.data.caption_data import \
        CaptionData as JCaptionData
    from simpleimagecaptionzoo_tpu.data.datasets import \
        CaptionTrainBatches as JBatches
    from simpleimagecaptionzoo_tpu.data.datasets import \
        _VisualSource as JVisualSource
    from simpleimagecaptionzoo_tpu_torch.data.datasets import \
        CaptionTrainBatches
    eng = _engine(ds)
    ann = str(ds / "modified_annotations" / "captions_train.json")
    b = CaptionTrainBatches(eng._capdata("train"), eng.vocab,
                            eng._visual_source(), batch_size=8,
                            max_caption_len=8, seed=0)
    full = list(b.epoch(epoch_index=3))
    tail = list(b.epoch(epoch_index=3, skip_batches=2))
    assert len(full) == 5 and len(tail) == len(full) - 2
    for x, y in zip(full[2:], tail):
        for k in ("captions", "lengths", "sample_weight"):
            np.testing.assert_array_equal(x[k], y[k])
        np.testing.assert_array_equal(x["visual"]["bu_feats"],
                                      y["visual"]["bu_feats"])
    other = list(b.epoch(epoch_index=4))
    assert any((x["captions"] != y["captions"]).any()
               for x, y in zip(full, other))
    from simpleimagecaptionzoo_tpu.data.datasets import SuppFeatureLoader
    jvs = JVisualSource("Flickr8K", "", False, SuppFeatureLoader(
        str(ds / "Data"), "fixed", 5))
    jb = JBatches(JCaptionData(annotation_file=ann), eng.vocab, jvs,
                  batch_size=8, max_caption_len=8, seed=0)
    for x, y in zip(tail, list(jb.epoch(epoch_index=3, skip_batches=2))):
        np.testing.assert_array_equal(x["captions"], y["captions"])
        np.testing.assert_array_equal(x["visual"]["bu_feats"],
                                      y["visual"]["bu_feats"])


def test_interrupted_xe_resume_is_bit_identical(ds, monkeypatch):
    ref = _engine(ds, "cp_ref")
    ref_cider = ref.training()
    # a crash in epoch 2's third step: its resume point is steps_done=2
    orig = _crashing(monkeypatch, "make_xe_train_step", 5 + 2)
    eng = _engine(ds, "cp_int")
    with pytest.raises(KeyboardInterrupt):
        eng.training()
    monkeypatch.setattr(S, "make_xe_train_step", orig)
    mid = ds / "cp_int" / TAG / "cp" / "midepoch_state.json"
    with open(mid) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["steps_done"], meta["step"]) == (2, 2, 7)
    assert [s["steps_done"] for s in eng.midepoch_saves] == [2, 4, 2]
    # a fresh engine (a new process) resumes
    res = _engine(ds, "cp_int")
    cider = res.training(start_from="checkpoint")
    assert not mid.exists()                  # cleared once epoch 2 is saved
    assert cider[-1] == ref_cider[-1]
    assert len(res.epoch_losses) == 3
    assert res.epoch_losses == ref.epoch_losses[2:]
    assert_bit_identical(to_numpy(res.tree["params"]),
                         to_numpy(ref.tree["params"]))
    assert torch.equal(res._gen.get_state(), ref._gen.get_state())


def test_resume_point_discarded_on_config_mismatch(ds, capsys):
    eng = _engine(ds, verbose=True)
    tx = make_grad_transform("Adam", 0.1)
    tree = {"params": eng.tree["params"],
            "model_state": eng.tree["model_state"],
            "opt_state": tx.init(eng.tree["params"])}
    meta = {"epoch": 1, "steps_done": 2, "step": 2,
            "rng": eng._gen.get_state().tolist(),
            **eng._midepoch_env(False, n_batches=5)}
    eng.ckpt.save_midepoch(tree, meta, scst=False)
    opt, skip, step = eng._try_resume_midepoch(tx, 1, scst=False,
                                               n_batches=5)
    assert opt is not None and skip == 2 and step == 2
    assert opt["count"] == 0 and set(opt) == {"count", "mu", "nu"}
    capsys.readouterr()
    for bad in ({"batch_size": 999}, {"seed": 7}, {"n_batches": 4},
                {"native_loader": not meta["native_loader"]},
                {"package": "another"}):
        eng.ckpt.save_midepoch(tree, dict(meta, **bad), scst=False)
        got = eng._try_resume_midepoch(tx, 1, scst=False, n_batches=5)
        assert got == (None, 0, None), bad
        assert "resume point discarded" in capsys.readouterr().out
    # another epoch's point is not this epoch's
    eng.ckpt.save_midepoch(tree, dict(meta, epoch=2), scst=False)
    assert eng._try_resume_midepoch(tx, 1, scst=False, n_batches=5) == \
        (None, 0, None)


def test_point_written_by_the_jax_package_is_discarded(ds, capsys):
    """The JAX package's resume point (its own engine's file and meta, in
    the same layout) is discarded: its random streams differ."""
    import jax
    from simpleimagecaptionzoo_tpu.config import ModelConfig as JModelConfig
    from simpleimagecaptionzoo_tpu.engine.checkpoint import \
        CheckpointManager as JCheckpointManager
    from simpleimagecaptionzoo_tpu.engine.optim import \
        make_grad_transform as jmake_tx
    from simpleimagecaptionzoo_tpu.models.base import get_captioner as jget
    eng = _engine(ds, verbose=True)
    jm = jget(JModelConfig(vocab_size=len(eng.vocab), **BUTD))
    jp = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    jtx = jmake_tx("Adam", 0.1)
    JCheckpointManager("BUTDDetection", "Flickr8K",
                       root=str(ds / "cp")).save_midepoch(
        {"params": jp, "model_state": {"cnn_stats": None},
         "opt_state": jtx.init(jp)},
        {"epoch": 1, "steps_done": 2, "rng": [0, 0], "batch_size": 8,
         "seed": 0, "n_batches": 5}, scst=False)
    assert os.path.exists(ds / "cp" / TAG / "cp" / "midepoch_state.json")
    capsys.readouterr()
    tx = make_grad_transform("Adam", 0.1)
    assert eng._try_resume_midepoch(tx, 1, scst=False, n_batches=5) == \
        (None, 0, None)
    out = capsys.readouterr().out
    assert "resume point discarded" in out and "JAX package" in out


def test_scst_midepoch_resume_is_bit_identical(ds, monkeypatch):
    idf = str(ds / "Data" / "cider_idf_table.npz")
    for ckpt in ("cp_ref", "cp_int"):
        _engine(ds, ckpt, num_epochs=1, midepoch_save_steps=0).training()
    ref = _engine(ds, "cp_ref", midepoch_save_steps=1)
    ref_cider = ref.scst_training(num_epochs=2, idf_cache=idf)
    # 8 images at B=4: 2 steps an epoch, a resume point after the first;
    # the crash in epoch 2's second step
    orig = _crashing(monkeypatch, "make_scst_train_step", 3)
    eng = _engine(ds, "cp_int", midepoch_save_steps=1)
    with pytest.raises(KeyboardInterrupt):
        eng.scst_training(num_epochs=2, idf_cache=idf)
    monkeypatch.setattr(S, "make_scst_train_step", orig)
    mid = ds / "cp_int" / TAG / "cp" / "midepoch_scst_state.json"
    with open(mid) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["steps_done"]) == (2, 1)
    res = _engine(ds, "cp_int", midepoch_save_steps=1)
    cider = res.scst_training(start_from="checkpoint", num_epochs=2,
                              idf_cache=idf)
    assert len(cider) == 2 and cider[-1] == ref_cider[-1]
    with open(ds / "cp_int" / TAG / "cp" / "scst_state_histories.json") as f:
        assert len(json.load(f)["cider_his"]) == 2
    assert res.epoch_rewards == ref.epoch_rewards[1:]
    assert_bit_identical(to_numpy(res.tree["params"]),
                         to_numpy(ref.tree["params"]))


def test_two_processes_resume_after_a_sigkill_bit_identical(ds, tmp_path):
    """Two gloo processes, each feeding 4 rows of the batch of 8: process 1
    SIGKILLs itself once epoch 2's resume point after step 2 has committed;
    process 0, left waiting at the next collective, is killed too; a fresh
    pair resumes and ends as the uninterrupted pair did."""
    base = dict(mode="engine", root=str(ds), cfg=dict(BUTD, dropout=0.5),
                epochs=2, train=dict(train_batch_size=8, eval_batch_size=8,
                                     midepoch_save_steps=2, ss=SS))

    def case(name, ckpt, **kw):
        d = tmp_path / ("cwd_" + name)
        d.mkdir(exist_ok=True)
        return dict(base, cwd=str(d), ckpt_root=str(tmp_path / ckpt), **kw)

    ref = torch_dist.run(tmp_path, case("ref", "cp2_ref",
                                        start_from="scratch"), name="ref")
    procs, _, logs = torch_dist.start(
        tmp_path, case("crash", "cp2_int", start_from="scratch",
                       kill=(1, 2, 2)), name="crash")
    assert procs[1].wait(timeout=torch_dist.TIMEOUT_S) == -signal.SIGKILL
    procs[0].kill()
    torch_dist.wait(procs, logs)
    with open(tmp_path / "cp2_int" / TAG / "cp" / "midepoch_state.json") as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["steps_done"]) == (2, 2)
    res = torch_dist.run(tmp_path, case("resume", "cp2_int",
                                        start_from="checkpoint"),
                         name="resume")
    assert ref[0]["cider"] == ref[1]["cider"]
    assert res[0]["cider"][-1] == ref[0]["cider"][-1]
    assert res[0]["losses"] == ref[0]["losses"][2:]
    for r in (res[0], res[1], ref[1]):
        assert_bit_identical(r["params"], ref[0]["params"])
        np.testing.assert_array_equal(r["gen_state"], ref[0]["gen_state"])
    # process 0 alone wrote the checkpoints and the metrics, once an epoch
    with open(tmp_path / "cp2_ref" / TAG / "metrics.jsonl") as f:
        assert [json.loads(x)["epoch"] for x in f] == [1, 2]
