"""The port's CLI (``simpleimagecaptionzoo_tpu_torch.main``): every flag of
the JAX package's ``build_argparser`` with the same default and choices,
``--gpu_id`` (an index is ``cuda:<i>``, ``cpu`` the CPU, the default the
card), DataConfig and the vocabulary pickle shared with the JAX package, and
train, eval, sample and resume through ``main()`` with ``--gpu_id cpu`` on
the data tests/test_cli.py writes."""
import json
import os
import subprocess
import sys

import pytest
import torch

from simpleimagecaptionzoo_tpu import main as jmain
from simpleimagecaptionzoo_tpu.config import DataConfig as JDataConfig
from simpleimagecaptionzoo_tpu.vocab import build_vocab as jbuild_vocab
from simpleimagecaptionzoo_tpu.vocab import load_vocab as jload_vocab
from simpleimagecaptionzoo_tpu.vocab import save_vocab as jsave_vocab
from simpleimagecaptionzoo_tpu_torch import main as M
from simpleimagecaptionzoo_tpu_torch.config import DataConfig
from simpleimagecaptionzoo_tpu_torch.vocab import (build_vocab, load_vocab,
                                                   save_vocab)
from test_cli import _write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "CheckPoints/Model_BUTDDetection_Dataset_Flickr8K/"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_jax_flag_with_its_default_and_choices():
    jax_acts = _actions(jmain.build_argparser())
    port_acts = _actions(M.build_argparser())
    assert set(port_acts) == set(jax_acts)
    for dest, ja in jax_acts.items():
        pa = port_acts[dest]
        assert pa.option_strings == ja.option_strings, dest
        assert pa.default == ja.default, dest
        assert pa.choices == ja.choices, dest
        assert (pa.type is None) == (ja.type is None), dest
        if ja.type is not None and ja.type.__name__ != "_str2bool":
            assert pa.type is ja.type, dest
    # the defaults parse to equal namespaces
    assert vars(M.build_argparser().parse_args([])) == vars(
        jmain.build_argparser().parse_args([]))


@pytest.mark.parametrize("flag,value,want", [
    ("--eval_scst", "False", False), ("--eval_best", "yes", True),
    ("--tqdm_visible", "0", False), ("--output_statics", "TRUE", True)])
def test_bool_flags_parse_as_jax(flag, value, want):
    got = getattr(M.build_argparser().parse_args([flag, value]),
                  flag.lstrip("-"))
    assert got is want is getattr(jmain.build_argparser().parse_args(
        [flag, value]), flag.lstrip("-"))


def test_bad_choice_and_bool_rejected():
    for args in (["--operation", "serve"], ["--eval_scst", "maybe"],
                 ["--decode_dtype", "fp8"]):
        with pytest.raises(SystemExit):
            M.build_argparser().parse_args(args)


@pytest.mark.parametrize("gpu_id,want", [("0", "cuda:0"), ("3", "cuda:3"),
                                         ("cpu", "cpu"), ("CPU", "cpu")])
def test_gpu_id_selects_the_device(gpu_id, want):
    assert M.device_of(gpu_id) == want


@pytest.mark.parametrize("gpu_id", ["-1", "x", "cuda"])
def test_bad_gpu_id_raises(gpu_id):
    with pytest.raises(ValueError, match="--gpu_id"):
        M.device_of(gpu_id)


@pytest.fixture()
def ds(tmp_path, monkeypatch):
    _write_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    # enc_dim must match the synthetic features (as tests/test_cli.py)
    orig = M.load_model_config
    monkeypatch.setattr(M, "load_model_config",
                        lambda *a, **k: orig(*a, **dict(k, enc_dim=8,
                                                        max_bu_len=5)))
    return tmp_path


BASE = ["--dataset", "Flickr8K", "--model_type", "BUTDDetection",
        "--use_bu", "fixed", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--scst_train_batch_size", "8",
        "--tqdm_visible", "False"]


def _run(*extra, gpu="cpu"):
    return M.main(M.build_argparser().parse_args(
        BASE + ["--gpu_id", gpu] + list(extra)))


def test_default_gpu_id_needs_a_card(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.main(M.build_argparser().parse_args(BASE + ["--operation",
                                                      "train"]))


def test_cli_train_eval_sample_resume(ds):
    assert _run("--operation", "train", "--num_epochs", "1") == 0
    assert os.path.exists(CKPT + "cp/Captioner_cp.msgpack")
    assert _run("--operation", "eval", "--eval_split", "test",
                "--eval_beam_size", "2") == 0
    assert os.path.exists("coco_caption/results/captions-generate.json")
    assert _run("--operation", "sample", "--img_filename", "img_0.jpg",
                "--eval_beam_size", "-1") == 0
    assert _run("--operation", "train", "--num_epochs", "2",
                "--start_from", "checkpoint") == 0
    with open(CKPT + "cp/state_histories.json") as f:
        assert len(json.load(f)["cider_his"]) == 2
    with open(CKPT + "metrics.jsonl") as f:
        phases = [json.loads(x)["phase"] for x in f]
    assert phases == ["xe", "eval", "xe"]
    # the checkpoint the port wrote loads in the JAX package's CLI
    jorig = jmain.load_model_config
    jmain.load_model_config = lambda *a, **k: jorig(
        *a, **dict(k, enc_dim=8, max_bu_len=5))
    try:
        assert jmain.main(jmain.build_argparser().parse_args(
            BASE + ["--operation", "eval", "--eval_split", "test",
                    "--eval_beam_size", "-1", "--eval_best", "False"])) == 0
    finally:
        jmain.load_model_config = jorig


def test_cli_scst_and_int8_eval(ds):
    assert _run("--operation", "train", "--num_epochs", "1") == 0
    assert _run("--operation", "scst_train", "--scst_num_epochs", "1") == 0
    assert os.path.exists("Data/cider_idf_table.npz")
    assert os.path.exists(CKPT + "cp/Captioner_scst_cp.msgpack")
    assert _run("--operation", "eval", "--decode_dtype", "int8",
                "--eval_scst", "True") == 0
    with open(CKPT + "metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["phase"] == "eval" and last["scst"] is True
    assert last["decode_dtype"] == "int8"


def test_cli_midepoch_and_needs_the_vocab(ds, monkeypatch):
    """--midepoch_save_steps 4 writes a resume point within the epoch (5
    steps at B=8, so after step 4; cleared at the epoch's end); a missing
    vocab is still refused."""
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    metas = []
    save = CheckpointManager.save_midepoch

    def spy(self, tree, meta, scst=False):
        metas.append(dict(meta))
        return save(self, tree, meta, scst=scst)
    monkeypatch.setattr(CheckpointManager, "save_midepoch", spy)
    assert _run("--operation", "train", "--num_epochs", "1",
                "--midepoch_save_steps", "4") == 0
    assert [(m["epoch"], m["steps_done"]) for m in metas] == [(1, 4)]
    assert not os.path.exists(CKPT + "cp/midepoch_state.json")
    assert _run("--operation", "sample") == 1      # no --img_filename
    os.remove("Data/caption_vocab.pkl")
    assert _run("--operation", "train") == 1


def test_torchrun_env_picks_the_device_or_refuses(monkeypatch):
    """Without WORLD_SIZE (or at 1) no process group starts and --gpu_id
    picks the device; under WORLD_SIZE > 1 any --gpu_id other than the
    default (cuda:$LOCAL_RANK, NCCL) and cpu (gloo) is refused."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.start_process_group("cpu") == ("cpu", False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.start_process_group("2") == ("cuda:2", False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        M.start_process_group("1")
    assert not torch.distributed.is_initialized()


def test_data_config_equals_jax(ds):
    path = str(ds / "Configs" / "Datasets" / "Flickr8K.data")
    for kw in ({}, {"base_dir": str(ds), "dataset_name": "X"}):
        assert vars(DataConfig.from_data_file(path, **kw)) == vars(
            JDataConfig.from_data_file(path, **kw))


def test_vocab_pickles_load_in_both_packages(tmp_path):
    toks = [["a", "dog", "runs"], ["a", "cat"], ["a", "dog"]]
    ours, theirs = build_vocab(toks, 2), jbuild_vocab(toks, 2)
    assert ours.word2ix == theirs.word2ix == {
        "<pad>": 0, "<sta>": 1, "<end>": 2, "<unk>": 3, "a": 4, "dog": 5}
    save_vocab(ours, str(tmp_path / "t.pkl"))
    jsave_vocab(theirs, str(tmp_path / "j.pkl"))
    for path in ("t.pkl", "j.pkl"):
        for load in (load_vocab, jload_vocab):
            v = load(str(tmp_path / path))
            assert v.word2ix == ours.word2ix and v.ix2word == ours.ix2word


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m",
                          "simpleimagecaptionzoo_tpu_torch.main", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "--gpu_id" in out.stdout
