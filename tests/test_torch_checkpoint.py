"""The port's checkpoints (``engine/checkpoint.py``) in the JAX package's
layout and flax msgpack format, written and read without flax: the file
names, a bit-exact round trip of float32, bf16 and integer leaves and of
AoA's ``refine`` list, a file written by JAX's CheckpointManager read by
the port (which then greedy-decodes to JAX's ids) and the port's file read
by JAX's, the resume epoch, and the idf npz cache shared both ways."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.data.caption_data import CaptionData as JCD
from simpleimagecaptionzoo_tpu.engine import engine as jengine
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.engine.checkpoint import \
    CheckpointManager as JaxCkpt
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops.cider import RewardVocab as JRewardVocab
from simpleimagecaptionzoo_tpu.vocab import build_vocab as jbuild_vocab
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData
from simpleimagecaptionzoo_tpu_torch.engine import engine as tengine
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import (
    MAX_CHUNK_SIZE, CheckpointManager, from_bytes, to_bytes)
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops.cider import RewardVocab
from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab

AOA = dict(model_type="AoADetection", vocab_size=40, embed_dim=32,
           hidden_dim=32, enc_dim=16, num_heads=4, num_refine_layers=2,
           max_bu_len=5)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _mixed_tree(gen):
    return {"params": {
        "w": torch.randn(3, 5, generator=gen),
        "bf": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
        "idx": torch.arange(7, dtype=torch.int32),
        "i64": torch.tensor([2 ** 40, -3], dtype=torch.int64),
        "q8": torch.randint(-128, 127, (2, 3), dtype=torch.int8,
                            generator=gen),
        "scalar": torch.tensor(1.5),
        "refine": [{"a": {"w": torch.randn(2, 2, generator=gen)}}
                   for _ in range(3)]},
        "model_state": {"cnn_stats": None}}


_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.view(_INT_OF[t.element_size()]) if t.is_floating_point() else t


def _equal_bits(a, b):
    """The same structure (dict keys in any order), dtypes, shapes and
    bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _equal_bits(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_bits(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_layout_and_file_names(tmp_path):
    m = CheckpointManager("AoADetection", "Flickr8K", root=str(tmp_path))
    tree = _mixed_tree(torch.Generator().manual_seed(0))
    m.save(tree, [0.5, 0.75])
    m.save_best(tree, 0.75)
    m.save(tree, [0.1], scst=True)
    m.save_best(tree, 0.1, scst=True)
    root = tmp_path / "Model_AoADetection_Dataset_Flickr8K"
    assert sorted(os.listdir(root / "cp")) == [
        "Captioner_cp.msgpack", "Captioner_scst_cp.msgpack",
        "scst_state_histories.json", "state_histories.json"]
    assert sorted(os.listdir(root / "best")) == [
        "Captioner_cp.msgpack", "Captioner_scst_cp.msgpack",
        "best_score_record.json", "best_scst_score_record.json"]
    with open(root / "best" / "best_scst_score_record.json") as f:
        assert json.load(f) == {"cider": 0.1}
    with open(root / "cp" / "state_histories.json") as f:
        assert json.load(f) == {"cider_his": [0.5, 0.75]}
    assert m.history_best() == 0.75 and m.history_best(scst=True) == 0.1
    # JAX's manager reads the same records
    j = JaxCkpt("AoADetection", "Flickr8K", root=str(tmp_path))
    assert j.history_best() == 0.75 and j.history_best(scst=True) == 0.1


@pytest.mark.parametrize("scst", [False, True])
@pytest.mark.parametrize("best", [False, True])
def test_round_trip_bit_for_bit(tmp_path, scst, best):
    m = CheckpointManager("AoADetection", "Flickr8K", root=str(tmp_path))
    tree = _mixed_tree(torch.Generator().manual_seed(1))
    if best:
        m.save_best(tree, 0.3, scst=scst)
    else:
        m.save(tree, [0.2, 0.3, 0.1], scst=scst)
    template = _mixed_tree(torch.Generator().manual_seed(2))
    got, his, start = m.load(template, scst=scst, best=best)
    _equal_bits(got, tree)
    assert isinstance(got["params"]["refine"], list)
    # the resume epoch is len(cider_his) + 1 (1 for a best load)
    assert (his, start) == (([], 1) if best else ([0.2, 0.3, 0.1], 4))


def test_load_without_a_file_keeps_the_current_weights(tmp_path, capsys):
    m = CheckpointManager("NIC", "Flickr8K", root=str(tmp_path))
    tree, his, start = m.load({"params": {}}, best=True)
    assert tree is None and his == [] and start == 1
    assert "WARNING" in capsys.readouterr().out


def test_bytes_equal_flax_and_refuse_mismatches():
    import flax.serialization as fs
    tree = _mixed_tree(torch.Generator().manual_seed(3))
    data = to_bytes(tree)
    jtree = jax.tree_util.tree_map(
        lambda t: None if t is None else np.asarray(
            jnp.asarray(t.float().numpy(), jnp.bfloat16))
        if t.dtype == torch.bfloat16 else t.numpy(), tree,
        is_leaf=lambda x: x is None)
    # flax writes the same bytes for the same tree, as the JAX package's
    # manager hands it (through tree_map)
    assert fs.to_bytes(jtree) == data
    bad = _mixed_tree(torch.Generator().manual_seed(3))
    bad["params"]["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="shape"):
        from_bytes(bad, data)
    bad = _mixed_tree(torch.Generator().manual_seed(3))
    bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="lacks"):
        from_bytes(bad, data)
    bad = _mixed_tree(torch.Generator().manual_seed(3))
    bad["params"]["refine"].append({"a": {"w": torch.zeros(2, 2)}})
    with pytest.raises(ValueError, match="entries"):
        from_bytes(bad, data)


def test_oversized_leaf_refused(monkeypatch):
    from simpleimagecaptionzoo_tpu_torch.engine import checkpoint
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunk size"):
        to_bytes({"w": torch.zeros(17)})
    assert MAX_CHUNK_SIZE == 2 ** 30


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A tiny AoADetection saved by JAX's CheckpointManager."""
    root = tmp_path_factory.mktemp("ckpt")
    jm = jax_get(JaxModelConfig(**AOA))
    params = jm.init_params(jax.random.PRNGKey(4), include_cnn=False)
    tree = {"params": params, "model_state": jm.init_model_state()}
    JaxCkpt("AoADetection", "Flickr8K", root=str(root)).save(tree, [0.25])
    return root, jm, tree


def test_jax_checkpoint_loads_in_the_port_bit_for_bit(jax_saved):
    root, _, jtree = jax_saved
    tm = get_captioner(ModelConfig(**AOA))
    template = {"params": tm.init_params(torch.Generator().manual_seed(0)),
                "model_state": tm.init_model_state()}
    got, his, start = CheckpointManager("AoADetection", "Flickr8K",
                                        root=str(root)).load(template)
    assert his == [0.25] and start == 2
    want = from_jax(jax.tree_util.tree_map(np.asarray, jtree["params"]))
    _equal_bits(got["params"], want)
    assert len(got["params"]["refine"]) == AOA["num_refine_layers"]


def test_port_greedy_decodes_the_jax_checkpoint_to_jax_ids(jax_saved):
    root, jm, jtree = jax_saved
    tm = get_captioner(ModelConfig(**AOA))
    template = {"params": tm.init_params(torch.Generator().manual_seed(0)),
                "model_state": tm.init_model_state()}
    got, _, _ = CheckpointManager("AoADetection", "Flickr8K",
                                  root=str(root)).load(template)
    rng = np.random.default_rng(5)
    vis = {"bu_feats": rng.normal(size=(6, 5, AOA["enc_dim"])).astype(
        np.float32), "bu_masks": np.ones((6, 5), np.float32)}
    vis["bu_masks"][1, 3:] = 0
    want = np.asarray(JS.make_greedy_decode(jm, 12)(
        jtree["params"], jtree["model_state"],
        jax.tree_util.tree_map(jnp.asarray, vis)))
    ids = TS.make_greedy_decode(tm, 12, device="cpu")(
        got["params"], got["model_state"], from_jax(vis))
    np.testing.assert_array_equal(ids.numpy(), want)


@pytest.mark.parametrize("bf16", [False, True])
def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path, bf16):
    tm = get_captioner(ModelConfig(**AOA))
    params = tm.init_params(torch.Generator().manual_seed(6))
    if bf16:
        params = TS._cast_floats(params, torch.bfloat16)
    CheckpointManager("AoADetection", "Flickr8K", root=str(tmp_path)).save(
        {"params": params, "model_state": tm.init_model_state()}, [0.5, 0.6])
    jm = jax_get(JaxModelConfig(**AOA))
    jp = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    if bf16:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    template = {"params": jp, "model_state": jm.init_model_state()}
    tree, his, start = JaxCkpt("AoADetection", "Flickr8K",
                               root=str(tmp_path)).load(template)
    assert his == [0.5, 0.6] and start == 3
    back = from_jax(jax.tree_util.tree_map(np.asarray, tree["params"]))
    _equal_bits(back, params)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_idf_npz_cache_read_by_the_other_package(tmp_path, writer):
    words = ["a", "dog", "runs", "on", "grass"]
    rng = np.random.default_rng(7)
    images, anns = [], []
    for i in range(6):
        sents = []
        for s in range(3):
            toks = [words[int(j)] for j in rng.integers(0, 5, 4)]
            sents.append({"tokens": toks})
            anns.append({"image_id": i, "id": i * 3 + s, "tokens": toks,
                         "caption": " ".join(toks)})
        images.append({"id": i, "file_name": "%d.jpg" % i,
                       "sentences": sents})
    path = tmp_path / "ann.json"
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    cache = str(tmp_path / "cider_idf_table.npz")
    logs = []
    me = types.SimpleNamespace(_log=logs.append)
    jv, tv = jbuild_vocab([words], 1), build_vocab([words], 1)
    jargs = (JCD(str(path)), JRewardVocab(jv), cache)
    targs = (CaptionData(str(path)), RewardVocab(tv), cache)
    first, second = ((jengine.Engine, jargs), (tengine.Engine, targs))
    if writer == "port":
        first, second = second, first
    built = first[0]._cider_table(me, *first[1])
    assert os.path.exists(cache)
    read = second[0]._cider_table(me, *second[1])
    assert not logs                       # read, not rebuilt
    for k in ("h1", "h2", "df"):
        np.testing.assert_array_equal(getattr(read, k), getattr(built, k))
    assert read.log_ref_len == built.log_ref_len
