"""The port's reference-checkpoint converter
(``simpleimagecaptionzoo_tpu_torch/convert_reference.py``) and its two
tools against the JAX package's, on the synthetic reference-shaped
state_dicts of tests/test_convert_reference.py (its modules with the
reference's attribute layout; the ResNet's keys from
tests/test_resnet_weights.synthetic_state_dict at block counts (1, 1, 1, 1)
in both packages).

Holds: for every family the port's tree equals JAX's ``convert_state_dict``
leaf for leaf, exactly (numpy float32 both); greedy ids equal JAX's on the
converted params; export -> convert is bit-exact; the port's ``.pth``
strict-loads into the reference-shaped modules; strict mode refuses a wrong
model type; the new-style weight-norm keys are accepted; both tools run end
to end with ``--gpu_id cpu`` and give back the state_dict they were given,
bit for bit."""
import json

import jax
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu import convert_reference as JR
from simpleimagecaptionzoo_tpu.config import ModelConfig as JModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models import resnet as jresnet
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jget
from simpleimagecaptionzoo_tpu_torch import convert_reference as TR
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models import resnet as tresnet
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.tools import (
    convert_reference_checkpoint, export_reference_checkpoint)
from test_convert_reference import (A, E, ENC, H, HEADS, LAYERS, NBOX, V,
                                    RefAoA, RefBUTD, RefNIC)
from test_resnet_weights import synthetic_state_dict

FAMILIES = ("NIC", "BUTDSpatial", "BUTDDetection", "AoASpatial",
            "AoADetection")
REF = {"NIC": RefNIC, "BUTDSpatial": RefBUTD, "BUTDDetection": RefBUTD,
       "AoASpatial": RefAoA, "AoADetection": RefAoA}
_SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
        "layer3": "6", "layer4": "7"}


@pytest.fixture(autouse=True)
def _small_resnet(monkeypatch):
    monkeypatch.setattr(jresnet, "BLOCK_COUNTS", (1, 1, 1, 1))
    monkeypatch.setattr(tresnet, "BLOCK_COUNTS", (1, 1, 1, 1))
    torch.set_num_threads(1)


def _cfg_kw(family):
    kw = dict(model_type=family, vocab_size=V, embed_dim=E, hidden_dim=H,
              enc_dim=ENC)
    if family.startswith("BUTD"):
        kw.update(atten_dim=A, max_bu_len=NBOX)
    elif family.startswith("AoA"):
        kw.update(num_heads=HEADS, num_refine_layers=LAYERS,
                  max_bu_len=NBOX)
    if family.endswith("Spatial"):
        kw.update(enc_img_size=1)
    return kw


def reference_state_dict(family, seed=0, cnn=None):
    """A reference-shaped state_dict of ``family``: the reference module's
    random init from ``seed`` (torch), plus the ResNet's keys under
    ``encoder.feature_extractor`` (the Spatial families always, NIC when
    ``cnn``)."""
    torch.manual_seed(seed)
    sd = dict(REF[family]().state_dict())
    if cnn if cnn is not None else family.endswith("Spatial"):
        for k, v in synthetic_state_dict().items():
            if k.startswith("fc."):
                continue
            name, _, tail = k.partition(".")
            sd["encoder.feature_extractor.%s.%s" % (_SEQ[name], tail)] = v
    return sd


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def assert_trees_equal(got, want):
    """Same structure, every leaf float32 and equal bit for bit."""
    g, w = _leaves_with_paths(got), _leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == np.float32 and b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("family,cnn", [(f, None) for f in FAMILIES]
                         + [("NIC", True)])
def test_converted_tree_equals_jax_exactly(family, cnn):
    sd = reference_state_dict(family, cnn=cnn)
    params, stats = TR.convert_state_dict(sd, family)
    jparams, jstats = JR.convert_state_dict(sd, family)
    assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, jparams))
    if jstats is None:
        assert stats is None
    else:
        assert_trees_equal(stats, jax.tree_util.tree_map(np.asarray, jstats))
    if family.startswith("AoA"):
        assert len(params["refine"]) == LAYERS    # read from the keys


def _visual(family, rng, b=4):
    if family == "NIC":
        return {"features": rng.normal(size=(b, ENC)).astype(np.float32)}
    if family.endswith("Detection"):
        return {"bu_feats": rng.normal(size=(b, NBOX, ENC)).astype(
            np.float32), "bu_masks": np.ones((b, NBOX), np.float32)}
    return {"spatial_feats": rng.normal(size=(b, 1, ENC)).astype(
        np.float32)}


@pytest.mark.parametrize("family", ["NIC", "BUTDDetection", "AoADetection"])
def test_greedy_ids_on_converted_params_equal_jax(family):
    sd = reference_state_dict(family, seed=3)
    for v in sd.values():           # larger weights: varied captions
        if v.is_floating_point():
            v.mul_(4.0)
    params, _ = TR.convert_state_dict(sd, family)
    jparams, _ = JR.convert_state_dict(sd, family)
    visual = _visual(family, np.random.default_rng(2))
    kw = _cfg_kw(family)
    jm, tm = jget(JModelConfig(**kw)), get_captioner(ModelConfig(**kw))
    jids = np.asarray(JS.make_greedy_decode(jm, 12)(
        jparams, {}, jax.tree_util.tree_map(jax.numpy.asarray, visual)))
    ids = TS.make_greedy_decode(tm, 12, device="cpu")(
        from_jax(params), {}, from_jax(visual))
    np.testing.assert_array_equal(ids.numpy(), jids.astype(np.int64))
    assert len(np.unique(jids)) > 2


@pytest.mark.parametrize("family", FAMILIES)
def test_export_convert_roundtrip_bit_exact(family):
    model = get_captioner(ModelConfig(**_cfg_kw(family)))
    cnn = family.endswith("Spatial")
    params = model.init_params(torch.Generator().manual_seed(3),
                               include_cnn=cnn)
    ms = model.init_model_state()
    if cnn:
        ms = {"cnn_stats": jax.tree_util.tree_map(
            lambda t: t + 0.25, ms["cnn_stats"])}
    sd = TR.export_state_dict(params, ms, family)
    # the JAX package's export of the same tree writes the same dict
    jsd = JR.export_state_dict(jax.tree_util.tree_map(
        lambda t: t.numpy(), params), jax.tree_util.tree_map(
        lambda t: t.numpy(), ms), family)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
        assert sd[k].dtype == jsd[k].dtype, k
    back, stats = TR.convert_state_dict(sd, family)
    assert_trees_equal(back, params)
    if cnn:
        assert_trees_equal(stats, ms["cnn_stats"])
    else:
        assert stats is None


@pytest.mark.parametrize("family", ["NIC", "BUTDDetection", "AoADetection"])
def test_port_pth_strict_loads_into_the_reference_module(tmp_path, family):
    model = get_captioner(ModelConfig(**_cfg_kw(family)))
    params = model.init_params(torch.Generator().manual_seed(4))
    path = str(tmp_path / "Captioner_cp.pth")
    TR.save_reference_checkpoint(path, params, None, family)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    m = REF[family]()
    m.load_state_dict(sd, strict=True)
    back, _ = TR.convert_state_dict(m.state_dict(), family)
    assert_trees_equal(back, params)


def test_strict_mode_rejects_wrong_model_type():
    sd = reference_state_dict("BUTDDetection")
    with pytest.raises((KeyError, ValueError)):
        TR.convert_state_dict(sd, "NIC")
    with pytest.raises(ValueError, match="unconsumed"):
        TR.convert_state_dict(dict(sd, **{"extra.weight": torch.ones(2)}),
                              "BUTDDetection")
    params, _ = TR.convert_state_dict(
        dict(sd, **{"extra.weight": torch.ones(2)}), "BUTDDetection",
        strict=False)
    assert set(params) == set(TR.convert_state_dict(sd, "BUTDDetection")[0])


def test_new_style_weight_norm_keys_accepted():
    sd = reference_state_dict("NIC")
    new = dict(sd)
    for pre in ("encoder.img_embedding", "decoder.predict"):
        new[pre + ".parametrizations.weight.original0"] = new.pop(
            pre + ".weight_g")
        new[pre + ".parametrizations.weight.original1"] = new.pop(
            pre + ".weight_v")
    params, _ = TR.convert_state_dict(new, "NIC")
    assert_trees_equal(params, TR.convert_state_dict(sd, "NIC")[0])
    assert_trees_equal(params, jax.tree_util.tree_map(
        np.asarray, JR.convert_state_dict(new, "NIC")[0]))


@pytest.mark.parametrize("family", ["AoADetection", "NIC"])
def test_both_tools_run_end_to_end_on_the_cpu(tmp_path, family, capsys):
    """convert_reference_checkpoint writes the checkpoint (best/ slot here)
    that export_reference_checkpoint reads back into a .pth equal to the
    state_dict given, key for key and bit for bit (NIC from pixels, its
    dead encoder.bn at identity, as the export writes it)."""
    sd = reference_state_dict(family, seed=5, cnn=family == "NIC")
    if family == "NIC":
        sd["encoder.bn.running_mean"].zero_()
        sd["encoder.bn.running_var"].fill_(1.0)
        sd["encoder.bn.weight"].fill_(1.0)
        sd["encoder.bn.bias"].zero_()
    src = tmp_path / "ref.pth"
    torch.save(sd, src)
    root = tmp_path / "CheckPoints"
    assert convert_reference_checkpoint.main(
        ["--pth", str(src), "--model_type", family, "--dataset", "Flickr8K",
         "--best", "--checkpoint_root", str(root), "--gpu_id", "cpu"]) == 0
    assert (root / ("Model_%s_Dataset_Flickr8K" % family) / "best"
            / "Captioner_cp.msgpack").exists()
    cfg = tmp_path / "model.json"
    kw = {k: v for k, v in _cfg_kw(family).items() if k != "vocab_size"}
    cfg.write_text(json.dumps(kw))
    out = tmp_path / "back.pth"
    assert export_reference_checkpoint.main(
        ["--model_config", str(cfg), "--vocab_size", str(V), "--dataset",
         "Flickr8K", "--best", "--checkpoint_root", str(root), "--out",
         str(out), "--gpu_id", "cpu"]) == 0
    back = torch.load(out, map_location="cpu", weights_only=True)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(back[k].reshape(-1)[0]) == 0
            continue
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    text = capsys.readouterr().out
    assert "converted %s" % family in text and "exported" in text
