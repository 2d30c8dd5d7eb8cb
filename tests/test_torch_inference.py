"""The port's inference bundle (simpleimagecaptionzoo_tpu_torch/inference.py)
against the JAX package's ``load_inference_bundle``, on the CPU.

Both bundles load one checkpoint written by the JAX package's
``CheckpointManager`` (tests/torch_serving.py: NIC, BUTDSpatial and
AoASpatial at small widths, the ResNet at block counts (1, 1, 1, 1) with
calibrated running statistics, both trunks float32) and decode the same
photo-like uint8 images: greedy (cap 20) and beam-3 (cap 50) ids
identical in float32; in NIC's int8 serving form (bf16 activations over
the int8 hot set, which the two packages round in different orders) the
first two ids identical and any later difference a near tie under the rule
of tests/test_torch_aoa_bf16.py.  Also: the caps, the JAX package's
exits (detection families, a missing checkpoint, ``beam`` 0), the tree on
the device in the decode dtype with the int8 layers' types kept, and the
GPU default.
"""
import os

import numpy as np
import pytest
import torch

import torch_serving as TSV
from simpleimagecaptionzoo_tpu_torch import inference as TINF
from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
from simpleimagecaptionzoo_tpu_torch.ops import quant

B = 4
GAP_TOL = 1e-2                   # tests/test_torch_aoa_bf16.py's rule
# a greedy pick's float32 logit gap, over the row's largest |logit|: bf16
# keeps 2^-8 of a value, and a step's logits pass through about four bf16
# roundings (x, h and c of the cell, the head's input)
BF16_GAP = 2.0 ** -6


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with TSV.shallow_f32_trunks():
        yield


@pytest.fixture(autouse=True)
def _threads(monkeypatch):
    torch.set_num_threads(1)
    for name in ("SICZ_TPU_FUSED_HEAD", "SICZ_TPU_PALLAS_LSTM",
                 "SICZ_TPU_PALLAS_QUANT"):
        monkeypatch.setenv(name, "auto")


_LAYOUTS = {}


def layout_of(family, tmp_path_factory):
    if family not in _LAYOUTS:
        _LAYOUTS[family] = TSV.write_layout(
            tmp_path_factory.mktemp("bundle_" + family), family)
    return _LAYOUTS[family]


def port_bundle(layout, beam, dtype, device="cpu"):
    return TINF.load_inference_bundle(use_scst_model=False, beam=beam,
                                      dtype=dtype, device=device, **layout)


@pytest.mark.parametrize("family,dtype", [
    ("NIC", "float32"), ("NIC", "int8"), ("BUTDSpatial", "float32"),
    ("AoASpatial", "float32")])
@pytest.mark.parametrize("beam", [-1, 3])
def test_bundle_ids_equal_jax_bundle(family, dtype, beam, tmp_path_factory):
    """The port's bundle and the JAX package's, on the JAX-written
    checkpoint: ids identical (greedy (B, 20); beam 3 (B, 51) with column
    0 = <sta>), and the images choose them."""
    layout = layout_of(family, tmp_path_factory)
    images = TSV.photos(B, 224, 11)
    jb = TSV.jax_bundle(layout, beam, dtype)
    jids = np.asarray(jb.decode(jb.tree["params"], jb.tree["model_state"],
                                {"img_tensors": images}))
    tb = port_bundle(layout, beam, dtype)
    tids = tb.decode(tb.tree["params"], tb.tree["model_state"],
                     {"img_tensors": torch.from_numpy(images)}).numpy()
    cap = TINF.GREEDY_MAX_LEN if beam == -1 else TINF.BEAM_MAX_LEN + 1
    assert tids.shape == jids.shape == (B, cap)
    first = tids[:, 0] if beam == -1 else tids[:, 1]
    assert len(set(first.tolist())) >= 2, tids[:, :4]
    if dtype == "float32":
        np.testing.assert_array_equal(tids, jids)
        return
    assert quant.is_quantized(tb.tree["params"]["lstm"])
    np.testing.assert_array_equal(tids[:, :2], jids[:, :2])
    near_tie(tb, images, tids, jids, beam)


def near_tie(tb, images, tids, jids, beam):
    """Int8 serving runs bf16 activations, which the two packages round in
    different orders: ids identical, or (the rule of
    tests/test_torch_aoa_bf16.py) a greedy row's first difference at an id
    whose float32 logit, the port's step over the int8 tree after the
    common prefix, is within ``BF16_GAP`` of the row's largest |logit| of
    the port's pick (NIC's sharpened head gives logits near 3, where
    ``GAP_TOL``'s 1e-2 is under three bf16 roundings), and a beam
    row's two winners, rescored by the port's float32 step, within
    ``GAP_TOL``."""
    differ = np.flatnonzero((tids != jids).any(axis=1))
    if not len(differ):
        return
    from simpleimagecaptionzoo_tpu_torch import STA_ID
    from simpleimagecaptionzoo_tpu_torch.engine.steps import _cast_floats
    from simpleimagecaptionzoo_tpu_torch.ops import decode
    tm = tb.model
    params = _cast_floats(tb.tree["params"], torch.float32)
    with torch.no_grad():
        enc, _ = tm.encode(params, {"img_tensors": torch.from_numpy(images)},
                           model_state=tb.tree["model_state"])
        if beam != -1:
            diff = (decode.sequence_logprob(tm, params, enc,
                                            torch.from_numpy(tids))
                    - decode.sequence_logprob(tm, params, enc,
                                              torch.from_numpy(jids).long()))
            assert (diff.abs().numpy()[differ] < GAP_TOL).all(), diff
            return
        first = {int(i): int(np.flatnonzero(tids[i] != jids[i])[0])
                 for i in differ}
        state = tm.init_state(params, enc)
        tok = torch.full((B,), STA_ID, dtype=torch.long)
        for t in range(max(first.values()) + 1):
            hidden, state, _ = tm.step_core(params, enc, state, tok)
            logits = tm.predict(params, hidden)
            for i, ti in first.items():
                if ti == t:
                    gap = float(logits[i, tids[i, t]]
                                - logits[i, jids[i, t]])
                    scale = float(logits[i].abs().max())
                    assert abs(gap) < BF16_GAP * scale, (i, t, gap, scale)
            tok = torch.from_numpy(tids[:, t]).long()


def test_caps_and_constants():
    assert (TINF.GREEDY_MAX_LEN, TINF.BEAM_MAX_LEN) == (20, 50)
    from simpleimagecaptionzoo_tpu import inference as JINF
    assert (JINF.GREEDY_MAX_LEN, JINF.BEAM_MAX_LEN) == (20, 50)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tree_lives_in_the_decode_dtype(dtype, tmp_path_factory):
    """The bundle's tree is cast once: float leaves in the decode dtype
    (bf16 for int8), the int8 layers' q int8 and s float32, the running
    statistics float32; the decode's own cast then returns each leaf as
    it is (no copy a batch)."""
    from simpleimagecaptionzoo_tpu_torch.engine.steps import _cast_floats
    tb = port_bundle(layout_of("NIC", tmp_path_factory), -1, dtype)
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    params = tb.tree["params"]
    for path, layer in (("lstm", params["lstm"]),
                        ("predict", params["predict"])):
        if dtype == "int8":
            assert layer["q"].dtype == torch.int8, path
            assert layer["s"].dtype == torch.float32, path
    assert params["cnn"]["conv1"].dtype == want
    assert params["img_embed"]["v"].dtype == want
    assert all(t.dtype == torch.float32
               for t in tree_leaves(tb.tree["model_state"]))
    cast = _cast_floats(params, None if dtype == "float32" else want, "cpu")
    assert all(a is b for a, b in zip(tree_leaves(cast),
                                      tree_leaves(params)))


def test_exits_match_jax(tmp_path_factory, tmp_path):
    """The JAX package's SystemExit messages: the detection families, a
    missing checkpoint, and a beam that is neither -1 nor >= 1."""
    from simpleimagecaptionzoo_tpu import inference as JINF
    layout = layout_of("NIC", tmp_path_factory)
    md = os.path.join(layout["model_config_root"], "AoADetection.json")
    with open(md, "w") as f:
        f.write('{"model_type": "AoADetection", "embed_dim": 16, '
                '"hidden_dim": 16}')
    det = dict(layout, model_type="AoADetection")
    for load in (JINF.load_inference_bundle, TINF.load_inference_bundle):
        kw = {} if load is JINF.load_inference_bundle else {"device": "cpu"}
        with pytest.raises(SystemExit, match="Detection models need"):
            load(use_scst_model=False, beam=3, dtype="float32", **det, **kw)
        with pytest.raises(SystemExit, match="no checkpoint found under"):
            load(use_scst_model=False, beam=3, dtype="float32",
                 **dict(layout, checkpoint_root=str(tmp_path / "none")),
                 **kw)
        with pytest.raises(SystemExit,
                           match=r"--beam must be -1 \(greedy\) or >= 1, "
                                 r"got 0"):
            load(use_scst_model=False, beam=0, dtype="float32", **layout,
                 **kw)


def test_bundle_defaults_to_the_gpu(tmp_path_factory):
    """Without a card, and without the CPU asked for, the bundle raises
    rather than decode on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layout = layout_of("NIC", tmp_path_factory)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TINF.load_inference_bundle(use_scst_model=False, beam=3,
                                   dtype="float32", **layout)
