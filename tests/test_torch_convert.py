"""The parameter bridge between the JAX package and its PyTorch port, and the
port's independence from JAX: it imports neither ``jax`` nor anything of
``simpleimagecaptionzoo_tpu``."""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu_torch.convert import from_jax, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "simpleimagecaptionzoo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "simpleimagecaptionzoo_tpu")


def _jax_params():
    cfg = JaxModelConfig(model_type="AoADetection", vocab_size=50,
                         embed_dim=16, hidden_dim=16, enc_dim=12, num_heads=2,
                         num_refine_layers=2, max_bu_len=5)
    params = jax_get(cfg).init_params(jax.random.PRNGKey(3),
                                      include_cnn=False)
    return jax.tree_util.tree_map(np.asarray, params)


def test_round_trip_is_exact():
    torch.set_num_threads(1)
    ref = _jax_params()
    tp = from_jax(ref)
    assert isinstance(tp["refine"], list) and len(tp["refine"]) == 2
    assert tp["lstm"]["w_ih"].shape == ref["lstm"]["w_ih"].shape  # (in, out)
    assert isinstance(tp["predict"]["v"], torch.Tensor)
    back = to_numpy(tp)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    back_leaves, back_def = jax.tree_util.tree_flatten(back)
    assert ref_def == back_def
    for a, b in zip(ref_leaves, back_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["BUTDDetection", "BUTDSpatial"])
@pytest.mark.parametrize("bf16", [False, True])
def test_butd_tree_carries_across(family, bf16):
    """A BUTD param tree (both cells, the weight-norm layers, the zeroed
    head bias), as float32 leaves or as JAX's bf16 leaves, arrives with the
    same structure, shapes and bits; the port's own init draws the same
    tree."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    torch.set_num_threads(1)
    dims = dict(model_type=family, vocab_size=30, embed_dim=16,
                hidden_dim=24, atten_dim=8, enc_dim=12)
    ref = jax_get(JaxModelConfig(**dims)).init_params(jax.random.PRNGKey(5),
                                                      include_cnn=False)
    if bf16:
        ref = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref)
    tp = from_jax(ref)
    assert tp["lstm_td"]["w_ih"].shape == (16 + 12 + 24, 4 * 24)
    assert tp["lstm_lang"]["w_ih"].shape == (12 + 24, 4 * 24)
    assert tp["att_affine"]["v"].shape == (8, 1)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    leaves, tdef = jax.tree_util.tree_flatten(tp)
    assert tdef == ref_def
    for a, t in zip(ref_leaves, leaves):
        assert t.dtype == (torch.bfloat16 if bf16 else torch.float32)
        want = np.asarray(a.astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want)
    mine = get_captioner(ModelConfig(**dims)).init_params(
        torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, ref))


@pytest.mark.parametrize("family", ["NIC", "AoASpatial"])
@pytest.mark.parametrize("bf16", [False, True])
def test_nic_and_aoa_spatial_trees_carry_across(family, bf16):
    """A NIC tree (the weight-norm image embedding, the N(0, 1) embedding,
    one cell) and an AoASpatial tree (the refiner's list, the decoder's AoA
    block), built by the JAX package without ``cnn``, as float32 leaves or
    as JAX's bf16 leaves, arrive with the same structure, shapes and bits;
    the port's own init draws the same tree."""
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    torch.set_num_threads(1)
    dims = dict(model_type=family, vocab_size=30, embed_dim=16,
                hidden_dim=24, enc_dim=12, num_heads=2, num_refine_layers=2)
    ref = jax_get(JaxModelConfig(**dims)).init_params(jax.random.PRNGKey(7),
                                                      include_cnn=False)
    assert "cnn" not in ref
    if bf16:
        ref = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref)
    tp = from_jax(ref)
    if family == "NIC":
        assert tp["img_embed"]["v"].shape == (12, 16)
        assert tp["lstm"]["w_ih"].shape == (16, 4 * 24)
    else:
        assert isinstance(tp["refine"], list) and len(tp["refine"]) == 2
        assert tp["lstm"]["w_ih"].shape == (16 + 24, 4 * 24)
        assert tp["aoa_dec"]["aoa"]["w"].shape == (48, 48)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    leaves, tdef = jax.tree_util.tree_flatten(tp)
    assert tdef == ref_def
    for a, t in zip(ref_leaves, leaves):
        assert t.dtype == (torch.bfloat16 if bf16 else torch.float32)
        want = np.asarray(a.astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want)
    mine = get_captioner(ModelConfig(**dims)).init_params(
        torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, ref))


def test_bf16_round_trip_comes_back_float32():
    torch.set_num_threads(1)
    tp = from_jax({"w": np.linspace(-1, 1, 7, dtype=np.float32)},
                  dtype=torch.bfloat16)
    assert tp["w"].dtype == torch.bfloat16
    back = to_numpy(tp)["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, tp["w"].float().numpy())


@pytest.mark.parametrize("as_numpy", [False, True])
def test_bf16_leaf_carries_bit_for_bit(as_numpy):
    """A bf16 leaf, as a jnp array or after ``np.asarray`` (ml_dtypes'
    bfloat16, which torch.from_numpy refuses), arrives as torch.bfloat16
    with JAX's bits; ``dtype`` still casts it."""
    torch.set_num_threads(1)
    vals = np.array([[1.0, -2.5, 3.1415927], [1e-3, -65504.0, 7e20]],
                    np.float32)
    leaf = jnp.asarray(vals, dtype=jnp.bfloat16)
    if as_numpy:
        leaf = np.asarray(leaf)
    tp = from_jax({"w": leaf, "n": np.arange(3, dtype=np.int32)})
    assert tp["w"].dtype == torch.bfloat16 and tp["w"].shape == (2, 3)
    want = np.asarray(jnp.asarray(vals, dtype=jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(tp["w"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(
        tp["w"].float().numpy(),
        np.asarray(jnp.asarray(vals, dtype=jnp.bfloat16).astype(jnp.float32)))
    assert tp["n"].dtype == torch.int32
    assert from_jax(leaf, dtype=torch.float32).dtype == torch.float32


# the training slices' modules, XE's and SCST's (engine/steps.py held
# decode before them; ops/cider.py is SCST's reward), and the ResNet and
# the image ops of encode from pixels
TRAINING_MODULES = ("engine.optim", "engine.state", "engine.steps",
                    "ops.losses", "ops.decode", "ops.fused_lstm", "config",
                    "ops.cider", "ops.fused_head", "device", "models.resnet",
                    "ops.image")
# the system around the models: the CLI, the engine, the data layer, the
# checkpoints and the COCO-caption scorers; the inference bundle and the
# serving tools (the directory captioner, the HTTP caption server)
SYSTEM_MODULES = ("main", "vocab", "inference", "tools.caption_images",
                  "tools.caption_server", "engine.engine", "engine.model_engines",
                  "engine.sample", "engine.observe", "engine.checkpoint",
                  "data.caption_data", "data.loader", "data.datasets",
                  "data._native_image", "evalcap.tokenizer", "evalcap._native",
                  "evalcap.bleu", "evalcap.rouge", "evalcap.cider_scorer",
                  "evalcap.meteor", "evalcap.spice", "evalcap.spice_lite",
                  "evalcap.coco_eval", "utils.visualize")
# data parallelism, mid-epoch resume, reference checkpoints, and the FLOP
# counts and profiling helpers
SCALE_OUT_MODULES = ("parallel", "parallel.mesh", "engine.multihost",
                    "engine.midepoch", "convert_reference",
                    "tools.convert_reference_checkpoint",
                    "tools.export_reference_checkpoint", "utils.flops",
                    "utils.profiling")


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, pkgutil, importlib\n"
        "import simpleimagecaptionzoo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "print('BAD', bad)\n"
        "print('HAVE', sorted(sys.modules))\n" % (FORBIDDEN,))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # the training slice's modules and the system's are among those imported
    for name in TRAINING_MODULES + SYSTEM_MODULES + SCALE_OUT_MODULES:
        assert "'simpleimagecaptionzoo_tpu_torch.%s'" % name in out.stdout, \
            name


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    assert os.path.join(PORT, "models", "butd.py") in files
    assert os.path.join(PORT, "models", "nic.py") in files
    for name in TRAINING_MODULES + SYSTEM_MODULES + SCALE_OUT_MODULES:
        path = os.path.join(PORT, *name.split("."))
        assert path + ".py" in files or \
            os.path.join(path, "__init__.py") in files, name
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_bf16_carry_keeps_int8_layer_types():
    """``dtype=bfloat16`` casts float leaves but leaves a weight-only int8
    layer at its types: q int8, s and b float32 (as _cast_floats does)."""
    torch.set_num_threads(1)
    tree = {"lstm": {"q": np.ones((128, 512), np.int8),
                     "s": np.full(4, 0.01, np.float32),
                     "b": np.linspace(-1, 1, 4, dtype=np.float32)},
            "embed": {"table": np.ones((3, 2), np.float32)}}
    tp = from_jax(tree, dtype=torch.bfloat16)
    assert tp["lstm"]["q"].dtype == torch.int8
    assert tp["lstm"]["s"].dtype == tp["lstm"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(tp["lstm"]["b"].numpy(), tree["lstm"]["b"])
    assert tp["embed"]["table"].dtype == torch.bfloat16
