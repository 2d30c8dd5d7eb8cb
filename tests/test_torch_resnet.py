"""The ResNet-101 of simpleimagecaptionzoo_tpu_torch (models/resnet.py)
against the JAX package's, on the CPU: the init tree, ``apply`` in eval and
train mode (float32 and bf16), the running statistics train mode returns,
the convolution's padding, the max-pool's, ``spatial_features``,
``global_pool`` and the torchvision state_dict conversion.  Same params
(numpy, carried by convert.from_jax), same seeded numpy inputs.

Tolerances: float32 at block counts (1, 1, 1, 1), B = 2, eval mode
elementwise within 1e-5 of the output's largest magnitude, train mode
within ``F32_REL`` (1e-5) relative norm (its last batch statistics are
over 8 values, which spreads rounding; 5.0e-6 measured on the CPU), and
train mode's statistics within 1e-6; float32 at full depth, one image,
within ``F32_REL``.  bf16 in eval mode within ``BF16_REL`` (2e-2) relative
norm at both depths: the two packages round bf16 in different orders, and
``init``'s (0, 1) statistics let each of the 101 layers amplify it
(features around 1e5).  bf16 in train mode within ``BF16_TRAIN_REL``
(3e-2; 2.3e-2 measured): the JAX package's own bf16 train run is 5.0e-2
from its float32 one at this size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simpleimagecaptionzoo_tpu.models import resnet as JR
from simpleimagecaptionzoo_tpu_torch.convert import from_jax, to_numpy
from simpleimagecaptionzoo_tpu_torch.models import resnet as TR

SHALLOW = (1, 1, 1, 1)
F32_REL = 1e-5
BF16_REL = 2e-2
BF16_TRAIN_REL = 3e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture()
def shallow(monkeypatch):
    monkeypatch.setattr(JR, "BLOCK_COUNTS", SHALLOW)
    monkeypatch.setattr(TR, "BLOCK_COUNTS", SHALLOW)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat}


def _trees(seed=0):
    """(params, stats) as numpy, from the port's init at the current
    BLOCK_COUNTS."""
    p, s = TR.init(torch.Generator().manual_seed(seed))
    return to_numpy(p), to_numpy(s)


def _images(b, side=64, seed=1):
    return np.random.default_rng(seed).normal(size=(b, side, side, 3)) \
        .astype(np.float32)


def _jax_apply(p, s, x, dtype, train=False):
    out = JR.apply(jax.tree_util.tree_map(jnp.asarray, p),
                   jax.tree_util.tree_map(jnp.asarray, s), jnp.asarray(x),
                   dtype=dtype, train=train)
    if train:
        return (np.asarray(out[0].astype(jnp.float32)),
                jax.tree_util.tree_map(np.asarray, out[1]))
    return np.asarray(out.astype(jnp.float32))


def _port_apply(p, s, x, dtype, train=False):
    with torch.no_grad():
        out = TR.apply(from_jax(p), from_jax(s), torch.from_numpy(x),
                       dtype=dtype, train=train)
    if train:
        return out[0].float().numpy(), to_numpy(out[1])
    return out.float().numpy()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", ["shallow", "full"])
def test_init_tree_matches_jax(depth, monkeypatch):
    """The tree (HWIO kernels, ``{"scale", "bias"}`` BN leaves, ``layerN``
    lists, the downsample on each layer's first block) and every shape of
    the JAX package's ``init``; He-normal fan_out scale, (0, 1) stats."""
    if depth == "shallow":
        monkeypatch.setattr(JR, "BLOCK_COUNTS", SHALLOW)
        monkeypatch.setattr(TR, "BLOCK_COUNTS", SHALLOW)
    # a fresh function: eval_shape caches a trace by the function, and
    # init reads BLOCK_COUNTS while it traces
    want_p, want_s = jax.eval_shape(lambda k: JR.init(k),
                                    jax.random.PRNGKey(0))
    got_p, got_s = TR.init(torch.Generator().manual_seed(0))
    assert _paths(to_numpy(got_p)) == _paths(want_p)
    assert _paths(to_numpy(got_s)) == _paths(want_s)
    assert len(got_p["layer3"]) == (1 if depth == "shallow" else 23)
    w = got_p["layer3"][0]["conv2"]                   # 3 x 3, 256 -> 256
    assert abs(float(w.std()) - (2.0 / (9 * 256)) ** 0.5) < 2e-3
    assert float(got_s["bn1"]["var"].min()) == 1.0
    assert float(got_s["bn1"]["mean"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _with_stats(s, seed):
    """Running statistics with random means and variances (O(1))."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        return rng.normal(scale=0.1, size=a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, s)


@pytest.mark.parametrize("stats", ["init", "drawn"])
def test_apply_eval_f32_shallow(shallow, stats):
    """Eval mode, float32, (1, 1, 1, 1), B = 2: elementwise within 1e-5
    of the largest magnitude of the JAX package's output."""
    p, s = _trees()
    if stats == "drawn":
        s = _with_stats(s, 3)
    x = _images(2)
    want = _jax_apply(p, s, x, jnp.float32)
    got = _port_apply(p, s, x, torch.float32)
    assert got.shape == want.shape == (2, 2, 2, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_apply_train_f32_shallow_and_its_stats(shallow):
    """Train mode, float32, (1, 1, 1, 1), B = 2: the output within
    ``F32_REL`` relative norm and every new running mean and
    variance (momentum 0.1, the unbiased variance over B·H·W) within 1e-6
    of the JAX package's."""
    p, s = _trees()
    s = _with_stats(s, 4)
    x = _images(2)
    want, want_s = _jax_apply(p, s, x, jnp.float32, train=True)
    got, got_s = _port_apply(p, s, x, torch.float32, train=True)
    assert _rel(got, want) < F32_REL
    flat = jax.tree_util.tree_flatten_with_path(want_s)[0]
    assert _paths(got_s) == _paths(want_s)
    for path, w in flat:
        g = got_s
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_apply_train_bf16_shallow(shallow):
    """Train mode in bf16, (1, 1, 1, 1): within ``BF16_TRAIN_REL``."""
    p, s = _trees()
    x = _images(2)
    want, _ = _jax_apply(p, s, x, jnp.bfloat16, train=True)
    got, _ = _port_apply(p, s, x, torch.bfloat16, train=True)
    assert _rel(got, want) < BF16_TRAIN_REL


def test_apply_eval_bf16_shallow(shallow):
    p, s = _trees()
    x = _images(2)
    assert _rel(_port_apply(p, s, x, torch.bfloat16),
                _jax_apply(p, s, x, jnp.bfloat16)) < BF16_REL


@pytest.fixture(scope="module")
def full():
    """The full ResNet-101 (3, 4, 23, 3) with ``init``'s (0, 1)
    statistics, and one 224 x 224 image."""
    p, s = TR.init(torch.Generator().manual_seed(0))
    return to_numpy(p), to_numpy(s), _images(1, side=224, seed=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_eval_full_depth(full, dtype):
    """Full depth, one image, ``init``'s statistics: float32 within 1e-5
    relative norm of the JAX package's (3.9e-6 measured on the CPU), bf16
    within ``BF16_REL`` (1.1e-2 measured)."""
    p, s, x = full
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    want = _jax_apply(p, s, x, jd)
    got = _port_apply(p, s, x, td)
    assert got.shape == want.shape == (1, 7, 7, 2048)
    assert np.isfinite(got).all()
    assert _rel(got, want) < (F32_REL if dtype == "float32" else BF16_REL)


# ---------------------------------------------------------------------------
# padding, max-pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", [8, 9])
def test_stride2_conv_pads_symmetrically(side):
    """A stride-2 3 x 3 convolution pads 1 on each side (torch's
    ``padding=1``), as the JAX package's explicit padding does, on even
    and odd inputs; XLA's SAME would pad (0, 1) on the even one."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, side, side, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = TR._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w), stride=2).permute(0, 2, 3, 1)
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    same = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    gap = float(np.abs(np.asarray(same) - want).max())
    assert gap > 1e-2 if side % 2 == 0 else gap < 1e-5


def test_max_pool_pads_with_minus_inf():
    """On a signed map whose border windows are all negative, the pool
    equals the JAX package's ``reduce_window`` with a -inf init (a zero
    padding would give 0 there)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 10, 3)).astype(np.float32) - 3.0
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), float("-inf"), jax.lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)]))
    got = TR._max_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert (want < 0).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", [7, 14, 8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_features_matches_jax(side, dtype):
    """(B, side, side, C) -> (B, 49, C) float32 within 1e-6: the map as it
    is at 7, the box mean at 14, and the JAX package's ``jax.image.resize
    (..., "linear")`` (antialiased: it shrinks) at 8 and 9 (img_size 256
    and 288)."""
    rng = np.random.default_rng(side)
    x = rng.normal(size=(2, side, side, 16)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(JR.spatial_features(jx, 7))
    got = TR.spatial_features(tx, 7)
    assert got.dtype == torch.float32 and got.shape == (2, 49, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_global_pool_matches_jax():
    x = np.random.default_rng(8).normal(size=(3, 7, 7, 32)).astype(
        np.float32)
    got = TR.global_pool(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(JR.global_pool(jnp.asarray(x).astype(jnp.bfloat16)))
    assert got.dtype == torch.float32 and got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# torchvision conversion
# ---------------------------------------------------------------------------

def _synthetic_state_dict():
    """A torchvision-layout resnet state_dict at the current BLOCK_COUNTS
    (keys and OIHW shapes; the fc layer the converters ignore)."""
    rng = np.random.default_rng(0)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def add_bn(prefix, c):
        sd[prefix + ".weight"] = t(c)
        sd[prefix + ".bias"] = t(c)
        sd[prefix + ".running_mean"] = t(c)
        sd[prefix + ".running_var"] = torch.abs(t(c)) + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = t(64, 3, 7, 7)
    add_bn("bn1", 64)
    cin = 64
    for li, (count, width) in enumerate(zip(TR.BLOCK_COUNTS, TR.WIDTHS),
                                        start=1):
        cout = width * 4
        for bi in range(count):
            pre = "layer%d.%d" % (li, bi)
            sd[pre + ".conv1.weight"] = t(width, cin, 1, 1)
            add_bn(pre + ".bn1", width)
            sd[pre + ".conv2.weight"] = t(width, width, 3, 3)
            add_bn(pre + ".bn2", width)
            sd[pre + ".conv3.weight"] = t(cout, width, 1, 1)
            add_bn(pre + ".bn3", cout)
            if bi == 0:
                sd[pre + ".downsample.0.weight"] = t(cout, cin, 1, 1)
                add_bn(pre + ".downsample.1", cout)
            cin = cout
    sd["fc.weight"] = t(10, 2048)
    sd["fc.bias"] = t(10)
    return sd


def test_state_dict_conversion_matches_jax_and_round_trips(shallow,
                                                           tmp_path):
    """``load_torchvision_weights`` (a ``.pth`` on disk) gives the JAX
    package's conversion leaf for leaf (OIHW -> HWIO, BN weight and bias
    -> scale and bias, running mean and var -> stats), bit for bit;
    ``export_torch_state_dict`` gives the state_dict back (the fc layer
    aside), equal to the JAX package's export; the tree runs through
    ``apply``."""
    sd = _synthetic_state_dict()
    path = tmp_path / "resnet101.pth"
    torch.save(sd, path)
    p, s = TR.load_torchvision_weights(str(path))
    jp, js = JR.convert_torch_state_dict(sd)
    for got, want in ((p, jp), (s, js)):
        want = jax.tree_util.tree_map(np.asarray, want)
        assert _paths(to_numpy(got)) == _paths(want)
        for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    back = TR.export_torch_state_dict(p, s)
    want_back = JR.export_torch_state_dict(jp, js)
    assert set(back) == set(want_back) == set(sd) - {"fc.weight", "fc.bias"}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want_back[k])
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    with torch.no_grad():
        fmap = TR.apply(p, s, torch.zeros(2, 64, 64, 3))
    assert fmap.shape == (2, 2, 2, 2048)
