"""The device-side image ops of simpleimagecaptionzoo_tpu_torch
(ops/image.py) against the JAX package's, on the CPU: ImageNet
normalization, Pillow-BILINEAR's resample weights, the fast-ingest resize
of a pad box, and ``prepare_images`` on both of its branches.  Same seeded
numpy inputs; float32 within 1e-5.  A NaN in the don't-care part of a pad
box must not reach the output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import image as JI
from simpleimagecaptionzoo_tpu_torch.ops import image as TI

TOL = dict(rtol=1e-5, atol=1e-5)
PAD, OUT = 512, 224


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _box(b, seed, extents=None):
    rng = np.random.default_rng(seed)
    box = rng.integers(0, 256, (b, PAD, PAD, 3)).astype(np.uint8)
    hw = (rng.integers(60, PAD + 1, size=(b, 2)) if extents is None
          else np.asarray(extents)).astype(np.int32)
    return box, hw


def test_constants_match_jax():
    assert TI.IMAGENET_MEAN == JI.IMAGENET_MEAN
    assert TI.IMAGENET_STD == JI.IMAGENET_STD
    assert TI.INGEST_PAD == PAD


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_normalize_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 16, 16, 3)).astype(dtype)
    got = TI.normalize(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JI.normalize(jnp.asarray(x))),
                               **TOL)


def test_maybe_normalize_passes_floats():
    """uint8 is normalized; a float batch (already normalized) passes
    unchanged, as in the JAX package."""
    x = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3))
    u8 = torch.from_numpy(x.astype(np.uint8))
    np.testing.assert_allclose(
        TI.maybe_normalize(u8).numpy(),
        np.asarray(JI.maybe_normalize(jnp.asarray(x.astype(np.uint8)))),
        **TOL)
    f = torch.from_numpy(x.astype(np.float32))
    assert TI.maybe_normalize(f) is f


def test_axis_weights_match_jax_and_are_zero_past_the_window():
    """Batched (B, 224, 512) weights for extents 60-512 in a 512 box equal
    the JAX package's per-image ones within 1e-5; every column past the
    extent, and every one outside the window, is exactly 0; rows sum to
    1."""
    extents = np.array([60, 111, 224, 225, 300, 448, 511, 512], np.int32)
    got = TI._axis_weights(torch.from_numpy(extents), OUT, PAD)
    assert got.shape == (len(extents), OUT, PAD)
    for i, n in enumerate(extents):
        want = np.asarray(JI._axis_weights(jnp.int32(n), OUT, PAD))
        np.testing.assert_allclose(got[i].numpy(), want, **TOL)
        assert (got[i, :, n:] == 0).all()
        assert ((got[i].numpy() == 0) == (want == 0)).all()
    np.testing.assert_allclose(got.sum(dim=2).numpy(), 1.0, rtol=1e-6)


def test_resize_normalize_matches_jax():
    box, hw = _box(4, 2)
    got = TI.resize_normalize(torch.from_numpy(box), torch.from_numpy(hw),
                              OUT)
    want = np.asarray(JI.resize_normalize(jnp.asarray(box), jnp.asarray(hw),
                                          OUT))
    assert got.shape == (4, OUT, OUT, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_resize_of_a_final_size_image_is_the_identity():
    """An image already at 224 in the box (the host parity path) comes
    through as ``normalize`` of it."""
    box, hw = _box(2, 3, extents=[[OUT, OUT], [OUT, OUT]])
    got = TI.resize_normalize(torch.from_numpy(box), torch.from_numpy(hw),
                              OUT)
    np.testing.assert_allclose(
        got.numpy(), TI.normalize(torch.from_numpy(box[:, :OUT, :OUT]))
        .numpy(), **TOL)


def test_nan_in_the_pad_box_does_not_leak():
    """A float box with NaN everywhere past each image's extent gives a
    finite output equal to that of the box with zeros there, and to the
    JAX package's on the zeroed box."""
    box, hw = _box(3, 4)
    clean = box.astype(np.float32)
    dirty = clean.copy()
    for i, (h, w) in enumerate(hw):
        clean[i, h:] = 0
        clean[i, :, w:] = 0
        dirty[i, h:] = np.nan
        dirty[i, :, w:] = np.nan
    t_hw = torch.from_numpy(hw)
    got = TI.resize_normalize(torch.from_numpy(dirty), t_hw, OUT)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(
        got.numpy(), TI.resize_normalize(torch.from_numpy(clean), t_hw,
                                         OUT).numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JI.resize_normalize(
            jnp.asarray(clean), jnp.asarray(hw), OUT)), **TOL)


@pytest.mark.parametrize("branch", ["plain", "fast"])
def test_prepare_images_matches_jax(branch):
    """A plain uint8 batch is normalized; one with ``img_hw`` is resampled
    to ``out_size`` and normalized."""
    if branch == "plain":
        x = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3)) \
            .astype(np.uint8)
        vis = {"img_tensors": x}
    else:
        box, hw = _box(2, 6)
        vis = {"img_tensors": box, "img_hw": hw}
    got = TI.prepare_images({k: torch.from_numpy(v) for k, v in vis.items()},
                            OUT)
    want = np.asarray(JI.prepare_images(
        {k: jnp.asarray(v) for k, v in vis.items()}, OUT))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
