"""Captions from pixels: NIC, BUTDSpatial and AoASpatial with their ResNet
in simpleimagecaptionzoo_tpu_torch against the JAX package, on the CPU.

Small widths, the ResNet at block counts (1, 1, 1, 1) (both packages'
``BLOCK_COUNTS`` patched), parameters from the JAX package's
``init_params(include_cnn=True)`` carried over by ``convert.from_jax``,
seeded photo-like uint8 images at 224 x 224.  The running statistics are
set to a calibration batch's own (not the served one): one
``apply(train=True)`` with ``BN_MOMENTUM`` patched to 1.0, in each package,
so the features are O(1) as a trained backbone's are (``init``'s (0, 1)
statistics give features around 1e5, where every decoder saturates).

Two rules for the ids, float32 decode:

* both trunks in float32 (``apply``'s default dtype patched on both
  sides): greedy and beam-3 ids identical;
* the trunks in bf16, as encode runs them: ids identical, or a greedy
  row's first difference at an id whose float32 logit (the port's step
  after the common prefix) is within ``GAP_TOL`` of the port's pick, and a
  beam row's two winners, rescored by the port, within ``GAP_TOL`` (the
  bf16 rule of tests/test_torch_aoa_bf16.py).

Also: the encode from uint8 pixels and from a fast-ingest pad box, int8
serving of NIC from pixels, the fine-tune scope of XE training from pixels
(engine/steps._stop_cnn_grads: the stem and layers 1-3 get no gradient,
``layer4`` only when not frozen), and the GPU default of the entry points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models import resnet as JR
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import decode as JD
from simpleimagecaptionzoo_tpu.ops import image as JI
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import optim as TO
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models import resnet as TR
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode, fused_head, quant
from simpleimagecaptionzoo_tpu_torch.ops import image as TI

FAMILIES = {
    "NIC": dict(vocab_size=50, embed_dim=64, hidden_dim=128, enc_dim=2048),
    "BUTDSpatial": dict(vocab_size=50, embed_dim=32, hidden_dim=64,
                        atten_dim=32, enc_dim=2048),
    "AoASpatial": dict(vocab_size=50, embed_dim=32, hidden_dim=64,
                       enc_dim=2048, num_heads=4, num_refine_layers=1),
}
B, STEPS, SIDE, PAD = 6, 8, 224, 512
CAL_B = 8                        # the calibration batch
GAP_TOL = 1e-2                   # tests/test_torch_aoa_bf16.py's rule
ENC_TOL = 1e-5                   # float32 trunks: encode, relative norm


def photos(n, side, seed):
    """Photo-like uint8 images (n, side, side, 3): smoothed noise over a
    gradient and a checkerboard (examples/bench_ingest.py's recipe), each
    image with its own gradient angle, checker period and channel mix."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (n, side, side, 3)).astype(np.float32)
    for _ in range(3):
        img = (np.roll(img, 1, 1) + np.roll(img, -1, 1) + np.roll(img, 1, 2)
               + np.roll(img, -1, 2) + img) / 5
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        angle = rng.uniform(0, 2 * np.pi)
        ramp = (np.cos(angle) * xx + np.sin(angle) * yy + 1) / 2
        period = int(rng.choice([8, 16, 32, 64]))
        checker = ((np.mgrid[0:side, 0:side] // period).sum(0) % 2)
        mix = rng.uniform(0, 1, size=(3, 2))
        for c in range(3):
            img[i, ..., c] = (img[i, ..., c] * 0.3 + mix[c, 0] * ramp * 200
                              + mix[c, 1] * checker * 120)
    return np.clip(img, 0, 255).astype(np.uint8)


def pad_box(n, seed):
    """A fast-ingest batch: images of random true extents 60-512 top-left
    in a (n, 512, 512, 3) box whose rest is random (don't-care)."""
    rng = np.random.default_rng(seed)
    box = rng.integers(0, 256, (n, PAD, PAD, 3)).astype(np.uint8)
    hw = rng.integers(60, PAD + 1, size=(n, 2)).astype(np.int32)
    for i, (h, w) in enumerate(hw):
        box[i, :h, :w] = photos(1, max(h, w), seed + i)[0, :h, :w]
    return {"img_tensors": box, "img_hw": hw}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "BLOCK_COUNTS", (1, 1, 1, 1))
        mp.setattr(TR, "BLOCK_COUNTS", (1, 1, 1, 1))
        yield


@pytest.fixture(autouse=True)
def _threads(monkeypatch):
    torch.set_num_threads(1)
    for name in ("SICZ_TPU_FUSED_HEAD", "SICZ_TPU_PALLAS_LSTM",
                 "SICZ_TPU_PALLAS_QUANT"):
        monkeypatch.setenv(name, "auto")


def f32_trunks(mp):
    """Both packages' ``resnet.apply`` default to a float32 trunk."""
    mp.setattr(JR.apply, "__defaults__", (jnp.float32, False))
    mp.setattr(TR.apply, "__defaults__", (torch.float32, False))


def calibrate(jcnn, jstats, tcnn, tstats, images):
    """Each package's running statistics set to ``images``' own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "BN_MOMENTUM", 1.0)
        mp.setattr(TR, "BN_MOMENTUM", 1.0)
        _, jcal = JR.apply(jcnn, jstats, JI.normalize(jnp.asarray(images)),
                           dtype=jnp.float32, train=True)
        with torch.no_grad():
            _, tcal = TR.apply(tcnn, tstats,
                               TI.normalize(torch.from_numpy(images)),
                               dtype=torch.float32, train=True)
    return _np(jcal), tcal


_SETUPS = {}


def setup_of(family):
    if family not in _SETUPS:
        dims = dict(FAMILIES[family], model_type=family)
        jm = jax_get(JaxModelConfig(**dims))
        tm = get_captioner(ModelConfig(**dims))
        p = _np(jm.init_params(jax.random.PRNGKey(0), include_cnn=True))
        if family == "NIC":
            # at random init NIC's head bias outweighs h @ W and the word
            # embedding the image's: every row picks the same words.  A
            # sharper image embedding, cell input and head, no head bias,
            # let the image choose them (the same params on both sides)
            p["img_embed"]["g"] = p["img_embed"]["g"] * 10
            p["lstm"]["w_ih"] = p["lstm"]["w_ih"] * 4
            p["predict"]["g"] = p["predict"]["g"] * 10
            p["predict"]["b"] = np.zeros_like(p["predict"]["b"])
        stats = _np(jm.init_model_state()["cnn_stats"])
        jcal, tcal = calibrate(_j(p["cnn"]), _j(stats), from_jax(p["cnn"]),
                               from_jax(stats), photos(CAL_B, SIDE, 5))
        _SETUPS[family] = dict(
            jm=jm, tm=tm, p=p, jms={"cnn_stats": jcal},
            tms={"cnn_stats": tcal},
            vis={"img_tensors": photos(B, SIDE, 11)})
    return _SETUPS[family]


@pytest.fixture(params=list(FAMILIES))
def family(request):
    return request.param


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _encode_both(s, vis, params=None):
    p = s["p"] if params is None else params
    jenc, _ = s["jm"].encode(_j(p), _j(vis), model_state=_j(s["jms"]))
    with torch.no_grad():
        tenc, _ = s["tm"].encode(from_jax(p), from_jax(vis),
                                 model_state=s["tms"])
    return jenc, tenc


@pytest.mark.parametrize("ingest", ["plain", "fast"])
def test_encode_from_pixels_matches_jax(family, ingest, monkeypatch):
    """Encode from uint8 pixels (``img_tensors`` (B, 224, 224, 3)) and
    from a fast-ingest pad box (``img_hw``, extents 60-512), float32
    trunks: the features and the mean within 1e-5 relative norm of the
    JAX package's; the ResNet's pooled features are float32, (B, 2048)
    for NIC (its encoding then (B, 1, E)) and (B, 49, 2048) for the
    spatial families."""
    f32_trunks(monkeypatch)
    s = setup_of(family)
    vis = s["vis"] if ingest == "plain" else pad_box(B, 3)
    pooled = []
    for fn in ("global_pool", "spatial_features"):
        orig = getattr(TR, fn)
        monkeypatch.setattr(TR, fn, lambda *a, _f=orig: pooled.append(
            _f(*a)) or pooled[-1])
    jenc, tenc = _encode_both(s, vis)
    assert len(pooled) == 1 and pooled[0].dtype == torch.float32
    assert tuple(pooled[0].shape) == ((B, 2048) if family == "NIC"
                                      else (B, 49, 2048))
    assert tenc.features.shape == tuple(jenc.features.shape)
    assert tenc.mask is None and jenc.mask is None
    for name in ("features", "mean"):
        got, want = getattr(tenc, name), getattr(jenc, name)
        assert torch.isfinite(got).all()
        assert _rel(got.numpy(), want) < ENC_TOL, name


def test_trunk_runs_bf16_by_default(family):
    """As encode runs it: the trunk in bf16 (``apply``'s default) in a
    float32 decode, its pooled features float32 and within 2e-2 relative
    norm of the JAX package's."""
    s = setup_of(family)
    jenc, tenc = _encode_both(s, s["vis"])
    assert tenc.features.dtype == torch.float32
    assert _rel(tenc.mean.numpy(), jenc.mean) < 2e-2


# ---------------------------------------------------------------------------
# greedy and beam 3
# ---------------------------------------------------------------------------

def _greedy_both(s, params, vis=None, dtype=None):
    vis = s["vis"] if vis is None else vis
    jids = JS.make_greedy_decode(s["jm"], max_len=STEPS)(
        _j(params), _j(s["jms"]), _j(vis))
    tids = TS.make_greedy_decode(s["tm"], max_len=STEPS, dtype=dtype,
                                 device="cpu")(from_jax(params), s["tms"],
                                               from_jax(vis))
    return np.asarray(jids), tids.numpy()


def _beam_both(s, params):
    jids = JS.make_beam_decode(s["jm"], beam_size=3, max_steps=STEPS)(
        _j(params), _j(s["jms"]), _j(s["vis"]))
    tids = TS.make_beam_decode(s["tm"], beam_size=3, max_steps=STEPS,
                               device="cpu")(from_jax(params), s["tms"],
                                             from_jax(s["vis"]))
    return np.asarray(jids), tids.numpy()


def _check_rows(ids):
    assert ids.shape == (B, STEPS + 1) and ids.dtype == np.int64
    assert (ids[:, 0] == STA_ID).all()
    for row in ids:
        ends = np.flatnonzero(row == END_ID)
        if len(ends):
            assert (row[ends[0] + 1:] == PAD_ID).all()


def test_greedy_f32_trunks_ids_identical(family, monkeypatch):
    """Float32 trunks: greedy ids identical, and the images choose them
    (at least half the rows start differently)."""
    f32_trunks(monkeypatch)
    s = setup_of(family)
    jids, tids = _greedy_both(s, s["p"])
    assert tids.shape == (B, STEPS)
    np.testing.assert_array_equal(tids, jids)
    assert len(set(tids[:, 0])) >= B // 2, tids[:, 0]


def test_beam3_f32_trunks_ids_identical(family, monkeypatch):
    f32_trunks(monkeypatch)
    s = setup_of(family)
    jids, tids = _beam_both(s, s["p"])
    _check_rows(tids)
    np.testing.assert_array_equal(tids, jids)


def _port_encoding(s):
    params = from_jax(s["p"])
    with torch.no_grad():
        enc, _ = s["tm"].encode(params, from_jax(s["vis"]),
                                model_state=s["tms"])
    return params, enc


def test_greedy_bf16_trunks_identical_or_near_tie(family):
    """The trunks in bf16: greedy ids identical, or each differing row's
    first difference at an id whose float32 logit is within ``GAP_TOL``
    of the port's pick."""
    s = setup_of(family)
    jids, tids = _greedy_both(s, s["p"])
    differ = np.flatnonzero((tids != jids).any(axis=1))
    if not len(differ):
        return
    tm = s["tm"]
    params, enc = _port_encoding(s)
    head = fused_head.prepare_head(params["predict"], torch.float32)
    first = {int(i): int(np.flatnonzero(tids[i] != jids[i])[0])
             for i in differ}
    state = tm.init_state(params, enc)
    tok = torch.full((B,), STA_ID, dtype=torch.long)
    with torch.no_grad():
        for t in range(max(first.values()) + 1):
            hidden, state, _ = tm.step_core(params, enc, state, tok)
            logits = fused_head.logits_plain(head, hidden)
            for i, ti in first.items():
                if ti == t:
                    gap = float(logits[i, tids[i, t]] - logits[i, jids[i, t]])
                    assert 0 <= gap < GAP_TOL, (i, t, gap)
            tok = torch.from_numpy(tids[:, t]).long()


def test_beam3_bf16_trunks_identical_or_near_tie(family):
    """The trunks in bf16: beam-3 ids identical, or a differing row's two
    winners, rescored by the port, within ``GAP_TOL``."""
    s = setup_of(family)
    jids, tids = _beam_both(s, s["p"])
    _check_rows(tids)
    differ = (tids != jids).any(axis=1)
    if not differ.any():
        return
    params, enc = _port_encoding(s)
    with torch.no_grad():
        s_port = decode.sequence_logprob(s["tm"], params, enc,
                                         torch.from_numpy(tids))
        s_jax = decode.sequence_logprob(s["tm"], params, enc,
                                        torch.from_numpy(jids).long())
    diff = (s_port - s_jax).abs().numpy()
    assert (diff < GAP_TOL).all(), diff


def test_fast_ingest_greedy_f32_trunks_ids_identical(monkeypatch):
    """NIC greedy from a fast-ingest pad box: ids identical."""
    f32_trunks(monkeypatch)
    s = setup_of("NIC")
    jids, tids = _greedy_both(s, s["p"], vis=pad_box(B, 3))
    np.testing.assert_array_equal(tids, jids)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_int8_nic_from_pixels_f32_trunks_ids_identical(decoder,
                                                       monkeypatch):
    """Int8 serving of NIC from pixels (``quantize_decode_params`` leaves
    ``cnn`` as it is, in both packages), float32 trunks: greedy and beam-3
    ids identical to the JAX package's, every cell and head call through
    K3 and K1-int8 (their plain versions on the CPU)."""
    f32_trunks(monkeypatch)
    s = setup_of("NIC")
    q = _np(s["jm"].quantize_decode_params(_j(s["p"])))
    tq = s["tm"].quantize_decode_params(from_jax(s["p"]))
    assert quant.is_quantized(tq["lstm"]) and "cnn" in tq
    np.testing.assert_array_equal(q["cnn"]["conv1"], s["p"]["cnn"]["conv1"])
    before = quant.COUNT.n
    if decoder == "greedy":
        jids, tids = _greedy_both(s, q)
    else:
        jids, tids = _beam_both(s, q)
        _check_rows(tids)
    np.testing.assert_array_equal(tids, jids)
    assert quant.COUNT.n == before          # no launch on the CPU


def test_bf16_decode_casts_cnn_but_not_its_stats(monkeypatch):
    """A bf16 decode casts the ResNet's parameters (BN scale and bias
    included) and a float ``img_tensors`` to bf16, and leaves
    ``model_state`` float32, as the JAX package's; the trunk runs in
    bf16 and the pooled features come out float32."""
    s = setup_of("BUTDSpatial")
    seen = {}
    apply = TR.apply

    def spy(params, stats, images, *a, **kw):
        seen.update(conv=params["conv1"].dtype,
                    scale=params["bn1"]["scale"].dtype,
                    var=stats["bn1"]["var"].dtype, images=images.dtype)
        out = apply(params, stats, images, *a, **kw)
        seen["fmap"] = out.dtype
        return out
    monkeypatch.setattr(TR, "apply", spy)
    vis = {"img_tensors": TI.normalize(torch.from_numpy(s["vis"][
        "img_tensors"]))}
    ids = TS.make_greedy_decode(s["tm"], max_len=STEPS, dtype=torch.bfloat16,
                                device="cpu")(from_jax(s["p"]), s["tms"],
                                              vis)
    assert ids.shape == (B, STEPS)
    assert seen == dict(conv=torch.bfloat16, scale=torch.bfloat16,
                        var=torch.float32, images=torch.bfloat16,
                        fmap=torch.bfloat16)


# ---------------------------------------------------------------------------
# XE from pixels: the fine-tune scope
# ---------------------------------------------------------------------------

XE_B, XE_T, XE_SIDE = 4, 6, 64


def _xe_setup():
    dims = dict(FAMILIES["NIC"], model_type="NIC", dropout=0.0)
    jm = jax_get(JaxModelConfig(**dims))
    tm = get_captioner(ModelConfig(**dims))
    p = _np(jm.init_params(jax.random.PRNGKey(1), include_cnn=True))
    stats = _np(jm.init_model_state()["cnn_stats"])
    rng = np.random.default_rng(4)
    caps = rng.integers(4, 50, size=(XE_B, XE_T)).astype(np.int32)
    caps[:, 0] = STA_ID
    lens = rng.integers(3, XE_T + 1, size=(XE_B,)).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, n - 1] = END_ID
        caps[i, n:] = PAD_ID
    batch = {"visual": {"img_tensors": photos(XE_B, XE_SIDE, 9)},
             "captions": caps, "lengths": lens}
    return jm, tm, p, stats, batch


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("freeze_cnn", [False, True])
def test_xe_fine_tune_scope_matches_jax(freeze_cnn, monkeypatch):
    """XE of NIC from pixels, float32 trunks, train-mode BN: the gradient
    tree ``make_xe_train_step`` hands its optimizer against
    ``jax.value_and_grad`` of the JAX package's loss under its
    ``_stop_cnn_grads``: the loss and every leaf within 1e-5, the stem and
    layers 1-3 exactly zero, ``layer4`` zero too when ``freeze_cnn`` and
    not otherwise; the new ``cnn_stats`` within 1e-6 of JAX's."""
    f32_trunks(monkeypatch)
    jm, tm, p, stats, batch = _xe_setup()
    captions = jnp.asarray(batch["captions"])
    mask = JL.xe_mask_from_lengths(jnp.asarray(batch["lengths"]) - 1,
                                   XE_T - 1)

    def loss_fn(params):
        params = JS._stop_cnn_grads(params, freeze_cnn)
        enc, new_ms = jm.encode(params, _j(batch["visual"]), train=True,
                                rng=jax.random.PRNGKey(2),
                                model_state={"cnn_stats": _j(stats)})
        logits = JD.teacher_forced_logits(jm, params, enc, captions, 0.0,
                                          jax.random.PRNGKey(3), train=True,
                                          ss_active=False)
        return (JL.label_smoothing_loss(logits, captions[:, 1:], mask, 0.1),
                new_ms)

    (jloss, jms), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(_j(p))

    handed = []

    def update(grads, state, params):
        handed.append(grads)
        return TO.tree_map(torch.zeros_like, grads), state

    tx = TO.GradientTransformation(lambda params: (), update)
    params = from_jax(p)
    step = TS.make_xe_train_step(tm, tx, tm.param_labels(params),
                                 freeze_cnn=freeze_cnn, ss_active=False,
                                 device="cpu")
    tbatch = from_jax(batch)
    tbatch["captions"] = tbatch["captions"].long()
    tbatch["lengths"] = tbatch["lengths"].long()
    state = TrainState.create(params, tx, {"cnn_stats": from_jax(stats)})
    new, met = step(state, tbatch, torch.Generator().manual_seed(0), 0.0,
                    0.0, 0.0)
    assert abs(float(met["loss"]) - float(jloss)) <= 1e-5 * float(jloss)
    grads = handed[0]
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(TO.tree_leaves(grads))
    for path, want in paths:
        got = _at(grads, path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))
        key = jax.tree_util.keystr(path)
        if key.startswith("['cnn']") and (freeze_cnn
                                           or "layer4" not in key):
            assert not got.any(), key
    assert bool(grads["cnn"]["layer4"][0]["conv3"].any()) != freeze_cnn
    for path, want in jax.tree_util.tree_leaves_with_path(jms["cnn_stats"]):
        np.testing.assert_allclose(_at(new.model_state["cnn_stats"],
                                       path).numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=str(path))


# ---------------------------------------------------------------------------
# the entry points default to the GPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_entry_points_default_to_the_gpu(family, decoder):
    """Without a CUDA device the default entry points raise for the
    from-pixels families; they never carry on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = setup_of(family)["tm"]
    make = (TS.make_greedy_decode if decoder == "greedy"
            else TS.make_beam_decode)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(tm)
