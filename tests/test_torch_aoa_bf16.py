"""The bf16 decode held against the JAX package: AoADetection encode, one
decoder step, greedy and beam-3 decode in simpleimagecaptionzoo_tpu_torch
against the JAX package in bf16, same params and numpy inputs.  The JAX
side runs its fused head and fused LSTM cell in interpret mode, so it
computes the Pallas kernels' bf16 semantics (float32 products and
epilogue, only h' and c' rounded), which the port follows.  B = 16 makes
B*k a multiple of 16, which the JAX package's bf16 kernel gates need.

Tolerances, bf16 on both sides with sums in other orders:
- ``TOL`` (rtol = atol = 1e-2, one bf16 ulp, as the kernels' bf16 holds):
  one step's pre-logits, h, c and attention;
- encode's outputs: one bf16 ulp of the largest value (atol = max |x| /
  128, rtol 1e-2): the refiner's sums and layer norms mix values of every
  magnitude, so a small value carries a large one's rounding;
- ``GAP_TOL`` = 1e-2: the head's float32 logits of the two packages'
  pre-logits for the same state may differ by up to ``GAP_TOL / 2`` (held
  below); two ids can trade places only where their logits are within
  twice that.  So ids are identical, or the first difference of a greedy
  row is at a logit gap below ``GAP_TOL``, and a beam row's two winners,
  rescored by the port, are within ``GAP_TOL``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine import steps as JS
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import fused_head as jax_fused_head
from simpleimagecaptionzoo_tpu_torch import STA_ID
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.engine import steps as TS
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode, fused_head

CFG = dict(model_type="AoADetection", vocab_size=1000, embed_dim=128,
           hidden_dim=128, enc_dim=64, num_heads=4, num_refine_layers=2,
           max_bu_len=5)
B, N, STEPS = 16, 5, 8
TOL = dict(rtol=1e-2, atol=1e-2)
GAP_TOL = 1e-2
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _kernels(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SICZ_TPU_FUSED_HEAD", "interpret")
    monkeypatch.setenv("SICZ_TPU_PALLAS_LSTM", "interpret")


@pytest.fixture(scope="module")
def setup():
    jm = jax_get(JaxModelConfig(**CFG))
    jparams = jm.init_params(jax.random.PRNGKey(0), include_cnn=False)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tm = get_captioner(ModelConfig(**CFG))
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(B, N, CFG["enc_dim"])).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 3:] = 0                   # some rows padded ('adaptive' boxes)
    mask[5, 1:] = 0
    mask[9, 4:] = 0
    return jm, tm, np_params, {"bu_feats": feats, "bu_masks": mask}


def _jax_bf16(tree):
    return JS._cast_floats(jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_bf16(tree):
    return TS._cast_floats(from_jax(tree), BF)


def _encodings(setup):
    """JAX's and the port's bf16 encodings, and the port's encoding with
    JAX's tensors in it (the same inputs to both steps)."""
    jm, tm, p, vis = setup
    jenc, _ = jm.encode(_jax_bf16(p), _jax_bf16(vis))
    tenc, _ = tm.encode(_port_bf16(p), _port_bf16(vis))
    to_t = lambda x: torch.from_numpy(np.array(_np(x))).to(BF)  # noqa: E731
    same = dataclasses.replace(
        tenc, features=to_t(jenc.features), mean=to_t(jenc.mean),
        extras=dict(tenc.extras, k_proj=to_t(jenc.extras["k_proj"]),
                    v_proj=to_t(jenc.extras["v_proj"])))
    return jenc, tenc, same


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), err_msg=what,
                               **tol)


def test_bf16_encode_matches_jax(setup):
    jenc, tenc, _ = _encodings(setup)
    assert tenc.features.dtype == BF
    for name, j, t in (("features", jenc.features, tenc.features),
                       ("mean", jenc.mean, tenc.mean),
                       ("k_proj", jenc.extras["k_proj"],
                        tenc.extras["k_proj"]),
                       ("v_proj", jenc.extras["v_proj"],
                        tenc.extras["v_proj"])):
        _close(t, j, name, dict(rtol=1e-2,
                                atol=float(np.abs(_np(j)).max()) / 128))


@pytest.mark.parametrize("lanes", [None, 3])
def test_bf16_one_step_matches_jax(setup, lanes):
    """One step (flat, and the lanes step at k=3) on the same bf16 state and
    encoding: pre-logits, h, c and attention within ``TOL``; the head's
    float32 logits of both pre-logits within ``GAP_TOL / 2``."""
    jm, tm, p, _ = setup
    jenc, _, tenc = _encodings(setup)
    shape = (B,) if lanes is None else (B, lanes)
    rng = np.random.default_rng(12)
    state = {n: (0.5 * rng.normal(size=shape + (CFG["hidden_dim"],))).astype(
        np.float32) for n in ("h", "m", "ctx")}
    toks = rng.integers(4, CFG["vocab_size"], size=shape).astype(np.int32)
    jfn = jm.step_core if lanes is None else jm.step_lanes_core
    tfn = tm.step_core if lanes is None else tm.step_lanes_core
    jpre, jst, jal = jfn(_jax_bf16(p), jenc, _jax_bf16(state),
                         jnp.asarray(toks))
    tpre, tst, tal = tfn(_port_bf16(p), tenc, _port_bf16(state),
                         torch.from_numpy(toks).long())
    assert tpre.dtype == tst["h"].dtype == tst["m"].dtype == BF
    _close(tpre, jpre, "pre-logits")
    _close(tal, jal, "alpha")
    for n in ("h", "m", "ctx"):
        _close(tst[n], jst[n], n)
    head = fused_head.prepare_head(_port_bf16(p)["predict"], BF)
    flat = lambda x: x.reshape(-1, CFG["hidden_dim"])  # noqa: E731
    logit_err = (fused_head.logits_plain(head, flat(tpre))
                 - fused_head.logits_plain(
                     head, flat(torch.from_numpy(np.array(_np(jpre))).to(BF))))
    assert float(logit_err[:, :head.v].abs().max()) < GAP_TOL / 2


def test_bf16_greedy_matches_jax_or_differs_at_a_near_tie(setup):
    """Greedy ids identical, or each row's first difference at an id whose
    logit is within ``GAP_TOL`` of the port's pick (the port's float32
    logits after the common prefix)."""
    jm, tm, p, vis = setup
    jids = np.asarray(JS.make_greedy_decode(jm, max_len=STEPS,
                                            dtype=jnp.bfloat16)(
        jax.tree_util.tree_map(jnp.asarray, p), {},
        jax.tree_util.tree_map(jnp.asarray, vis)))
    tids = TS.make_greedy_decode(tm, max_len=STEPS, dtype=BF, device="cpu")(
        from_jax(p), {}, from_jax(vis)).numpy()
    assert tids.shape == jids.shape == (B, STEPS)
    differ = np.flatnonzero((tids != jids).any(axis=1))
    assert len(differ) <= B // 4, "%d of %d rows differ" % (len(differ), B)
    if not len(differ):
        return
    params = _port_bf16(p)
    enc, _ = tm.encode(params, _port_bf16(vis))
    head = fused_head.prepare_head(params["predict"], BF)
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


def test_bf16_beam3_matches_jax_or_differs_at_a_near_tie(setup):
    """Beam-3 ids identical, or, where a row differs, the two winners
    rescored by the port (``decode.sequence_logprob``, float32 log-probs
    of the bf16 step) within ``GAP_TOL``."""
    jm, tm, p, vis = setup
    assert jax_fused_head.enabled(_jax_bf16(p)["predict"], B * 3, 3,
                                  jnp.bfloat16)
    jids = np.asarray(JS.make_beam_decode(jm, beam_size=3, max_steps=STEPS,
                                          dtype=jnp.bfloat16)(
        jax.tree_util.tree_map(jnp.asarray, p), {},
        jax.tree_util.tree_map(jnp.asarray, vis)))
    tids = TS.make_beam_decode(tm, beam_size=3, max_steps=STEPS, dtype=BF,
                               device="cpu")(from_jax(p), {},
                                             from_jax(vis)).numpy()
    assert tids.shape == jids.shape == (B, STEPS + 1)
    differ = (tids != jids).any(axis=1)
    assert differ.sum() <= B // 4, "%d of %d rows differ" % (differ.sum(), B)
    params = _port_bf16(p)
    enc, _ = tm.encode(params, _port_bf16(vis))
    with torch.no_grad():
        s_port = decode.sequence_logprob(tm, params, enc,
                                         torch.from_numpy(tids))
        s_jax = decode.sequence_logprob(
            tm, params, enc, torch.from_numpy(np.array(jids)).long())
    diff = (s_port - s_jax).abs().numpy()
    assert (diff[~differ] == 0).all()
    assert (diff < GAP_TOL).all(), diff
