"""The XE loss and the training configs of simpleimagecaptionzoo_tpu_torch
against the JAX package: label_smoothing_loss on the same numpy logits,
xe_mask_from_lengths, and TrainConfig / LrOpts / SsOpts field for field
with their schedules."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu import config as JC
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch import config as TC
from simpleimagecaptionzoo_tpu_torch.ops import losses as TL

B, T, V = 6, 9, 50


def _inputs(seed, all_masked_rows=(2,)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(B, T, V))).astype(np.float32)
    targets = rng.integers(0, V, size=(B, T)).astype(np.int32)
    lengths = rng.integers(1, T + 1, size=(B,))
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    for r in all_masked_rows:
        mask[r] = 0.0
    return logits, targets, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.2])
def test_label_smoothing_loss_matches_jax(smoothing, dtype):
    """Masked tokens and an all-masked row; float32 and bf16 logits (the
    same bf16 values on both sides: the loss upcasts them).  Within 1e-6
    relative."""
    logits, targets, mask = _inputs(int(smoothing * 10) + len(dtype))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    want = float(JL.label_smoothing_loss(jl, jnp.asarray(targets),
                                         jnp.asarray(mask), smoothing))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = TL.label_smoothing_loss(tl, torch.from_numpy(targets).long(),
                                  torch.from_numpy(mask), smoothing)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want), (float(got), want)


def test_label_smoothing_loss_all_masked_is_zero():
    """No valid token: the mean's count is clamped to 1, so the loss is 0
    on both sides (not a division by zero)."""
    logits, targets, mask = _inputs(3)
    mask[:] = 0.0
    want = float(JL.label_smoothing_loss(jnp.asarray(logits),
                                         jnp.asarray(targets),
                                         jnp.asarray(mask), 0.1))
    got = float(TL.label_smoothing_loss(torch.from_numpy(logits),
                                        torch.from_numpy(targets),
                                        torch.from_numpy(mask), 0.1))
    assert want == 0.0 and got == 0.0


def test_label_smoothing_loss_is_the_kl_to_the_smoothed_one_hot():
    """The split sum equals KL(td || softmax) with td made explicitly."""
    logits, targets, mask = _inputs(4)
    eps = 0.1
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1)
    td = torch.full((B, T, V), eps / (V - 1), dtype=torch.float64)
    td.scatter_(-1, torch.from_numpy(targets).long()[..., None], 1 - eps)
    kl = (td * (td.log() - lp)).sum(-1)
    m = torch.from_numpy(mask).double()
    want = float((kl * m).sum() / m.sum())
    got = float(TL.label_smoothing_loss(torch.from_numpy(logits),
                                        torch.from_numpy(targets),
                                        torch.from_numpy(mask), eps))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_xe_mask_from_lengths_matches_jax():
    lengths = np.array([0, 1, 5, 8, 12], np.int32)
    want = np.asarray(JL.xe_mask_from_lengths(jnp.asarray(lengths), 8))
    got = TL.xe_mask_from_lengths(torch.from_numpy(lengths), 8)
    assert got.dtype == torch.float32 and got.shape == (5, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["TrainConfig", "LrOpts", "SsOpts"])
def test_train_configs_field_for_field(name):
    """The same fields, in the same order, with the same defaults."""
    jcls, tcls = getattr(JC, name), getattr(TC, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    jd, td = dataclasses.asdict(jcls()), dataclasses.asdict(tcls())
    assert td == jd


@pytest.mark.parametrize("opts", [
    {}, dict(learning_rate=2e-4, lr_dec_start_epoch=2, lr_dec_every=4,
             lr_dec_rate=0.5), dict(lr_dec_start_epoch=-1)])
def test_lr_schedule_matches_jax(opts):
    """decay_factor and lrs_for_epoch, epochs 0-30, every CNN switch."""
    j, t = JC.LrOpts(**opts), TC.LrOpts(**opts)
    for epoch in range(31):
        assert t.decay_factor(epoch) == j.decay_factor(epoch)
        for model in (False, True):
            for enabled in (False, True):
                assert t.lrs_for_epoch(epoch, model, enabled) == \
                    j.lrs_for_epoch(epoch, model, enabled)


@pytest.mark.parametrize("opts", [
    {}, dict(ss_start_epoch=3, ss_inc_every=2, ss_inc_prob=0.1,
             ss_max_prob=0.25), dict(ss_start_epoch=-1)])
def test_ss_schedule_matches_jax(opts):
    j, t = JC.SsOpts(**opts), TC.SsOpts(**opts)
    assert [t.prob_for_epoch(e) for e in range(31)] == \
        [j.prob_for_epoch(e) for e in range(31)]
