"""The gates that hold a decode through the kernels against the same decode
through their plain versions (simpleimagecaptionzoo_tpu_torch/engine/
holds.py), on the CPU: each kernel's per-call hold passes its plain version
and reports a result off by more than its tolerance, and
scripts/rehearse_beam_gate.py at its small size passes noise the size of
the holds and fails the planted faults on every path."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu_torch.engine import holds
from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                 int8_attention, quant)

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "rehearse_beam_gate.py")


def _rehearsal():
    spec = importlib.util.spec_from_file_location("rehearse_beam_gate",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8/float32",
                                  "int8/bfloat16"])
def test_rehearsal_passes_noise_and_fails_faults(path, monkeypatch):
    """AoADetection beam 3 at the small size (hidden 256, 2 heads, vocab
    1,000, B=16, 8 steps): noise at 99 % of each kernel's hold passes the
    gate, both its parts; K1's second and third ids swapped, and (int8) K4
    ignoring the mask, fail it."""
    monkeypatch.setenv("SICZ_TPU_INT8_KV", "auto")
    rehearse = _rehearsal()
    res = rehearse.rehearse(torch.device("cpu"), rehearse.SMALL,
                            paths=(path,), log=lambda *a: None)[path]
    assert set(res) == set(rehearse.plants_of(path))
    for plant, r in res.items():
        assert r["as_expected"], (plant, r)
        assert r["passed"] == (plant == "noise"), (plant, r)
    # K4 ignoring the mask moves winners far beyond the end-to-end tol too
    if path.startswith("int8"):
        assert not res["k4_mask"]["end_to_end_passed"]
        assert res["k4_mask"]["min_margin"] < -4 * res["k4_mask"]["tol"]


def test_beam_tol_at_the_smoke_shape():
    """2 x 20 steps x 4 x K1's value hold: 0.016 (float32), 0.32 (bf16)."""
    assert holds.beam_tol(torch.float32, 20) == pytest.approx(0.016)
    assert holds.beam_tol(torch.bfloat16, 20) == pytest.approx(0.32)


def test_plain_versions_put_the_wrappers_back():
    before = [getattr(m, n) for m, n, _ in holds.plain_swaps()]
    with pytest.raises(RuntimeError):
        with holds.plain_versions(lambda name, plain: None):
            assert fused_head.topk_head is None
            raise RuntimeError
    assert [getattr(m, n) for m, n, _ in holds.plain_swaps()] == before


def _call(name, dtype):
    """The wrapper ``name`` of a kernel, and arguments for it at a small
    shape in ``dtype``, from a seed."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    if name == "topk_head":
        head = fused_head.prepare_head({"w": t(128, 600), "b": t(600)}, dtype)
        return fused_head, (head, (0.1 * t(8, 128)).to(dtype), 3)
    if name == "lstm_cell_fused":
        w = fused_lstm.prepare_lstm({"w_ih": 0.1 * t(64, 128),
                                     "w_hh": 0.1 * t(32, 128),
                                     "b_ih": t(128), "b_hh": t(128)})
        return fused_lstm, (w.w_cat.to(dtype), w.b_sum, t(8, 64).to(dtype),
                            t(8, 32).to(dtype), t(8, 32).to(dtype), w.split)
    if name in ("lstm_cell_bwd", "lstm_cell_bwd_full"):
        # K2's backward kernel and its whole backward (the kernel and its
        # products): the forward's inputs and the cotangents dh', dc'
        w = fused_lstm.prepare_lstm({"w_ih": 0.1 * t(64, 128),
                                     "w_hh": 0.1 * t(32, 128),
                                     "b_ih": t(128), "b_hh": t(128)})
        return fused_lstm, (w.w_cat.to(dtype), w.b_sum.to(dtype),
                            *(t(8, n).to(dtype) for n in (64, 32, 32, 32, 32)),
                            w.split)
    if name == "quant_matmul":
        qp = quant.quantize_dense({"w": t(200, 300), "b": t(300)})
        return quant, (t(8, 200).to(dtype), qp)
    kq, ks = int8_attention.quantize_rows(t(4, 5, 256))
    vq, vs = int8_attention.quantize_rows(t(4, 5, 256))
    mask = (torch.arange(5)[None] < torch.tensor([[1], [3], [5], [5]]))
    return int8_attention, (t(4, 3, 256).to(dtype), kq, ks, vq, vs,
                            mask.float(), 2)


def _off(got):
    """A result moved by 5 % of itself and 0.05 more: beyond every hold."""
    def move(x):
        return x + (0.05 + 0.05 * x.float().abs()).to(x.dtype) \
            if x.is_floating_point() else x
    if isinstance(got, torch.Tensor):
        return move(got)
    return tuple(move(x) for x in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["topk_head", "lstm_cell_fused",
                                  "lstm_cell_bwd", "lstm_cell_bwd_full",
                                  "quant_matmul", "lanes_attention_int8"])
def test_each_hold_passes_the_plain_version_and_reports_an_error(name,
                                                                 dtype):
    """held_calls holds every call of a kernel wrapper against its plain
    version: on the CPU the wrapper is the plain version, which holds; a
    wrapper whose result is off by more than its tolerance is reported by
    name."""
    mod, args = _call(name, dtype)
    broken = []
    with holds.held_calls(broken):
        getattr(mod, name)(*args)
    assert broken == []
    with holds.plain_versions(lambda n, plain: (
            (lambda *a: _off(plain(*a))) if n == name else plain)), \
            holds.held_calls(broken):
        getattr(mod, name)(*args)
    assert [n for n, _ in broken] == [name]
