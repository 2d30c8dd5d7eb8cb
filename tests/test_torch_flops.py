"""The port's FLOP counts (``utils/flops.py``) and profiling helpers
(``utils/profiling.py``) against the JAX package's: every count equal for
all five families at their published widths and a narrow one, for decode
(greedy and beam), XE and SCST; ``mfu`` and ``ThroughputMeter`` behaving
as JAX's (the port's peak is the H100 SXM's, named in the result); the
timer, the trace and the aten FLOP counter on the CPU."""
import json
import os
import time

import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JModelConfig
from simpleimagecaptionzoo_tpu.config import \
    load_model_config as jload_model_config
from simpleimagecaptionzoo_tpu.utils import flops as JF
from simpleimagecaptionzoo_tpu.utils import profiling as JP
from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.config import load_model_config
from simpleimagecaptionzoo_tpu_torch.utils import flops as TF
from simpleimagecaptionzoo_tpu_torch.utils import profiling as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("NIC", "BUTDSpatial", "BUTDDetection", "AoASpatial",
            "AoADetection")


def _configs(family):
    path = os.path.join(ROOT, "Configs", "Models", family + ".json")
    yield load_model_config(path, 10102), jload_model_config(path, 10102)
    narrow = dict(model_type=family, vocab_size=50, embed_dim=32,
                  hidden_dim=48, atten_dim=16, enc_dim=24, num_heads=2,
                  num_refine_layers=2)
    yield ModelConfig(**narrow), JModelConfig(**narrow)


@pytest.mark.parametrize("family", FAMILIES)
def test_every_count_equals_jax(family):
    for cfg, jcfg in _configs(family):
        for b, n, steps in ((384, 36, 20), (128, 49, 21), (1, 1, 1)):
            assert TF.encode_flops(cfg, b, n) == JF.encode_flops(jcfg, b, n)
            for rows in (b, 3 * b):
                assert TF.step_flops(cfg, rows, n) == \
                    JF.step_flops(jcfg, rows, n)
            for beam in (1, 3):
                assert TF.decode_flops(cfg, b, n, steps, beam) == \
                    JF.decode_flops(jcfg, b, n, steps, beam)
            assert TF.xe_train_flops(cfg, b, n, steps) == \
                JF.xe_train_flops(jcfg, b, n, steps)
            assert TF.scst_train_flops(cfg, b, n, steps) == \
                JF.scst_train_flops(jcfg, b, n, steps)
            assert TF.decode_flops(cfg, b, n, steps) > 0


def test_mfu_behaves_as_jax():
    for flops, secs, dtype in ((4.2e12, 0.05, "bf16"), (1e9, 1e-3, "f32"),
                               (3.3e14, 2.0, "bf16")):
        got, want = TP.mfu(flops, secs, dtype), JP.mfu(flops, secs, dtype)
        assert got["achieved_tflops"] == want["achieved_tflops"]
        assert got["peak_tflops_assumed"] == TP.PEAK_TFLOPS[dtype]
        assert got["mfu"] == round(
            flops / secs / 1e12 / TP.PEAK_TFLOPS[dtype], 4)
        assert got["peak_of"] == TP.PEAK_CARD and "H100" in got["peak_of"]
        assert set(got) == set(want) | {"peak_of"}
    assert TP.PEAK_TFLOPS == {"bf16": 989.0, "f32": 67.0}
    for args in ((None, 1.0), (0.0, 1.0), (1e9, 0.0), (1e9, -1.0)):
        assert TP.mfu(*args) is None and JP.mfu(*args) is None


def test_throughput_meter_behaves_as_jax():
    ours, theirs = TP.ThroughputMeter(), JP.ThroughputMeter()
    for m in (ours, theirs):
        m.add(30)
        m.add(12.5)
    time.sleep(0.02)
    assert ours.items == theirs.items == 42.5
    assert 0 < ours.rate <= 42.5 / 0.02 and 0 < theirs.rate <= 42.5 / 0.02
    ours.reset()
    assert ours.items == 0.0


def test_step_timer_trace_and_aten_flops(tmp_path):
    lines = []
    with TP.step_timer("mm", sink=lines.append, device="cpu"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert len(lines) == 1 and lines[0].startswith("[mm] ")
    with TP.profiler_trace(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert prof is not None
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with TP.profiler_trace("") as prof:
        pass
    assert prof is None
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    assert TP.aten_flops(torch.mm, a, b) == 2 * 4 * 6 * 5
    assert TP.aten_flops(torch.relu, a) is None
