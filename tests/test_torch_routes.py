"""The kernel routes of K1, K2 and K3 (simpleimagecaptionzoo_tpu_torch/ops),
on the CPU: which route a wrapper picks from dtypes, shapes and alignment,
and K1's chunk plan per route.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import pytest
import torch

from simpleimagecaptionzoo_tpu_torch.ops import (_build, fused_head, fused_lstm,
                                                 quant)


def _misaligned(*shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts 2 bytes (4 for float32) past a
    16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.zeros(n + 8, dtype=dtype)
    past = max(2, flat.element_size())
    off = next(i for i in range(1, 8)
               if (flat.data_ptr() + i * flat.element_size()) % 16 == past)
    return flat[off:off + n].view(*shape)


def _lstm(b, e, h, dtype=torch.bfloat16):
    return (torch.zeros(e + h, 4 * h, dtype=dtype),
            torch.zeros(b, e, dtype=dtype), torch.zeros(b, h, dtype=dtype))


@pytest.mark.parametrize("b,e,h,dtype,route", [
    (384, 2048, 1024, torch.bfloat16, "wgmma"),       # the decode step
    (1152, 2048, 1024, torch.bfloat16, "wgmma"),      # the beam step
    (37, 200, 128, torch.bfloat16, "wgmma"),          # ragged B, K step straddles E
    (384, 2048, 1024, torch.float32, "tf32x3"),       # float32: 3xTF32 wgmma
    (37, 70, 128, torch.bfloat16, "cuda_core"),       # rows of 140 bytes
    (16, 384, 100, torch.bfloat16, "cuda_core"),      # H not a multiple of 8
    (1152, 2048, 1024, torch.float32, "tf32x3"),      # the beam step
    (37, 200, 128, torch.float32, "tf32x3"),          # ragged B, E=200
    (16, 384, 100, torch.float32, "tf32x3"),          # rows of 400 bytes
    (37, 70, 128, torch.float32, "cuda_core"),        # rows of 280 bytes
    (16, 384, 102, torch.float32, "cuda_core"),       # rows of 408 bytes
])
def test_lstm_route_rule(b, e, h, dtype, route):
    w, x, hh = _lstm(b, e, h, dtype)
    assert fused_lstm.lstm_route(w, x, hh) == route


def test_lstm_route_needs_aligned_bases():
    w, x, hh = _lstm(16, 384, 128)
    assert fused_lstm.lstm_route(w, x, hh) == "wgmma"
    assert fused_lstm.lstm_route(w, _misaligned(16, 384), hh) == "cuda_core"
    assert fused_lstm.lstm_route(w, x, _misaligned(16, 128)) == "cuda_core"
    assert fused_lstm.lstm_route(_misaligned(512, 512), x, hh) == "cuda_core"


@pytest.mark.parametrize("which", ["w", "x", "h"])
def test_lstm_f32_route_needs_aligned_bases(which):
    f32 = torch.float32
    w, x, hh = _lstm(16, 384, 128, f32)
    assert fused_lstm.lstm_route(w, x, hh) == "tf32x3"
    if which == "w":
        w = _misaligned(512, 512, dtype=f32)
    elif which == "x":
        x = _misaligned(16, 384, dtype=f32)
    else:
        hh = _misaligned(16, 128, dtype=f32)
    assert fused_lstm.lstm_route(w, x, hh) == "cuda_core"


def test_lstm_route_needs_one_dtype():
    w, x, hh = _lstm(16, 384, 128, torch.float32)
    assert fused_lstm.lstm_route(w.bfloat16(), x, hh) == "cuda_core"
    assert fused_lstm.lstm_route(w, x, hh.bfloat16()) == "cuda_core"


def _head(vocab, dtype, wdtype=None):
    head = fused_head.prepare_head(
        {"w": torch.randn(96, vocab), "b": torch.zeros(vocab)}, dtype)
    if wdtype is not None:
        head = head._replace(w=head.w.to(wdtype))
    return head


# a case whose expected route changed keeps the id it was collected under
@pytest.mark.parametrize("xdtype,wdtype,route", [
    (torch.bfloat16, torch.bfloat16, "wgmma"),
    (torch.float32, torch.float32, "tf32x3"),      # 3xTF32 wgmma
    (torch.bfloat16, torch.int8, "wgmma"),         # K1-int8, widened to bf16
    pytest.param(torch.float32, torch.int8, "tf32x2",   # 2xTF32, widened
                 id="xdtype3-wdtype3-cuda_core"),       # to float32
])
def test_head_route_rule(xdtype, wdtype, route):
    head = _head(1000, xdtype, wdtype)
    x = torch.zeros(16, head.w.shape[0], dtype=xdtype)
    assert fused_head.head_route(head.w, x) == route


def test_head_route_int8_rows_need_16_bytes():
    head = _head(1000, torch.bfloat16, torch.int8)       # Vp 1,024
    x = torch.zeros(16, head.w.shape[0], dtype=torch.bfloat16)
    assert fused_head.head_route(head.w, x) == "wgmma"
    w = torch.zeros(head.w.shape[0], 1000, dtype=torch.int8)  # rows of 1,000 B
    assert fused_head.head_route(w, x) == "cuda_core"
    assert fused_head.head_route(_misaligned(128, 1024, dtype=torch.int8),
                                 x) == "cuda_core"


def test_head_route_f32_int8_needs_16_byte_rows_and_aligned_bases():
    head = _head(1000, torch.float32, torch.int8)        # Kp 128, Vp 1,024
    x = torch.zeros(16, head.w.shape[0])
    assert fused_head.head_route(head.w, x) == "tf32x2"
    w = torch.zeros(head.w.shape[0], 1000, dtype=torch.int8)  # rows of 1,000 B
    assert fused_head.head_route(w, x) == "cuda_core"
    assert fused_head.head_route(_misaligned(128, 1024, dtype=torch.int8),
                                 x) == "cuda_core"
    assert fused_head.head_route(
        head.w, _misaligned(16, 128, dtype=torch.float32)) == "cuda_core"
    assert fused_head.head_route(head.w[:98], torch.zeros(16, 98)) == \
        "cuda_core"                                      # x rows of 392 B


def test_head_route_needs_aligned_bases():
    head = _head(1000, torch.bfloat16)
    x = _misaligned(16, head.w.shape[0])
    assert fused_head.head_route(head.w, x) == "cuda_core"
    assert fused_head.head_route(head.w, x.clone()) == "wgmma"


def test_head_f32_route_needs_aligned_bases_and_16_byte_rows():
    f32 = torch.float32
    head = _head(1000, f32)                              # Kp 128, Vp 1,024
    x = _misaligned(16, head.w.shape[0], dtype=f32)
    assert fused_head.head_route(head.w, x) == "cuda_core"
    assert fused_head.head_route(head.w, x.clone()) == "tf32x3"
    assert fused_head.head_route(_misaligned(128, 1024, dtype=f32),
                                 x.clone()) == "cuda_core"
    w = torch.zeros(head.w.shape[0], 1001)               # rows of 4,004 B
    assert fused_head.head_route(w, x.clone()) == "cuda_core"
    assert fused_head.head_route(head.w[:98], torch.zeros(16, 98)) == \
        "cuda_core"                                      # x rows of 392 B


@pytest.mark.parametrize("route,vp,nchunk", [
    ("wgmma", 10240, 40),         # the COCO vocabulary, padded to 512
    ("cuda_core", 10240, 80),
    ("wgmma", 512, 2),
    ("cuda_core", 512, 4),
    ("wgmma", 700, 3),            # a ragged last chunk
    ("tf32x3", 10240, 80),
    ("tf32x3", 512, 4),
    ("tf32x3", 700, 6),
    ("tf32x2", 10240, 80),        # K1-int8 in float32: tf32x3's chunks
    ("tf32x2", 700, 6),
])
def test_head_chunk_plan(route, vp, nchunk):
    assert fused_head.head_chunks(route, vp) == nchunk


def test_head_chunk_widths_match_the_kernel_tiles():
    assert (fused_head.HEAD_CHUNK, fused_head.HEAD_CHUNK_WGMMA,
            fused_head.HEAD_CHUNK_TF32X3) == (128, 256, 128)
    assert fused_head.head_chunks("tf32x2", 10240) == \
        fused_head.head_chunks("tf32x3", 10240)
    assert fused_head.V_TILE % fused_head.HEAD_CHUNK_WGMMA == 0
    assert fused_head.V_TILE % fused_head.HEAD_CHUNK_TF32X3 == 0
    with pytest.raises(KeyError):
        fused_head.head_chunks("tf32", 512)


def _q(kp, np_):
    return torch.zeros(kp, np_, dtype=torch.int8)


@pytest.mark.parametrize("m,k,dtype,route", [
    (384, 3072, torch.bfloat16, "wgmma"),      # the LSTM gates
    (384, 1024, torch.bfloat16, "wgmma"),      # aoa_dec.q
    (384, 2048, torch.bfloat16, "wgmma"),      # aoa_dec.aoa
    (1152, 3072, torch.bfloat16, "wgmma"),     # the beam rows
    (37, 200, torch.bfloat16, "wgmma"),        # ragged m and K
    pytest.param(384, 3072, torch.float32, "tf32x2",   # float32: 2xTF32
                 id="384-3072-dtype5-cuda_core"),      # (id kept)
    (37, 70, torch.bfloat16, "cuda_core"),     # K not a multiple of 8
    (5, 1, torch.bfloat16, "cuda_core"),
    (384, 1024, torch.float32, "tf32x2"),      # aoa_dec.q
    (384, 2048, torch.float32, "tf32x2"),      # aoa_dec.aoa
    (1152, 3072, torch.float32, "tf32x2"),     # the beam rows
    (37, 200, torch.float32, "tf32x2"),        # ragged m and K, rows of 800 B
    (37, 70, torch.float32, "cuda_core"),      # K not a multiple of 4
    (16, 102, torch.float32, "cuda_core"),     # rows of 408 bytes
    (5, 1, torch.float32, "cuda_core"),
    (16, 256, torch.float16, "cuda_core"),     # no route takes float16
])
def test_quant_route_rule(m, k, dtype, route):
    x = torch.zeros(m, k, dtype=dtype)
    assert quant.quant_route(x, _q(-(-k // 128) * 128, 512)) == route


@pytest.mark.parametrize("which", ["x", "q"])
def test_quant_route_needs_aligned_bases(which):
    x, q = torch.zeros(16, 256, dtype=torch.bfloat16), _q(256, 512)
    assert quant.quant_route(x, q) == "wgmma"
    if which == "x":
        x = _misaligned(16, 256)
    else:
        q = _misaligned(256, 512, dtype=torch.int8)
    assert quant.quant_route(x, q) == "cuda_core"


@pytest.mark.parametrize("which", ["x", "q"])
def test_quant_f32_route_needs_aligned_bases(which):
    x, q = torch.zeros(16, 256), _q(256, 512)
    assert quant.quant_route(x, q) == "tf32x2"
    if which == "x":
        x = _misaligned(16, 256, dtype=torch.float32)
    else:
        q = _misaligned(256, 512, dtype=torch.int8)
    assert quant.quant_route(x, q) == "cuda_core"


def test_tma_alignment_rule():
    t = torch.zeros(4, 16, dtype=torch.bfloat16)
    assert _build.tma_aligned(t)
    assert not _build.tma_aligned(torch.zeros(4, 12, dtype=torch.bfloat16))
    assert not _build.tma_aligned(_misaligned(4, 16))
    # a view whose rows lie 40 bytes apart
    assert not _build.tma_aligned(torch.zeros(4, 20, dtype=torch.bfloat16)[:, :16])
    assert _build.tma_aligned(torch.zeros(4, 24, dtype=torch.bfloat16)[:, :16])


def test_cpu_tensors_take_the_plain_versions_on_either_route():
    """bf16 on the CPU would be the wgmma route on the card (int8 weights
    too); here the wrappers take their plain versions and count no
    launch."""
    torch.manual_seed(0)
    w, x, hh = (t.normal_() for t in _lstm(8, 64, 32))
    b = torch.zeros(128, dtype=torch.bfloat16)
    c = torch.randn(8, 32).bfloat16()
    head = _head(600, torch.bfloat16)
    xh = torch.randn(8, 96).bfloat16()
    qhead = fused_head.prepare_head(quant.quantize_dense(
        {"w": torch.randn(96, 600), "b": torch.randn(600)}), torch.bfloat16)
    qp = quant.quantize_dense({"w": torch.randn(96, 200),
                               "b": torch.randn(200)})
    xq = torch.randn(8, 96).bfloat16()
    assert quant.quant_route(xq, qp["q"]) == "wgmma"
    assert fused_head.head_route(qhead.w, torch.nn.functional.pad(
        xh, (0, 32))) == "wgmma"
    counters = (fused_lstm.COUNT, fused_lstm.COUNT_WGMMA, fused_head.COUNT,
                fused_head.COUNT_WGMMA, quant.COUNT, quant.COUNT_WGMMA)
    counts = [cn.n for cn in counters]
    got = fused_lstm.lstm_cell_fused(w, b, x, hh, c)
    want = fused_lstm.lstm_cell_plain(w, b, x, hh, c)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    for hd in (head, qhead):
        got = fused_head.topk_head(hd, xh, 3)
        want = fused_head.topk_head_plain(hd, xh, 3)
        assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert torch.equal(quant.quant_matmul(xq, qp),
                       quant.quant_matmul_plain(xq, qp))
    assert counts == [cn.n for cn in counters]

