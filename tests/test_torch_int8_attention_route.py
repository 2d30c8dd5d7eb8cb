"""The kernel routes of K4, the int8 K/V attention
(simpleimagecaptionzoo_tpu_torch/ops/int8_attention.py), on the CPU: which
route ``attention_route`` picks from the shapes and the alignment of kq and
vq, the "tma" route's shared-memory plan, and the plain version taken for
CPU tensors on either route's shapes.  The kernels themselves run only on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu_torch.ops import int8_attention as IA


def _kv(b, n, d):
    return torch.zeros(b, n, d, dtype=torch.int8)


def _misaligned_kv(b, n, d, past=1):
    """A contiguous int8 (b, n, d) tensor whose data starts ``past`` bytes
    after a 16-byte boundary."""
    flat = torch.zeros(b * n * d + 32, dtype=torch.int8)
    off = next(i for i in range(32) if (flat.data_ptr() + i) % 16 == past)
    return flat[off:off + b * n * d].view(b, n, d)


@pytest.mark.parametrize("b,k,n,d,heads,route", [
    (384, 1, 36, 1024, 8, "tma"),          # the greedy decode step
    (384, 3, 36, 1024, 8, "tma"),          # the beam step
    (384, 16, 36, 1024, 8, "tma"),         # the most query rows
    (6, 1, 300, 256, 2, "tma"),            # two TMA boxes of rows
    (5, 4, 37, 384, 3, "tma"),             # 3 heads
    (4, 1, 36, 2048, 16, "tma"),           # 16 heads
    (2, 1, 109, 1024, 8, "tma"),           # the largest N at D 1,024, k=1
    (2, 1, 110, 1024, 8, "cuda_core"),     # one row past the plan
    (3, 16, 2048, 256, 1, "cuda_core"),    # N = 2048: beyond 227 KB
    (384, 1, 300, 1024, 8, "cuda_core"),
    (4, 1, 36, 1000, 8, "cuda_core"),      # D not a multiple of 16
    (4, 1, 36, 1024, 0, "cuda_core"),
    (4, 17, 36, 1024, 8, "cuda_core"),     # k beyond the kernel's 16
])
def test_attention_route_rule(b, k, n, d, heads, route):
    q = torch.zeros(b, k, d)
    assert IA.attention_route(q, _kv(b, n, d), _kv(b, n, d), n, d,
                              heads) == route


@pytest.mark.parametrize("which", ["k", "v", "q"])
@pytest.mark.parametrize("past", [1, 4, 8])
def test_attention_route_needs_16_byte_aligned_bases(which, past):
    b, n, d = 4, 36, 1024
    q = torch.zeros(b, 1, d, dtype=torch.bfloat16)
    kq, vq = _kv(b, n, d), _kv(b, n, d)
    assert IA.attention_route(q, kq, vq, n, d, 8) == "tma"
    if which == "k":
        kq = _misaligned_kv(b, n, d, past)
    elif which == "v":
        vq = _misaligned_kv(b, n, d, past)
    else:                                   # bf16: an even number of bytes
        flat = torch.zeros(b * d + 16, dtype=torch.bfloat16)
        off = next(i for i in range(16)
                   if (flat.data_ptr() + 2 * i) % 16 == past + past % 2)
        q = flat[off:off + b * d].view(b, 1, d)
    assert IA.attention_route(q, kq, vq, n, d, 8) == "cuda_core"


@pytest.mark.parametrize("k,n,d,heads,smem", [
    (1, 36, 1024, 8, 76608),       # the greedy step: three blocks an SM
    (3, 36, 1024, 8, 81216),       # the beam step: two
    (16, 36, 1024, 8, 111168),
    (1, 300, 256, 2, 162144),      # two boxes of 150 rows
    (1, 257, 256, 2, 139436),      # two boxes of 129 rows: one row past N
])
def test_tma_smem_plan(k, n, d, heads, smem):
    assert IA.tma_smem_bytes(k, n, d, heads) == smem


@pytest.mark.parametrize("dtype,k,staged", [
    (torch.float32, 1, False), (torch.float32, 2, False),
    (torch.float32, 3, True), (torch.float32, 16, True),
    (torch.bfloat16, 3, False), (torch.bfloat16, 16, False)])
def test_q_staged_in_shared_memory_for_float32_beams(dtype, k, staged):
    """float32 q with 3 or more rows (attend_tma<float, 4>) is staged in
    shared memory, 16 bytes to align and k x d floats more; bf16 q and
    fewer rows read q through L1.  The route decision counts the staged q:
    at N=36 and D=1,024 float32 k=16 still fits 227 KB."""
    base = IA.tma_smem_bytes(k, 36, 1024, 8)
    assert IA.tma_smem_bytes(k, 36, 1024, 8, dtype) == (
        base + (16 + 4 * k * 1024 if staged else 0))
    q = torch.zeros(384, k, 1024, dtype=dtype)
    assert IA.attention_route(q, _kv(384, 36, 1024), _kv(384, 36, 1024), 36,
                              1024, 8) == "tma"
    # the beam step's plan: two blocks an SM either way
    assert IA.tma_smem_bytes(3, 36, 1024, 8, torch.float32) == 93520


def _inputs(b, k, n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, k, d)).astype(np.float32)).to(
        dtype)
    kq, ks = IA.quantize_rows(torch.from_numpy(
        rng.normal(size=(b, n, d)).astype(np.float32)))
    vq, vs = IA.quantize_rows(torch.from_numpy(
        rng.normal(size=(b, n, d)).astype(np.float32)))
    valid = 1 + np.arange(b) % n
    mask = torch.from_numpy((np.arange(n)[None, :] < valid[:, None])
                            .astype(np.float32))
    return q, kq, ks, vq, vs, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,d,heads,route", [
    (4, 1, 36, 1024, 8, "tma"),
    (4, 3, 36, 1024, 8, "tma"),
    (2, 2, 1000, 256, 2, "cuda_core"),     # beyond the "tma" plan
])
def test_cpu_tensors_take_the_plain_version_on_either_route(dtype, b, k, n,
                                                            d, heads, route):
    """On the card these shapes take ``route``; here the wrapper takes the
    plain version and counts no launch."""
    q, kq, ks, vq, vs, mask = _inputs(b, k, n, d, dtype, b + k + n)
    assert IA.attention_route(q, kq, vq, n, d, heads) == route
    before = IA.COUNT.n, IA.COUNT_TMA.n
    got = IA.lanes_attention_int8(q, kq, ks, vq, vs, mask, heads)
    want = IA.lanes_attention_int8_plain(q, kq, ks, vq, vs, mask, heads)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (IA.COUNT.n, IA.COUNT_TMA.n) == before
