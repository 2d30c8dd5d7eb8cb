"""The weight half of the 3xTF32 products of K1 and K2 (the "tf32x3" route).

Hopper's tensor cores have no float32 product; their nearest type, TF32,
keeps 10 of float32's 23 mantissa bits.  3xTF32 splits each operand into
two TF32 values, ``a = a_hi + a_lo`` (exact to 2^-22 of ``|a|``), and sums
``a_lo * b_hi + a_hi * b_lo + a_hi * b_hi`` in one float32 accumulator; the
dropped ``a_lo * b_lo`` is below 2^-22 of the product.  That keeps float32
accuracy at a third of the TF32 rate.

The weights do not change within a decode, so their split is made here,
once, by the ``prepare_*`` functions (``fused_lstm.prepare_lstm``,
``fused_head.prepare_head``); the kernels split the activations
themselves, with ``cvt.rna.tf32.f32``, whose rounding :func:`round_tf32`
reproduces bit for bit.  An int8 weight is exact in TF32, so the "tf32x2"
routes of K3 and K1-int8 split only x.  Both parts are stored transposed, (N, K) with K
contiguous: ``wgmma`` takes TF32 operands K-major only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_HALF = 0x1000               # half a unit of the last TF32 mantissa bit
_KEEP = -0x2000              # 0xFFFFE000: sign, exponent, 10 mantissa bits


class Split(NamedTuple):
    """A float32 weight (K, N) as two TF32 parts, each (N, K) contiguous."""
    hi: torch.Tensor
    lo: torch.Tensor


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (PTX's
    ``cvt.rna.tf32.f32``), as float32 with the low 13 bits zero."""
    if t.dtype != torch.float32:
        raise TypeError("round_tf32 takes float32, got %s" % t.dtype)
    bits = t.contiguous().view(torch.int32)
    return ((bits + _HALF) & _KEEP).view(torch.float32)


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w -> (w_hi, w_lo), both TF32 values and ``w - w_hi - w_lo`` within
    2^-22 of ``|w|`` (where w_lo is a normal float, ``|w| >= 2^-114``).
    ``w - w_hi`` is exact in float32."""
    hi = round_tf32(w)
    return hi, round_tf32(w - hi)


def prepare_split(w: torch.Tensor) -> Split:
    """A float32 weight (K, N) as stored -> its :class:`Split`, transposed
    to (N, K) for the kernels."""
    hi, lo = split_tf32(w.t().contiguous())
    return Split(hi, lo)
