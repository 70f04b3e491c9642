"""The split that the port's 3xTF32 designs make of a float32 operand,
on the CPU.

The tensor cores take float32 products only as TF32 (10 stored mantissa
bits). Design 3 of the flash kernels (`ops/attention.py`) and of the
conv+BN statistics kernels (`ops/conv_fused.py`) never round a float32
operand to a single TF32 term: each x is split into big = tf32(x) and
small = tf32(x - big), and each product is taken as small·big + big·small
+ big·big, which keeps about 22 bits of each operand. These functions are
that split for the plain emulations the CPU tests run; the CUDA kernels
split in registers or in a split pass of their own.
"""

from __future__ import annotations

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as `cvt.rna.tf32.f32` rounds it: a float's
    bits are sign and magnitude, so adding half of the dropped unit to
    the magnitude's bits and clearing the 13 low bits rounds the
    magnitude. For finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_split(x: torch.Tensor):
    """(big, small) with big = tf32(x), small = tf32(x - big), the split
    design 3 makes of each float32 operand: big + small rebuilds x within
    2^-22 of |x|. Plain emulation for the CPU tests; nothing on the
    card's path calls it."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)
