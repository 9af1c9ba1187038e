"""Matmul-precision policy (counterpart of `ilqr_admm_tpu/utils/precision.py`).

On the TPU, default f32 matmuls run as single-pass bf16 and break ADMM
convergence, so the JAX package traces setup and solver code under
`highest_precision`. On NVIDIA cards the same trap is TF32: it keeps
about three decimal digits of each f32 operand. PyTorch leaves TF32 off
for matmuls by default but on for cuDNN convolutions, and any caller can
turn either on globally. `full_f32_matmul` pins both off for the code it
wraps and restores the caller's settings on exit.

A kernel that wants the tensor cores' rate at f32 accuracy splits each
operand into two TF32 parts and takes three products (3xTF32, the
counterpart of the TPU kernels' bf16x3 `_dot3`); `tf32_round` and
`tf32x3_matmul` emulate that in plain torch, on any device.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run the body with every f32 matmul and convolution in full f32.

    Usable as `with full_f32_matmul():` or as a decorator
    `@full_f32_matmul()`.
    """
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    prev_precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_precision)
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as the card's `cvt.rna.tf32.f32` does.

    The result is a float32 tensor whose low 13 mantissa bits are zero;
    +-inf, +-0 and NaN pass through.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: TF32 toward zero, as a
    tensor core reads an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the 3xTF32 tensor-core route computes it: each operand x
    split into hi = `tf32_round(x)` and lo = x - hi (exact in f32), which
    the tensor core truncates to TF32; then a_lo b_hi + a_hi b_lo, then
    + a_hi b_hi, in f32 (a product of two TF32 values is exact in f32).
    float32 only.
    """
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = _tf32_truncate(a - a_hi), _tf32_truncate(b - b_hi)
    with full_f32_matmul():
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
