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
`tf32x3_matmul` emulate that in plain torch, on any device. Three parts
an operand and six products (6xTF32, `tf32x6_matmul`) are the
counterpart of the TPU's bf16x6 `_dot6`: the f32 class without the
3xTF32 split's own error. One pass of the two TF32 high parts
(`tf32x1_matmul`) is the counterpart of the TPU's single bf16 pass.
"""

from __future__ import annotations

import contextlib
import functools

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


def highest_precision(fn):
    """Decorator: run fn under `full_f32_matmul` (the counterpart of the JAX
    package's `highest_precision`, which traces fn at matmul precision
    'highest')."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32_matmul():
            return fn(*args, **kwargs)

    return wrapper


def use_x64():
    """Make float64 the default dtype of new tensors (the counterpart of
    enabling `jax_enable_x64`).

    Needed for weight ratios beyond ~1e7 (e.g. the 3DoF arm benchmark's
    x_std = 1e6 against u_std = 1e-4): no f32 formulation survives
    condition numbers past ~1e7 in the Riccati and lifted solves. Call it
    before creating tensors; `torch.set_default_dtype(torch.float32)`
    undoes it.
    """
    torch.set_default_dtype(torch.float64)


def stiffness_ratio(Q, R) -> float:
    """max state weight / min positive control weight, which sets the
    conditioning of this problem class. An all-zero R gives inf (0 when Q
    is zero too)."""
    Q, R = torch.as_tensor(Q), torch.as_tensor(R)
    q_max = float(torch.max(torch.abs(Q)))
    r_diag = torch.abs(torch.diagonal(R, dim1=-2, dim2=-1))
    r_pos = r_diag[r_diag > 0]
    if r_pos.numel() == 0:  # all-zero R: worst conditioning
        return float("inf") if q_max > 0 else 0.0
    return q_max / float(torch.min(r_pos))


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


def tf32_split(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """x as the sum of `parts` (2 or 3) TF32 values, as the kernels split
    an operand: each part but the last rounds what is left to TF32
    (`tf32_round`), and the last is the rest, exact in f32, truncated to
    TF32 as a tensor core reads it. float32 only."""
    if parts not in (2, 3):
        raise ValueError(f"parts must be 2 or 3, got {parts}")
    out, rest = [], x
    for _ in range(parts - 1):
        out.append(tf32_round(rest))
        rest = rest - out[-1]
    return out + [_tf32_truncate(rest)]


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the 3xTF32 tensor-core route computes it: each operand x
    split into hi = `tf32_round(x)` and lo = x - hi (exact in f32), which
    the tensor core truncates to TF32; then a_lo b_hi + a_hi b_lo, then
    + a_hi b_hi, in f32 (a product of two TF32 values is exact in f32).
    float32 only.
    """
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a, 2), tf32_split(b, 2)
    with full_f32_matmul():
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32x1_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 tensor-core pass computes it: each operand
    rounded to TF32 (`tf32_round`, the high part of `tf32_split`), their
    product summed in f32. The Hopper counterpart of the TPU kernels'
    single bf16 pass, which the u-only kernel takes for its delta
    products (c += bf16(s - s_prev) @ W_u_hi). float32 only.
    """
    with full_f32_matmul():
        return tf32_round(a) @ tf32_round(b)


def tf32x6_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the 6xTF32 route computes it: each operand split into
    three TF32 parts (`tf32_split(x, 3)`: hi, mid, lo), then the six
    products above the f32 rounding, smallest first, into f32:
    (a_lo b_hi + a_mid b_mid + a_hi b_lo) + (a_mid b_hi + a_hi b_mid)
    + a_hi b_hi. The Hopper counterpart of the TPU's bf16x6 `_dot6`.
    float32 only.
    """
    (a0, a1, a2), (b0, b1, b2) = tf32_split(a, 3), tf32_split(b, 3)
    with full_f32_matmul():
        return ((a2 @ b0 + a1 @ b1 + a0 @ b2) + (a1 @ b0 + a0 @ b1)) + a0 @ b0
