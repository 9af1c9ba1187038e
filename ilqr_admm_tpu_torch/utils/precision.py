"""Matmul-precision policy (counterpart of `ilqr_admm_tpu/utils/precision.py`).

On the TPU, default f32 matmuls run as single-pass bf16 and break ADMM
convergence, so the JAX package traces setup and solver code under
`highest_precision`. On NVIDIA cards the same trap is TF32: it keeps
about three decimal digits of each f32 operand. PyTorch leaves TF32 off
for matmuls by default but on for cuDNN convolutions, and any caller can
turn either on globally. `full_f32_matmul` pins both off for the code it
wraps and restores the caller's settings on exit.
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
