"""The plain emulation of the 3xTF32 and 6xTF32 products of
`csrc/admm_box.cu` and `csrc/admm_u_only.cu`.

`utils/precision.py::tf32_round`, `tf32x3_matmul` and `tf32x6_matmul`
model, on the CPU, how the kernels take their products on the tensor
cores; `admm_box_reference(..., products="tf32x3")` runs the whole loop
with them (the u-only loop's are held in `test_torch_fused_admm.py`). These tests hold the rounding to its definition, the products to
an error bound against f64, and the emulated loop to the state-bounded
fleet's certificates and to the f32 plain version the kernel is gated
against. The JAX package's own split, bf16x3 `_dot3`, is another route
to the same accuracy (`tests/test_pallas_admm.py` holds it).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ilqr_admm_tpu_torch.ops.fused_admm import admm_box_reference
from ilqr_admm_tpu_torch.utils.certify import certify_state_box, state_box_gate_failures
from ilqr_admm_tpu_torch.utils.precision import (
    full_f32_matmul,
    tf32_round,
    tf32_split,
    tf32x3_matmul,
    tf32x6_matmul,
)

torch.set_num_threads(2)

F32 = torch.float32
BATCH = 256


def test_tf32_round_keeps_ten_bits_with_ties_away():
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11, float("inf"),
                      -float("inf"), 0.0, -0.0, float("nan")], dtype=F32)
    r = tf32_round(x)
    assert r[:4].tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-9]
    assert r[4].item() == float("inf") and r[5].item() == -float("inf")
    assert r[6].item() == 0.0 and r[7].item() == 0.0
    assert torch.signbit(r[6:8]).tolist() == [False, True]
    assert torch.isnan(r[8])
    y = torch.tensor(np.random.default_rng(0).normal(size=1000) * 10.0 ** np.arange(-5, 5).repeat(100),
                     dtype=F32)
    ry = tf32_round(y)
    assert int((ry.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((ry - y).abs() <= 2.0**-11 * y.abs()).all())
    with pytest.raises(TypeError, match="float32"):
        tf32_round(y.double())


@pytest.mark.parametrize("K", [8, 100, 304])
def test_tf32x3_matmul_is_within_the_f32_class_bound(K):
    """Within 2^-18 (|a| @ |b|) of the f64 product elementwise, where a
    product of the operands rounded once to TF32 is not."""
    rng = np.random.default_rng(K)
    a = torch.tensor(rng.normal(size=(32, K)) * np.exp(rng.normal(size=(32, K))), dtype=F32)
    b = torch.tensor(rng.normal(size=(K, 40)) * np.exp(rng.normal(size=(K, 40))), dtype=F32)
    exact = a.double() @ b.double()
    bound = 2.0**-18 * (a.abs().double() @ b.abs().double())
    assert bool(((tf32x3_matmul(a, b).double() - exact).abs() <= bound).all())
    with full_f32_matmul():
        plain_tf32 = (tf32_round(a) @ tf32_round(b)).double()
    assert bool(((plain_tf32 - exact).abs() > bound).any())


def _operands(K):
    rng = np.random.default_rng(K)
    a = torch.tensor(rng.normal(size=(32, K)) * np.exp(rng.normal(size=(32, K))), dtype=F32)
    b = torch.tensor(rng.normal(size=(K, 40)) * np.exp(rng.normal(size=(K, 40))), dtype=F32)
    return a, b


def test_tf32_split_sums_back():
    """Two TF32 parts hold x to 2^-21 (the last one truncated), three
    exactly; every part has its low 13 mantissa bits clear."""
    x = _operands(100)[0]
    for parts, tol in ((2, 2.0**-21), (3, 0.0)):
        pieces = tf32_split(x, parts)
        assert len(pieces) == parts
        assert all(int((p.view(torch.int32) & 0x1FFF).abs().sum()) == 0 for p in pieces)
        err = (sum(p.double() for p in pieces) - x.double()).abs()
        assert bool((err <= tol * x.double().abs()).all())
    with pytest.raises(ValueError, match="2 or 3"):
        tf32_split(x, 4)


@pytest.mark.parametrize("K", [8, 100, 304])
def test_tf32x6_matmul_is_at_the_f32_level(K):
    """6xTF32 in f32 sits where a plain f32 product sits against f64
    (within 2^-20 (|a| @ |b|), and at most twice the f32 product's worst
    error); its split alone, the six products summed in f64, is within
    2^-30 (|a| @ |b|) and at least 50x below the 3xTF32 split's."""
    a, b = _operands(K)
    exact = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    with full_f32_matmul():
        f32_err = float(((a @ b).double() - exact).abs().max())
    err6 = (tf32x6_matmul(a, b).double() - exact).abs()
    assert bool((err6 <= 2.0**-20 * scale).all())
    assert float(err6.max()) <= 2.0 * f32_err
    (a0, a1), (b0, b1) = ([p.double() for p in tf32_split(t, 2)] for t in (a, b))
    split3 = ((a1 @ b0 + a0 @ b1 + a0 @ b0 - exact).abs() / scale).max()
    (a0, a1, a2), (b0, b1, b2) = ([p.double() for p in tf32_split(t, 3)] for t in (a, b))
    six = a2 @ b0 + a1 @ b1 + a0 @ b2 + a1 @ b0 + a0 @ b1 + a0 @ b0
    split6 = ((six - exact).abs() / scale).max()
    assert float(split6) <= 2.0**-30
    assert float(split6) * 50.0 <= float(split3)


def test_emulated_loop_passes_the_state_box_gates():
    """The full-width velocity-box fleet (256 instances, 200 iterations)
    with every product as the kernel takes it passes the certificates the
    card's main path is held to."""
    (A, B, cost), box = chip_smoke.box_solver("cpu")
    x0s = chip_smoke.bench_problem("cpu", batch=BATCH)[3]
    x, u, z_x, z_u = admm_box_reference(*box.kernel_inputs(x0s), **box.kernel_options,
                                        products="tf32x3")
    lo, hi = chip_smoke.velocity_box()
    cert = certify_state_box(A, B, cost, x0s, x, u, z_x, z_u, -chip_smoke.U_MAX,
                             chip_smoke.U_MAX, lo, hi)
    assert state_box_gate_failures(cert) == []
    assert cert["converged_frac"] == 1.0


@pytest.mark.parametrize("case", [0, 1, 2])
def test_emulated_loop_stays_within_the_kernel_tolerance(case):
    """In each of chip_smoke's three kernel-vs-plain cases (the full
    width and the state box only at 256 instances, the odd width), the
    3xTF32 loop stays within BOX_TOL x scale of the f32 loop."""
    label, solver, inputs = chip_smoke.box_cases("cpu", batch=BATCH)[case]
    kw = solver.kernel_options
    want = admm_box_reference(*inputs, **kw)
    got = admm_box_reference(*inputs, **kw, products="tf32x3")
    scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert 0.0 < err <= chip_smoke.BOX_TOL * scale, label


def test_products_option_is_checked():
    inputs = [torch.randn(8, 6, dtype=torch.float64), torch.randn(8, 3, dtype=torch.float64),
              torch.randn(8, 3, dtype=torch.float64), torch.randn(9, 3, dtype=torch.float64),
              torch.randn(3, 6, dtype=torch.float64), torch.ones(2, 6, dtype=torch.float64),
              torch.ones(2, 3, dtype=torch.float64)]
    with pytest.raises(TypeError, match="float32"):
        admm_box_reference(*inputs, n_iters=2, products="tf32x3")
    with pytest.raises(ValueError, match="products"):
        admm_box_reference(*inputs, n_iters=2, products="tf32")
    f32 = [t.float() for t in inputs]
    x, u, z_x, z_u = admm_box_reference(*f32, n_iters=0, products="tf32x3")
    assert torch.equal(u, f32[2]) and torch.equal(z_u, f32[2])
    assert torch.equal(x, f32[0] + tf32x3_matmul(f32[2], f32[4]))
