"""Slow: the beyond-reference demos on the car and the arm against their JAX examples on the CPU.

Each case runs the JAX example and its `examples_torch/` twin (`--device
cpu`) in subprocesses, asserts the example's `GOLDENS` rows on the
twin's output and compares the two outputs with the tolerances and the
recorded causes of `tests/torch_examples.py` (`SPECS`).
"""

import pytest

import torch_examples as te

NAMES = ["boxddp_car_parking", "pd_ilqr_infeasible_start", "robust_joint_calibration"]


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_its_example(name):
    te.compare(name)
