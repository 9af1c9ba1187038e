"""Slow: the beyond-reference demos on the double integrator against their JAX examples on the CPU.

Each case runs the JAX example and its `examples_torch/` twin (`--device
cpu`) in subprocesses, asserts the example's `GOLDENS` rows on the
twin's output and compares the two outputs with the tolerances and the
recorded causes of `tests/torch_examples.py` (`SPECS`).
"""

import pytest

import torch_examples as te

NAMES = ["admm_acceleration", "al_obstacle_avoidance", "batched_multistart",
         "inverse_lqt_learning", "robust_fleet_diamond", "sparse_control_l1"]


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_its_example(name):
    te.compare(name)
