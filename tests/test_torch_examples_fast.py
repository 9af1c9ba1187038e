"""Fast checks of the `examples_torch/` twins (no solve runs here):

- the twin set equals the `examples/` set;
- no twin imports jax or the JAX package (an AST scan of each file, and
  each twin imported in a process where `import jax` fails);
- each twin's `main()` called without a device on a machine with no CUDA
  card raises the port's CUDA error before doing any work: the default
  dtype is left as it was and no process group is started;
- `examples_torch/goldens.py` reads the same `GOLDENS` as
  `tests/test_examples.py` holds.

The slow comparisons against the JAX examples are in
`tests/test_torch_examples_*.py` (`-m slow`).
"""

import ast
import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

import torch_examples as te

NAMES = te.example_names()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(te.TWINS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_twin_set_equals_example_set():
    assert te.twin_names() == NAMES
    assert sorted(te.SPECS) == NAMES
    assert sorted(te.GOLDENS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_twin_imports_neither_jax_nor_the_jax_package(name):
    path = os.path.join(te.TWINS, name + ".py")
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    roots = {m.split(".")[0] for m in imported}
    assert "jax" not in roots and "ilqr_admm_tpu" not in roots and "optax" not in roots, roots
    assert "ilqr_admm_tpu_torch" in roots
    assert roots <= {"os", "sys", "argparse", "socket", "time", "numpy", "torch", "scipy",
                     "matplotlib", "ilqr_admm_tpu_torch"}, roots


def test_twins_import_with_jax_absent():
    """Every twin and the goldens helper import in a process where any
    `import jax` fails."""
    code = textwrap.dedent(
        f"""
        import importlib.util, sys
        sys.modules["jax"] = None
        for name in {NAMES + ["goldens"]!r}:
            spec = importlib.util.spec_from_file_location(
                name, {te.TWINS!r} + "/" + name + ".py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules if m.split(".")[0] == "ilqr_admm_tpu")
        assert not leaked, leaked
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=te.REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", NAMES)
def test_twin_without_a_card_raises_before_any_work(name, monkeypatch):
    module = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dtype = torch.get_default_dtype()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        module.main()
    assert torch.get_default_dtype() == dtype
    assert not dist.is_initialized()


def test_goldens_helper_reads_the_test_table():
    import test_examples

    assert te.GOLDENS == test_examples.GOLDENS


def test_slow_files_cover_every_twin_once():
    import test_torch_examples_demos_linear as dl
    import test_torch_examples_demos_nonlinear as dn
    import test_torch_examples_mirrors_linear as ml
    import test_torch_examples_mirrors_nonlinear as mn

    names = ml.NAMES + mn.NAMES + dl.NAMES + dn.NAMES
    assert sorted(names) == NAMES
