"""The examples' golden checks, read from `tests/test_examples.py`.

`GOLDENS` there maps each example to its checks: ("has", substring) or
("float", regex with one group, lo, hi). This module reads that
assignment with `ast.literal_eval`, without importing the test (which
imports pytest) or editing it, so that the twins' tests and
`chip_smoke.py` hold a twin's output to the same rows as the JAX
example's. It imports only the standard library.
"""

from __future__ import annotations

import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_FILE = os.path.join(REPO, "tests", "test_examples.py")


def load_goldens() -> dict:
    """{example name: [check, ...]} from the `GOLDENS = {...}` assignment."""
    with open(TEST_FILE, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=TEST_FILE)
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "GOLDENS"):
            return ast.literal_eval(node.value)
    raise LookupError(f"no GOLDENS assignment in {TEST_FILE}")


def check_output(name: str, out: str, goldens: dict | None = None):
    """Hold an example's stdout to its golden rows, as
    `tests/test_examples.py` does. Returns (failures, values): a list of
    messages (empty when every row holds) and, for each "float" row, the
    number its regex captured (None where it found no match)."""
    rows = (load_goldens() if goldens is None else goldens)[name]
    failures, values = [], []
    for row in rows:
        if row[0] == "has":
            if row[1] not in out:
                failures.append(f"{name}: expected {row[1]!r} in the output")
            continue
        _, pattern, lo, hi = row
        m = re.search(pattern, out, re.DOTALL)
        if not m:
            failures.append(f"{name}: no match for {pattern!r}")
            values.append(None)
            continue
        val = float(m.group(1))
        values.append(val)
        if not lo <= val <= hi:
            failures.append(f"{name}: {pattern!r} -> {val} outside [{lo}, {hi}]")
    return failures, values

