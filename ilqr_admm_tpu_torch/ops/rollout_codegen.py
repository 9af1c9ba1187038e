"""A plant's step, traced and emitted as C++ for the generated rollout kernel.

The Pallas rollout (`ilqr_admm_tpu/ops/pallas_rollout.py:54-134`) takes
any `step_cols(x (d, A), u (m, A)) -> (d, A)` written in elementwise jnp
ops and traces it into its kernel. The port does the same for the CUDA
kernel of `csrc/linesearch_rollout_generic.cuh`: `emit_step` traces the
step with `torch.fx.symbolic_trace` on (d, A) and (m, A) placeholders and
writes it out as one C++ function,

    __host__ __device__ inline void rollout_step(const float* x,
                                                 const float* u, float* out)

on one candidate's state (d floats) and controls (m floats), which the
template includes and `_build.build_rollouts` compiles for `sm_90a`. The
function compiles on the host too (`g++`), which is how the CPU tests
hold it to the plain version.

Each operation is written as ATen's CUDA kernel computes it on float32,
not as the textbook formula, so that the kernel gives the plain version's
bits on the card:
- every sum, difference and product rounds on its own (`__fadd_rn`,
  `__fsub_rn`, `__fmul_rn`: nvcc would contract a * b + c into an FMA,
  which torch's separate elementwise launches never do);
- Python scalars are folded while tracing, in f64, as the plain version
  folds them (`dist**2` is 4.0), and each scalar operand is the f32 that
  ATen rounds it to, written as a hex-float literal;
- a division by a Python scalar is a product by its f32 reciprocal (ATen's
  CUDA kernel for a CPU scalar divisor), and `s / x` is `reciprocal(x) *
  s` (`Tensor.__rtruediv__`);
- `pow` with a scalar exponent: 0 fills 1, 1 copies, 0.5 is `sqrt`, -0.5
  `rsqrt`, -1 `reciprocal`, 2 `x * x`, 3 `x * x * x`, -2 `1.0 / (x * x)`
  in double, anything else `powf` (ATen's `pow_tensor_scalar_kernel`);
- `remainder` (and `%`) is `fmodf` moved into the divisor's sign, the
  maxima and minima propagate NaN, and `clamp` with scalar bounds keeps a
  NaN, as ATen's kernels do.

The table: integer `getitem` of x, u and of a `torch.stack` the step made;
`+ - * /` between rows and with a Python number on either side (`add` and
`sub` without `alpha`, `div` without `rounding_mode`); unary `-`; `pow`
with a number as the exponent; `sin`, `cos`, `tan`, `asin`, `acos`,
`atan`, `atan2`, `sqrt`, `exp`, `log`, `tanh`, `abs`, `minimum`,
`maximum`, `clamp` with number bounds, `remainder` / `%`; `zeros_like`,
`ones_like` and `full_like` of a row (a constant row). The step returns
`torch.stack` of d rows, each a computed row, a constant or an input
row. Anything else raises ValueError when the rollout is built, and names
the operation: Python control flow on a value, an in-place write, an
operation on the whole state (`A @ x` is `matmul`), a tensor constant, an
operation outside the table. There is no fallback to the plain version.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.fx

# The JAX contract: state and control each fit one sublane tile
# (pallas_rollout.py:70-75)
MAX_DIM = 8

_FUNCTIONS = {
    operator.getitem: "getitem", torch.stack: "stack",
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub", torch.subtract: "sub",
    operator.mul: "mul", torch.mul: "mul", torch.multiply: "mul",
    operator.truediv: "div", torch.div: "div", torch.divide: "div",
    torch.true_divide: "div",
    operator.neg: "neg", torch.neg: "neg", torch.negative: "neg",
    operator.pow: "pow", torch.pow: "pow",
    operator.mod: "remainder", torch.remainder: "remainder",
    torch.sin: "sin", torch.cos: "cos", torch.tan: "tan",
    torch.asin: "asin", torch.arcsin: "asin", torch.acos: "acos", torch.arccos: "acos",
    torch.atan: "atan", torch.arctan: "atan", torch.atan2: "atan2", torch.arctan2: "atan2",
    torch.sqrt: "sqrt", torch.exp: "exp", torch.log: "log", torch.tanh: "tanh",
    operator.abs: "abs", torch.abs: "abs", torch.absolute: "abs",
    torch.minimum: "minimum", torch.maximum: "maximum",
    torch.clamp: "clamp", torch.clip: "clamp",
    torch.zeros_like: "zeros_like", torch.ones_like: "ones_like",
    torch.full_like: "full_like",
}
_METHODS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul", "multiply": "mul",
    "div": "div", "divide": "div", "true_divide": "div", "neg": "neg", "negative": "neg",
    "pow": "pow", "remainder": "remainder", "sin": "sin", "cos": "cos", "tan": "tan",
    "asin": "asin", "arcsin": "asin", "acos": "acos", "arccos": "acos", "atan": "atan",
    "arctan": "atan", "atan2": "atan2", "arctan2": "atan2", "sqrt": "sqrt", "exp": "exp",
    "log": "log", "tanh": "tanh", "abs": "abs", "absolute": "abs", "minimum": "minimum",
    "maximum": "maximum", "clamp": "clamp", "clip": "clamp",
}
# unary ops -> the libm function ATen's CUDA kernel calls on a float
_UNARY = {"sin": "sinf", "cos": "cosf", "tan": "tanf", "asin": "asinf", "acos": "acosf",
          "atan": "atanf", "sqrt": "sqrtf", "exp": "expf", "log": "logf", "tanh": "tanhf",
          "abs": "fabsf"}
TABLE = ("getitem", "stack", "add", "sub", "mul", "div", "neg", "pow", "remainder",
         *_UNARY, "atan2", "minimum", "maximum", "clamp", "zeros_like", "ones_like",
         "full_like")

# Helpers of the emitted step: each op as ATen's CUDA kernel computes it on
# float32; on the host (a CPU test's g++) the same formulas in plain IEEE
# float arithmetic, compiled without FMA contraction.
PRELUDE = r"""#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

// Sums, differences, products and quotients rounded one at a time: nvcc
// contracts a * b + c into an FMA unless told not to, and torch's
// elementwise kernels round each operation on its own.
__host__ __device__ inline float ro_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ inline float ro_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
__host__ __device__ inline float ro_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ inline float ro_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
// torch.reciprocal and pow(x, -1)
__host__ __device__ inline float ro_reciprocal(float a) { return ro_div(1.0f, a); }
// pow(x, -0.5) is ATen's rsqrt kernel
__host__ __device__ inline float ro_rsqrt(float a) {
#ifdef __CUDA_ARCH__
  return rsqrtf(a);
#else
  return 1.0f / sqrtf(a);
#endif
}
// pow(x, 2), pow(x, 3), pow(x, -2) as ATen's pow_tensor_scalar_kernel_impl
__host__ __device__ inline float ro_square(float a) { return ro_mul(a, a); }
__host__ __device__ inline float ro_cube(float a) { return ro_mul(ro_mul(a, a), a); }
__host__ __device__ inline float ro_inv_square(float a) {
  return static_cast<float>(1.0 / static_cast<double>(ro_mul(a, a)));
}
// torch.remainder: fmod, moved into the divisor's sign
__host__ __device__ inline float ro_remainder(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r = ro_add(r, b);
  return r;
}
// torch.maximum / torch.minimum: a NaN on either side wins
__host__ __device__ inline float ro_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__host__ __device__ inline float ro_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with number bounds: a NaN stays
__host__ __device__ inline float ro_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__host__ __device__ inline float ro_clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__host__ __device__ inline float ro_clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
"""


class GeneratedStep(NamedTuple):
    """A step emitted for the generated rollout kernel."""
    d: int
    m: int
    source: str  # PRELUDE and `rollout_step`, for nvcc or a host compiler
    ops: tuple  # the table's operations the step uses, in order of first use
    n_ops: int  # operations a step (each emitted operation one)
    # the longest loop-carried latency cycle, in operations a step: the
    # largest mean, over cycles of the state's dependencies from one step
    # to the next, of the operations on the cycle (1 for CarSimple)
    chain: float


class _Row(NamedTuple):
    expr: str  # a C expression of one float
    # per state component j: the most operations on a path from x[j] to
    # this row within one step, or -1 where the row does not depend on it
    lat: tuple


class _Whole(NamedTuple):
    name: str  # "x" or "u": a placeholder, the whole (d, A) or (m, A) state


class _Stack(NamedTuple):
    rows: tuple  # of _Row


class _Constant(NamedTuple):
    name: str  # a tensor the step closed over (a get_attr node)


def f32_literal(value: float) -> str:
    """The f32 that ATen rounds a Python scalar to, as a C++ literal
    (hex-float, exact)."""
    with np.errstate(over="ignore"):
        v = float(np.float32(value))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    text = v.hex() + "f"
    return f"({text})" if text.startswith("-") else text


def _reciprocal_f32(value: float) -> float:
    """1 / value in f32, as ATen computes a CPU scalar divisor's inverse."""
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        return float(np.float32(1.0) / np.float32(value))


def _op_name(node: torch.fx.Node) -> tuple[str | None, str]:
    """(the table's name of the node's operation or None, its own name)."""
    if node.op == "call_function":
        own = getattr(node.target, "__name__", repr(node.target))
        return _FUNCTIONS.get(node.target), own
    if node.op == "call_method":
        return _METHODS.get(node.target), node.target
    return None, node.op


def _in_place(name: str) -> bool:
    return (name.endswith("_") and not name.startswith("__")) or name == "__setitem__" or (
        name.startswith("__i") and name.endswith("__"))


def trace_step(step_cols: Callable) -> torch.fx.Graph:
    """The step's graph: `torch.fx.symbolic_trace` of step_cols(x, u).
    Raises ValueError where the step cannot be traced (Python control flow
    on a value, for one)."""

    def step(x, u):
        return step_cols(x, u)

    try:
        return torch.fx.symbolic_trace(step).graph
    except TypeError as exc:
        if "item assignment" not in str(exc):
            raise ValueError(f"the rollout step could not be traced: TypeError: {exc}") from exc
        raise ValueError("the rollout step writes in place (`__setitem__`): the generated "
                         "kernel takes a step that returns new rows") from exc
    except torch.fx.proxy.TraceError as exc:
        raise ValueError(f"the rollout step branches on a value ({exc}); the generated "
                         "kernel takes a step of elementwise operations only") from exc
    except Exception as exc:  # noqa: BLE001 - any failure to trace is a refusal at build
        raise ValueError(f"the rollout step could not be traced: {type(exc).__name__}: "
                         f"{exc}") from exc


class _Emitter:
    def __init__(self, d: int, m: int):
        self.d, self.m = d, m
        self.lines: list[str] = []
        self.ops: list[str] = []
        self.n_ops = 0

    def none(self) -> tuple:
        return (-1,) * self.d

    def const(self, value: float) -> _Row:
        return _Row(f32_literal(value), self.none())

    def emit(self, op: str, expr: str, *args: _Row) -> _Row:
        lat = tuple(max((a.lat[j] for a in args), default=-1) for j in range(self.d))
        lat = tuple(v + 1 if v >= 0 else -1 for v in lat)
        name = f"v{len(self.lines)}"
        self.lines.append(f"  const float {name} = {expr};")
        self.n_ops += 1
        if op not in self.ops:
            self.ops.append(op)
        return _Row(name, lat)

    def row(self, op: str, value, what: str = "operand") -> _Row:
        if isinstance(value, _Row):
            return value
        if isinstance(value, _Whole):
            raise ValueError(f"`{op}` of the whole state {value.name}: the generated kernel "
                             f"takes a step written on its rows ({value.name}[i])")
        if isinstance(value, _Stack):
            raise ValueError(f"`{op}` of a stacked state: the generated kernel takes "
                             "operations on rows, and `torch.stack` only to return them")
        if isinstance(value, _Constant):
            raise ValueError(f"`{op}` of a tensor constant ({value.name}): the generated "
                             "kernel takes Python numbers as constants")
        raise ValueError(f"`{op}`: its {what} {value!r} is not a row")

    @staticmethod
    def is_number(value) -> bool:
        return isinstance(value, (int, float)) and not isinstance(value, bool)

    def binary(self, op: str, a, b) -> _Row:
        """`+ - * /`, atan2, minimum, maximum, remainder of two rows or a row
        and a Python number."""
        num_a, num_b = self.is_number(a), self.is_number(b)
        if num_a and num_b:
            raise ValueError(f"`{op}` of two numbers")
        if op in ("atan2", "minimum", "maximum") and (num_a or num_b):
            raise ValueError(f"`{op}` with a Python number: torch takes two tensors there")
        fn = {"add": "ro_add", "sub": "ro_sub", "mul": "ro_mul", "remainder": "ro_remainder",
              "atan2": "atan2f", "minimum": "ro_minimum", "maximum": "ro_maximum"}
        if op == "div":
            if num_b:  # a product by the divisor's f32 reciprocal
                ra = self.row(op, a)
                return self.emit(op, f"ro_mul({ra.expr}, {f32_literal(_reciprocal_f32(b))})", ra)
            rb = self.row(op, b, "divisor")
            if num_a:  # Tensor.__rtruediv__: reciprocal(b) * a
                rec = self.emit(op, f"ro_reciprocal({rb.expr})", rb)
                return self.emit(op, f"ro_mul({rec.expr}, {f32_literal(a)})", rec)
            ra = self.row(op, a)
            return self.emit(op, f"ro_div({ra.expr}, {rb.expr})", ra, rb)
        ra = self.const(a) if num_a else self.row(op, a)
        rb = self.const(b) if num_b else self.row(op, b)
        return self.emit(op, f"{fn[op]}({ra.expr}, {rb.expr})", ra, rb)

    def pow(self, base, exponent) -> _Row:
        if not self.is_number(exponent):
            raise ValueError("`pow` with a tensor exponent: the generated kernel takes a "
                             "Python number as the exponent")
        rb = self.row("pow", base, "base")
        e = float(exponent)
        if e == 0.0:
            return self.const(1.0)
        if e == 1.0:
            return rb
        special = {0.5: "sqrtf", -0.5: "ro_rsqrt", -1.0: "ro_reciprocal"}
        if e in special:
            return self.emit("pow", f"{special[e]}({rb.expr})", rb)
        e32 = float(np.float32(e))
        fn = {2.0: "ro_square", 3.0: "ro_cube", -2.0: "ro_inv_square"}.get(e32)
        if fn is not None:
            return self.emit("pow", f"{fn}({rb.expr})", rb)
        return self.emit("pow", f"powf({rb.expr}, {f32_literal(e32)})", rb)

    def clamp(self, value, lo=None, hi=None) -> _Row:
        rv = self.row("clamp", value)
        for bound in (lo, hi):
            if bound is not None and not self.is_number(bound):
                raise ValueError("`clamp` with a tensor bound: the generated kernel takes "
                                 "Python numbers as the bounds (or torch.minimum / maximum)")
            if bound is not None and math.isnan(bound):
                raise ValueError("`clamp` with a NaN bound")
        if lo is None and hi is None:
            raise ValueError("`clamp` without a bound")
        if hi is None:
            return self.emit("clamp", f"ro_clamp_min({rv.expr}, {f32_literal(lo)})", rv)
        if lo is None:
            return self.emit("clamp", f"ro_clamp_max({rv.expr}, {f32_literal(hi)})", rv)
        return self.emit("clamp", f"ro_clamp({rv.expr}, {f32_literal(lo)}, {f32_literal(hi)})",
                         rv)


def _getitem(container, index, dims):
    if isinstance(index, bool) or not isinstance(index, int):
        raise ValueError(f"`getitem` with the index {index!r}: the generated kernel takes "
                         "integer indices of rows")
    if isinstance(container, _Whole):
        dim = dims[container.name]
        if not -dim <= index < dim:
            raise ValueError(f"{container.name}[{index}] is out of range: "
                             f"{'d' if container.name == 'x' else 'm'} = {dim}")
        i = index % dim
        lat = tuple(0 if (container.name == "x" and j == i) else -1 for j in range(dims["x"]))
        return _Row(f"{container.name}[{i}]", lat)
    if isinstance(container, _Stack):
        if not -len(container.rows) <= index < len(container.rows):
            raise ValueError(f"`getitem` {index} of a stack of {len(container.rows)} rows")
        return container.rows[index]
    raise ValueError(f"`getitem` of {container!r}: the generated kernel indexes x, u or a "
                     "stack of rows")


def _max_cycle_mean(weights: list[list[int]]) -> float:
    """The largest mean weight of a cycle in the graph weights[j][i] (an
    edge j -> i where >= 0): over closed walks of k <= n edges, which reach
    every simple cycle."""
    n = len(weights)
    best = 0.0
    walk = [row[:] for row in weights]  # the heaviest walks of k edges
    for k in range(1, n + 1):
        best = max([best] + [walk[i][i] / k for i in range(n) if walk[i][i] >= 0])
        walk = [[max([walk[i][j] + weights[j][l] for j in range(n)
                      if walk[i][j] >= 0 and weights[j][l] >= 0], default=-1)
                 for l in range(n)] for i in range(n)]
    return best


def emit_step(step_cols: Callable, d: int, m: int) -> GeneratedStep:
    """Trace step_cols(x (d, A), u (m, A)) -> (d, A) and emit it as the C++
    `rollout_step`. Raises ValueError, naming the operation, for a step the
    generated kernel does not take, and for d or m outside 1..MAX_DIM."""
    for name, dim in (("d", d), ("m", m)):
        if isinstance(dim, bool) or not isinstance(dim, int) or not 1 <= dim <= MAX_DIM:
            raise ValueError(f"{name}={dim}: the generated rollout takes state and control "
                             f"dims 1..{MAX_DIM} (the JAX contract: one sublane tile)")
    graph = trace_step(step_cols)
    em = _Emitter(d, m)
    dims = {"x": d, "u": m}
    env = {}
    result = None

    def value(arg):
        if isinstance(arg, torch.fx.Node):
            return env[arg]
        if isinstance(arg, (list, tuple)):
            return [value(a) for a in arg]
        return arg

    placeholders = iter(("x", "u"))
    for node in graph.nodes:
        if node.op == "placeholder":
            env[node] = _Whole(next(placeholders))
            continue
        if node.op == "get_attr":
            env[node] = _Constant(str(node.target))
            continue
        if node.op == "output":
            result = value(node.args[0])
            continue
        op, own = _op_name(node)
        if op is None:
            if _in_place(own):
                raise ValueError(f"the rollout step writes in place (`{own}`): the generated "
                                 "kernel takes a step that returns new rows")
            raise ValueError(f"the rollout step uses `{own}`, which the generated kernel does "
                             f"not take; it takes {', '.join(TABLE)}")
        args = [value(a) for a in node.args]
        kwargs = {k: value(v) for k, v in node.kwargs.items()}
        if op in ("add", "sub") and kwargs.pop("alpha", 1) != 1:
            raise ValueError(f"`{op}` with alpha: the generated kernel takes alpha = 1")
        if op == "div" and kwargs.pop("rounding_mode", None) is not None:
            raise ValueError("`div` with a rounding_mode: the generated kernel takes true "
                             "division")
        if op == "stack":
            kwargs.setdefault("dim", args[1] if len(args) > 1 else 0)
            if kwargs.pop("dim") != 0 or not isinstance(args[0], list):
                raise ValueError("`stack` other than of a list of rows on dim 0")
            env[node] = _Stack(tuple(em.row("stack", r) for r in args[0]))
            continue
        if op == "clamp":
            names = ("min", "max")
            bounds = dict(zip(names, args[1:]), **{k: kwargs.pop(k) for k in names if k in kwargs})
            args = args[:1]
        if kwargs:
            raise ValueError(f"`{own}` with the arguments {sorted(kwargs)}: the generated "
                             "kernel does not take them")
        if op == "getitem":
            env[node] = _getitem(*args, dims)
        elif op in _UNARY:
            r = em.row(op, args[0])
            env[node] = em.emit(op, f"{_UNARY[op]}({r.expr})", r)
        elif op == "neg":
            r = em.row(op, args[0])
            env[node] = em.emit(op, f"(-{r.expr})", r)
        elif op == "pow":
            env[node] = em.pow(*args)
        elif op == "clamp":
            env[node] = em.clamp(args[0], bounds.get("min"), bounds.get("max"))
        elif op in ("zeros_like", "ones_like", "full_like"):
            em.row(op, args[0])
            if op == "full_like" and not em.is_number(args[1] if len(args) > 1 else None):
                raise ValueError("`full_like` with a fill other than a Python number")
            env[node] = em.const({"zeros_like": 0.0, "ones_like": 1.0}.get(op, args[-1]))
        else:
            env[node] = em.binary(op, *args)

    if isinstance(result, _Whole) and result.name == "x":
        rows = tuple(_getitem(result, i, dims) for i in range(d))
    elif isinstance(result, _Stack):
        rows = result.rows
    else:
        raise ValueError("the rollout step must return torch.stack of its d rows, got "
                         f"{result!r}")
    if len(rows) != d:
        raise ValueError(f"the rollout step returns {len(rows)} rows, d = {d}")
    weights = [[rows[i].lat[j] for i in range(d)] for j in range(d)]
    label = getattr(step_cols, "__qualname__", type(step_cols).__name__)
    body = "\n".join(em.lines + [f"  out[{i}] = {r.expr};" for i, r in enumerate(rows)])
    source = (
        PRELUDE
        + f"\n// {label}: d = {d}, m = {m}, {em.n_ops} operations a step\n"
        + f"#define ROLLOUT_D {d}\n#define ROLLOUT_M {m}\n"
        + "__host__ __device__ inline void rollout_step(const float* __restrict__ x,\n"
        + "                                             const float* __restrict__ u,\n"
        + "                                             float* __restrict__ out) {\n"
        + "  (void)x;\n  (void)u;\n"
        + body + "\n}\n"
    )
    return GeneratedStep(d, m, source, tuple(em.ops), em.n_ops, _max_cycle_mean(weights))
