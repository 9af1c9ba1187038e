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

The kernel does not run `rollout_step` a step at a time: `stage_plan`
reads the traced graph (`StagePlan`) and `emit_step` also writes the
staged program the template runs, a function a pass (every thread,
parallel over the chunk's steps) and a function a chain (one thread, in
series), built of the same expressions, so each value keeps its
operation, operands and rounding. The chains carry only the states that
feed back on themselves; the rest of the step (controls,
transcendentals, products of earlier levels' states) runs in parallel
over t. The program compiles on the host too, where
tests/test_torch_rollout_staged.py runs it beside the serial
`rollout_step`, bit for bit.

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

// The staged program's loads: a candidate's controls at one step (W
// floats, as float4 or float2 where the row width allows), and a chain's
// next G staged addends (G a multiple of 4, 16-byte aligned on the card)
template <int W>
__host__ __device__ inline void ro_load_row(const float* __restrict__ src, float* v) {
#ifdef __CUDA_ARCH__
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(src)[j];
      v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
    }
    return;
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      const float2 q = reinterpret_cast<const float2*>(src)[j];
      v[2 * j] = q.x, v[2 * j + 1] = q.y;
    }
    return;
  }
#endif
  for (int j = 0; j < W; ++j) v[j] = src[j];
}
template <int G>
__host__ __device__ inline void ro_load_group(const float* __restrict__ src, float* v) {
  ro_load_row<G>(src, v);
}
// a chain's G results (G a multiple of 4, 16-byte aligned on the card)
template <int G>
__host__ __device__ inline void ro_store_group(float* __restrict__ dst, const float* v) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int j = 0; j < G / 4; ++j)
    reinterpret_cast<float4*>(dst)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                                    v[4 * j + 3]);
#else
  for (int j = 0; j < G; ++j) dst[j] = v[j];
#endif
}
"""

# The staged program's block-wide pieces, after its defines: the states'
# carries into the arrays, and a chunk's rows of xs written out (element e
# of the chunk is state e % D of step e / D, so neighbouring threads write
# neighbouring floats), each state's carry moved to the next chunk's t = 0.
STAGED_RUNTIME = r"""
__host__ __device__ inline void rollout_init(float* __restrict__ s, int row,
                                             const float* __restrict__ x0, int tid, int threads) {
  for (int k = tid; k < ROLLOUT_D; k += threads) s[k * row] = x0[k];
}
__host__ __device__ inline void rollout_write(float* __restrict__ s, int row,
                                              float* __restrict__ xs_c, int len, int tid,
                                              int threads) {
  for (int e = tid; e < len * ROLLOUT_D; e += threads) {
    const int t = e / ROLLOUT_D, k = e - t * ROLLOUT_D;
    xs_c[e] = s[k * row + t];
    if (t == 0) s[k * row] = s[k * row + len];  // the only reader of s[k * row] here
  }
}
"""


class GeneratedStep(NamedTuple):
    """A step emitted for the generated rollout kernel."""
    d: int
    m: int
    # PRELUDE, `rollout_step` and the staged program of `plan`, for nvcc or
    # a host compiler
    source: str
    ops: tuple  # the table's operations the step uses, in order of first use
    n_ops: int  # operations a step (each emitted operation one)
    # the longest loop-carried latency cycle, in operations a step: the
    # largest mean, over cycles of the state's dependencies from one step
    # to the next, of the operations on the cycle (1 for CarSimple)
    chain: float
    plan: "StagePlan"  # how the staged kernel runs the step


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


class _Value(NamedTuple):
    """An emitted operation: `const float name = expr;`."""
    name: str  # "v<k>", k its place in emission order
    op: str  # the table's operation
    expr: str
    refs: tuple  # its operands other than numbers: ("v", k), ("x", i) or ("u", j)


def _ref(expr: str):
    """What a row's C expression names: ("v", k), ("x", i), ("u", j), or
    None for a number."""
    if expr.startswith("v") and expr[1:].isdigit():
        return ("v", int(expr[1:]))
    if expr[:2] in ("x[", "u[") and expr.endswith("]"):
        return (expr[0], int(expr[2:-1]))
    return None


class StagePlan(NamedTuple):
    """How the staged kernel runs a step over a chunk of the horizon
    (`stage_plan`).

    The state graph has an edge j -> k where row k of the step reads x[j].
    Its strongly connected components (SCCs), ordered by level in the
    condensation, say what is truly serial: an SCC whose rows read its own
    states (`cyclic`) is a chain, run in series by one thread; any other
    state is a function of earlier levels and of the controls, computed in
    parallel over t. Each emitted value is one of: "stage 0" (reads no
    state: parallel over t before anything else), ("cycle", c) (reads a
    state of SCC c and a row of c reads it: in c's chain), or ("parallel",
    L) (reads states of levels up to L: parallel over t once they are
    known). A value crossing from one phase to another is `staged` in
    shared memory; the rest stay in registers.
    """
    sccs: tuple  # each a tuple of state indices, by level, then by least index
    cyclic: tuple  # per SCC: a chain (its rows read its own states)
    levels: tuple  # per level: the indices of its SCCs
    chains: tuple  # per level that has chains: its cyclic SCCs (tuples of states)
    cycle_ops: dict  # chained SCC (tuple of states) -> the operations on its cycle
    classes: tuple  # per emitted value: "stage 0", ("cycle", scc) or ("parallel", level)
    staged: tuple  # values and controls kept in shared memory, e.g. ("u[0]", "v3")
    phases: tuple  # a chunk's phases in order: ("pass", level) or ("chains", level)
    arrays: int  # shared-memory arrays a chunk takes: the d states', then `staged`
    most_chains: int  # the most chains one phase runs (each on a warp of its own)
    serial: bool  # the whole step as one chain (a step with too many staged values)


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
        self.values: list[_Value] = []
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
        self.values.append(_Value(name, op, expr, tuple(
            r for r in (_ref(a.expr) for a in args) if r is not None)))
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


# The most shared-memory arrays a staged plan takes: at 256 a chunk of 192
# steps still fits a block's 227 KB (csrc/linesearch_rollout_generic.cuh).
# A step that would stage more runs as one chain (`StagePlan.serial`).
MAX_ARRAYS = 256
# A chain thread reads its next G steps' staged inputs ahead into
# registers and unrolls its loop G times: G (32, 16, 8 or 4) times its
# inputs at most READ_AHEAD floats, G times its cycle's operations at most
# UNROLL_OPS.
READ_AHEAD = 64
UNROLL_OPS = 512


def stage_plan(values, rows, d: int, serial: bool = False) -> StagePlan:
    """The stage plan of a step: its emitted values (`_Value`s in emission
    order) and its d rows (each `_ref` of the row's expression). serial:
    the whole step as one chain, run by one thread, as it is planned
    where a plan would stage more than MAX_ARRAYS arrays."""
    sdeps = []  # per value: the states it reads, through any path
    for v in values:
        sdeps.append(frozenset().union(*(
            {j} if kind == "x" else sdeps[j] if kind == "v" else set() for kind, j in v.refs)))

    def reads(ref):
        if ref is None or ref[0] == "u":
            return frozenset()
        return frozenset((ref[1],)) if ref[0] == "x" else sdeps[ref[1]]

    row_reads = [reads(r) for r in rows]
    row_uses = [_value_closure(values, r) for r in rows]
    # reach[j][k]: a path of at least one edge x[j] -> ... -> x[k]
    reach = [[j in row_reads[k] for k in range(d)] for j in range(d)]
    for via in range(d):
        for j in range(d):
            if reach[j][via]:
                reach[j] = [a or b for a, b in zip(reach[j], reach[via])]
    if serial:
        comps = [tuple(range(d))]
    else:
        comps = sorted({tuple(k for k in range(d) if k == j or (reach[j][k] and reach[k][j]))
                        for j in range(d)})
    comp_of = {k: c for c, comp in enumerate(comps) for k in comp}
    preds = [{comp_of[j] for k in comp for j in row_reads[k]} - {c}
             for c, comp in enumerate(comps)]
    level = [0] * len(comps)
    for _ in comps:  # longest paths in the condensation, a DAG of <= d nodes
        level = [max((level[p] + 1 for p in preds[c]), default=0) for c in range(len(comps))]
    order = sorted(range(len(comps)), key=lambda c: (level[c], comps[c]))
    comps, level = [comps[c] for c in order], [level[c] for c in order]
    comp_of = {k: c for c, comp in enumerate(comps) for k in comp}
    cyclic = [serial or any(j in row_reads[k] for k in comp for j in comp) for comp in comps]

    classes = []
    for i in range(len(values)):
        if serial:
            classes.append(("cycle", 0))
        elif not sdeps[i]:
            classes.append("stage 0")
        else:
            on = [c for c, comp in enumerate(comps)
                  if sdeps[i] & set(comp) and any(i in row_uses[k] for k in comp)]
            classes.append(("cycle", on[0]) if on else
                           ("parallel", max(level[comp_of[j]] for j in sdeps[i])))
    levels = tuple(tuple(c for c in range(len(comps)) if level[c] == lv)
                   for lv in range(max(level) + 1))
    live = frozenset().union(*row_uses)
    row_phase = [_row_phase(k, comps, cyclic, levels) for k in range(d)]
    consumers = {}  # a ref -> the phases that read it
    for i in live:
        for r in values[i].refs:
            consumers.setdefault(r, set()).add(_phase(classes[i], levels))
    for k, r in enumerate(rows):
        if r is not None:
            consumers.setdefault(r, set()).add(row_phase[k])
    # a value or control is staged where a phase other than its own reads it
    # (the controls' own: level 0's pass, which reads them)
    staged = tuple(_name(r) for r in sorted(consumers) if r[0] != "x" and consumers[r] - {
        _phase(classes[r[1]], levels) if r[0] == "v" else ("pass", 0)})
    if d + len(staged) > MAX_ARRAYS and not serial:
        return stage_plan(values, rows, d, serial=True)
    used = {_phase(classes[i], levels) for i in live} | set(row_phase)
    if any(name.startswith("u[") for name in staged):
        used.add(("pass", 0))
    chains = tuple(tuple(comps[c] for c in cs if cyclic[c]) for cs in levels)
    return StagePlan(
        sccs=tuple(comps), cyclic=tuple(cyclic), levels=levels,
        chains=tuple(level_chains for level_chains in chains if level_chains),
        cycle_ops={comps[c]: tuple(values[i].op for i in sorted(live)
                                   if classes[i] == ("cycle", c))
                   for c in range(len(comps)) if cyclic[c]},
        classes=tuple(classes), staged=staged,
        phases=tuple(sorted(used, key=lambda p: 2 * p[1] + (p[0] == "chains"))),
        arrays=d + len(staged),
        most_chains=max((len(level_chains) for level_chains in chains), default=0),
        serial=serial)


def _name(ref) -> str:
    """A ref's C name: "v3", "x[2]", "u[0]"."""
    return f"v{ref[1]}" if ref[0] == "v" else f"{ref[0]}[{ref[1]}]"


def _phase(cls, levels) -> tuple:
    """The phase that computes a value of class cls: stage 0 in level 0's
    pass, a cycle in its level's chains, a parallel value of level L in
    level L + 1's pass."""
    if cls == "stage 0":
        return ("pass", 0)
    if cls[0] == "cycle":
        return ("chains", next(lv for lv, cs in enumerate(levels) if cls[1] in cs))
    return ("pass", cls[1] + 1)


def _row_phase(k, sccs, cyclic, levels) -> tuple:
    """The phase that needs row k: its chain, or the pass that writes state
    k at t + 1 (a state that is a function of earlier levels)."""
    c = next(c for c, comp in enumerate(sccs) if k in comp)
    return ("chains" if cyclic[c] else "pass", next(lv for lv, cs in enumerate(levels)
                                                     if c in cs))


def _value_closure(values, ref) -> frozenset:
    """The emitted values a row's expression reads, through any path."""
    if ref is None or ref[0] != "v":
        return frozenset()
    seen, todo = set(), [ref[1]]
    while todo:
        i = todo.pop()
        if i not in seen:
            seen.add(i)
            todo += [j for kind, j in values[i].refs if kind == "v"]
    return frozenset(seen)


def _read_ahead(n_inputs: int, n_ops: int) -> int:
    """Steps a chain reads ahead: the most of 32, 16, 8, 4 that keeps its
    inputs' registers within READ_AHEAD and its unrolled loop within
    UNROLL_OPS."""
    return next((g for g in (32, 16, 8)
                 if g * n_inputs <= READ_AHEAD and g * n_ops <= UNROLL_OPS), 4)


def _staged_source(plan: StagePlan, values, row_exprs, d: int) -> str:
    """The staged program of `plan` in C++: a function a pass (all threads,
    parallel over the chunk's steps t), a function a chain (one thread,
    in series over t), and `rollout_phase(p, ...)`, which runs phase p of
    a chunk on thread tid (csrc/linesearch_rollout_generic.cuh calls it,
    a block barrier after each phase). Every value keeps the expression
    of `rollout_step`: its operation, operands and rounding."""
    slot = {name: d + i for i, name in enumerate(plan.staged)}
    live = frozenset().union(*(_value_closure(values, _ref(e)) for e in row_exprs))
    out = [f"\n// The staged program: {len(plan.phases)} phases a chunk, {plan.arrays} "
           f"shared-memory arrays (the {d} states', then {', '.join(plan.staged) or 'none'})"
           + (", the whole step as one chain" if plan.serial else ""),
           f"#define ROLLOUT_PHASES {len(plan.phases)}",
           f"#define ROLLOUT_ARRAYS {plan.arrays}",
           f"#define ROLLOUT_CHAINS {plan.most_chains}", STAGED_RUNTIME]
    cases = []
    for p, (kind, lv) in enumerate(plan.phases):
        if kind == "pass":
            computed = [i for i in sorted(live)
                        if _phase(plan.classes[i], plan.levels) == (kind, lv)]
            rows = [k for k in range(d)
                    if _row_phase(k, plan.sccs, plan.cyclic, plan.levels) == (kind, lv)]
            out.append(_pass_source(lv, plan, values, row_exprs, slot, computed, rows))
            cases.append(f"    case {p}: rollout_pass_{lv}(s, row, u_c, len, tid, threads); "
                         "break;")
            continue
        calls = []
        for c in plan.levels[lv]:
            if plan.cyclic[c]:
                comp = plan.sccs[c]
                name = f"rollout_chain_{'_'.join(map(str, comp))}"
                out.append(_chain_source(name, comp, plan, values, row_exprs, slot,
                                         [i for i in sorted(live)
                                          if plan.classes[i] == ("cycle", c)]))
                calls.append(f"if (tid == {32 * len(calls)}) {name}(s, row, len);")
        cases.append(f"    case {p}: {' else '.join(calls)} break;")
    out.append(
        "// phase p of a chunk on thread tid of `threads` (>= 32 x ROLLOUT_CHAINS: a "
        "phase's chains run\n// on lane 0 of warps 0, 1, ...)\n"
        "__host__ __device__ inline void rollout_phase(int p, float* __restrict__ s, int row,\n"
        "    const float* __restrict__ u_c, int len, int tid, int threads) {\n"
        "  (void)u_c;\n  (void)threads;\n  switch (p) {\n" + "\n".join(cases)
        + "\n    default: break;\n  }\n}\n")
    return "\n".join(out)


def _pass_source(lv, plan, values, row_exprs, slot, computed, rows) -> str:
    """Level lv's pass: every thread takes steps t = tid, tid + threads, ...
    of the chunk, reads the step's inputs (the controls at level 0, staged
    values and states after), computes the level's values and writes those
    a later phase reads, and the states of `rows` at t + 1."""
    refs = {r for i in computed for r in values[i].refs}
    refs |= {_ref(row_exprs[k]) for k in rows} - {None}
    body = []
    if lv == 0 and (any(r[0] == "u" for r in refs)
                    or any(name.startswith("u[") for name in plan.staged)):
        body.append("ro_load_row<ROLLOUT_M>(u_c + static_cast<size_t>(t) * ROLLOUT_M, u);")
    for r in sorted(refs):
        if (r[0] == "v" and r[1] in computed) or (r[0] == "u" and lv == 0):
            continue
        target = f"const float {_name(r)}" if r[0] == "v" else _name(r)
        body.append(f"{target} = s[{r[1] if r[0] == 'x' else slot[_name(r)]} * row + t];")
    body += [f"const float {values[i].name} = {values[i].expr};" for i in computed]
    body += [f"s[{slot[values[i].name]} * row + t] = {values[i].name};"
             for i in computed if values[i].name in slot]
    if lv == 0:
        body += [f"s[{slot[name]} * row + t] = {name};" for name in plan.staged
                 if name.startswith("u[")]
    body += [f"s[{k} * row + t + 1] = {row_exprs[k]};" for k in rows]
    head = f"// level {lv}'s pass: " + (", ".join(values[i].name for i in computed) or "no values")
    if rows:
        head += f"; states {', '.join(f'x[{k}]' for k in rows)} at t + 1"
    return "\n".join([
        head,
        f"__host__ __device__ inline void rollout_pass_{lv}(float* __restrict__ s, int row,",
        "    const float* __restrict__ u_c, int len, int tid, int threads) {",
        "  (void)u_c;", "  for (int t = tid; t < len; t += threads) {",
        "    float x[ROLLOUT_D], u[ROLLOUT_M];", "    (void)x;", "    (void)u;",
        *(f"    {line}" for line in body), "  }", "}"])


def _chain_source(name, comp, plan, values, row_exprs, slot, cycle) -> str:
    """One chained SCC's function: its thread carries the SCC's states over
    the chunk, a step at a time, reading the step's staged inputs G steps
    ahead and storing its results a group of G at a time; it writes each
    state at t before the step and, at the end, the carry at t = len."""
    inside = set(cycle)
    refs = {r for i in cycle for r in values[i].refs}
    refs |= {_ref(row_exprs[k]) for k in comp} - {None}
    inputs = sorted(r for r in refs if not (r[0] == "v" and r[1] in inside)
                    and not (r[0] == "x" and r[1] in comp))
    g = _read_ahead(len(inputs), len(cycle))
    # (array, value) of each result: the states before the step, the staged cycle values
    outputs = [(k, f"x[{k}]") for k in comp] + [
        (slot[values[i].name], values[i].name) for i in cycle if values[i].name in slot]

    def step(source, sink):
        lines = []
        for a, r in enumerate(inputs):
            target = f"const float {_name(r)}" if r[0] == "v" else _name(r)
            lines.append(f"{target} = {source(a, r)};")
        lines += [sink(o, *outputs[o]) for o in range(len(comp))]
        lines += [f"const float {values[i].name} = {values[i].expr};" for i in cycle]
        lines += [sink(o, *outputs[o]) for o in range(len(comp), len(outputs))]
        lines += [f"const float next{k} = {row_exprs[k]};" for k in comp]
        lines += [f"x[{k}] = next{k};" for k in comp]
        return lines

    def slot_of(r):
        return r[1] if r[0] == "x" else slot[_name(r)]

    grouped = step(lambda a, r: f"in{a}[j]", lambda o, array, value: f"out{o}[j] = {value};")
    single = step(lambda a, r: f"s[{slot_of(r)} * row + t]",
                  lambda o, array, value: f"s[{array} * row + t] = {value};")
    ops = " then ".join(plan.cycle_ops[comp]) or "no operation"
    text = [f"// SCC {{{', '.join(f'x[{k}]' for k in comp)}}}: its cycle {ops}; inputs "
            + (", ".join(_name(r) for r in inputs) or "none"),
            f"__host__ __device__ inline void {name}(float* __restrict__ s, int row, int len) {{",
            "  float x[ROLLOUT_D], u[ROLLOUT_M];", "  (void)x;", "  (void)u;"]
    text += [f"  x[{k}] = s[{k} * row];" for k in comp]
    text.append(f"  constexpr int G = {g};")
    for a, r in enumerate(inputs):
        text += [f"  float in{a}[G], ahead{a}[G];",
                 f"  ro_load_group<G>(s + {slot_of(r)} * row, in{a});"]
    text += ["  int t0 = 0;", "  for (; t0 + G <= len; t0 += G) {"]
    text += [f"    ro_load_group<G>(s + {slot_of(r)} * row + t0 + G, ahead{a});"
             for a, r in enumerate(inputs)]
    text += [f"    float out{o}[G];" for o in range(len(outputs))]
    text += ["#pragma unroll", "    for (int j = 0; j < G; ++j) {"]
    text += [f"      {line}" for line in grouped]
    text.append("    }")
    text += [f"    ro_store_group<G>(s + {array} * row + t0, out{o});"
             for o, (array, _) in enumerate(outputs)]
    if inputs:
        text += ["#pragma unroll", "    for (int j = 0; j < G; ++j) {"]
        text += [f"      in{a}[j] = ahead{a}[j];" for a in range(len(inputs))]
        text.append("    }")
    text += ["  }", "  for (int t = t0; t < len; ++t) {"]
    text += [f"    {line}" for line in single]
    text.append("  }")
    text += [f"  s[{k} * row + len] = x[{k}];" for k in comp]
    text.append("}")
    return "\n".join(text)


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
    plan = stage_plan(em.values, [_ref(r.expr) for r in rows], d)
    source += _staged_source(plan, em.values, [r.expr for r in rows], d)
    return GeneratedStep(d, m, source, tuple(em.ops), em.n_ops, _max_cycle_mean(weights), plan)
