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
  ATen rounds it to, written as a hex-float literal; a 0-d tensor
  constant on the CPU is such a scalar too (ATen's kernels take it as
  one);
- a division by a Python scalar is a product by its f32 reciprocal (ATen's
  CUDA kernel for a CPU scalar divisor), and `s / x` is `reciprocal(x) *
  s` (`Tensor.__rtruediv__`); floor and trunc division by a scalar take
  the same reciprocal;
- `pow` with a scalar exponent: 0 fills 1, 1 copies, 0.5 is `sqrt`, -0.5
  `rsqrt`, -1 `reciprocal`, 2 `x * x`, 3 `x * x * x`, -2 `1.0 / (x * x)`
  in double, anything else `powf` (ATen's `pow_tensor_scalar_kernel`,
  which a 0-d CPU tensor exponent takes too); with a row exponent, or a
  scalar base, `powf`;
- `remainder` (and `%`) is `fmodf` moved into the divisor's sign, the
  maxima and minima propagate NaN, `clamp` with number bounds keeps a
  NaN and with row bounds propagates one from either bound, `sign` of NaN
  and of -0.0 is +0.0, `sigmoid` is 1 / (1 + exp(-x)), and a comparison
  is a 0/1 float that only `where` and the logical operators read;
- a sum, product, maximum or minimum over the state axis of a (k, C)
  block folds each column as ATen's CUDA reduction does for C >= 2
  (element i into accumulator i % 4, each from the identity, the four
  combined in order); the plain version keeps every block's candidates
  on its fastest axis, with at least two columns (`ops/fused_rollout.py`).

Values are rows (A,) and blocks (k, A): `x`, `u`, their slices and the
`torch.cat` or `torch.stack` of rows and blocks are blocks, and every
elementwise operation on a block is lowered row by row, a row or a
number broadcast against it, so a step written on the whole state emits
the values its rows written one at a time would.

The table: `getitem` of a block by an integer (negative ones too) or a
slice with a positive step; `torch.stack` of rows and `torch.cat` of
blocks on dim 0; `+ - * /` between rows and blocks and with a Python
number on either side (`add` and `sub` without `alpha`); `div` with
`rounding_mode` "floor" or "trunc", `//` and `floor_divide`; unary `-`;
`pow`; `sin`, `cos`, `tan`, `asin`, `acos`, `atan`, `atan2`, `sqrt`,
`exp`, `log`, `tanh`, `abs`, `sinh`, `cosh`, `expm1`, `log1p`,
`sigmoid`, `sign`, `square`, `floor`, `ceil`, `trunc`, `round`,
`reciprocal`, `rsqrt`, `hypot`, `fmod`, `minimum`, `maximum`, `clamp`
with number or row bounds, `remainder` / `%`; the comparisons `gt`, `lt`,
`ge`, `le`, `eq`, `ne` (operators or functions), `&`, `|`, `~` and
`logical_and`, `logical_or`, `logical_not` of masks, `torch.where(mask,
a, b)`; `sum`, `prod`, `amax` and `amin` over dim 0 of a block
(`keepdim` too); `select_scatter`, `slice_scatter` and out-of-place
`index_put` on dim 0 (the counterparts of jnp's `.at[i].set(v)`);
`zeros_like`, `ones_like` and `full_like` (a constant row). The step
returns a block of d rows (`torch.stack` of rows, `torch.cat` of blocks,
or an operation on the whole state), none a mask. Anything else raises
ValueError when the rollout is built, and names the operation: Python
control flow on a value, an in-place write, `alpha`, a reduction over
the candidates (`sum()` over every dim, or over dim 1), a vector or
matrix constant and `matmul` (the Pallas call refuses both too),
arithmetic on a mask or a mask returned as a state, an index out of
range (jnp would clamp it), an operation outside the table. There is no
fallback to the plain version.
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
    torch.cat: "cat",
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub", torch.subtract: "sub",
    operator.mul: "mul", torch.mul: "mul", torch.multiply: "mul",
    operator.truediv: "div", torch.div: "div", torch.divide: "div",
    torch.true_divide: "div",
    operator.floordiv: "floor_divide", torch.floor_divide: "floor_divide",
    operator.neg: "neg", torch.neg: "neg", torch.negative: "neg",
    operator.pow: "pow", torch.pow: "pow",
    operator.mod: "remainder", torch.remainder: "remainder",
    torch.sin: "sin", torch.cos: "cos", torch.tan: "tan",
    torch.asin: "asin", torch.arcsin: "asin", torch.acos: "acos", torch.arccos: "acos",
    torch.atan: "atan", torch.arctan: "atan", torch.atan2: "atan2", torch.arctan2: "atan2",
    torch.sqrt: "sqrt", torch.exp: "exp", torch.log: "log", torch.tanh: "tanh",
    operator.abs: "abs", torch.abs: "abs", torch.absolute: "abs",
    torch.sinh: "sinh", torch.cosh: "cosh", torch.expm1: "expm1", torch.log1p: "log1p",
    torch.sigmoid: "sigmoid", torch.sign: "sign", torch.square: "square",
    torch.floor: "floor", torch.ceil: "ceil", torch.trunc: "trunc",
    torch.round: "round", torch.reciprocal: "reciprocal", torch.rsqrt: "rsqrt",
    torch.hypot: "hypot", torch.fmod: "fmod",
    torch.minimum: "minimum", torch.maximum: "maximum",
    torch.clamp: "clamp", torch.clip: "clamp",
    operator.gt: "gt", torch.gt: "gt", torch.greater: "gt",
    operator.lt: "lt", torch.lt: "lt", torch.less: "lt",
    operator.ge: "ge", torch.ge: "ge", torch.greater_equal: "ge",
    operator.le: "le", torch.le: "le", torch.less_equal: "le",
    operator.eq: "eq", torch.eq: "eq",
    operator.ne: "ne", torch.ne: "ne", torch.not_equal: "ne",
    operator.and_: "and", torch.logical_and: "and",
    operator.or_: "or", torch.logical_or: "or",
    operator.invert: "not", torch.logical_not: "not",
    torch.where: "where",
    torch.sum: "sum", torch.prod: "prod", torch.amax: "amax", torch.amin: "amin",
    torch.select_scatter: "select_scatter", torch.slice_scatter: "slice_scatter",
    torch.index_put: "index_put",
    torch.zeros_like: "zeros_like", torch.ones_like: "ones_like",
    torch.full_like: "full_like",
}
_METHODS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul", "multiply": "mul",
    "div": "div", "divide": "div", "true_divide": "div", "floor_divide": "floor_divide",
    "neg": "neg", "negative": "neg",
    "pow": "pow", "remainder": "remainder", "sin": "sin", "cos": "cos", "tan": "tan",
    "asin": "asin", "arcsin": "asin", "acos": "acos", "arccos": "acos", "atan": "atan",
    "arctan": "atan", "atan2": "atan2", "arctan2": "atan2", "sqrt": "sqrt", "exp": "exp",
    "log": "log", "tanh": "tanh", "abs": "abs", "absolute": "abs", "minimum": "minimum",
    "maximum": "maximum", "clamp": "clamp", "clip": "clamp",
    "sinh": "sinh", "cosh": "cosh", "expm1": "expm1", "log1p": "log1p", "sigmoid": "sigmoid",
    "sign": "sign", "square": "square", "floor": "floor", "ceil": "ceil", "trunc": "trunc",
    "round": "round", "reciprocal": "reciprocal", "rsqrt": "rsqrt",
    "hypot": "hypot", "fmod": "fmod",
    "gt": "gt", "greater": "gt", "lt": "lt", "less": "lt", "ge": "ge",
    "greater_equal": "ge", "le": "le", "less_equal": "le", "eq": "eq", "ne": "ne",
    "not_equal": "ne", "logical_and": "and", "logical_or": "or", "logical_not": "not",
    "sum": "sum", "prod": "prod", "amax": "amax", "amin": "amin",
    "select_scatter": "select_scatter", "slice_scatter": "slice_scatter",
    "index_put": "index_put",
}
# unary ops -> the function ATen's CUDA kernel calls on a float (libm's, or
# the prelude's where ATen writes a formula)
_UNARY = {"sin": "sinf", "cos": "cosf", "tan": "tanf", "asin": "asinf", "acos": "acosf",
          "atan": "atanf", "sqrt": "sqrtf", "exp": "expf", "log": "logf", "tanh": "tanhf",
          "abs": "fabsf", "sinh": "sinhf", "cosh": "coshf", "expm1": "expm1f",
          "log1p": "log1pf", "floor": "floorf", "ceil": "ceilf", "trunc": "truncf",
          "round": "nearbyintf", "sign": "ro_sign", "square": "ro_square",
          "reciprocal": "ro_reciprocal", "rsqrt": "ro_rsqrt", "sigmoid": "ro_sigmoid"}
# comparisons and logical operators -> their helper (a 0/1 float, a mask)
_COMPARE = {"gt": "ro_gt", "lt": "ro_lt", "ge": "ro_ge", "le": "ro_le", "eq": "ro_eq",
            "ne": "ro_ne"}
_LOGICAL = {"and": "ro_and", "or": "ro_or"}
# reductions over the state axis -> (the fold's operation, its identity)
_REDUCE = {"sum": ("ro_sum_op", 0.0), "prod": ("ro_prod_op", 1.0),
           "amax": ("ro_amax_op", -math.inf), "amin": ("ro_amin_op", math.inf)}
TABLE = ("getitem", "stack", "cat", "add", "sub", "mul", "div", "floor_divide", "neg", "pow",
         "remainder", *_UNARY, "atan2", "hypot", "fmod", "minimum", "maximum", "clamp",
         *_COMPARE, *_LOGICAL, "not", "where", *_REDUCE, "select_scatter", "slice_scatter",
         "index_put", "zeros_like", "ones_like", "full_like")

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
// torch.clamp with row bounds (ATen's clamp kernel): a NaN value, then a NaN
// lower, then a NaN upper bound wins
__host__ __device__ inline float ro_clamp_rows(float v, float lo, float hi) {
  return v != v ? v : (lo != lo ? lo : (hi != hi ? hi : fminf(fmaxf(v, lo), hi)));
}
// torch.sign: (0 < a) - (a < 0), so NaN and -0.0 give +0.0
__host__ __device__ inline float ro_sign(float a) {
  return static_cast<float>(static_cast<int>(0.0f < a) - static_cast<int>(a < 0.0f));
}
// torch.sigmoid: 1 / (1 + exp(-a))
__host__ __device__ inline float ro_sigmoid(float a) {
  return ro_div(1.0f, ro_add(1.0f, expf(-a)));
}
// floor division as c10::div_floor_floating computes it (a row divisor),
// and as ATen's CUDA kernel does for a CPU scalar divisor b, with inv_b its
// f32 reciprocal; written as ATen writes them, so nvcc contracts them alike
__host__ __device__ inline float ro_div_floor(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if ((mod != 0.0f) && (b < 0.0f) != (mod < 0.0f)) div -= 1.0f;
  float floordiv;
  if (div != 0.0f) {
    floordiv = floorf(div);
    if (div - floordiv > 0.5f) floordiv += 1.0f;
  } else {
    floordiv = copysignf(0.0f, a / b);
  }
  return floordiv;
}
__host__ __device__ inline float ro_div_floor_scalar(float a, float b, float inv_b) {
  const float mod = fmodf(a, b);
  float div = (a - mod) * inv_b;
  if ((mod != 0.0f) && (b < 0.0f) != (mod < 0.0f)) div -= 1.0f;
  float floordiv;
  if (div != 0.0f) {
    floordiv = floorf(div);
    if (div - floordiv > 0.5f) floordiv += 1.0f;
  } else {
    floordiv = copysignf(0.0f, a * inv_b);
  }
  return floordiv;
}
// comparisons and logical operators: a mask is a 0/1 float
__host__ __device__ inline float ro_gt(float a, float b) { return a > b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_lt(float a, float b) { return a < b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_ge(float a, float b) { return a >= b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_le(float a, float b) { return a <= b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_eq(float a, float b) { return a == b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_ne(float a, float b) { return a != b ? 1.0f : 0.0f; }
__host__ __device__ inline float ro_and(float a, float b) {
  return (a != 0.0f && b != 0.0f) ? 1.0f : 0.0f;
}
__host__ __device__ inline float ro_or(float a, float b) {
  return (a != 0.0f || b != 0.0f) ? 1.0f : 0.0f;
}
__host__ __device__ inline float ro_not(float a) { return a != 0.0f ? 0.0f : 1.0f; }
__host__ __device__ inline float ro_where(float mask, float a, float b) {
  return mask != 0.0f ? a : b;
}
// Reductions over the state axis of a (k, C) block, C >= 2, as ATen's CUDA
// reduction folds a column (Reduce.cuh, thread_reduce_impl): element i into
// accumulator i % 4, each from the identity, the four then combined in
// order. amax and amin take ATen's MaxNanFunctor / MinNanFunctor.
struct ro_sum_op {
  __host__ __device__ float operator()(float a, float b) const { return ro_add(a, b); }
};
struct ro_prod_op {
  __host__ __device__ float operator()(float a, float b) const { return ro_mul(a, b); }
};
struct ro_amax_op {
  __host__ __device__ float operator()(float a, float b) const {
    return (a != a || a > b) ? a : b;
  }
};
struct ro_amin_op {
  __host__ __device__ float operator()(float a, float b) const {
    return (a != a || a < b) ? a : b;
  }
};
template <class Op, class... T>
__host__ __device__ inline float ro_fold(float ident, T... v) {
  const float e[] = {static_cast<float>(v)...};
  float acc[4] = {ident, ident, ident, ident};
  for (int i = 0; i < static_cast<int>(sizeof...(T)); ++i) acc[i % 4] = Op()(acc[i % 4], e[i]);
  return Op()(Op()(Op()(acc[0], acc[1]), acc[2]), acc[3]);
}

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
    # to the next, of the operations on the cycle (1 for CarSimple; a
    # compare and a select count one each, a reduction the operations on
    # its longest path)
    chain: float
    plan: "StagePlan"  # how the staged kernel runs the step


class _Row(NamedTuple):
    """A (A,) row: one float a candidate."""
    expr: str  # a C expression of one float
    # per state component j: the most operations on a path from x[j] to
    # this row within one step, or -1 where the row does not depend on it
    lat: tuple
    mask: bool = False  # a comparison's 0/1 (a bool tensor): read by `where` and logic only


class _Block(NamedTuple):
    """A (k, A) block: its rows in order."""
    rows: tuple  # of _Row
    name: str = ""  # "x" or "u" for the step's inputs


class _Constant(NamedTuple):
    """A tensor the step closed over or made (a get_attr node) that is not
    a 0-d number: an index of `index_put`, else refused."""
    name: str
    tensor: torch.Tensor


class _Tensor0(float):
    """A 0-d tensor constant on the CPU, as the Python number ATen's kernels
    take it for (a CPU scalar); but CUDA's `clamp` refuses it as a bound."""


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
    shared memory; the rest stay in registers. Compares, selects and
    reductions are values like any other.
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


def trace_step(step_cols: Callable) -> torch.fx.GraphModule:
    """The step's graph module: `torch.fx.symbolic_trace` of step_cols(x,
    u), its tensor constants as attributes. A plant that is a
    torch.nn.Module is traced through its `forward` (fx would refuse a
    call of a module that is not its root's). Raises ValueError where the
    step cannot be traced (Python control flow on a value, for one)."""
    call = step_cols.forward if isinstance(step_cols, torch.nn.Module) else step_cols

    def step(x, u):
        return call(x, u)

    try:
        return torch.fx.symbolic_trace(step)
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


def _is_number(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _lift(op: str, fn: Callable, *args):
    """fn of rows and numbers, lowered row by row over blocks: a (k, A)
    block's rows in order, a row, a number or a block of one row broadcast
    against it, as torch broadcasts (k, A) with (A,) and (1, A)."""
    sizes = {len(a.rows) for a in args if isinstance(a, _Block)}
    if not sizes:
        return fn(*args)
    k = max(sizes)
    if sizes - {1, k}:
        raise ValueError(f"`{op}` of blocks of {sorted(sizes)} rows, which do not broadcast")

    def pick(a, i):
        return a.rows[i if len(a.rows) > 1 else 0] if isinstance(a, _Block) else a

    return _Block(tuple(fn(*(pick(a, i) for a in args)) for i in range(k)))


def _fold_depths(k: int) -> list[int]:
    """Per element of a reduction over k rows: the operations on its path
    through ATen's fold (`ro_fold`: element i into accumulator i % 4 after
    the identity, then accumulators 1, 2, 3 combined into 0 in order)."""
    return [sum(1 for e in range(i, k, 4)) + (3 if i % 4 == 0 else 4 - i % 4)
            for i in range(k)]


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

    def emit(self, op: str, expr: str, *args: _Row, mask: bool = False, depths=None) -> _Row:
        """Emit `const float v<k> = expr;` of operand rows args; depths: the
        operations on each operand's path to the result (1 each)."""
        depths = depths or (1,) * len(args)
        lat = tuple(max((a.lat[j] + w for a, w in zip(args, depths) if a.lat[j] >= 0),
                        default=-1) for j in range(self.d))
        name = f"v{len(self.lines)}"
        self.lines.append(f"  const float {name} = {expr};")
        self.values.append(_Value(name, op, expr, tuple(
            r for r in (_ref(a.expr) for a in args) if r is not None)))
        self.n_ops += 1
        if op not in self.ops:
            self.ops.append(op)
        return _Row(name, lat, mask)

    def row(self, op: str, value, what: str = "operand", mask: bool = False) -> _Row:
        """value as a row operand of op: a float row, or a mask where op
        takes one."""
        if isinstance(value, _Row):
            if value.mask and not mask:
                raise ValueError(f"`{op}` of a mask (a comparison): the generated kernel "
                                 "takes masks in `where` and the logical operators only")
            if mask and not value.mask:
                raise ValueError(f"`{op}` of a float row: it takes a mask (a comparison)")
            return value
        if isinstance(value, _Constant):
            raise ValueError(f"`{op}` of a tensor constant of shape "
                             f"{tuple(value.tensor.shape)} ({value.name}): the generated "
                             "kernel takes numbers and 0-d tensors as constants (the Pallas "
                             "call refuses a captured array too)")
        raise ValueError(f"`{op}`: its {what} {value!r} is not a row")

    def operand(self, op: str, value) -> _Row:
        """A row, or a number as its f32 constant row."""
        return self.const(value) if _is_number(value) else self.row(op, value)

    def unary(self, op: str, value) -> _Row:
        r = self.row(op, value)
        if op == "neg":
            return self.emit(op, f"(-{r.expr})", r)
        return self.emit(op, f"{_UNARY[op]}({r.expr})", r)

    def binary(self, op: str, a, b) -> _Row:
        """`+ - * /`, atan2, hypot, fmod, minimum, maximum, remainder and the
        comparisons of two rows or a row and a Python number."""
        num_a, num_b = _is_number(a), _is_number(b)
        if num_a and num_b:
            raise ValueError(f"`{op}` of two numbers")
        if op in ("atan2", "hypot", "minimum", "maximum") and (num_a or num_b):
            raise ValueError(f"`{op}` with a Python number: torch takes two tensors there")
        if op == "fmod" and num_a:
            raise ValueError("`fmod` with a Python number as the dividend: torch takes a "
                             "tensor there")
        fn = {"add": "ro_add", "sub": "ro_sub", "mul": "ro_mul", "remainder": "ro_remainder",
              "atan2": "atan2f", "minimum": "ro_minimum", "maximum": "ro_maximum",
              "hypot": "hypotf", "fmod": "fmodf", **_COMPARE}
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
        return self.emit(op, f"{fn[op]}({ra.expr}, {rb.expr})", ra, rb, mask=op in _COMPARE)

    def rounded_div(self, mode: str, a, b) -> _Row:
        """`div` with rounding_mode "floor" (`//`, floor_divide) or "trunc",
        as ATen's CUDA kernels: by a Python number through its f32
        reciprocal (0 divides truly: a * inf), else c10's formulas."""
        op = "floor_divide" if mode == "floor" else "div"
        if _is_number(a) and _is_number(b):
            raise ValueError(f"`{op}` of two numbers")
        ra = self.operand(op, a)
        if _is_number(b):
            inv = f32_literal(_reciprocal_f32(b))
            if mode == "trunc":
                return self.emit(op, f"truncf(ro_mul({ra.expr}, {inv}))", ra)
            if float(np.float32(b)) == 0.0:
                return self.emit(op, f"ro_mul({ra.expr}, {inv})", ra)
            return self.emit(op, f"ro_div_floor_scalar({ra.expr}, {f32_literal(b)}, {inv})", ra)
        rb = self.row(op, b, "divisor")
        if mode == "trunc":
            return self.emit(op, f"truncf(ro_div({ra.expr}, {rb.expr}))", ra, rb)
        return self.emit(op, f"ro_div_floor({ra.expr}, {rb.expr})", ra, rb)

    def pow(self, base, exponent) -> _Row:
        if _is_number(base):  # torch.pow(Scalar, Tensor): 1 fills 1, else powf
            re = self.row("pow", exponent, "exponent")
            if float(base) == 1.0:
                return self.const(1.0)
            return self.emit("pow", f"powf({f32_literal(base)}, {re.expr})", re)
        rb = self.row("pow", base, "base")
        if not _is_number(exponent):  # ATen's pow_tensor_tensor_kernel: powf of the two
            re = self.row("pow", exponent, "exponent")
            return self.emit("pow", f"powf({rb.expr}, {re.expr})", rb, re)
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
        if lo is None and hi is None:
            raise ValueError("`clamp` without a bound")
        if isinstance(lo, _Tensor0) or isinstance(hi, _Tensor0):
            raise ValueError("`clamp` with a 0-d tensor bound: torch's CUDA clamp refuses a "
                             "CPU tensor there; pass a Python number")
        rows = [b for b in (lo, hi) if b is not None and not _is_number(b)]
        if rows:  # ATen's clamp with tensor bounds; one bound alone is maximum / minimum
            if len(rows) < (lo is not None) + (hi is not None):
                raise ValueError("`clamp` with a number and a row as its bounds: torch takes "
                                 "both bounds of one kind")
            if hi is None:
                return self.binary("maximum", rv, lo)
            if lo is None:
                return self.binary("minimum", rv, hi)
            rl, rh = self.row("clamp", lo, "bound"), self.row("clamp", hi, "bound")
            return self.emit("clamp", f"ro_clamp_rows({rv.expr}, {rl.expr}, {rh.expr})",
                             rv, rl, rh)
        for bound in (lo, hi):
            if bound is not None and math.isnan(bound):
                raise ValueError("`clamp` with a NaN bound")
        if hi is None:
            return self.emit("clamp", f"ro_clamp_min({rv.expr}, {f32_literal(lo)})", rv)
        if lo is None:
            return self.emit("clamp", f"ro_clamp_max({rv.expr}, {f32_literal(hi)})", rv)
        return self.emit("clamp", f"ro_clamp({rv.expr}, {f32_literal(lo)}, {f32_literal(hi)})",
                         rv)

    def logical(self, op: str, a, b=None) -> _Row:
        ra = self.row(op, a, mask=True)
        if op == "not":
            return self.emit(op, f"ro_not({ra.expr})", ra, mask=True)
        rb = self.row(op, b, mask=True)
        return self.emit(op, f"{_LOGICAL[op]}({ra.expr}, {rb.expr})", ra, rb, mask=True)

    def where(self, cond, a, b) -> _Row:
        rm = self.row("where", cond, "condition", mask=True)
        ra, rb = self.operand("where", a), self.operand("where", b)
        return self.emit("where", f"ro_where({rm.expr}, {ra.expr}, {rb.expr})", rm, ra, rb)

    def reduce(self, op: str, block: _Block) -> _Row:
        rows = [self.row(op, r) for r in block.rows]
        fn, ident = _REDUCE[op]
        args = ", ".join(r.expr for r in rows)
        return self.emit(op, f"ro_fold<{fn}>({f32_literal(ident)}, {args})", *rows,
                         depths=_fold_depths(len(rows)))

    def scalar(self, value):
        """A _Constant that is a 0-d tensor as the number ATen takes (a CPU
        scalar: `_Tensor0`) or, on another device, its constant row."""
        if not isinstance(value, _Constant) or value.tensor.dim() != 0:
            return value
        t = value.tensor
        if t.dtype == torch.bool or t.is_complex():
            raise ValueError(f"a {t.dtype} tensor constant ({value.name}): the generated "
                             "kernel takes real numbers")
        if t.device.type == "cpu":
            return _Tensor0(float(t.item()))
        return self.const(float(t.item()))


def _dim0(op: str, dim, rank: int = 2):
    """dim as the state axis of a (k, A) block (0 or -2), else ValueError."""
    if isinstance(dim, (tuple, list)) and len(dim) == 1:
        dim = dim[0]
    if isinstance(dim, bool) or not isinstance(dim, int) or dim not in (0, -rank):
        raise ValueError(f"`{op}` on dim {dim!r}: the generated kernel takes dim 0, the state "
                         "axis (dim 1 is the candidates')")


def _block(op: str, value, what: str = "operand") -> _Block:
    if isinstance(value, _Block):
        return value
    if isinstance(value, _Row):
        raise ValueError(f"`{op}` of a row (A,): its one axis is the candidates'; take a block "
                         "(a slice such as x[i:i + 1]) or torch.stack of rows")
    raise ValueError(f"`{op}`: its {what} {value!r} is not a block of rows")


def _getitem(container, index, dims=None):
    if isinstance(container, _Row):
        raise ValueError(f"`getitem` [{index!r}] of a row: its one axis is the candidates'")
    if not isinstance(container, _Block):
        raise ValueError(f"`getitem` of {container!r}: the generated kernel indexes x, u or a "
                         "block of rows")
    k = len(container.rows)
    if isinstance(index, slice):
        parts = (index.start, index.stop, index.step)
        if any(p is not None and (isinstance(p, bool) or not isinstance(p, int)) for p in parts):
            raise ValueError(f"`getitem` with the slice {index!r}: the generated kernel takes "
                             "integer bounds")
        if index.step is not None and index.step < 1:
            raise ValueError(f"`getitem` with the step {index.step}: torch takes a positive one")
        rows = container.rows[index]
        if not rows:
            raise ValueError(f"`getitem` {index!r} of a block of {k} rows is empty")
        return _Block(rows)
    if isinstance(index, bool) or not isinstance(index, int):
        raise ValueError(f"`getitem` with the index {index!r}: the generated kernel takes "
                         "integer indices and slices of rows")
    if not -k <= index < k:
        if container.name:
            raise ValueError(f"{container.name}[{index}] is out of range: "
                             f"{'d' if container.name == 'x' else 'm'} = {k}")
        raise ValueError(f"`getitem` {index} of a block of {k} rows")
    return container.rows[index]


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



def _take(op: str, args: list, kwargs: dict, names: tuple, defaults: dict | None = None) -> list:
    """The op's arguments by name, positional or keyword (torch's names
    and numpy's `axis`), else its default; ValueError for any other."""
    if "axis" in kwargs and "dim" in names:
        kwargs["dim"] = kwargs.pop("axis")
    defaults = defaults or {}
    if len(args) > len(names):
        raise ValueError(f"`{op}` with {len(args)} arguments: the generated kernel takes "
                         f"({', '.join(names)})")
    got = dict(zip(names, args))
    for key in list(kwargs):
        if key in names and key not in got:
            got[key] = kwargs.pop(key)
    if kwargs:
        raise ValueError(f"`{op}` with the arguments {sorted(kwargs)}: the generated kernel "
                         "does not take them")
    missing = [n for n in names if n not in got and n not in defaults]
    if missing:
        raise ValueError(f"`{op}` without {', '.join(missing)}")
    return [got.get(n, defaults.get(n)) for n in names]


def _index_rows(op: str, indices, k: int) -> list[int]:
    """index_put's indices: one integer tensor constant (0-d or 1-D) on the
    state axis, without repeats, as row positions of a block of k rows."""
    if not isinstance(indices, (tuple, list)) or len(indices) != 1:
        raise ValueError(f"`{op}` with the indices {indices!r}: the generated kernel takes one "
                         "integer tensor on the state axis")
    index = indices[0]
    if isinstance(index, _Constant):
        t = index.tensor
    elif isinstance(index, _Tensor0) and float(index).is_integer():
        t = torch.tensor(int(index))
    else:
        raise ValueError(f"`{op}` with the index {index!r}: the generated kernel takes an "
                         "integer tensor constant")
    if t.dtype in (torch.bool, torch.uint8) or t.is_floating_point() or t.is_complex() \
            or t.dim() > 1:
        raise ValueError(f"`{op}` with a {t.dtype} index of shape {tuple(t.shape)}: the "
                         "generated kernel takes an integer tensor of row positions")
    rows = [int(i) for i in t.reshape(-1).tolist()]
    if any(not -k <= i < k for i in rows):
        raise ValueError(f"`{op}` with the rows {rows}, out of range of a block of {k} rows")
    rows = [i % k for i in rows]
    if len(set(rows)) != len(rows):
        raise ValueError(f"`{op}` with a repeated row in {rows}: torch leaves which write wins "
                         "undefined")
    return rows


def _scatter(op: str, em: _Emitter, args: list, kwargs: dict):
    """select_scatter, slice_scatter and index_put (out of place) on the
    state axis of a block: a new block, the input's rows but those written."""
    if op == "select_scatter":
        base, src, dim, index = _take(op, args, kwargs, ("input", "src", "dim", "index"))
        base = _block(op, base, "input")
        _dim0(op, dim)
        _getitem(base, index)  # an integer in range
        rows = list(base.rows)
        rows[index % len(rows)] = em.row(op, src, "source")
        return _Block(tuple(rows))
    if op == "slice_scatter":
        base, src, dim, start, end, step = _take(
            op, args, kwargs, ("input", "src", "dim", "start", "end", "step"),
            {"dim": 0, "start": None, "end": None, "step": 1})
        base, src = _block(op, base, "input"), _block(op, src, "source")
        _dim0(op, dim)
        positions = list(range(len(base.rows)))[slice(start, end, step)]
        if step is None or step < 1 or len(positions) != len(src.rows):
            raise ValueError(f"`{op}` of {len(src.rows)} rows into the slice {start}:{end}:"
                             f"{step} of a block of {len(base.rows)} rows")
        rows = list(base.rows)
        for p, r in zip(positions, src.rows):
            rows[p] = r
        return _Block(tuple(rows))
    base, indices, values, accumulate = _take(op, args, kwargs,
                                              ("input", "indices", "values", "accumulate"),
                                              {"accumulate": False})
    base = _block(op, base, "input")
    if accumulate is not False:
        raise ValueError(f"`{op}` with accumulate: the generated kernel writes rows")
    positions = _index_rows(op, indices, len(base.rows))
    if _is_number(values):
        raise ValueError(f"`{op}` with a Python number: torch takes a tensor of values")
    if isinstance(values, _Block):
        if len(values.rows) not in (1, len(positions)):
            raise ValueError(f"`{op}` of {len(values.rows)} rows into {len(positions)}")
        src = [values.rows[i if len(values.rows) > 1 else 0] for i in range(len(positions))]
    else:
        src = [em.row(op, values, "values")] * len(positions)
    rows = list(base.rows)
    for p, r in zip(positions, src):
        rows[p] = r
    return _Block(tuple(rows))


def _node_value(op: str, em: _Emitter, args: list, kwargs: dict):
    """The value of one traced operation of the table."""
    if op in ("add", "sub") and kwargs.pop("alpha", 1) != 1:
        raise ValueError(f"`{op}` with alpha: the generated kernel takes alpha = 1")
    if op == "getitem":
        return _getitem(*args)
    if op == "stack":
        tensors, dim = _take(op, args, kwargs, ("tensors", "dim"), {"dim": 0})
        if not isinstance(tensors, list) or not tensors:
            raise ValueError("`stack` other than of a list of rows")
        if any(isinstance(t, _Block) for t in tensors):
            raise ValueError("`stack` of a block: it would add an axis; the generated kernel "
                             "stacks rows (torch.cat joins blocks)")
        _dim0(op, dim, rank=2)
        return _Block(tuple(em.row("stack", r, mask=getattr(r, "mask", False))
                            for r in tensors))
    if op == "cat":
        tensors, dim = _take(op, args, kwargs, ("tensors", "dim"), {"dim": 0})
        if not isinstance(tensors, list) or not tensors:
            raise ValueError("`cat` other than of a list of blocks")
        blocks = [_block(op, t) for t in tensors]
        _dim0(op, dim)
        return _Block(tuple(r for b in blocks for r in b.rows))
    if op in _REDUCE:
        names = ("input", "dim", "keepdim")
        value, dim, keepdim = _take(op, args, kwargs, names, {"dim": None, "keepdim": False})
        if dim is None:
            raise ValueError(f"`{op}` over every dim: it would reduce over the candidates "
                             "too; the generated kernel takes dim 0, the state axis")
        block = _block(op, value)
        _dim0(op, dim)
        row = em.reduce(op, block)
        return _Block((row,)) if keepdim else row
    if op in ("select_scatter", "slice_scatter", "index_put"):
        return _scatter(op, em, args, kwargs)
    if op == "clamp":
        value, lo, hi = _take(op, args, kwargs, ("input", "min", "max"),
                              {"min": None, "max": None})
        return _lift(op, lambda v, a, b: em.clamp(v, a, b), value, lo, hi)
    if op == "where":
        cond, a, b = _take(op, args, kwargs, ("condition", "input", "other"))
        return _lift(op, em.where, cond, a, b)
    if op in ("zeros_like", "ones_like", "full_like"):
        names = ("input", "fill_value") if op == "full_like" else ("input",)
        got = _take(op, args, kwargs, names)
        if op == "full_like" and not _is_number(got[1]):
            raise ValueError("`full_like` with a fill other than a Python number")
        fill = {"zeros_like": 0.0, "ones_like": 1.0}.get(op, got[-1])
        return _lift(op, lambda r: (em.row(op, r), em.const(fill))[1], got[0])
    if op == "div" and kwargs.get("rounding_mode") is not None:
        mode = kwargs.pop("rounding_mode")
        if mode not in ("floor", "trunc"):
            raise ValueError(f"`div` with rounding_mode {mode!r}")
        a, b = _take(op, args, kwargs, ("input", "other"))
        return _lift(op, lambda p, q: em.rounded_div(mode, p, q), a, b)
    kwargs.pop("rounding_mode", None)
    if op == "floor_divide":
        a, b = _take(op, args, kwargs, ("input", "other"))
        return _lift(op, lambda p, q: em.rounded_div("floor", p, q), a, b)
    if op in ("and", "or", "not"):
        names = ("input",) if op == "not" else ("input", "other")
        return _lift(op, lambda *r: em.logical(op, *r), *_take(op, args, kwargs, names))
    if op == "pow":
        return _lift(op, em.pow, *_take(op, args, kwargs, ("input", "exponent")))
    if op in _UNARY or op == "neg":
        return _lift(op, lambda r: em.unary(op, r), *_take(op, args, kwargs, ("input",)))
    return _lift(op, lambda p, q: em.binary(op, p, q),
                 *_take(op, args, kwargs, ("input", "other")))


def emit_step(step_cols: Callable, d: int, m: int) -> GeneratedStep:
    """Trace step_cols(x (d, A), u (m, A)) -> (d, A) and emit it as the C++
    `rollout_step`. Raises ValueError, naming the operation, for a step the
    generated kernel does not take, and for d or m outside 1..MAX_DIM."""
    for name, dim in (("d", d), ("m", m)):
        if isinstance(dim, bool) or not isinstance(dim, int) or not 1 <= dim <= MAX_DIM:
            raise ValueError(f"{name}={dim}: the generated rollout takes state and control "
                             f"dims 1..{MAX_DIM} (the JAX contract: one sublane tile)")
    module = trace_step(step_cols)
    em = _Emitter(d, m)
    env = {}
    result = None
    inputs = {"x": _Block(tuple(_Row(f"x[{i}]", tuple(0 if j == i else -1 for j in range(d)))
                                for i in range(d)), "x"),
              "u": _Block(tuple(_Row(f"u[{j}]", em.none()) for j in range(m)), "u")}

    def value(arg, scalars=True):
        if isinstance(arg, torch.fx.Node):
            return em.scalar(env[arg]) if scalars else env[arg]
        if isinstance(arg, (list, tuple)):
            return [value(a, scalars) for a in arg]
        return arg

    placeholders = iter(("x", "u"))
    for node in module.graph.nodes:
        if node.op == "placeholder":
            env[node] = inputs[next(placeholders)]
            continue
        if node.op == "get_attr":
            env[node] = _Constant(str(node.target), getattr(module, str(node.target)))
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
        scalars = op != "index_put"  # its indices stay tensors
        args = [value(a, scalars) for a in node.args]
        kwargs = {k: value(v, scalars) for k, v in node.kwargs.items()}
        env[node] = _node_value(op, em, args, kwargs)

    if not isinstance(result, _Block):
        raise ValueError("the rollout step must return a (d, A) block of its d rows "
                         f"(torch.stack of rows, torch.cat of blocks), got {result!r}")
    rows = result.rows
    if len(rows) != d:
        raise ValueError(f"the rollout step returns {len(rows)} rows, d = {d}")
    if any(r.mask for r in rows):
        raise ValueError("the rollout step returns a mask (a comparison) as a state row: the "
                         "generated kernel's states are floats")
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
