#!/usr/bin/env python3
"""Which order and which paths ATen's CUDA float32 kernels take, for the
generated rollout's emitter (ilqr_admm_tpu_torch/ops/rollout_codegen.py)
to write each op as the card computes it.

On one CUDA card, with numpy float32 (exact IEEE sums, products and
comparisons) as the reference: for sum, prod, amax and amin over dim 0 of
a (k, C) block, k = 1..8, C = 1, 2, 3, 50, 128, 3,200 and 32,768 (the
widest fleet's F * A), contiguous or with the candidates not its fastest
axis, which fold order ATen's result matches bit for bit (`fold`: element i into accumulator i % 4 from the
identity, the four combined in order, as `ro_fold`; `lanes`: the
reduction split over a warp's lanes; `seq`: one accumulator, from the
identity or from the first element), and for amax / amin which functor
(`nanfunctor`: ATen's MaxNanFunctor / MinNanFunctor, or `std::max`).
Specials (±0, NaN, ±inf, subnormals, the largest finite) are mixed in.
Then whether a 0-d CPU tensor exponent takes `pow`'s scalar special cases
or `powf`, a number base `powf`, floor division by a number the
reciprocal path with or without FMA contraction, `sign` of NaN and -0.0,
`round` of halves, and whether `where` and `clamp` take 0-d CPU tensors
beside CUDA ones.

Run from the repository root on the card: python3 tools/aten_fold_probe.py
(~1 min). It prints one line a case; nothing is gated."""
import subprocess
import sys

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("tools/aten_fold_probe.py needs a CUDA card")
print(sys.version.split()[0], torch.__version__, torch.version.cuda)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
dev = "cuda"
f32 = np.float32
rng = np.random.default_rng(0)


def values(shape):
    v = rng.normal(size=shape).astype(f32) * f32(10.0) ** rng.integers(-3, 4, shape).astype(f32)
    flat = v.reshape(-1)
    sp = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45, 3e38, -3e38], f32)
    idx = rng.integers(0, flat.size, flat.size // 5)
    flat[idx] = sp[rng.integers(0, sp.size, idx.size)]
    return v


def fold(v, op, ident):
    """ATen thread_reduce: element i into acc i % 4 from ident, combined in order."""
    k = v.shape[0]
    acc = [np.full(v.shape[1:], ident, f32) for _ in range(4)]
    for i in range(k):
        acc[i % 4] = op(acc[i % 4], v[i])
    return op(op(op(acc[0], acc[1]), acc[2]), acc[3])


def lanes(v, op, ident):
    """the reduction split over lanes of a warp (block.x over the reduced dim)"""
    k = v.shape[0]
    bw = 1
    while bw * 2 <= k:
        bw *= 2
    lane = []
    for l in range(bw):
        acc = [np.full(v.shape[1:], ident, f32) for _ in range(4)]
        els = list(range(l, k, bw))
        for j, e in enumerate(els):
            acc[j % 4] = op(acc[j % 4], v[e])
        lane.append(op(op(op(acc[0], acc[1]), acc[2]), acc[3]))
    off = 1
    while off < bw:
        lane = [op(lane[i], lane[i + off]) if i + off < bw else lane[i] for i in range(bw)]
        off *= 2
    return lane[0]


def seq(v, op, ident):
    acc = np.full(v.shape[1:], ident, f32)
    for i in range(v.shape[0]):
        acc = op(acc, v[i])
    return acc


def seq_noident(v, op, ident):
    acc = v[0].copy()
    for i in range(1, v.shape[0]):
        acc = op(acc, v[i])
    return acc


def add(a, b):
    return (a + b).astype(f32)


def mul(a, b):
    return (a * b).astype(f32)


def amax_nan(a, b):
    return np.where(np.isnan(a) | (a > b), a, b).astype(f32)


def amin_nan(a, b):
    return np.where(np.isnan(a) | (a < b), a, b).astype(f32)


def amax_std(a, b):  # isnan(b) ? b : std::max(a, b)
    return np.where(np.isnan(b), b, np.where(a < b, b, a)).astype(f32)


def amin_std(a, b):
    return np.where(np.isnan(b), b, np.where(b < a, b, a)).astype(f32)


def same(got, want):
    g, w = got.view(np.int32), want.view(np.int32)
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan) and np.array_equal(g[~nan], w[~nan]))


REDS = {
    "sum": (lambda t: t.sum(dim=0), {"fold": (add, 0.0)}),
    "prod": (lambda t: t.prod(dim=0), {"fold": (mul, 1.0)}),
    "amax": (lambda t: t.amax(dim=0), {"fold nanfunctor": (amax_nan, -np.inf),
                                         "fold std::max": (amax_std, -np.inf)}),
    "amin": (lambda t: t.amin(dim=0), {"fold nanfunctor": (amin_nan, np.inf),
                                         "fold std::min": (amin_std, np.inf)}),
}
for name, (fn, variants) in REDS.items():
    for layout in ("contiguous", "transposed"):
        for C in (1, 2, 3, 50, 128, 3200, 32768):
            row = []
            for k in range(1, 9):
                v = values((k, C))
                if name == "prod":
                    v = np.clip(v, -3, 3).astype(f32)
                t = torch.tensor(v, device=dev)
                if layout == "transposed":
                    t = torch.tensor(np.ascontiguousarray(v.T), device=dev).T
                got = fn(t).cpu().numpy()
                hits = []
                for vn, (op, ident) in variants.items():
                    for how, g in (("", fold), (" lanes", lanes), (" seq", seq), (" seq0", seq_noident)):
                        if same(got, g(v, op, f32(ident))):
                            hits.append(vn + how)
                row.append(f"k={k}:{'|'.join(hits) or 'NONE'}")
            print(f"[reduce] {name} {layout} C={C}: " + "; ".join(row))

# -0.0 sums
z = torch.tensor([[-0.0, -0.0], [-0.0, -0.0]], device=dev)
print("[reduce] sum of -0.0 rows:", z.sum(dim=0).cpu().numpy(), torch.tensor([-0.0], device=dev).sum().item(),
      z[:1].sum(dim=0).cpu().numpy(), z[:1].sum(dim=0, keepdim=True).cpu().numpy())

# pow with a 0-d CPU tensor exponent on a CUDA tensor: the scalar special cases or powf?
x = torch.tensor(values((65536,)), device=dev)
for e in (2.0, 0.5, 3.0, -1.0, 2.5):
    t = x ** torch.tensor(e)
    num = x ** e
    gen = x ** torch.full_like(x, e)
    print(f"[pow] exponent tensor({e}): == number path {same(t.cpu().numpy(), num.cpu().numpy())}; "
          f"== tensor-tensor powf {same(t.cpu().numpy(), gen.cpu().numpy())}; number path == powf "
          f"{same(num.cpu().numpy(), gen.cpu().numpy())}")
for b in (2.0, 0.5):
    t = b ** x
    gen = torch.full_like(x, b) ** x
    t2 = torch.tensor(b) ** x
    print(f"[pow] base {b}: number == powf {same(t.cpu().numpy(), gen.cpu().numpy())}; tensor({b}) == powf "
          f"{same(t2.cpu().numpy(), gen.cpu().numpy())}")
print("[pow] 1.0 ** nan:", (1.0 ** torch.tensor([float('nan')], device=dev)).item())

# floor division by a number: reciprocal path with or without FMA contraction
xv = values((65536,))
for b in (0.3, -1.7, 2.0, 1e-3, 7.0):
    got = (torch.tensor(xv, device=dev) // b).cpu().numpy()
    bf = f32(b)
    inv = f32(f32(1.0) / bf)
    with np.errstate(all="ignore"):
        mod = np.fmod(xv, bf).astype(f32)
        t = (xv - mod).astype(f32)
        res = {}
        for contract in (False, True):
            div = (t * inv).astype(f32)
            fix = (mod != 0) & ((bf < 0) != (mod < 0))
            if contract:
                divm1 = (t.astype(np.float64) * np.float64(inv) - 1.0).astype(f32)
            else:
                divm1 = (div - f32(1)).astype(f32)
            d = np.where(fix, divm1, div).astype(f32)
            fl = np.floor(d).astype(f32)
            if contract:
                diff = np.where(fix, (d - fl).astype(f32), (t.astype(np.float64) * np.float64(inv) - fl).astype(f32))
            else:
                diff = (d - fl).astype(f32)
            fl = np.where(diff > f32(0.5), (fl + f32(1)).astype(f32), fl).astype(f32)
            zero = np.copysign(f32(0), (xv * inv).astype(f32)).astype(f32)
            res[contract] = np.where(d != 0, fl, zero).astype(f32)
        true_div = np.floor_divide(xv, bf)
    print(f"[floordiv] x // {b}: plain ops {same(got, res[False])}, contracted {same(got, res[True])}, "
          f"numpy {same(got, true_div.astype(f32))}")

# sign, round, the where with a 0-d CPU tensor
s = torch.tensor([float('nan'), -0.0, 0.0, -2.0, 3.0], device=dev)
print("[sign]", torch.sign(s).cpu().numpy(), np.signbit(torch.sign(s).cpu().numpy()))
print("[round]", torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5], device=dev)).cpu().numpy())
try:
    w = torch.where(s > 0, torch.tensor(2.0), s)
    print("[where] 0-d CPU tensor operand:", w.cpu().numpy())
except Exception as exc:
    print("[where] 0-d CPU tensor operand raises:", type(exc).__name__, exc)
try:
    c = torch.clamp(s, torch.tensor(-1.0), torch.tensor(1.0))
    print("[clamp] 0-d CPU tensor bounds:", c.cpu().numpy())
except Exception as exc:
    print("[clamp] 0-d CPU tensor bounds raise:", type(exc).__name__, exc)
