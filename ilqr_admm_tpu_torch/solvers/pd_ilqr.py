"""Primal-dual (multiple-shooting) iLQR (counterpart of
`ilqr_admm_tpu/solvers/pd_ilqr.py`).

Both the state path x and the controls u are decision variables; the
dynamics hold through defects d_t = f(x_t, u_t) - x_{t+1}, driven to zero
over the iterations. So a solve can start from any state path (a straight
line to the goal, no controls known), and the backward pass gives the
costates lambda_t = v_t + V_t dx_t.

An iteration: linearize and expand the cost at (x, u); a backward Riccati
sweep with the defects in its linear terms; for each line-search alpha a
forward linear sweep du_t = alpha k_t + K_t dx_t, dx_{t+1} = A_t dx_t +
B_t du_t + alpha d_t (vmapped over the alphas); accept the candidate of
least merit cost + mu ||defects||_1. The JAX package's scans are Python
loops here, its `cho_factor` / `cho_solve` a `cholesky_ex` and two
triangular solves (no host read, as `ops/riccati.py::ilqr_backward`).
`pd_ilqr_solve` reads one status an iteration on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.riccati import _cho_solve, _cholesky, _sym
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers.admm import read_status
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class PDILQRState(NamedTuple):
    x_nom: torch.Tensor  # (N, d) state decision variables (defects allowed)
    u_nom: torch.Tensor  # (N, m)
    lam: torch.Tensor  # (N, d) costates (lambda_t at stage t)
    cost: torch.Tensor  # true cost (ignores defects)
    defect: torch.Tensor  # max |d_t|
    merit: torch.Tensor  # cost + mu * ||defects||_1 at this iterate
    prev_merit: torch.Tensor
    iteration: int
    status: int  # SolveStatus


def _defects(f, xs, us):
    """d_t = f(x_t, u_t) - x_{t+1} for t = 0..N-2: (N-1, d)."""
    return vmap(f)(xs[:-1], us[:-1]) - xs[1:]


def pd_ilqr_init(cost_fn: Callable, f: Callable, x_init, u_init, mu: float = 10.0, *,
                 device=None) -> PDILQRState:
    """Start from an arbitrary state path and control guess. x_init need
    not satisfy the dynamics; x_init[0] must be the true initial state
    (it is held fixed). device: where the solve runs (default the CUDA
    card)."""
    device = resolve_device(device)
    xs = torch.as_tensor(x_init, device=device)
    us = torch.as_tensor(u_init, device=device)
    c = cost_fn(xs, us)
    d = _defects(f, xs, us)
    return PDILQRState(x_nom=xs, u_nom=us, lam=torch.zeros_like(xs), cost=c,
                       defect=torch.amax(torch.abs(d)), merit=c + mu * torch.sum(torch.abs(d)),
                       prev_merit=torch.full_like(c, math.inf), iteration=0,
                       status=int(SolveStatus.RUNNING))


@full_f32_matmul()
def pd_ilqr_iterate(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                    state: PDILQRState, alphas, mu: float = 10.0):
    """One primal-dual iteration. Returns (new_state, accept, (K, k))."""
    xs, us = state.x_nom, state.u_nom
    N, d = xs.shape
    m = us.shape[-1]
    A, B = get_AB(xs, us)
    cts, Cts = get_Cs(xs, us)
    cx, cu = cts[:, :d], cts[:, d:]
    Cxx, Cuu, Cux = Cts[:, :d, :d], Cts[:, d:, d:], Cts[:, d:, :d]
    defects = _defects(f, xs, us)  # (N-1, d)
    eye = 1e-9 * torch.eye(m, dtype=xs.dtype, device=xs.device)

    # backward sweep with defects, from t = N-2 down to 0
    V, v = Cxx[-1], cx[-1]
    Ks, ks, Vs, vs = [], [], [], []
    for t in range(N - 2, -1, -1):
        At, Bt = A[t], B[t]
        # the value expansion propagated through x_{t+1} = A dx + B du + d
        vb = v + V @ defects[t]
        qx = cx[t] + At.T @ vb
        qu = cu[t] + Bt.T @ vb
        Qxx = Cxx[t] + At.T @ V @ At
        Quu = Cuu[t] + Bt.T @ V @ Bt
        Qux = Cux[t] + Bt.T @ V @ At
        sol = -_cho_solve(_cholesky(_sym(Quu) + eye), torch.cat([Qux, qu[:, None]], dim=-1))
        Kt, kt = sol[:, :-1], sol[:, -1]
        Ks.append(Kt)
        ks.append(kt)
        Vs.append(V)
        vs.append(v)
        V = _sym(Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt)
        v = qx + Qux.T @ kt + Kt.T @ qu + Kt.T @ Quu @ kt
    V0, v0 = V, v
    K, k = torch.stack(Ks[::-1]), torch.stack(ks[::-1])
    V_next, v_next = torch.stack(Vs[::-1]), torch.stack(vs[::-1])

    def sweep(alpha):
        dx = torch.zeros((d,), dtype=xs.dtype, device=xs.device)
        dxs, dus = [], []
        for t in range(N - 1):
            du = alpha * k[t] + K[t] @ dx
            dxs.append(dx)
            dus.append(du)
            dx = A[t] @ dx + B[t] @ du + alpha * defects[t]
        # u_{N-1} unused by convention (final-step gains zero)
        x_c = xs + torch.stack(dxs + [dx])
        u_c = us + torch.stack(dus + [torch.zeros((m,), dtype=xs.dtype, device=xs.device)])
        c = cost_fn(x_c, u_c)
        d_c = _defects(f, x_c, u_c)
        merit = c + mu * torch.sum(torch.abs(d_c))
        merit = torch.where(torch.isnan(merit), torch.full_like(merit, math.inf), merit)
        return x_c, u_c, merit, c, torch.amax(torch.abs(d_c))

    xs_c, us_c, merits, costs, dmaxs = vmap(sweep)(alphas)
    ind = torch.argmin(merits).reshape(1)
    best = torch.index_select(merits, 0, ind)[0]
    accept = best < state.merit

    def pick(cands, old):
        return torch.where(accept, torch.index_select(cands, 0, ind)[0], old)

    x_new, u_new = pick(xs_c, xs), pick(us_c, us)
    # costates at the accepted iterate: lambda_t = v_t + V_t dx_t, with
    # V_next[t] = V_{t+1}, v_next[t] = v_{t+1} and lambda_0 from (V0, v0)
    dx_acc = x_new - xs
    lam_tail = v_next + torch.einsum("tij,tj->ti", V_next, dx_acc[1:])
    lam = torch.cat([(v0 + V0 @ dx_acc[0])[None], lam_tail], dim=0)
    new_state = PDILQRState(
        x_nom=x_new, u_nom=u_new, lam=lam, cost=pick(costs, state.cost),
        defect=pick(dmaxs, state.defect), merit=torch.where(accept, best, state.merit),
        prev_merit=state.merit, iteration=state.iteration + 1, status=state.status)
    return new_state, accept, (K, k)


def pd_ilqr_solve(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                  state0: PDILQRState, cfg: ILQRConfig = ILQRConfig(), mu: float = 10.0,
                  tol_defect: float = 1e-6) -> PDILQRState:
    """Full primal-dual iLQR solve on the device of state0.

    CONVERGED when the merit moved by less than tol_fun and the max defect
    is below tol_defect (an infeasible iterate with a flat merit is not
    converged); a rejected step on a feasible iterate is
    LINE_SEARCH_FAILED, on an infeasible one the solve keeps iterating
    (to max_iter).
    """
    alphas = line_search_alphas(cfg, state0.x_nom.dtype, state0.x_nom.device)
    state = state0
    while state.iteration < cfg.max_iter and state.status == SolveStatus.RUNNING:
        new, accept, _ = pd_ilqr_iterate(f, get_AB, get_Cs, cost_fn, state, alphas, mu=mu)
        small_step = torch.abs(new.prev_merit - new.merit) < cfg.tol_fun
        feasible = new.defect < tol_defect
        status = torch.where(
            ~accept,
            torch.where(feasible, int(SolveStatus.LINE_SEARCH_FAILED), int(SolveStatus.RUNNING)),
            torch.where(small_step & feasible, int(SolveStatus.CONVERGED),
                        int(SolveStatus.RUNNING)))
        state = new._replace(status=read_status(status))
    if state.status == SolveStatus.RUNNING:
        state = state._replace(status=int(SolveStatus.MAX_ITER))
    return state
