"""Reference-compatible object facade over the functional core
(counterpart of `ilqr_admm_tpu/facade.py`).

`SLS` and `iSLS` keep the JAX package's classes, methods and keyword
spellings (the reference library's API: `set_cost_variables` is
`set_quadratic_cost`, `solve_ilqr(...)` is `solve(...)`, and both
`tol=`/`threshold=` spellings are accepted); every method delegates to
the port's solvers.

Conventions: trajectories are (N, dim); lifted vectors are flattened
row-major; a user `forward_model(x, u)` maps one state/control pair to
the next state (torch); a user `cost_function(xs, us)` maps one
trajectory to a scalar (the solvers vmap it).

Each object lives on one device: the CUDA card unless the constructor is
given another (`device="cpu"` runs everything on the host), and raises
without a card. The working dtype is `torch.get_default_dtype()`, read
at each call as the JAX facade reads its x64 flag
(`utils.precision.use_x64()` makes it float64).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sw
from ilqr_admm_tpu_torch.ops.riccati import DPGains, lqt_backward_ff, quad_cost_model
from ilqr_admm_tpu_torch.ops.rollout import (
    rollout_closed_loop,
    rollout_nonlinear,
    rollout_sls_delta,
)
from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig, broadcast_AB
from ilqr_admm_tpu_torch.solvers.al_ilqr import al_ilqr_solve
from ilqr_admm_tpu_torch.solvers.barrier_ilqr import barrier_ilqr_solve
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_init, boxddp_solve
from ilqr_admm_tpu_torch.solvers.ilqr import (
    ILQRState,
    ilqr_iterate_batch,
    ilqr_iterate_dp,
    ilqr_iterate_sls,
)
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm as _ilqr_admm
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm as _isls_admm
from ilqr_admm_tpu_torch.solvers.lqt import (
    broadcast_rho,
    lqt_solve_batch,
    lqt_solve_dp,
    lqt_solve_sls,
    replan_feedforward,
    replanning_matrix,
    sls_controller,
)
from ilqr_admm_tpu_torch.solvers.lqt_admm import lqt_admm_batch, lqt_admm_dp
from ilqr_admm_tpu_torch.solvers.sls_admm import sls_admm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import highest_precision, stiffness_ratio


def _dtype() -> torch.dtype:
    return torch.get_default_dtype()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Base:
    """Shared state: dims, device, stacked dynamics, quadratic cost."""

    def __init__(self, x_dim: int, u_dim: int, N: int, *, device=None):
        self.x_dim = x_dim
        self.u_dim = u_dim
        self.N = N
        self.device = resolve_device(device)
        self.A = None  # (N, x, x) stacked
        self.B = None  # (N, x, u)
        self.quad_cost = None  # QuadCost
        self._Su = None
        self._Sw = None
        self._stiffness = None  # cached stiffness_ratio of quad_cost

    def _t(self, x):
        """x as a tensor of the working dtype on this object's device (None stays)."""
        return None if x is None else torch.as_tensor(x, dtype=_dtype(), device=self.device)

    # -- dynamics ----------------------------------------------------------
    @property
    def AB(self):
        return [self.A, self.B]

    @AB.setter
    def AB(self, value):
        A, B = broadcast_AB(self._t(value[0]), self._t(value[1]), self.N)
        self.A, self.B = A.contiguous(), B.contiguous()
        self._Su = None
        self._Sw = None

    @property
    def Su(self):
        """Dense lifted input-response operator (N*x, N*u)."""
        if self._Su is None:
            self._Su = build_Su(self.A, self.B)
        return self._Su

    @property
    def Sw(self):
        """Dense lifted noise/initial-state response operator (N*x, N*x)."""
        if self._Sw is None:
            self._Sw = build_Sw(self.A)
        return self._Sw

    # -- cost --------------------------------------------------------------
    def set_quadratic_cost(self, zs, Qs, seq, u_std):
        """Via-point quadratic cost: Q_t = Qs[seq[t]], xd_t = zs[seq[t]],
        R_t = u_std I. Warns when the weight ratio is past what float32
        can hold."""
        self.zs = self._t(zs)
        self.Qs = self._t(Qs)
        self.seq = np.asarray(seq)
        self.Rt = torch.eye(self.u_dim, dtype=_dtype(), device=self.device) * u_std
        self.quad_cost = viapoint_cost(self.zs, self.Qs, self.seq, u_std, self.u_dim)
        self._stiffness = stiffness_ratio(self.quad_cost.Q, self.quad_cost.R)
        if _dtype() != torch.float64 and self._stiffness > 1e7:
            warnings.warn(
                f"cost weight ratio {self._stiffness:.1e} exceeds float32 capability "
                "(~1e7); enable float64 "
                "(ilqr_admm_tpu_torch.utils.precision.use_x64()) or rescale the "
                "weights, or solvers may fail to improve / NaN.",
                stacklevel=2,
            )

    # the reference notebooks' older name
    set_cost_variables = set_quadratic_cost

    def _auto_use_qr(self) -> bool:
        """The square-root (QR) x-update for a stiff cost under float32."""
        if self._stiffness is None:
            self._stiffness = stiffness_ratio(self.quad_cost.Q, self.quad_cost.R)
        return _dtype() != torch.float64 and self._stiffness > 1e5

    @property
    def Q(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_Q()

    @property
    def R(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_R()

    @property
    def xd(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_xd()

    def compute_Rr_Qr(self, rho_x, rho_u, dp: bool = True):
        """ADMM penalties broadcast to stacked (N, d, d) blocks."""
        del dp  # the stacked form is canonical here
        return (
            broadcast_rho(rho_x, self.x_dim, self.N, _dtype(), self.device),
            broadcast_rho(rho_u, self.u_dim, self.N, _dtype(), self.device),
        )

    @highest_precision
    def compute_cost(self, x, u=None, cost_function=None):
        """Quadratic cost of (batched) lifted or stacked trajectories:
        x (N*d,), (N, d), (batch, N*d) or (batch, N, d), optional u alike."""
        if cost_function is not None:
            return cost_function(x=x, u=u)
        dtype = _dtype() if self.quad_cost is None else self.quad_cost.Q.dtype

        def as_stacked(arr, dim, name):
            # stacked if the trailing two dims are exactly (N, dim); lifted
            # if the last dim is exactly N*dim (also right for N = 1)
            arr = torch.as_tensor(arr, dtype=dtype, device=self.device)
            if arr.ndim >= 2 and tuple(arr.shape[-2:]) == (self.N, dim):
                return arr
            if arr.shape[-1] == self.N * dim:
                return arr.reshape(arr.shape[:-1] + (self.N, dim))
            raise ValueError(
                f"{name} must be stacked (..., {self.N}, {dim}) or lifted "
                f"(..., {self.N * dim}); got shape {tuple(arr.shape)}"
            )

        xs = as_stacked(x, self.x_dim, "x")
        dx = xs - self.quad_cost.xd
        c = torch.einsum("...ti,tij,...tj->...", dx, self.quad_cost.Q, dx)
        if u is not None:
            us = as_stacked(u, self.u_dim, "u")
            c = c + torch.einsum("...ti,tij,...tj->...", us, self.quad_cost.R, us)
        return c

    def _noise(self, shape, noise_scale, rng):
        """Process noise drawn by the numpy generator (the same draws as the
        JAX facade's), then moved to the device; None without noise."""
        if noise_scale == 0:
            return None
        rng = np.random.default_rng() if rng is None else rng
        return self._t(rng.normal(0.0, noise_scale, shape))

    def _batchify_x0(self, x0):
        x0 = self._t(x0)
        single = x0.ndim == 1
        return (x0[None] if single else x0), single


class SLS(_Base):
    """Linear LQT / SLS solver facade.

    Methods: `solve` (batch / dp / sls), `ADMM_LQT_Batch`, `ADMM_LQT_DP`,
    `ADMM_SLS`, `controller`, rollout simulators, replanning.
    """

    def __init__(self, x_dim: int, u_dim: int, N: int, *, device=None):
        super().__init__(x_dim, u_dim, N, device=device)
        self.PHI_U = None
        self.du = None

    # ------------------------------------------------------------- solves
    def solve(self, x0=None, method: str = "sls"):
        if method == "batch":
            assert x0 is not None, "x0 required for the batch method"
            return self.solve_batch(x0)
        if method == "dp":
            return self.solve_dp()
        if method == "sls":
            return self.solve_sls()
        raise ValueError(f"unknown method {method!r}")

    def solve_batch(self, x0, use_qr=None):
        if use_qr is None:
            use_qr = self._auto_use_qr()
        return lqt_solve_batch(self.A, self.B, self.quad_cost, self._t(x0), use_qr=use_qr)

    def solve_dp(
        self, Qr=None, Rr=None, ur=None, xr=None, return_Qs: bool = False,
        time_parallel=None, fast_inverse: bool = False,
    ):
        """time_parallel: None = sequential recursion; 'flat' = associative
        scan; int L = blocked suffix scan (long horizons); fast_inverse:
        closed-form combine inverses (state dim <= 4) on the time-parallel
        paths (see `solvers/lqt.py::lqt_solve_dp`)."""
        gains = lqt_solve_dp(
            self.A, self.B, self.quad_cost, Qr=self._t(Qr), xr=self._t(xr), Rr=self._t(Rr),
            ur=self._t(ur), time_parallel=time_parallel, fast_inverse=fast_inverse,
        )
        if return_Qs:
            return gains.K, gains.k, gains.Quu, gains.Quu_inv, gains.Qux
        return gains.K, gains.k

    def solve_dp_ff(self, K, Quu, Qux, Quu_inv, Qr=None, Rr=None, ur=None, xr=None):
        """Feedforward-only re-sweep with cached DP blocks. Returns k (N, u_dim)."""
        gains = DPGains(
            K=self._t(K), k=torch.zeros((self.N, self.u_dim), dtype=_dtype(), device=self.device),
            Quu=self._t(Quu), Quu_inv=self._t(Quu_inv), Qux=self._t(Qux),
        )
        xr_ = None if xr is None else self._t(xr).reshape(self.N, self.x_dim)
        ur_ = None if ur is None else self._t(ur).reshape(self.N, self.u_dim)
        return lqt_backward_ff(
            gains, self.A, self.B, self.quad_cost.Q, self.quad_cost.xd,
            Qr=self._t(Qr), xr=xr_, Rr=self._t(Rr), ur=ur_,
        )

    def solve_sls(self, verbose: bool = False):
        del verbose
        PHI_U, du = lqt_solve_sls(self.A, self.B, self.quad_cost)
        self.PHI_U, self.du = PHI_U, du
        return PHI_U, du

    def controller(self, PHI_U, du):
        return sls_controller(self.A, self.B, self._t(PHI_U), self._t(du))

    def initialize_replanning_procedure(self, K):
        self.replan_matrix = replanning_matrix(self.A, self.B, self.quad_cost, self._t(K))

    def replan_feedforward(self, k, xd):
        return replan_feedforward(self._t(k), self.replan_matrix, self._t(xd), self.xd)

    # ---------------------------------------------------------- rollouts
    def forward_model(self, x, u):
        """Single-pair linear step with the first step's dynamics."""
        return self.A[0] @ x + self.B[0] @ u

    def u_optimal(self, x0, PHI_U, du):
        return (self._t(PHI_U)[:, : self.x_dim] @ self._t(x0) + self._t(du)).reshape(
            self.N, -1)[:-1]

    def x_optimal(self, x0, PHI_X, dx):
        return (self._t(PHI_X)[:, : self.x_dim] @ self._t(x0) + self._t(dx)).reshape(self.N, -1)

    def _linear_rollouts(self, x0, control, noise_scale, rng):
        """x_{t+1} = A_t x_t + B_t u_t + w_t over a batch of initial states,
        u_t = control(t, x_t, history) on (batch, .) tensors; returns
        (xs (b, N, d), us (b, N, m)), or one instance's for a single x0."""
        x0b, single = self._batchify_x0(x0)
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        x = x0b
        xs, us = [], []
        for t in range(self.N):
            u = control(t, x, xs)
            xs.append(x)
            us.append(u)
            x = x @ self.A[t].T + u @ self.B[t].T
            if ws is not None:
                x = x + ws[:, t]
        xs, us = torch.stack(xs, dim=1), torch.stack(us, dim=1)
        return (xs[0], us[0]) if single else (xs, us)

    @highest_precision
    def get_trajectory_batch(self, x0, us, noise_scale=0, rng=None):
        """Open-loop rollouts of us (N, m) from a batch of initial states."""
        us = self._t(us)
        return self._linear_rollouts(
            x0, lambda t, x, _: us[t].expand(x.shape[0], -1), noise_scale, rng)

    @highest_precision
    def get_trajectory_dp(self, x0, K, k, noise_scale=0, rng=None):
        """Closed-loop per-step-feedback rollouts, u_t = K_t x_t + k_t."""
        K, k = self._t(K), self._t(k)
        return self._linear_rollouts(x0, lambda t, x, _: x @ K[t].T + k[t], noise_scale, rng)

    @highest_precision
    def get_trajectory_sls(self, x0, K, k, noise_scale=0, rng=None):
        """History-feedback rollouts u_t = K[t, 0:t] x_{0:t} + k_t (K lifted
        (N*m, N*d), k (N*m,))."""
        K4 = self._t(K).reshape(self.N, self.u_dim, self.N, self.x_dim)
        k2 = self._t(k).reshape(self.N, self.u_dim)

        def control(t, x, past):
            hist = torch.stack(past + [x], dim=1)  # (b, t+1, d)
            return torch.einsum("unj,bnj->bu", K4[t, :, : t + 1], hist) + k2[t]

        return self._linear_rollouts(x0, control, noise_scale, rng)

    # ------------------------------------------------------------- ADMM
    def _report(self, info, verbose):
        if verbose:
            print(
                f"ADMM status {int(info.status)} after {int(info.iters)} iters; "
                f"residuals {float(info.prim_res):.2e} / {float(info.dual_res):.2e}"
            )

    def ADMM_LQT_Batch(
        self, x0, project_x=None, project_u=None, max_iter=20, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        use_qr=None, anderson_m=0,
    ):
        """Constrained LQT, batch x-update. anderson_m > 0 enables
        safeguarded type-II Anderson acceleration of the consensus
        iteration. Returns (x_flat, u_flat[, logs])."""
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, log=log, anderson_m=anderson_m)
        if use_qr is None:
            use_qr = self._auto_use_qr()
        x, u, info = lqt_admm_batch(
            self.A, self.B, self.quad_cost, self._t(x0), project_x or None, project_u or None,
            rho_x, rho_u, cfg, use_qr=use_qr,
        )
        self._report(info, verbose)
        if log:
            return x, u, _host(info.logs[: int(info.iters)])
        return x, u

    def ADMM_LQT_DP(
        self, x0, project_x=None, project_u=None, max_iter=2000, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        anderson_m=0,
    ):
        """Constrained LQT, DP x-update. Returns (x_flat, u_flat, K, k[, logs])."""
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, log=log, anderson_m=anderson_m)
        x, u, (K, k), info = lqt_admm_dp(
            self.A, self.B, self.quad_cost, self._t(x0), project_x or None, project_u or None,
            rho_x, rho_u, cfg,
        )
        self._report(info, verbose)
        if log:
            return x, u, K, k, _host(info.logs[: int(info.iters)])
        return x, u, K, k

    def ADMM_SLS(
        self, project_x=None, project_u=None, max_iter=5000, rho_x=0.0,
        rho_u=0.0, alpha=1.0, tol=1e-3, verbose=False, log=False,
        robust_dim=None, anderson_m=0,
    ):
        """Robust SLS-ADMM. Returns (du, phi_u[, logs])."""
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, stall_tol=1e-2, log=log,
                         anderson_m=anderson_m)
        du, phi_u, info = sls_admm(
            self.A, self.B, self.quad_cost, project_x or None, project_u or None, rho_x, rho_u,
            robust_dim=robust_dim, cfg=cfg,
        )
        self._report(info, verbose)
        if log:
            return du, phi_u, _host(info.logs[: int(info.iters)])
        return du, phi_u

    def reset(self):
        self.PHI_U = None
        self.du = None


class iSLS(_Base):
    """Nonlinear iLQR / robust iSLS solver facade."""

    def __init__(self, x_dim: int, u_dim: int, N: int, *, device=None):
        super().__init__(x_dim, u_dim, N, device=device)
        self._forward_model = None
        self._cost_function = None
        self.alphas = 10.0 ** np.linspace(0.0, -5.0, 50)
        self.x_nom = None
        self.u_nom = None
        self._cost = None
        self.cost_log = []
        self._K = None
        self._k = None

    # -------------------------------------------------- user plant / cost
    @property
    def forward_model(self):
        return self._forward_model

    @forward_model.setter
    def forward_model(self, fn):
        """fn(x (x_dim,), u (u_dim,)) -> next state, in torch."""
        self._forward_model = fn

    @property
    def cost_function(self):
        if self._cost_function is None:
            return lambda xs, us: self.compute_cost(xs, us)
        return self._cost_function

    @cost_function.setter
    def cost_function(self, fn):
        """fn(xs (N, x_dim), us (N, u_dim)) -> scalar, one trajectory."""
        self._cost_function = fn

    # ------------------------------------------------------ nominal state
    @property
    def nominal_values(self):
        return self.x_nom, self.u_nom

    @nominal_values.setter
    def nominal_values(self, value):
        self.x_nom = self._t(value[0])
        self.u_nom = self._t(value[1])
        self._cost = float(self.cost_function(self.x_nom, self.u_nom))
        self.cost_log.append(self._cost)

    @property
    def cost(self):
        """Scalar cost of the current nominal."""
        return self._cost

    @cost.setter
    def cost(self, value):
        self._cost = value

    @property
    def K(self):
        return self._K

    @property
    def k(self):
        return self._k

    def reset(self):
        self.x_nom = None
        self.u_nom = None
        self._cost = None
        self.cost_log = []
        self._K = None
        self._k = None

    # ------------------------------------------------------------ helpers
    def _get_Cs_or_quad(self, get_Cs):
        if get_Cs is not None:
            return get_Cs
        quad = self.quad_cost
        return lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def _alphas(self, n):
        return self._t(self.alphas[:n])

    def _adopt(self, x_nom, u_nom, cost, get_AB):
        """Take a solve's nominal and cost, and store the linearization at
        it (so controller(), Su and Sw work after a solve)."""
        self.x_nom, self.u_nom = x_nom, u_nom
        self._cost = float(cost)
        self.AB = get_AB(self.x_nom, self.u_nom)

    # ------------------------------------------------------------- solves
    def solve(
        self, get_AB, get_Cs=None, is_dynamics_linear=False, is_cost_quadratic=False,
        method="dp", max_iter=100, max_line_search_iter=25, tol_fun=1e-5,
        tol_grad=1e-4, verbose=False, riccati="chol",
    ):
        """iLQR outer loop on the host, one eager iteration a step, so that
        `cost_log` and the prints follow the reference workflow; method
        'dp', 'batch' or 'sls' (response-map synthesis and a
        history-feedback line search). For a solve that stops on the
        device's statuses use `solvers.ilqr.ilqr_solve`."""
        del is_dynamics_linear, is_cost_quadratic, tol_grad
        iterates = {"dp": ilqr_iterate_dp, "batch": ilqr_iterate_batch, "sls": ilqr_iterate_sls}
        if method not in iterates:
            raise ValueError(f"unknown method {method!r}; expected one of {sorted(iterates)}")
        iterate = iterates[method]
        kw = dict(riccati=riccati) if method == "dp" else {}
        f, cost_fn = self._forward_model, self.cost_function
        get_Cs_fn = self._get_Cs_or_quad(get_Cs)
        alphas = self._alphas(max_line_search_iter)

        state = ILQRState(
            x_nom=self.x_nom, u_nom=self.u_nom, cost=self._t(self._cost),
            prev_cost=self._t(np.inf), iteration=0, status=0,
        )
        aux = None
        for i in range(max_iter):
            state, accept, aux = iterate(f, get_AB, get_Cs_fn, cost_fn, state, alphas, **kw)
            accept = bool(accept)
            if accept:
                self.x_nom, self.u_nom = state.x_nom, state.u_nom
                self._cost = float(state.cost)
                self.cost_log.append(self._cost)
            if verbose:
                print(f"iteration {i}: cost {float(state.cost):.6e} accept={accept}")
            if not accept:
                print(f"Forward pass failed, cannot improve anymore at iteration {i + 1}.")
                break
            if bool(torch.abs(state.cost - state.prev_cost) < tol_fun):
                print(f"Cost change is too low, cannot improve anymore at iteration {i + 1}.")
                break
            if i == max_iter - 1:
                print("Maximum iterations reached.")
        if method == "dp" and aux is not None:
            self._K, self._k = aux
        elif method == "sls" and aux is not None:
            # lifted history-feedback gains (Nm, Nd) / (Nm,) in delta
            # coordinates, for get_trajectory_sls
            self._K_sls, self._k_sls = aux
        self.AB = get_AB(self.x_nom, self.u_nom)
        return self

    def solve_ilqr(self, get_AB, get_Cs=None, max_ilqr_iter=100,
                   max_line_search_iter=25, dp=True, verbose=False, **kw):
        """The reference notebooks' alias of `solve`."""
        return self.solve(
            get_AB, get_Cs=get_Cs, method="dp" if dp else "batch",
            max_iter=max_ilqr_iter, max_line_search_iter=max_line_search_iter,
            verbose=verbose, **kw,
        )

    def solve_boxddp(self, get_AB, u_lower, u_upper, get_Cs=None,
                     max_iter=100, tol_fun=1e-7, riccati="seq"):
        """Control-limited DDP, the bounds inside the Riccati recursion
        (`solvers/boxddp.py`; riccati='parallel' for the time-parallel
        backward). Updates the nominal values in place."""
        f, cost_fn = self._forward_model, self.cost_function
        lo, hi = self._t(u_lower), self._t(u_upper)
        st0 = boxddp_init(f, cost_fn, self.x_nom[0], self.u_nom, lo, hi, device=self.device)
        out = boxddp_solve(f, get_AB, self._get_Cs_or_quad(get_Cs), cost_fn, st0, lo, hi,
                           cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun), riccati=riccati)
        self._adopt(out.x_nom, out.u_nom, out.cost, get_AB)
        self.cost_log.append(self._cost)
        return out

    def solve_al(self, get_AB, ineq=None, eq=None, get_Cs=None, max_iter=40,
                 tol_fun=1e-9, n_al=10, mu0=1.0, mu_factor=5.0, tol_con=1e-6):
        """Augmented-Lagrangian iLQR over stagewise constraints
        ineq(x,u[,t]) <= 0, eq(x,u[,t]) = 0 (`solvers/al_ilqr.py`). Updates
        the nominal values in place and returns the ALResult."""
        f, cost_fn = self._forward_model, self.cost_function
        out = al_ilqr_solve(
            f, get_AB, self._get_Cs_or_quad(get_Cs), cost_fn, self.x_nom[0], self.u_nom,
            ineq=ineq, eq=eq, cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun),
            n_al=n_al, mu0=mu0, mu_factor=mu_factor, tol_con=tol_con, device=self.device,
        )
        self._adopt(out.x_nom, out.u_nom, out.cost, get_AB)
        self.cost_log.append(self._cost)
        return out

    def solve_barrier(self, get_AB, barrier, get_Cs=None, max_iter=40,
                      tol_fun=1e-9, mu0=1.0, mu_factor=5.0, n_barrier=6):
        """Interior-point iLQR over stagewise cones (`solvers/barrier_ilqr.py`;
        build `barrier` with `make_barrier`). The nominal controls must
        roll out strictly feasibly."""
        f, cost_fn = self._forward_model, self.cost_function
        out = barrier_ilqr_solve(
            f, get_AB, self._get_Cs_or_quad(get_Cs), cost_fn, self.x_nom[0], self.u_nom, barrier,
            cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun),
            mu0=mu0, mu_factor=mu_factor, n_barrier=n_barrier, device=self.device,
        )
        self._adopt(out.x_nom, out.u_nom, out.cost, get_AB)
        self.cost_log.append(self._cost)
        return out

    # ------------------------------------------------------------ rollouts
    def _rollouts(self, x0, rollout, noise_scale, rng):
        """rollout(x0 (d,), ws (N, d) or None) -> (xs, us) over a batch of
        initial states (vmapped: a time loop over batched tensors)."""
        x0b, single = self._batchify_x0(x0)
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        if single:
            return rollout(x0b[0], None if ws is None else ws[0])
        if ws is None:
            return vmap(lambda a: rollout(a, None))(x0b)
        return vmap(rollout)(x0b, ws)

    @highest_precision
    def rollout_batch(self, x0, us):
        """Open-loop rollouts; x0 (b, d) or (d,), us (b, N, m) or (N, m)."""
        f = self._forward_model
        x0, us = self._t(x0), self._t(us)
        if x0.ndim == 1 and us.ndim == 2:
            return rollout_nonlinear(f, x0, us), us
        x0b = x0 if x0.ndim == 2 else x0.expand((us.shape[0],) + tuple(x0.shape))
        return vmap(lambda a, u: rollout_nonlinear(f, a, u))(x0b, us), us

    @highest_precision
    def get_trajectory_batch(self, x0, us, noise_scale=0, rng=None):
        """Open-loop rollouts of us (N, m) with the nonlinear plant."""
        us = self._t(us)
        f = self._forward_model
        xs = self._rollouts(x0, lambda a, w: rollout_nonlinear(f, a, us, w), noise_scale, rng)
        return xs, (us if xs.ndim == 2 else us.expand((xs.shape[0],) + tuple(us.shape)))

    @highest_precision
    def get_trajectory_dp(self, x0, K, k, noise_scale=0, rng=None):
        """Closed-loop rollouts around the nominal with the nonlinear plant:
        u = K (x - x_nom) + k + u_nom."""
        f, K, k = self._forward_model, self._t(K), self._t(k)
        x_nom, u_nom = self.x_nom, self.u_nom
        return self._rollouts(
            x0, lambda a, w: rollout_closed_loop(f, a, K, k, x_nom, u_nom, w), noise_scale, rng)

    @highest_precision
    def get_trajectory_sls(self, x0, K, k, noise_scale=0, rng=None):
        """History-feedback rollouts around the nominal (K lifted (N*m, N*d))."""
        f, K, k = self._forward_model, self._t(K), self._t(k)
        x_nom, u_nom = self.x_nom, self.u_nom
        return self._rollouts(
            x0, lambda a, w: rollout_sls_delta(f, a, K, k, x_nom, u_nom, w), noise_scale, rng)

    def controller(self, PHI_U, du):
        """(K, k) from a response map, with the current linearization."""
        return sls_controller(self.A, self.B, self._t(PHI_U), self._t(du))

    # --------------------------------------------------------------- ADMM
    def ilqr_admm(
        self, get_AB, get_Cs=None, project_x=None, project_u=None,
        max_iter=20, max_line_search_iter=20, max_admm_iter=20, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        k_max=None, threshold=None, max_line_search=None,
        method="batch", riccati="chol", line_search="inner",
        anderson_m=0,
    ):
        """Constrained iLQR-ADMM (`solvers/ilqr_admm.py`). Takes the
        current and the notebook-era keyword spellings
        (`k_max`/`threshold`/`max_line_search`). line_search='outer'
        (batch method only) is the SQP-style variant: the inner ADMM on
        the linearized prediction, one nonlinear line search an outer
        step. Returns the ILQRADMMResult, or with log=True the outer
        iterations' costs (numpy)."""
        max_iter = k_max if k_max is not None else max_iter
        tol = threshold if threshold is not None else tol
        if max_line_search is not None:
            max_line_search_iter = max_line_search
        res = _ilqr_admm(
            self._forward_model, get_AB, self.cost_function, self.x_nom, self.u_nom,
            get_Cs=get_Cs, quad_cost=None if get_Cs is not None else self.quad_cost,
            project_x=project_x or None, project_u=project_u or None,
            rho_x=rho_x, rho_u=rho_u, max_iter=max_iter, max_admm_iter=max_admm_iter,
            alphas=self._alphas(max_line_search_iter), alpha=alpha, tol=tol,
            method=method, riccati=riccati, line_search=line_search, anderson_m=anderson_m,
            device=self.device,
        )
        self._adopt(res.x_nom, res.u_nom, res.cost, get_AB)
        finite = _host(res.cost_log)[: int(res.outer_iters)]
        self.cost_log.extend(float(c) for c in finite)
        if verbose:
            print(
                f"ilqr_admm: {int(res.outer_iters)} outer iterations, "
                f"final cost {self._cost:.6e}, status {int(res.status)}"
            )
        if log:
            return finite
        return res

    def isls_admm(
        self, dim, get_AB, get_Cs=None, project_x=None, project_u=None,
        max_admm_iter=20, k_max=20, max_line_search=20, rho_x=None, rho_u=None,
        alpha=1.0, threshold=1e-3, verbose=False, log=False, anderson_m=0,
    ):
        """Robust iSLS-ADMM (`solvers/isls_admm.py`). Returns (du, phi_u)."""
        del log
        res = _isls_admm(
            self._forward_model, get_AB, self.cost_function, self.x_nom, self.u_nom,
            robust_dim=dim, get_Cs=get_Cs,
            quad_cost=None if get_Cs is not None else self.quad_cost,
            project_x=project_x or None, project_u=project_u or None,
            rho_x=rho_x, rho_u=rho_u, k_max=k_max, max_admm_iter=max_admm_iter,
            alphas=self._alphas(max_line_search), alpha=alpha, tol=threshold,
            anderson_m=anderson_m, device=self.device,
        )
        self._adopt(res.x_nom, res.u_nom, res.cost, get_AB)
        finite = _host(res.cost_log)[: int(res.outer_iters)]
        self.cost_log.extend(float(c) for c in finite)
        if verbose:
            print(
                f"isls_admm: {int(res.outer_iters)} outer iterations, "
                f"final cost {self._cost:.6e}, status {int(res.status)}"
            )
        return res.du, res.phi_u
