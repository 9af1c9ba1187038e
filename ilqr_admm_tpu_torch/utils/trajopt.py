"""Optimal spline-basis trajectory parameterization (TrajOpt); counterpart
of `ilqr_admm_tpu/utils/trajopt.py`.

Represents a trajectory as y(t) = Phi(t) @ w with w = [y_nodes (N+1 per
dof), dy_0, dy_T] — the C2 cubic interpolant with clamped end velocities, which is
the minimum-acceleration trajectory through the nodes. Interior node
velocities are the solution of the cubic-spline continuity (tridiagonal)
system, so Phi and its derivatives are *linear* in w, exactly like the
reference's basis construction.

Host-side problem-setup utility in NumPy; `torch.as_tensor` takes its
arrays to a device.
"""

from __future__ import annotations

import numpy as np


class TrajOpt:
    def __init__(self, ndof: int):
        self.ndof = ndof

    def setup_task(self, h):
        """h: list of segment durations (N segments, N+1 nodes)."""
        self.h = np.asarray(h, dtype=float)
        self.N = len(self.h)
        self.nw_scalar = self.N + 1 + 2  # node values + dy_0 + dy_T

        # Solve for interior node velocities v_1..v_{N-1} from C2 continuity:
        #   h_i v_{i-1} + 2(h_{i-1}+h_i) v_i + h_{i-1} v_{i+1}
        #     = 3 [ h_i (y_i - y_{i-1}) / h_{i-1} + h_{i-1} (y_{i+1} - y_i) / h_i ]
        # with v_0 = dy_0 and v_N = dy_T clamped. Express all node velocities
        # as a linear map V: v = V @ w, w = [y_0..y_N, dy_0, dy_T].
        N = self.N
        nv = N + 1
        Amat = np.zeros((nv, nv))
        Bmat = np.zeros((nv, self.nw_scalar))
        Amat[0, 0] = 1.0
        Bmat[0, N + 1] = 1.0
        Amat[N, N] = 1.0
        Bmat[N, N + 2] = 1.0
        for i in range(1, N):
            hm, hp = self.h[i - 1], self.h[i]
            Amat[i, i - 1] = hp
            Amat[i, i] = 2.0 * (hm + hp)
            Amat[i, i + 1] = hm
            Bmat[i, i - 1] += -3.0 * hp / hm
            Bmat[i, i] += 3.0 * hp / hm - 3.0 * hm / hp
            Bmat[i, i + 1] += 3.0 * hm / hp
        self._V = np.linalg.solve(Amat, Bmat)  # (N+1, nw_scalar)

        # Node-value selector: y_i = S_i @ w
        self._S = np.zeros((nv, self.nw_scalar))
        self._S[:, : N + 1] = np.eye(N + 1)

    # ---------------------------------------------------------------- basis
    def _segment_base(self, t: float, der: int) -> np.ndarray:
        """Scalar basis row (1, nw_scalar) for time t and derivative order."""
        t = float(t)
        t_start = 0.0
        for n in range(self.N):
            if t <= t_start + self.h[n] or n == self.N - 1:
                s = t - t_start
                hn = self.h[n]
                # cubic Hermite on [0, hn] in terms of (y_n, y_{n+1}, v_n, v_{n+1})
                tau = s / hn
                if der == 0:
                    h00 = 2 * tau**3 - 3 * tau**2 + 1
                    h10 = (tau**3 - 2 * tau**2 + tau) * hn
                    h01 = -2 * tau**3 + 3 * tau**2
                    h11 = (tau**3 - tau**2) * hn
                elif der == 1:
                    h00 = (6 * tau**2 - 6 * tau) / hn
                    h10 = 3 * tau**2 - 4 * tau + 1
                    h01 = (-6 * tau**2 + 6 * tau) / hn
                    h11 = 3 * tau**2 - 2 * tau
                elif der == 2:
                    h00 = (12 * tau - 6) / hn**2
                    h10 = (6 * tau - 4) / hn
                    h01 = (-12 * tau + 6) / hn**2
                    h11 = (6 * tau - 2) / hn
                else:
                    raise ValueError("der must be 0, 1 or 2")
                row = (
                    h00 * self._S[n]
                    + h01 * self._S[n + 1]
                    + h10 * self._V[n]
                    + h11 * self._V[n + 1]
                )
                return row[None]
            t_start += self.h[n]
        raise AssertionError("unreachable")

    def _get_base(self, t, der: int) -> np.ndarray:
        ts = np.atleast_1d(np.asarray(t, dtype=float))
        rows = np.concatenate([self._segment_base(ti, der) for ti in ts], axis=0)
        return np.kron(rows, np.eye(self.ndof))

    def get_Phi(self, t):
        return self._get_base(t, 0)

    def get_dPhi(self, t):
        return self._get_base(t, 1)

    def get_ddPhi(self, t):
        return self._get_base(t, 2)

    # ----------------------------------------------------------- evaluation
    def _eval(self, t, y_nodes, dy_0, dy_T, der):
        w = np.concatenate(
            [np.asarray(y_nodes).reshape(-1), np.asarray(dy_0), np.asarray(dy_T)]
        )
        out = self._get_base(t, der) @ w
        if np.size(t) == 1:
            return out.reshape(self.ndof)
        return out.reshape(np.size(t), self.ndof)

    def get_y(self, t, y_nodes, dy_0, dy_T):
        return self._eval(t, y_nodes, dy_0, dy_T, 0)

    def get_dy(self, t, y_nodes, dy_0, dy_T):
        return self._eval(t, y_nodes, dy_0, dy_T, 1)

    def get_ddy(self, t, y_nodes, dy_0, dy_T):
        return self._eval(t, y_nodes, dy_0, dy_T, 2)
