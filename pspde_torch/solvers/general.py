"""General space-time parabolic solver (counterpart of
``pspde/solvers/general.py:GeneralSolver``, solver.py:934-1323).

Like ``EllipticSolver``, but the value net reads (x, t) (t last), start
points are uniform in space and t0 ~ U(0, T), a path stops on leaving the
domain or when its clock cannot advance (t + dt > T), and the loss adds the
terminal condition (V(x, T) - f(x))^2 on the first ``K_boundary`` domain
points beside the spatial boundary loss (Dirichlet or Neumann) on bounded
geometries.  PINN (pspde's ``_build_pinn_step``) takes the parabolic
residual (``losses/pinn.py``) on the domain samples at t ~ U(0, T), the
terminal term on the first ``K_boundary`` of them and the spatial
boundary term; V_L2 reads 0 there, as in pspde.  The rollout's two
engines are ``EllipticSolver``'s, with ``time_stopping``: the 'scan'
(``rollout/sde.py:stopped_rollout``, and ``solve_linear_L2_projection``)
and
'fused_train' (the ``time_stopping`` branch of the stopped kernels, for
'diffusion' and 'BSDE' with ``detach_forward``).  The gates, the engine
resolution, the rollout call, the logs and ``train`` are
``EllipticSolver``'s own.  As in ``pspde`` the kernels carry no reference
under ``time_stopping``: ``V_L2_log`` reads NaN on 'fused_train' and 0 on
the scan; ``K_test_log`` gives the test errors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval.test_error import compute_test_error
from ..losses.pinn import parabolic_pinn_residual
from ..rollout.sampling import sample_boundary, sample_domain
from .elliptic import EllipticSolver, masked_mean


class GeneralSolver(EllipticSolver):
    """Trains (and holds) the space-time value net of a parabolic problem.

    Constructor arguments mirror ``pspde.solvers.GeneralSolver``
    (``alpha``: weights of the rollout, terminal and spatial-boundary
    terms); the port adds ``device=`` as ``EllipticSolver`` does, and draws
    from generators seeded as there.
    """

    _time_stopping = True

    def __init__(self, problem, name, seed=42, delta_t=0.01, N=50, lr=0.001,
                 L=100000, K=200, K_boundary=50, alpha=(1.0, 1.0, 1.0),
                 adaptive_forward_process=False, detach_forward=True,
                 print_every=100, verbose=True, approx_method="Y",
                 sample_center=False, loss_method="diffusion",
                 loss_with_stopped=False, K_test_log=None,
                 PINN_log_variance=False, log_loss_parts=False,
                 boundary_loss=True, full_hessian=False,
                 uniform_square=False, solve_linear_L2_projection=False,
                 value_net=None, remat=None, mesh=None, steps_per_call="auto",
                 rng_impl="threefry", layout="auto", rollout_mode="scan",
                 fused_tile=None, fused_unroll=None, fused_rng=None,
                 device=None):
        if problem.T is None:
            raise ValueError(f"GeneralSolver needs a horizon: "
                             f"{type(problem).__name__}.T is None")
        if K_boundary > K:
            raise ValueError(f"K_boundary={K_boundary} exceeds K={K}: the "
                             "terminal loss reads the first K_boundary "
                             "domain points")
        self.T = float(problem.T)
        self.solve_linear_L2_projection = bool(solve_linear_L2_projection)
        super().__init__(
            problem, name, seed=seed, delta_t=delta_t, N=N, lr=lr, L=L, K=K,
            K_boundary=K_boundary, alpha=alpha,
            adaptive_forward_process=adaptive_forward_process,
            detach_forward=detach_forward, print_every=print_every,
            verbose=verbose, approx_method=approx_method,
            sample_center=sample_center, loss_method=loss_method,
            loss_with_stopped=loss_with_stopped, K_test_log=K_test_log,
            PINN_log_variance=PINN_log_variance,
            log_loss_parts=log_loss_parts, boundary_loss=boundary_loss,
            boundary_type=problem.boundary_type, full_hessian=full_hessian,
            uniform_square=uniform_square, value_net=value_net, remat=remat,
            mesh=mesh, steps_per_call=steps_per_call, rng_impl=rng_impl,
            layout=layout, rollout_mode=rollout_mode, fused_tile=fused_tile,
            fused_unroll=fused_unroll, fused_rng=fused_rng, device=device)
        self._warn_coverage()

    def _warn_coverage(self):
        """On an unbounded geometry the terminal loss pins V(., T) on the
        sampled ball only: warn when the diffusion spread leaves it (the
        Allen-Cahn notebook sets boundary_distance = 7.0 for this)."""
        geom = self.problem.geometry
        if geom is None or geom.bounded or not self.verbose:
            return
        mat = self.problem.sigma_struct.mat.cpu().numpy()
        spread = float(np.sqrt(np.trace(mat @ mat.T) * self.T))
        radius = (geom.boundary_distance if "square" not in geom.kind
                  else abs(geom.X_r - geom.X_l) / 2)
        if spread > 1.5 * radius:
            print(f"WARNING: diffusion spread ~{spread:.1f} exceeds the "
                  f"sampling radius {radius:.1f}; terminal pinning will not "
                  "cover path endpoints - increase "
                  "geometry.boundary_distance (cf. Allen-Cahn nb cell 1: "
                  "boundary_distance = 7.0).")

    # -- model ---------------------------------------------------------------
    def V(self, X, t):
        """V on X (K, d) at the times t (K,)."""
        return self.V_net(torch.cat([X, t[:, None]], dim=-1))[:, 0]

    def _grad_x(self, X, t):
        """The raw gradient of V in x at (X, t), differentiable in the
        net's parameters."""
        Xg = X.detach().requires_grad_(True)
        (grad_V,) = torch.autograd.grad(self.V(Xg, t).sum(), Xg,
                                        create_graph=True)
        return grad_V

    # -- training ------------------------------------------------------------
    def _spatial_boundary_loss(self, Xb, tb):
        """Dirichlet value matching (solver.py:1067) or Neumann
        radial-derivative matching (solver.py:1068-1074)."""
        g = self.problem.g(Xb, tb)
        if self.boundary_type == "Dirichlet":
            return torch.mean((self.V(Xb, tb) - g) ** 2)
        lhs = torch.sum(self._grad_x(Xb, tb) * Xb, dim=-1)
        rhs = torch.sum(g * Xb, dim=-1)
        return torch.mean((lhs - rhs) ** 2)

    def _test_errors(self):
        return compute_test_error(lambda XT: self.V_net(XT)[:, 0],
                                  self.problem, self.K_test_log,
                                  self._test_gen, modus="parabolic")

    def _uniform_t(self, n):
        return torch.rand((n,), generator=self._gen,
                          device=self.device) * self.T

    def _pinn_step(self, X=None, t=None, Xb=None, tb=None) -> dict:
        """One PINN step (pspde's ``_build_pinn_step``): the residual at K
        domain samples ``X`` and times ``t``, the terminal term on
        ``X[:K_boundary]`` and, on bounded geometries, the spatial boundary
        term at ``Xb``, ``tb`` (each drawn when None)."""
        problem, geom = self.problem, self.problem.geometry
        K, Kb, d, T = self.K, self.K_boundary, self.d, self.T
        a0, a1, a2 = self.alpha
        dev = self.device
        self.optimizer.zero_grad(set_to_none=True)
        if X is None:
            X = sample_domain(self._gen, geom, K, d,
                              uniform_square=self.uniform_square)
        if t is None:
            t = self._uniform_t(K)
        dom = self._domain_loss(parabolic_pinn_residual(
            problem, lambda XT: self.V_net(XT)[:, 0], X, t,
            self.full_hessian))
        loss = a0 * dom
        bound_l = torch.zeros((), device=dev)
        if self.boundary_loss:
            tT = torch.full((Kb,), T, device=dev)
            loss = loss + a1 * torch.mean(
                (self.V(X[:Kb], tT) - problem.f_terminal(X[:Kb])) ** 2)
            if geom.bounded:
                if Xb is None:
                    Xb = sample_boundary(self._gen, geom, Kb, d)
                if tb is None:
                    tb = self._uniform_t(Kb)
                bound_l = self._spatial_boundary_loss(Xb, tb)
                loss = loss + a2 * bound_l
        aux = {"boundary": bound_l.detach(), "domain": dom.detach(),
               "V_L2": torch.zeros((), device=dev),
               "K_count": torch.full((), float(K), device=dev),
               "all_stopped": torch.ones((), dtype=torch.bool, device=dev)}
        return self._finish_step(loss, aux)

    def step(self, X0=None, t0=None, Xb=None, tb=None,
             host_noise=None) -> dict:
        """One training step (pspde's ``_build_step``): sampling, rollout,
        loss, backward, Adam, test errors; with PINN ``_pinn_step`` at
        ``X0``, ``t0``.  ``X0`` (K, d), ``t0`` (K,), ``Xb`` (K_boundary,
        d), ``tb`` (K_boundary,) and ``host_noise`` (N, K, d) replace the
        solver's own draws.  Appends to the logs and returns the metrics
        (0-d tensors)."""
        return self._logged_step(dict(X0=X0, t0=t0, Xb=Xb, tb=tb,
                                      host_noise=host_noise))[0]

    def _train_step(self, seed, X0=None, t0=None, Xb=None, tb=None,
                    host_noise=None) -> dict:
        """The step at the optimizer's current lr with the kernels'
        ``seed``: its metrics as 0-d tensors."""
        if self.loss_method == "PINN":
            return self._pinn_step(X0, t0, Xb, tb)
        problem, geom, lm = self.problem, self.problem.geometry, \
            self.loss_method
        K, Kb, d, T = self.K, self.K_boundary, self.d, self.T
        a0, a1, a2 = self.alpha
        dev = self.device
        uniform_t = self._uniform_t

        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=dev)
        if X0 is None:
            X0 = sample_domain(self._gen, geom, K, d,
                               uniform_square=self.uniform_square)
        if t0 is None:
            t0 = uniform_t(K)
        bound_l = torch.zeros((), device=dev)
        if lm not in ("BSDE-4", "BSDE") and self.boundary_loss:
            # the terminal condition on the first K_boundary domain points
            # (solver.py:1062-1064)
            XT = X0[:Kb]
            tT = torch.full((Kb,), T, device=dev)
            loss = loss + a1 * torch.mean(
                (self.V(XT, tT) - problem.f_terminal(XT)) ** 2)
            if geom.bounded:
                if Xb is None:
                    Xb = sample_boundary(self._gen, geom, Kb, d)
                if tb is None:
                    tb = uniform_t(Kb)
                bound_l = self._spatial_boundary_loss(Xb, tb)
                loss = loss + a2 * bound_l
        if lm in ("BSDE-2", "BSDE-4", "BSDE", "diffusion"):
            Y0 = self.V(X0, t0)
        else:
            Y0 = torch.zeros((K,), device=dev)
        out = self._rollout(X0, Y0, host_noise, t0, seed)
        loss = loss + out.step_loss
        if lm == "diffusion":
            loss = loss + a0 * torch.mean((self.V(out.X, out.t) - out.Y) ** 2)
        if lm in ("BSDE-4", "BSDE"):
            # terminal or boundary data at the stopping state
            # (solver.py:1170-1183)
            if not geom.bounded:
                loss = loss + torch.mean(
                    (out.Y - problem.f_terminal(out.X)) ** 2)
            elif self.boundary_type == "Dirichlet":
                loss = loss + torch.mean(
                    (out.Y - problem.g(out.X, out.t)) ** 2)
            else:
                # Neumann: paths that ran out of time against the terminal
                # data, spatial exits against the radial derivative (the
                # raw grad_x V, not sigma^T grad, as solver.py:1183)
                at_T = out.t > (T - self.delta_t)
                loss = loss + masked_mean(
                    (out.Y - problem.f_terminal(out.X)) ** 2, at_T)
                lhs = torch.sum(self._grad_x(out.X, out.t) * out.X, dim=-1)
                rhs = torch.sum(problem.g(out.X, out.t) * out.X, dim=-1)
                loss = loss + masked_mean((lhs - rhs) ** 2, ~at_T)
        if self.loss_with_stopped:
            loss = loss + masked_mean(
                (out.Y - problem.f_terminal(out.X)) ** 2, out.stopped)
        aux = {"boundary": bound_l.detach(),
               "domain": (loss - a2 * bound_l).detach(),
               "V_L2": torch.mean(out.v_l2.detach()),
               "K_count": out.active_count.detach(),
               "all_stopped": torch.all(out.stopped)}
        return self._finish_step(loss, aux)
