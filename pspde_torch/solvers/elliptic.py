"""Elliptic boundary-value solver (counterpart of
``pspde/solvers/elliptic.py:EllipticSolver``, solver.py:560-931).

One step per iteration: boundary and domain sampling, the stopped
Euler-Maruyama rollout with Z = sigma^T grad V per step, the loss of the
method (diffusion with or without ``variance_moment_split``, BSDE,
BSDE-2/3/4, ``loss_with_stopped``, the Dirichlet or Neumann boundary
loss), one Adam update, and the ``K_test_log`` test errors.  PINN
(``losses/pinn.py``, pspde's ``_build_pinn_step``) takes no rollout: the
squared (or, with ``PINN_log_variance``, the variance of the) generator's
residual on the domain samples, with the Hessian contracted by B B^T
under ``full_hessian``, and the Dirichlet boundary term.  The rollout's
two engines:

  * 'scan': the plain autograd rollout (``rollout/sde.py:stopped_rollout``;
    second-order autograd through Z);
  * 'fused_train': the stopped training kernels (``rollout/kernels.py:
    fused_stopped_train_rollout``): one forward and one replay-backward
    launch per step, for 'diffusion' and 'BSDE' with ``detach_forward``.

Deviation from the JAX package, as in ``HJBSolver``: on a CUDA problem a
failed 'fused_train' gate raises a ValueError naming the gate (PINN
with 'fused_train' among them); on the CPU the kernels do not exist and
'fused_train' resolves to 'scan' with a warning, as JAX does off the TPU.
``layout='dk'``, ``rng_impl`` and ``mesh`` raise NotImplementedError
naming their ROADMAP.md item; save/load and resume are
``utils/checkpoint.py``'s.  ``lr`` is a number or a
callable step -> lr (``utils/schedule.py``).  ``train()`` runs
``steps_per_call`` steps per call as JAX resolves it ('auto': min(50,
print_every); ``solvers/_chunk.py``), PINN too: on CUDA each chunk is one
captured CUDA graph, replayed, with its metrics read once.

``GeneralSolver`` (``solvers/general.py``) is this class with a clock: the
gates, the engine resolution, ``_rollout``, ``_record`` and ``train`` are
defined here once and switch on ``_time_stopping``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ansatz import DenseNet
from ..eval.test_error import compute_test_error
from ..losses.pinn import elliptic_pinn_residual
from ..rollout.kernels import (RNG_MAPS, _check_stopped_family,
                               fused_stopped_train_rollout)
from ..rollout.sampling import inside_fn, sample_boundary, sample_domain
from ..rollout.sde import (StoppedRolloutConfig, StoppedRolloutOut,
                           stopped_rollout, value_and_z)
from ..utils.device import solver_device
from ..utils.schedule import adam
from ._chunk import ChunkedSolver, run_training


def _unbiased_var(x):
    n = x.shape[0]
    return torch.var(x, correction=0) * n / max(n - 1, 1)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _not_ported(who: str, what: str, item: str):
    return NotImplementedError(f"{who}: {what} is not ported to "
                               f"pspde_torch yet (ROADMAP.md, {item})")


class EllipticSolver(ChunkedSolver):
    """Trains (and holds) the value net of an elliptic problem.

    Constructor arguments mirror ``pspde.solvers.EllipticSolver``; the port
    adds ``device=``, the CUDA card when None, which must be the problem's
    device.  The default value net is ``DenseNet(d_out=1)`` initialised
    from a ``torch.Generator`` seeded with ``seed`` (0.1 N(0, 1) weights,
    zero biases), not from the JAX initialisation: load JAX parameters
    with ``load_jax_params``.  Sampling and the scan engine's noise come
    from a generator on the problem's device seeded with seed + 1, the
    kernels' per-step seeds from a CPU generator seeded with seed + 2, the
    test samples from a device generator seeded with seed + 3.  On CUDA the
    Adam is ``capturable`` with its lr on the device
    (``utils/schedule.py:adam``).  ``fused_unroll`` is a TPU lever,
    accepted and ignored.
    """

    _LOG_ATTRS = ("loss_log", "loss_log_domain", "loss_log_boundary",
                  "V_L2_log", "V_test_L2", "V_test_abs", "V_test_rel_abs",
                  "K_log", "times", "not_all_stopped_count")

    # GeneralSolver: the value net reads [x, t], every path carries a clock
    # and stops at the horizon
    _time_stopping = False
    solve_linear_L2_projection = False

    def __init__(self, problem, name, seed=42, delta_t=0.01, N=50, lr=0.001,
                 L=100000, K=200, K_boundary=50, alpha=(1.0, 1.0),
                 adaptive_forward_process=False, detach_forward=True,
                 print_every=100, verbose=True, approx_method="Y",
                 sample_center=False, loss_method="diffusion",
                 loss_with_stopped=False, K_test_log=None,
                 PINN_log_variance=False, log_loss_parts=False,
                 boundary_loss=True, boundary_type="Dirichlet",
                 variance_moment_split=False, full_hessian=False,
                 uniform_square=False, value_net=None, remat=None,
                 mesh=None, steps_per_call="auto", rng_impl="threefry",
                 layout="auto", rollout_mode="scan", fused_tile=None,
                 fused_unroll=None, fused_rng=None, device=None):
        if approx_method != "Y":
            # as pspde: the reference's 'Z' branch is dead code
            # (solver.py:723-729)
            raise ValueError(
                "approx_method=%r is not supported: the reference's 'Z' "
                "branch is dead code (its training loop only uses V, "
                "solver.py:723-729); use approx_method='Y'"
                % (approx_method,))
        who = type(self).__name__
        if layout == "dk":
            raise _not_ported(who, "layout='dk', a TPU lane-layout lever,",
                              "'Do not port'")
        if rng_impl != "threefry":
            raise _not_ported(who, f"rng_impl={rng_impl!r}, a TPU lever,",
                              "'Do not port'")
        if mesh is not None:
            raise _not_ported(who, "mesh=", "Queue 1 item 5")
        if rollout_mode not in ("scan", "fused_train"):
            raise _not_ported(who, f"rollout_mode={rollout_mode!r}",
                              "'Do not port'")
        if fused_rng is not None and fused_rng not in RNG_MAPS:
            raise ValueError(f"fused_rng={fused_rng!r} must be one of "
                             f"{RNG_MAPS}")
        self.problem = problem
        self.name = name
        self.d = problem.d
        self.seed = seed
        self.delta_t = float(delta_t)
        self.N = N
        self.lr = lr
        self.L = L
        self.K = K
        self.K_boundary = K_boundary
        self.alpha = tuple(alpha)
        self.boundary_type = boundary_type
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.approx_method = approx_method
        self.sample_center = sample_center
        self.loss_method = loss_method
        self.loss_with_stopped = loss_with_stopped
        self.boundary_loss = boundary_loss
        self.PINN_log_variance = PINN_log_variance
        self.variance_moment_split = variance_moment_split
        self.full_hessian = full_hessian
        self.uniform_square = uniform_square
        self.print_every = print_every
        self.verbose = verbose
        self.log_loss_parts = log_loss_parts
        self.steps_per_call = steps_per_call
        self.remat = (N > 512) if remat is None else remat
        self.rollout_mode = rollout_mode
        self.fused_tile = fused_tile
        self.fused_unroll = fused_unroll
        self.fused_rng = fused_rng
        self.device = solver_device(problem, device)

        if value_net is None:
            value_net = DenseNet(d_out=1,
                                 d_in=self.d + int(self._time_stopping),
                                 generator=torch.Generator().manual_seed(
                                     int(seed)), device=self.device)
        self.V_net = value_net.to(self.device)
        self.iteration = 0
        self._make_optimizer()
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 1)
        self._seed_gen = torch.Generator().manual_seed(int(seed) + 2)
        self._test_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 3)

        # logs (solver.py:613-626)
        self.K_test_log = K_test_log
        self.loss_log = []
        self.loss_log_domain = []
        self.loss_log_boundary = []
        self.V_L2_log = []
        self.V_test_L2 = []
        self.V_test_abs = []
        self.V_test_rel_abs = []
        self.K_log = []
        self.times = []
        self.not_all_stopped_count = 0
        self.resolved_rollout_mode = self._resolve_engine()

    # -- model ---------------------------------------------------------------
    def V(self, X):
        return self.V_net(X)[:, 0]

    def _make_optimizer(self):
        """A fresh Adam at the lr of the current iteration."""
        self._lrs = [self.lr]
        self.optimizer = adam([(self.V_net.parameters(), self.lr)],
                              self.iteration, self.device)

    def load_jax_params(self, tree):
        """Load the JAX solver's ``params`` tree (a Flax DenseNet tree,
        nested dicts of arrays) into the value net and start a fresh
        optimizer."""
        from ..utils.convert import dense_net_from_flax
        out_relu = getattr(self.V_net, "output_relu", False)
        self.V_net = dense_net_from_flax(tree, output_relu=out_relu,
                                         device=self.device)
        self._make_optimizer()
        self.resolved_rollout_mode = self._resolve_engine()

    # -- engine --------------------------------------------------------------
    def _fused_train_gates(self):
        """The gates of 'fused_train' (pspde's _resolve_fused) that fail,
        by name; the TPU test becomes 'problem on a CUDA device'."""
        failed = []
        if self.loss_method not in ("diffusion", "BSDE"):
            failed.append("loss_method 'diffusion' or 'BSDE' (got "
                          f"{self.loss_method!r})")
        if not self.detach_forward:
            failed.append("detach_forward=True")
        if self.solve_linear_L2_projection:
            failed.append("solve_linear_L2_projection=False")
        try:
            _check_stopped_family(self.problem, self.V_net,
                                  self.fused_rng or "erfinv",
                                  time_stopping=self._time_stopping)
        except ValueError as e:
            failed.append(f"the stopped kernels' family ({e})")
        if self.device.type != "cuda":
            failed.append("problem on a CUDA device")
        return failed

    def _resolve_engine(self) -> str:
        if self.rollout_mode != "fused_train":
            return "scan"
        failed = self._fused_train_gates()
        if not failed:
            return "fused_train"
        if self.device.type == "cuda":
            raise ValueError("rollout_mode='fused_train': gate failed: "
                             + "; ".join(failed))
        warnings.warn("rollout_mode='fused_train' fell back to 'scan' (a "
                      "gate failed: " + "; ".join(failed) + ")",
                      stacklevel=3)
        return "scan"

    def _rollout_cfg(self) -> StoppedRolloutConfig:
        lm = self.loss_method
        return StoppedRolloutConfig(
            N=self.N, delta_t=self.delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward,
            recursive_y_in_h=lm in ("BSDE-2", "BSDE-4"),
            step_loss=lm if lm in ("BSDE-2", "BSDE-3") else None,
            time_stopping=self._time_stopping,
            no_y_update=self.solve_linear_L2_projection,
            remat=self.remat, alpha0=self.alpha[0])

    def _rollout(self, X0, Y0, host_noise, t0=None,
                 seed=None) -> StoppedRolloutOut:
        """The stopped rollout from (X0, t0) on the resolved engine; t0 is
        zeros without ``_time_stopping``; ``seed`` is the kernels' (an int,
        or on CUDA their 0-d int64 device word).  The space-time scan
        carries no reference (as pspde: V_L2 reads 0 there)."""
        problem, K = self.problem, X0.shape[0]
        timed = self._time_stopping
        if t0 is None:
            t0 = torch.zeros((K,), dtype=torch.float32, device=self.device)
        if self.resolved_rollout_mode != "fused_train":
            with_ref = problem.has_v_ref and not timed
            return stopped_rollout(
                self._rollout_cfg(), problem,
                value_and_z(self.V_net, problem.sigma_struct,
                            space_time=timed,
                            z_free=self.solve_linear_L2_projection),
                X0, Y0, t0, inside_fn(problem.geometry), generator=self._gen,
                v_ref=problem.v_ref if with_ref else None,
                host_noise=host_noise)
        fo = fused_stopped_train_rollout(
            problem, self.V_net, X0, t0, self.N, self.delta_t, seed,
            adaptive_forward=self.adaptive_forward_process,
            rng=self.fused_rng or "erfinv", host_noise=host_noise,
            tile=self.fused_tile, time_stopping=timed)
        v_l2 = fo.v_l2
        if problem.has_v_ref and (timed or problem.v_ref_family() is None):
            # the kernel has no in-kernel reference for this problem (none
            # at all with time_stopping): NaN, not a 0.0 that would read as
            # a perfect fit (as pspde)
            v_l2 = torch.full_like(v_l2, float("nan"))
        return StoppedRolloutOut(
            X=fo.X, Y=Y0 + fo.Y, t=fo.t, stopped=fo.stopped > 0.5,
            hitting=fo.hitting, v_l2=v_l2,
            step_loss=torch.zeros((), device=self.device),
            active_count=torch.sum(fo.adv_steps))

    # -- training ------------------------------------------------------------
    def _boundary_loss(self, Xb):
        """Dirichlet value matching or Neumann radial-derivative matching
        (solver.py:676-685)."""
        g = self.problem.g(Xb)
        if self.boundary_type == "Dirichlet":
            return torch.mean((self.V(Xb) - g) ** 2)
        Xg = Xb.detach().requires_grad_(True)
        V = self.V(Xg)
        (grad_V,) = torch.autograd.grad(V.sum(), Xg, create_graph=True)
        lhs = torch.sum(grad_V * Xb, dim=-1)
        rhs = torch.sum(g * Xb, dim=-1)
        return torch.mean((lhs - rhs) ** 2)

    def _domain_loss(self, resid):
        """The PINN domain term: the residual's mean square, or its
        unbiased variance with ``PINN_log_variance``."""
        if self.PINN_log_variance:
            return _unbiased_var(resid)
        return torch.mean(resid ** 2)

    def _finish_step(self, loss, aux) -> dict:
        """Backward, Adam and the test errors of one step: its metrics."""
        loss.backward()
        self.optimizer.step()
        aux["loss"] = loss.detach()
        if self.K_test_log is not None:
            aux["test_L2"], aux["test_abs"], aux["test_rel_abs"] = \
                self._test_errors()
        return aux

    def _test_errors(self):
        return compute_test_error(self.V, self.problem, self.K_test_log,
                                  self._test_gen)

    def _pinn_step(self, X=None, Xb=None) -> dict:
        """One PINN step (pspde's ``_build_pinn_step``): the residual on K
        domain samples ``X`` and the Dirichlet boundary term on
        ``K_boundary`` boundary samples ``Xb`` (each drawn when None)."""
        problem, geom = self.problem, self.problem.geometry
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1 = self.alpha
        dev = self.device
        self.optimizer.zero_grad(set_to_none=True)
        if X is None:
            X = sample_domain(self._gen, geom, K, d,
                              uniform_square=self.uniform_square)
        dom = self._domain_loss(elliptic_pinn_residual(
            problem, self.V, X, self.full_hessian))
        loss = a0 * dom
        bound_l = torch.zeros((), device=dev)
        if self.boundary_loss and geom.bounded:
            if Xb is None:
                Xb = sample_boundary(self._gen, geom, Kb, d)
            bound_l = torch.mean((self.V(Xb) - problem.g(Xb)) ** 2)
            loss = loss + a1 * bound_l
        with torch.no_grad():
            # the diagnostic only where the problem carries an oracle
            v_l2 = (torch.mean((self.V(X) - problem.v_ref(X)) ** 2)
                    * self.delta_t if problem.has_v_ref
                    else torch.full((), float("nan"), device=dev))
        aux = {"boundary": bound_l.detach(), "domain": dom.detach(),
               "V_L2": v_l2, "K_count": torch.full((), float(K), device=dev),
               "all_stopped": torch.ones((), dtype=torch.bool, device=dev)}
        return self._finish_step(loss, aux)

    @property
    def _draws_seed(self) -> bool:
        return self.resolved_rollout_mode == "fused_train"

    def _chunk_modules(self) -> dict:
        return {"V_net": self.V_net}

    def _chunk_generators(self) -> dict:
        return {"_gen": self._gen, "_test_gen": self._test_gen}

    def step(self, X0=None, Xb=None, host_noise=None) -> dict:
        """One training step (pspde's ``_build_step``): sampling, rollout,
        loss, backward, Adam, test errors; with PINN ``_pinn_step`` on the
        domain samples ``X0``.  ``X0`` (K, d), ``Xb`` (K_boundary, d) and
        ``host_noise`` (N, K, d) replace the solver's own draws.  Appends
        to the logs and returns the metrics (0-d tensors)."""
        return self._logged_step(dict(X0=X0, Xb=Xb,
                                      host_noise=host_noise))[0]

    def _train_step(self, seed, X0=None, Xb=None, host_noise=None) -> dict:
        """The step at the optimizer's current lr with the kernels'
        ``seed``: its metrics as 0-d tensors."""
        if self.loss_method == "PINN":
            return self._pinn_step(X0, Xb)
        problem, geom, lm = self.problem, self.problem.geometry, \
            self.loss_method
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1 = self.alpha
        dev = self.device
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=dev)
        if self.sample_center and problem.has_v_ref:
            Xc = torch.zeros((1, d), device=dev)
            loss = loss + torch.mean((self.V(Xc) - problem.v_ref(Xc)) ** 2)
        bound_l = torch.zeros((), device=dev)
        if (lm not in ("BSDE-4", "BSDE") and self.boundary_loss
                and geom.bounded):
            if Xb is None:
                Xb = sample_boundary(self._gen, geom, Kb, d)
            bound_l = self._boundary_loss(Xb)
            loss = loss + a1 * bound_l
        if X0 is None:
            X0 = sample_domain(self._gen, geom, K, d,
                               uniform_square=self.uniform_square)
        if lm in ("BSDE-2", "BSDE-4", "BSDE", "diffusion"):
            Y0 = self.V(X0)
        else:
            Y0 = torch.zeros((K,), device=dev)
        out = self._rollout(X0, Y0, host_noise, seed=seed)
        loss = loss + out.step_loss
        if lm == "diffusion":
            r = self.V(out.X) - out.Y
            if self.variance_moment_split:
                # solver.py:788-789
                loss = loss + a0 * (_unbiased_var(r) + torch.mean(r[:1] ** 2))
            else:
                loss = loss + a0 * torch.mean(r ** 2)
        if lm in ("BSDE-4", "BSDE"):
            loss = loss + torch.mean((problem.g(out.X) - out.Y) ** 2)
        if self.loss_with_stopped:
            loss = loss + masked_mean((problem.g(out.X) - out.Y) ** 2,
                                      out.stopped)
        aux = {"boundary": bound_l.detach(),
               "domain": (loss - a1 * bound_l).detach(),
               "V_L2": torch.mean(out.v_l2.detach()),
               "K_count": out.active_count.detach(),
               "all_stopped": torch.all(out.stopped)}
        return self._finish_step(loss, aux)

    def _record(self, vals: dict):
        """Append one iteration's metrics (floats) to the reference-name
        logs."""
        self.loss_log.append(vals["loss"])
        self.V_L2_log.append(vals["V_L2"])
        self.K_log.append(vals["K_count"])
        if not vals["all_stopped"] and self.loss_method in ("BSDE",
                                                            "BSDE-4"):
            self.not_all_stopped_count += 1
        if self.log_loss_parts:
            self.loss_log_domain.append(vals["domain"])
            self.loss_log_boundary.append(vals["boundary"])
        if self.K_test_log is not None:
            self.V_test_L2.append(vals["test_L2"])
            self.V_test_abs.append(vals["test_abs"])
            self.V_test_rel_abs.append(vals["test_rel_abs"])

    def _maybe_print(self, done: int, n: int):
        first = done - n
        if self.verbose and (first == 0 or first // self.print_every
                             != done // self.print_every):
            print("%d - loss = %.4e, v L2 error = %.4e, %.2f"
                  % (done - 1, self.loss_log[-1], self.V_L2_log[-1],
                     np.mean(self.times[-self.print_every:])))

    def train(self):
        run_training(self)
