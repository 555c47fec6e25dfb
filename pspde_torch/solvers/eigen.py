"""Eigenvalue solver (counterpart of ``pspde/solvers/eigen.py:
EigenSolver``): the elliptic diffusion loop with a learnable eigenvalue.

One step per iteration, as the FP and Schroedinger notebooks train:

  * the Y recursion carries the extra ``- lambda V`` term (h + lambda y,
    pspde's ``_LambdaShiftedProblem``, here ``rollout/sde.py:
    LambdaShiftedProblem``); lambda is a ``ScalarParam`` with its own Adam
    group;
  * periodic boundary conditions on [X_l, X_r]^d by value AND gradient
    matching between opposite faces (``sample_boundary_reflected``);
  * the domain loss ``mean((V(X_end) - V(X_0) - Y)^2)``;
  * normalization 'center' (pin V at X_0 to the known eigenfunction value)
    or 'l2_penalty' (``norm_penalty_weight (E[V^2] - 1)^2`` plus the hat
    barrier around E[V^2] = 0).

Two engines for the domain leg, resolved as ``EllipticSolver`` resolves
them (its ``_fused_train_gates`` and ``_resolve_engine``): 'scan' (the
plain autograd ``stopped_rollout`` on the lambda-shifted problem) and
'fused_train' (the stopped kernels' torus family, or their Schroedinger
family with a ``DenseNetTanh`` value net; lambda a leaf of
``fused_stopped_train_rollout`` whose gradient the backward kernel
returns).  On a CUDA problem a failed gate raises a ValueError naming it;
on the CPU 'fused_train' resolves to 'scan' with a warning.  ``mesh``,
``rng_impl`` and ``layout='dk'`` raise NotImplementedError naming their
ROADMAP.md item; save/load and resume are ``utils/checkpoint.py``'s; the
semigroup power iteration that refines a trained V is
``eval/eigen_power.py``.  ``train()`` runs ``steps_per_call`` steps per
call as JAX resolves it ('auto': min(50, print_every);
``solvers/_chunk.py``): on CUDA each chunk is one captured CUDA graph,
replayed, with its metrics read once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ansatz import ConcatSkipNet, DenseNet, ScalarParam
from ..rollout.kernels import RNG_MAPS, fused_stopped_train_rollout
from ..rollout.sampling import (inside_fn, sample_boundary_reflected,
                                sample_domain)
from ..rollout.sde import (LambdaShiftedProblem, StoppedRolloutConfig,
                           stopped_rollout, value_and_z)
from ..utils.device import solver_device
from ..utils.schedule import adam
from ._chunk import ChunkedSolver, run_training
from .elliptic import EllipticSolver, _not_ported


def hat_function(x):
    """exp(-200 x^2) on (-0.2, 0.2): the barrier pushing E[V^2] away from
    0 (Schroedinger notebook cell 2)."""
    return torch.exp(-200.0 * x ** 2) * ((x > -0.2) & (x < 0.2))


class EigenSolver(ChunkedSolver):
    """Trains (and holds) an eigenfunction net V and its eigenvalue lambda.

    Constructor arguments mirror ``pspde.solvers.EigenSolver``; the port
    adds ``device=``, the CUDA card when None, which must be the problem's
    device.  The default value net is the FP notebook's DenseNet (10, 10,
    10, 10) with bias 0.8 and the relu output clamp, initialised from a
    ``torch.Generator`` seeded with ``seed``; lambda starts at
    ``lambda_init``.  Load JAX parameters with ``load_jax_params``.
    Sampling and the scan's noise come from a generator on the problem's
    device seeded with seed + 1, the kernels' per-step seeds from a CPU
    generator seeded with seed + 2 (as ``EllipticSolver``).  ``lr`` and
    ``lr_lambda`` are numbers or callables step -> lr
    (``utils/schedule.py``); on CUDA the Adam is ``capturable`` with its
    lrs on the device (``utils/schedule.py:adam``).  ``fused_unroll`` is a
    TPU lever, accepted and ignored.
    """

    _LOG_ATTRS = ("loss_log", "loss_log_boundary",
                  "loss_log_derivative_boundary", "loss_log_domain",
                  "loss_log_center", "V_L2_log", "lambda_log", "times")

    # the engine resolution is EllipticSolver's: the eigen domain leg IS
    # the diffusion loss (with the lambda-shifted h)
    loss_method = "diffusion"
    solve_linear_L2_projection = False
    _time_stopping = False
    _fused_train_gates = EllipticSolver._fused_train_gates
    _resolve_engine = EllipticSolver._resolve_engine

    def __init__(self, problem, name, seed=42, delta_t=1e-3, N=20, lr=0.001,
                 lr_lambda=None, lambda_init=0.5, L=100000, K=500,
                 K_boundary=50, alpha=(50.0, 1.0), normalization="center",
                 norm_penalty_weight=0.01, hat_weight=1.0,
                 adaptive_forward_process=False, detach_forward=True,
                 print_every=100, verbose=True, value_net=None, remat=None,
                 mesh=None, steps_per_call="auto", rng_impl="threefry",
                 layout="auto", rollout_mode="scan", fused_tile=None,
                 fused_unroll=None, fused_rng=None, device=None):
        who = type(self).__name__
        if mesh is not None:
            raise _not_ported(who, "mesh=", "Queue 1 item 5")
        if layout == "dk":
            raise _not_ported(who, "layout='dk', a TPU lane-layout lever,",
                              "'Do not port'")
        if rng_impl != "threefry":
            raise _not_ported(who, f"rng_impl={rng_impl!r}, a TPU lever,",
                              "'Do not port'")
        if rollout_mode not in ("scan", "fused_train"):
            raise _not_ported(who, f"rollout_mode={rollout_mode!r}",
                              "'Do not port'")
        if normalization not in ("center", "l2_penalty"):
            raise ValueError(f"normalization={normalization!r} must be "
                             "'center' or 'l2_penalty'")
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
        self.lr_lambda = lr if lr_lambda is None else lr_lambda
        self.L = L
        self.K = K
        self.K_boundary = K_boundary
        self.alpha = tuple(alpha)
        self.normalization = normalization
        self.norm_penalty_weight = norm_penalty_weight
        self.hat_weight = hat_weight
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.print_every = print_every
        self.verbose = verbose
        self.steps_per_call = steps_per_call
        self.remat = (N > 512) if remat is None else remat
        self.rollout_mode = rollout_mode
        self.fused_tile = fused_tile
        self.fused_unroll = fused_unroll
        self.fused_rng = fused_rng
        self.device = solver_device(problem, device)

        if value_net is None:
            # FP notebook cell 1: DenseNet with the relu output clamp
            value_net = DenseNet(d_out=1, arch=(10, 10, 10, 10),
                                 bias_init_value=0.8, output_relu=True,
                                 d_in=self.d,
                                 generator=torch.Generator().manual_seed(
                                     int(seed)), device=self.device)
        self.V_net = value_net.to(self.device)
        self.lam_net = ScalarParam(initial=float(lambda_init),
                                   device=self.device)
        self.iteration = 0
        self._make_optimizer()
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 1)
        self._seed_gen = torch.Generator().manual_seed(int(seed) + 2)

        self.loss_log = []
        self.loss_log_boundary = []
        self.loss_log_derivative_boundary = []
        self.loss_log_domain = []
        self.loss_log_center = []
        self.V_L2_log = []
        self.lambda_log = []
        self.times = []
        self.resolved_rollout_mode = self._resolve_engine()

    # -- model ---------------------------------------------------------------
    def V(self, X):
        return self.V_net(X)[:, 0]

    def lam(self):
        """The eigenvalue now, a 0-d tensor (a copy, detached)."""
        return self.lam_net.Y_0.detach()[0].clone()

    def _make_optimizer(self):
        """A fresh Adam: the net's group at lr, lambda's at lr_lambda (one
        Adam per group, as pspde's optax.multi_transform)."""
        self._lrs = [self.lr, self.lr_lambda]
        self.optimizer = adam([(self.V_net.parameters(), self.lr),
                               ([self.lam_net.Y_0], self.lr_lambda)],
                              self.iteration, self.device)

    def load_jax_params(self, tree):
        """Load the JAX solver's ``params`` tree {"V": <Flax concat-skip
        net>, "lam": <ScalarParam>} (nested dicts of arrays) into a net of
        the value net's class (``DenseNet`` unless it is another
        concat-skip net, e.g. the Schroedinger notebook's
        ``DenseNetTanh``) and start a fresh optimizer."""
        from ..utils.convert import eigen_params_from_flax
        cls = (type(self.V_net) if isinstance(self.V_net, ConcatSkipNet)
               else DenseNet)
        self.V_net, self.lam_net = eigen_params_from_flax(
            tree, output_relu=getattr(self.V_net, "output_relu", False),
            device=self.device, cls=cls)
        self._make_optimizer()
        self.resolved_rollout_mode = self._resolve_engine()

    # -- the domain leg ------------------------------------------------------
    def _grad_x(self, X):
        """grad_x V at X, differentiable in the net's parameters."""
        Xg = X.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(self.V(Xg).sum(), Xg, create_graph=True)
        return g

    def _cfg(self, N=None, delta_t=None):
        return StoppedRolloutConfig(
            N=self.N if N is None else N,
            delta_t=self.delta_t if delta_t is None else delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward, remat=self.remat)

    def _rollout(self, X0, lam, host_noise, seed=None, N=None,
                 delta_t=None):
        """(X_end, Y, v_l2) of the lambda-shifted stopped rollout from X0
        with Y_0 = 0 on the resolved engine; ``seed`` is the kernels' (an
        int, or on CUDA their 0-d int64 device word)."""
        problem, K = self.problem, X0.shape[0]
        zeros = torch.zeros((K,), dtype=torch.float32, device=self.device)
        N = self.N if N is None else N
        dt = self.delta_t if delta_t is None else delta_t
        if self.resolved_rollout_mode != "fused_train":
            out = stopped_rollout(
                self._cfg(N, dt), LambdaShiftedProblem(problem, lam),
                value_and_z(self.V_net, problem.sigma_struct), X0, zeros,
                zeros, inside_fn(problem.geometry), generator=self._gen,
                v_ref=problem.v_ref if problem.has_v_ref else None,
                host_noise=host_noise)
            return out.X, out.Y, out.v_l2
        fo = fused_stopped_train_rollout(
            problem, self.V_net, X0, zeros, N, dt, seed,
            adaptive_forward=self.adaptive_forward_process,
            rng=self.fused_rng or "erfinv", host_noise=host_noise,
            tile=self.fused_tile, lam=lam.reshape(1))
        v_l2 = fo.v_l2
        if problem.has_v_ref and problem.v_ref_family() is None:
            # no in-kernel reference for this problem: NaN, not a 0.0 that
            # would read as a perfect fit (as pspde's _fused_v_l2)
            v_l2 = torch.full_like(v_l2, float("nan"))
        return fo.X, fo.Y, v_l2

    # -- training ------------------------------------------------------------
    @property
    def _draws_seed(self) -> bool:
        return self.resolved_rollout_mode == "fused_train"

    def _chunk_modules(self) -> dict:
        return {"V_net": self.V_net, "lam_net": self.lam_net}

    def _chunk_generators(self) -> dict:
        return {"_gen": self._gen}

    def step(self, X0=None, Xb=None, X2=None, host_noise=None) -> dict:
        """One training step (pspde's ``_build_step``): normalization,
        periodic boundary matching, the domain rollout, backward, Adam.
        ``X0`` (K, d), ``Xb`` (the pair (Xb, Xb_reflected) of
        (K_boundary, d) points), ``X2`` (K, d; 'l2_penalty') and
        ``host_noise`` (N, K, d) replace the solver's own draws.  Appends
        to the logs and returns the metrics (0-d tensors)."""
        return self._logged_step(dict(X0=X0, Xb=Xb, X2=X2,
                                      host_noise=host_noise))[0]

    def _train_step(self, seed, X0=None, Xb=None, X2=None,
                    host_noise=None) -> dict:
        """The step at the optimizer's current lrs with the kernels'
        ``seed``: its metrics as 0-d tensors (lambda before the
        update)."""
        problem, geom = self.problem, self.problem.geometry
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1 = self.alpha
        self.optimizer.zero_grad(set_to_none=True)
        lam = self.lam_net.Y_0
        if self.normalization == "center":
            Xc = problem.X_0[None, :]
            center_l = torch.mean((self.V(Xc) - problem.v_ref(Xc)) ** 2)
            loss = center_l
        else:
            if X2 is None:
                X2 = sample_domain(self._gen, geom, K, d)
            m2 = torch.mean(self.V(X2) ** 2)
            center_l = self.norm_penalty_weight * (m2 - 1.0) ** 2
            loss = self.hat_weight * hat_function(m2) + center_l

        # periodic BCs: value + gradient matching on opposite faces
        if Xb is None:
            Xb = sample_boundary_reflected(self._gen, geom, Kb, d)
        Xb, Xb_r = Xb
        bound_l = torch.mean((self.V(Xb) - self.V(Xb_r)) ** 2)
        dbound_l = torch.mean((self._grad_x(Xb) - self._grad_x(Xb_r)) ** 2)
        loss = loss + a1 * bound_l + a1 * dbound_l

        if X0 is None:
            X0 = sample_domain(self._gen, geom, K, d)
        phi_0 = self.V(X0)
        X_end, Y, v_l2 = self._rollout(X0, lam, host_noise, seed)
        dom_l = torch.mean((self.V(X_end) - phi_0 - Y) ** 2)
        loss = loss + a0 * dom_l
        aux = {"loss": loss.detach(), "center": center_l.detach(),
               "boundary": bound_l.detach(), "dboundary": dbound_l.detach(),
               "domain": dom_l.detach(), "V_L2": torch.mean(v_l2.detach()),
               "lambda": lam.detach()[0].clone()}   # before the update
        loss.backward()
        self.optimizer.step()
        return aux

    def _record(self, vals: dict):
        """Append one iteration's metrics (floats) to the reference-name
        logs."""
        self.loss_log.append(vals["loss"])
        self.loss_log_center.append(vals["center"])
        self.loss_log_boundary.append(vals["boundary"])
        self.loss_log_derivative_boundary.append(vals["dboundary"])
        self.loss_log_domain.append(vals["domain"])
        self.V_L2_log.append(vals["V_L2"])
        self.lambda_log.append(vals["lambda"])

    def _maybe_print(self, done: int, n: int):
        first = done - n
        if self.verbose and (first == 0 or first // self.print_every
                             != done // self.print_every):
            print("%d - loss = %.4e, v L2 error = %.4e, lambda = %.4e, %.2f"
                  % (done - 1, self.loss_log[-1], self.V_L2_log[-1],
                     self.lambda_log[-1],
                     np.mean(self.times[-self.print_every:])))

    def train(self):
        run_training(self)

    # -- eigenvalue readouts beyond the last iterate -------------------------
    def lambda_tail_mean(self, window=None):
        """Tail-window average of ``lambda_log`` (default: the last 10% of
        the trace): averages out the Adam-equilibrium oscillation of the
        per-iterate lambda."""
        if not self.lambda_log:
            return None
        w = int(window) if window else max(1, len(self.lambda_log) // 10)
        return float(np.mean(self.lambda_log[-w:]))

    @torch.no_grad()
    def estimate_lambda(self, K=4096, n_batches=16, seed=None,
                        delta_t=None, batches=None):
        """Regression (Rayleigh-quotient-type) eigenvalue estimate at the
        frozen trained eigenfunction V (pspde's ``estimate_lambda``).

        Y is affine in lambda at fixed V (h_eff = h + lambda V), so
        Y(lambda) = Y(0) - lambda S with S = Y(0) - Y(1) from two rollouts
        on the same noise; the least-squares lambda of the domain loss is

            lambda_hat = -sum(r S) / sum(S S),  r = V(X_end) - V(X_0) - Y(0).

        On 'fused_train' both rollouts are forward launches of the kernel
        with one seed, so they see the same noise and masks; on the scan
        they share one host-noise draw.  ``delta_t`` overrides the step
        size with the horizon N delta_t kept.  ``batches`` (pairs (X0 (K,
        d), host_noise (N, K, d) or None)) replace the draws of the
        generator seeded with ``seed`` (default seed + 0x1a).  Returns
        ``(lambda_hat, stderr)`` with a batch-split error bar."""
        problem, d = self.problem, self.d
        if delta_t is None:
            N, dt = self.N, self.delta_t
        else:
            dt = float(delta_t)
            N = max(1, int(round(self.N * self.delta_t / dt)))
        fused = self.resolved_rollout_mode == "fused_train"
        if batches is None:
            gen = torch.Generator(device=self.device).manual_seed(
                int(self.seed + 0x1a if seed is None else seed))

            def draws():
                for _ in range(n_batches):
                    X0 = sample_domain(gen, problem.geometry, K, d)
                    noise = None if fused else torch.randn(
                        (N, K, d), generator=gen, device=self.device)
                    yield X0, noise
            batches = draws()
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        rs_tot, ss_tot, per_batch = 0.0, 0.0, []
        for X0, noise in batches:
            s = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                  generator=self._seed_gen))
            X_end, Y0, _ = self._rollout(X0, 0.0 * one, noise, seed=s, N=N,
                                         delta_t=dt)
            _, Y1, _ = self._rollout(X0, one, noise, seed=s, N=N,
                                     delta_t=dt)
            S = Y0 - Y1
            r = self.V(X_end) - self.V(X0) - Y0
            rs, ss = torch.stack([torch.sum(r * S),
                                  torch.sum(S * S)]).tolist()
            rs_tot += rs
            ss_tot += ss
            per_batch.append(-rs / max(ss, 1e-30))
        lam_hat = -rs_tot / max(ss_tot, 1e-30)
        stderr = float(np.std(per_batch) / np.sqrt(max(len(per_batch), 1)))
        return lam_hat, stderr

    def estimate_lambda_richardson(self, K=4096, n_batches=16, seed=None,
                                   refine=4.0, order=0.5):
        """Richardson dt-extrapolated eigenvalue readout at frozen V
        (pspde's ``estimate_lambda_richardson``): readouts at dt and
        dt / refine cancel the leading dt^order term of the stopping bias
        (s = refine^order),

            lambda_R = (s lambda(dt / refine) - lambda(dt)) / (s - 1),

        with the error bars of the two independent readouts propagated.
        ``seed`` (default seed + 0x1b) seeds the coarse readout, seed + 1
        the fine one."""
        seed = int(self.seed + 0x1b if seed is None else seed)
        s = float(refine) ** float(order)
        lam_c, se_c = self.estimate_lambda(K=K, n_batches=n_batches,
                                           seed=seed)
        lam_f, se_f = self.estimate_lambda(
            K=K, n_batches=n_batches, seed=seed + 1,
            delta_t=self.delta_t / float(refine))
        lam_R = (s * lam_f - lam_c) / (s - 1.0)
        se_R = float(np.hypot(s * se_f, se_c) / (s - 1.0))
        return lam_R, se_R
