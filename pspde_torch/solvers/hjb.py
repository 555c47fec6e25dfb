"""HJB / parabolic path-space solver (counterpart of
``pspde/solvers/hjb.py:HJBSolver``).

Ported: both approximations of the JAX solver, ``approx_method='control'``
(a control net, Z = net) and ``'value_function'`` (a value net V, Z =
sigma^T grad_x V by autograd with ``create_graph``, Y_0 = V(X_0, 0) and
the consistency penalty of ``rollout/sde.py``), each with the 'inner' time
approximation (one net on [t, X]: TanhMLP for the control, DenseNet for
the value) or the 'outer' one (one parameter set per step, stacked:
``StackedNet``; DenseNet on X by default: N copies of the control, N + 1
of the value); the learnable Y_0, ``random_X_0`` (X_0 ~ N(0, I)),
``metastability_logs`` (the fraction of X_T within eps of a target),
training with the whole loss zoo (the repa phases, the reparametrization
sum and ``burgers_drift`` included), Adam with a separate ``lr_y0`` group
(``lr`` and ``lr_y0`` numbers or callables step -> lr,
``utils/schedule.py``), the u_L2 diagnostic, early stopping, pspde's
per-iteration diagnostics (``compute_gradient_variance``: the relative
gradient errors of ``eval/gradient_variance.py``; ``IS_variance_K`` /
``IS_variance_iter``: IS through ``eval/importance_sampling.py:
make_is_runner``; each from a generator of its own, and either makes
``train()`` run one step a call, as pspde's gate), ``log_gradient`` (the
net's flat gradient a step, also from captured chunks),
``train_LSE_with_reference``, ``save_results`` / ``save_logs`` and the
checkpoints of ``utils/checkpoint.py``, and two engines:

  * 'scan': the plain autograd rollout (``rollout/sde.py:hjb_rollout``);
  * 'fused_train': the training kernels (``rollout/kernels.py:
    fused_train_rollout``): one forward and one replay-backward launch
    per step; 'inner' control mode with a TanhMLP and a fixed X_0 only,
    as in JAX.

Deviation from the JAX package, deliberate: where a 'fused_train' gate
fails on a CUDA problem, the solver raises a ValueError naming the gate
instead of warning and falling back to the scan.  On a CPU problem the
kernels do not exist and 'fused_train' resolves to 'scan' with a warning,
as JAX does off the TPU.  ``train()`` runs ``steps_per_call`` steps per
call as JAX resolves it (``solvers/_chunk.py``: 'auto' is min(50,
print_every) unless the loss has phases or a diagnostic is on; an integer
forces): on CUDA each chunk is one captured CUDA graph, replayed, with its
metrics read once, the sqrt-schedule remat's chunks too
(``rollout/sde.py:_remat_scan``).
"""

from __future__ import annotations

import copy
import json
import os
import time
import warnings
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ansatz import DenseNet, ScalarParam, TanhMLP
from ..losses.pathspace import hjb_loss, log_variance_y0_losses
from ..rollout.kernels import (FusedTrainOut, RNG_MAPS, _check_train_family,
                               fused_train_rollout)
from ..rollout.sde import (HJBRolloutConfig, HJBRolloutOut, hjb_rollout,
                           step_time)
from ..utils.convert import (flax_state_dict, load_control_npz,
                             scalar_param_from_flax, tanh_mlp_from_flax)
from ..utils.device import solver_device
from ..utils.schedule import adam, apply_lr, lr_text
from ._chunk import ChunkedSolver, resolve_steps_per_call, run_training

# options of the JAX solver that the port does not have yet: a value other
# than the default raises (ROADMAP.md, Queue 1 items 5 and 9)
_NOT_PORTED = ("plot_trajectories", "mesh")
# TPU-only levers of the JAX solver, accepted and ignored
_TPU_ONLY = ("rng_impl", "layout", "fused_unroll")


class StackedNet(nn.Module):
    """One parameter set per time step of a net, stacked on a leading axis
    (pspde's ``init_stacked``): ``forward(x, n)`` runs the template module
    with set clip(n, 0, n_copies - 1) (``select_step``) through
    ``torch.func.functional_call``.  ``copies`` are modules of one kind and
    shape; their parameters are stacked, the first one is the template
    (its own parameters are not used; its buffers are)."""

    def __init__(self, copies: Sequence[nn.Module]):
        super().__init__()
        self.n_copies = len(copies)
        self._names = [n for n, _ in copies[0].named_parameters()]
        self.stacked = nn.ParameterList(
            nn.Parameter(torch.stack([dict(c.named_parameters())[n].detach()
                                      for c in copies]))
            for n in self._names)
        # the template is not registered: its parameters are not trained
        object.__setattr__(self, "template", copies[0])

    def params_at(self, n: int) -> dict:
        n = min(max(int(n), 0), self.n_copies - 1)
        return {name: p[n] for name, p in zip(self._names, self.stacked)}

    def forward(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return torch.func.functional_call(self.template, self.params_at(n),
                                          (x,))

    @torch.no_grad()
    def load_flax(self, tree: dict):
        """Load a Flax tree stacked on a leading axis of n_copies."""
        state = flax_state_dict(self.template, tree)
        for name, p in zip(self._names, self.stacked):
            val = state[name]
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"stacked leaf {name} has shape "
                                 f"{tuple(val.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(val)


def _per_step(net: nn.Module, n_copies: int,
              gen: torch.Generator) -> StackedNet:
    """n_copies parameter sets: ``net`` and n_copies - 1 fresh draws of its
    configuration from ``gen`` (its ``redraw``, as pspde's init_stacked
    draws one set a step), or copies of ``net``'s parameters for a module
    without ``redraw``."""
    if hasattr(net, "redraw"):
        return StackedNet([net] + [net.redraw(gen)
                                   for _ in range(n_copies - 1)])
    return StackedNet([net] + [copy.deepcopy(net)
                               for _ in range(n_copies - 1)])


class HJBSolver(ChunkedSolver):
    """Trains (and holds) the control or value model of a parabolic/HJB
    problem.

    Constructor arguments mirror ``pspde.solvers.HJBSolver``; the port
    adds ``device=``, the CUDA card when None, which must be the problem's
    device.  Parameters are initialised from a ``torch.Generator`` seeded
    with ``seed`` (TanhMLP: N(0, 0.01) weights and biases; DenseNet: its
    N(0, 0.01) weights and zero biases; each 'outer' step its own draw;
    Y_0 = 0), not from the JAX initialisation: load JAX parameters with
    ``load_jax_params``.  A ``control_net`` or ``value_net`` given for the
    'outer' approximation keeps its parameters at step 0, and every other
    step is a fresh draw of its configuration from that generator (its
    ``redraw``; a module without one starts every step from its
    parameters).  The scan
    engine's noise (and ``random_X_0``'s X_0) comes from a generator on the
    problem's device seeded with seed + 1; the kernels' per-step seeds
    from a CPU generator seeded with seed + 2; the gradient-variance and
    IS diagnostics from device generators seeded with seed + 3 and + 4.
    On CUDA the Adam is
    ``capturable`` with its lrs on the device (``utils/schedule.py:adam``).
    """

    _stepwise = False   # train() runs pspde's per-step loop (no chunks)

    def __init__(self, name, problem, lr=0.001, L=10000, K=50, delta_t=0.05,
                 approx_method="control", loss_method="log-variance",
                 time_approx="outer", learn_Y_0=False,
                 adaptive_forward_process=True, detach_forward=False,
                 early_stopping_time=10000, random_X_0=False,
                 compute_gradient_variance=0, IS_variance_K=0,
                 IS_variance_iter=1, metastability_logs=None,
                 print_every=100, seed=42, save_results=False,
                 u_l2_error_flag=True, log_gradient=False,
                 burgers_drift=False, verbose=True,
                 control_net=None, value_net=None, lr_y0=None, remat=None,
                 dtype=torch.float32, rollout_mode="scan",
                 steps_per_call="auto", antithetic=False, fused_tile=None,
                 fused_rng=None, device=None, **kwargs):
        if approx_method not in ("control", "value_function"):
            raise ValueError(f"approx_method={approx_method!r} must be "
                             "'control' or 'value_function'")
        if time_approx not in ("outer", "inner"):
            raise ValueError(f"time_approx={time_approx!r} must be 'outer' "
                             "or 'inner'")
        for key, val in kwargs.items():
            if key in _NOT_PORTED:
                if val:
                    raise NotImplementedError(
                        f"{key}={val!r} is not ported to pspde_torch yet "
                        "(ROADMAP.md, Queue 1)")
            elif key not in _TPU_ONLY:
                raise TypeError(f"HJBSolver got an unexpected argument "
                                f"{key!r}")
        if dtype != torch.float32:
            raise NotImplementedError("pspde_torch trains in float32 only")
        if rollout_mode not in ("scan", "fused_train"):
            raise NotImplementedError(
                f"rollout_mode={rollout_mode!r} is not ported to pspde_torch "
                "('batched_grad' and the legacy 'fused' are on the do-not-"
                "port list of ROADMAP.md); use 'scan' or 'fused_train'")
        if fused_rng is not None and fused_rng not in RNG_MAPS:
            raise ValueError(f"fused_rng={fused_rng!r} must be one of "
                             f"{RNG_MAPS}")
        self.problem = problem
        self.name = name
        self.d = problem.d
        self.T = problem.T
        self.seed = seed
        self.delta_t = float(delta_t)
        self.N = int(np.floor(self.T / self.delta_t))
        self.lr = lr
        self.lr_y0 = lr if lr_y0 is None else lr_y0
        self.L = L
        self.K = K
        self.random_X_0 = random_X_0
        self.metastability_logs = metastability_logs
        self.loss_method = loss_method
        self.approx_method = approx_method
        self.time_approx = time_approx
        self.learn_Y_0 = learn_Y_0
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.early_stopping_time = early_stopping_time
        self.burgers_drift = burgers_drift
        self.print_every = print_every
        self.verbose = verbose
        self.save_results = save_results
        self.compute_gradient_variance = compute_gradient_variance
        self.IS_variance_K = IS_variance_K
        self.IS_variance_iter = IS_variance_iter
        self.log_gradient = log_gradient
        self.remat = (self.N > 512) if remat is None else remat
        self.rollout_mode = rollout_mode
        self.steps_per_call = steps_per_call
        self.fused_tile = fused_tile
        self.fused_rng = fused_rng
        self.device = solver_device(problem, device)

        if self.loss_method == "relative_entropy":
            self.adaptive_forward_process = True
        if self.loss_method == "cross_entropy":
            self.learn_Y_0 = False
        if detach_forward and self.loss_method == "relative_entropy":
            warnings.warn(
                "loss_method='relative_entropy' with detach_forward=True "
                "has a degenerate gradient (the on-policy measure term is "
                "detached; the remaining term only shrinks Z toward 0) - "
                "use detach_forward=False, or a detach-compatible loss "
                "(log-variance / moment / cross_entropy)", stacklevel=2)
        if antithetic and K % 2:
            raise ValueError("antithetic training needs even K")
        self.antithetic = antithetic

        self.has_ref_solution = (hasattr(problem, "u_ref_fn")
                                 or hasattr(problem, "u_ref"))
        self.u_l2_error_flag = u_l2_error_flag and self.has_ref_solution
        self._u_ref = None
        # the kernels' (N, d) reference-control table, made once
        self._u_tab = None
        if self.u_l2_error_flag:
            ts = np.arange(self.N) * self.delta_t
            if hasattr(problem, "u_ref_fn"):
                self._u_ref = problem.u_ref_fn(ts)
            else:
                self._u_ref = lambda x, n: problem.u_ref(x)
            if hasattr(problem, "u_ref_table"):
                self._u_tab = problem.u_ref_table(ts)
        self._meta = None
        if metastability_logs is not None:
            target = torch.as_tensor(np.asarray(
                torch.as_tensor(metastability_logs[0]).cpu(),
                dtype=np.float32), device=self.device)
            self._meta = (target, float(metastability_logs[1]))

        gen = torch.Generator().manual_seed(int(seed))
        d, dev, outer = self.d, self.device, time_approx == "outer"
        d_in = d if outer else d + 1
        if approx_method == "control":
            if control_net is None:
                control_net = (DenseNet(d_out=d, d_in=d, generator=gen,
                                        device=dev) if outer
                               else TanhMLP(d_in, d, generator=gen,
                                            device=dev))
            control_net = control_net.to(dev)
            self.z_net = (_per_step(control_net, self.N, gen) if outer
                          else control_net)
        else:
            if value_net is None:
                value_net = DenseNet(d_out=1, d_in=d_in, generator=gen,
                                     device=dev)
            value_net = value_net.to(dev)
            self.y_net = (_per_step(value_net, self.N + 1, gen) if outer
                          else value_net)
        self.y0_net = ScalarParam(initial=0.0, device=self.device)
        self._noise_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 1)
        self._seed_gen = torch.Generator().manual_seed(int(seed) + 2)
        # the diagnostics' own streams (JAX folds 3 and 1 into its keys):
        # neither takes noise from training's
        self._gv_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 3)
        self._is_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 4)
        self._is_runner = None
        self._make_optimizer()

        # logs (the reference's names)
        self.Y_0_log = []
        self.loss_log = []
        self.u_L2_loss = []
        self.IS_rel_log = []
        self.times = []
        self.particles_close_to_target = []
        self.grads_rel_error_log = []
        self.gradient_log = []
        self.iteration = 0
        self.resolved_rollout_mode = self._resolve_engine()
        self.resolved_steps_per_call = 1

    # -- model ---------------------------------------------------------------
    @property
    def _y0_learned(self) -> bool:
        """Y_0 is a parameter of its own in control mode only (value mode
        reads Y_0 = V(X_0, 0))."""
        return self.learn_Y_0 and self.approx_method == "control"

    @property
    def _net(self) -> nn.Module:
        return self.z_net if self.approx_method == "control" else self.y_net

    def _make_optimizer(self):
        """Adam over the control (or value) net, with Y_0 in its own lr_y0
        group."""
        groups = [(self._net.parameters(), self.lr)]
        if self._y0_learned:
            groups.append((self.y0_net.parameters(), self.lr_y0))
        self._lrs = [lr for _, lr in groups]
        self.optimizer = adam(groups, getattr(self, "iteration", 0),
                              self.device)

    def _value_fn(self):
        """(X, n, t) -> V(X, t_n) of the value net (value mode)."""
        net, outer = self.y_net, self.time_approx == "outer"

        def fn(X, n, t):
            if outer:
                return net(X, n)[:, 0]
            tX = torch.cat([torch.full((X.shape[0], 1), float(t),
                                       dtype=X.dtype, device=X.device), X],
                           dim=1)
            return net(tX)[:, 0]

        return fn

    def _control_fn(self):
        """(X, n, t) -> (Z, V or None): control mode Z = net([t, X])
        ('inner') or net_n(X) ('outer'); value mode Z = sigma^T grad_x V
        with V = V(X, t_n), differentiable in the parameters (through
        ``create_graph``) while grad mode is on."""
        if self.approx_method == "control":
            net, outer = self.z_net, self.time_approx == "outer"

            def fn(X, n, t):
                if outer:
                    return net(X, n), None
                tX = torch.cat([torch.full((X.shape[0], 1), float(t),
                                           dtype=X.dtype, device=X.device),
                                X], dim=1)
                return net(tX), None

            return fn

        value, sig = self._value_fn(), self.problem.sigma_struct

        def fn(X, n, t):
            graph = torch.is_grad_enabled()
            with torch.enable_grad():
                Xg = X if X.requires_grad else X.detach().requires_grad_(True)
                V = value(Xg, n, t)
                (gX,) = torch.autograd.grad(V.sum(), Xg, create_graph=graph)
            return sig.apply_T(gX), (V if graph else V.detach())

        return fn

    @torch.no_grad()
    def Z_n(self, X, t: float):
        """Control evaluation at continuous time t (grid time n dt with
        n = ceil(t / dt))."""
        n = int(np.ceil(t / self.delta_t))
        Z, _ = self._control_fn()(X, n, float(np.float32(n * self.delta_t)))
        return Z

    def u(self, X, t: float):
        return -self.Z_n(X, t)

    @torch.no_grad()
    def Y_n(self, X, t: float):
        """Value-function evaluation at time t (value mode only), at step
        min(ceil(t / dt), N)."""
        assert self.approx_method == "value_function"
        n = int(np.ceil(t / self.delta_t))
        return self._value_fn()(X, min(n, self.N), float(np.float32(t)))

    def load_jax_params(self, tree_or_npz):
        """Load a JAX ``HJBSolver.params`` tree ({'z': ..., 'y0': ...} or
        {'y': ...}, nested dicts of arrays, stacked on a leading axis under
        'outer') or the path of an exported ``.npz``, and start a fresh
        optimizer.  Returns the asset's metadata (empty for a tree)."""
        meta = {}
        tree = tree_or_npz
        if isinstance(tree_or_npz, str):
            tree, meta = load_control_npz(tree_or_npz)
        key = "z" if self.approx_method == "control" else "y"
        net = self._net
        if isinstance(net, StackedNet):
            net.load_flax(tree[key])
        elif isinstance(net, TanhMLP):
            self.z_net = tanh_mlp_from_flax(tree[key], device=self.device)
        else:
            net.load_state_dict(flax_state_dict(net, tree[key]))
        if "y0" in tree:
            self.y0_net = scalar_param_from_flax(tree["y0"],
                                                 device=self.device)
        self._make_optimizer()
        self.resolved_rollout_mode = self._resolve_engine()
        return meta

    # -- engine --------------------------------------------------------------
    def _rollout_cfg(self, phase: int) -> HJBRolloutConfig:
        lm = self.loss_method
        return HJBRolloutConfig(
            N=self.N, delta_t=self.delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward,
            accumulate_kl="relative_entropy" in lm,
            kl_ito_term=(lm == "relative_entropy_BSDE"),
            reparametrization=(lm == "reparametrization"),
            repa_phase=(phase if lm == "log-variance-repa" else None),
            burgers_drift=self.burgers_drift,
            value_mode=(self.approx_method == "value_function"),
            track_u_l2=self.u_l2_error_flag,
            remat=self.remat,
            antithetic=self.antithetic,
        )

    def _fused_train_gates(self):
        """The gates of 'fused_train' (pspde's _build_step) that fail, by
        name; the TPU test becomes 'problem on a CUDA device'."""
        problem, lm = self.problem, self.loss_method
        failed = []
        if not self.detach_forward:
            failed.append("detach_forward=True")
        if not getattr(problem, "h_is_y_free", False):
            failed.append("h independent of Y (problem.h_is_y_free)")
        if lm in ("log-variance-repa", "reparametrization"):
            failed.append(f"a loss without repa phases or the "
                          f"reparametrization sum (got {lm!r})")
        if self.burgers_drift:
            failed.append("burgers_drift=False")
        if self.approx_method != "control":
            failed.append("approx_method='control'")
        if self.time_approx != "inner":
            failed.append("time_approx='inner'")
        if self.random_X_0:
            failed.append("random_X_0=False")
        if self.u_l2_error_flag and not hasattr(problem, "u_ref_table"):
            failed.append("u_l2_error_flag=False or a problem with a "
                          "u_ref_table (state-independent reference control)")
        elif self.approx_method == "control":
            try:
                _check_train_family(problem, self.z_net, self.N, 1.0,
                                    self._u_tab,
                                    self.fused_rng or "binom")
            except ValueError as e:
                failed.append(f"the training kernels' family ({e})")
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

    def _initial_state(self, X0=None):
        """(X_0, Y_0) of a rollout: X_0 the problem's, or N(0, I) draws
        with ``random_X_0`` (``X0`` (K, d) replaces them); Y_0 = V(X_0, 0)
        in value mode, the learned Y_0 or 0 in control mode."""
        K, d = self.K, self.d
        if X0 is None:
            if self.random_X_0:
                X0 = torch.randn((K, d), generator=self._noise_gen,
                                 dtype=torch.float32, device=self.device)
            else:
                X0 = self.problem.X_0.to(torch.float32).expand(K, d)
        if self.approx_method == "value_function":
            Y0 = self._value_fn()(X0, 0, 0.0)
        elif self.learn_Y_0:
            Y0 = self.y0_net(X0[:, :1])
        else:
            Y0 = torch.zeros((K,), dtype=torch.float32, device=self.device)
        return X0, Y0

    def _rollout_outputs(self, cfg: HJBRolloutConfig, host_noise=None,
                         X0=None, seed=None) -> HJBRolloutOut:
        """One rollout of K paths from X_0 with Y = Y_0 + sum of the
        increments.  ``host_noise`` (N, K, d), or (N, K/2, d) with
        antithetic pairs, replaces the engine's own noise; ``X0`` (K, d)
        the draws of ``random_X_0``; ``seed`` is the kernels' (an int, or
        on CUDA the 0-d int64 device word they read)."""
        K = self.K
        X0, Y0 = self._initial_state(X0)
        if self.resolved_rollout_mode != "fused_train":
            return hjb_rollout(cfg, self.problem, self._control_fn(), X0, Y0,
                               generator=self._noise_gen, u_ref=self._u_ref,
                               host_noise=host_noise)
        kw = dict(adaptive_forward=cfg.adaptive_forward,
                  accumulate_kl=cfg.accumulate_kl,
                  kl_ito_term=cfg.kl_ito_term, u_tab=self._u_tab,
                  rng=self.fused_rng or "binom", host_noise=host_noise,
                  tile=self.fused_tile)
        K_f = K // 2 if self.antithetic else K
        out = fused_train_rollout(self.problem, self.z_net, K_f, self.N,
                                  self.delta_t, seed, **kw)
        if self.antithetic:
            # the same seed with the noise mirrored: paths i and i + K/2
            # form the (xi, -xi) pair
            neg = fused_train_rollout(self.problem, self.z_net, K_f, self.N,
                                      self.delta_t, seed, noise_sign=-1.0,
                                      **kw)
            out = FusedTrainOut(*(torch.cat([a, b]) for a, b in zip(out,
                                                                     neg)))
        return HJBRolloutOut(out.X, Y0 + out.Y, out.Z_sum, out.u_l2,
                             torch.zeros_like(out.Y))

    # -- training ------------------------------------------------------------
    def _phase(self, l: int) -> int:
        if self.loss_method == "log-variance-repa":
            return l % 2
        if self.loss_method == "relative_entropy_log-variance":
            return 0 if l < 1000 else 1
        return 0

    @property
    def _draws_seed(self) -> bool:
        return self.resolved_rollout_mode == "fused_train"

    def _chunk_modules(self) -> dict:
        return {"z_net" if self.approx_method == "control" else "y_net":
                self._net, "y0_net": self.y0_net}

    def _chunk_generators(self) -> dict:
        return {"_noise_gen": self._noise_gen}

    def step(self, host_noise=None, X0=None) -> dict:
        """One training step (pspde's ``_build_step``): rollout, loss,
        backward, Adam.  Appends to the logs and returns the metrics (as
        floats).  ``host_noise`` and ``X0`` replace the rollout's draws
        (``_rollout_outputs``)."""
        return self._logged_step(dict(host_noise=host_noise, X0=X0))[1]

    def _train_step(self, seed, host_noise=None, X0=None) -> dict:
        """The step at the optimizer's current lrs, the kernels' ``seed``:
        its metrics as 0-d tensors (loss, u_l2, Y_0 after the update where
        it is learned, meta_frac with ``metastability_logs``)."""
        phase = self._phase(self.iteration)
        cfg = self._rollout_cfg(phase)
        out = self._rollout_outputs(cfg, host_noise, X0, seed)
        gX = self.problem.g(out.X)
        self.optimizer.zero_grad(set_to_none=True)
        if self.loss_method == "log-variance-y_0":
            # the variance part updates the control net, the squared-mean
            # part updates y_0: one forward, two pullbacks
            var_part, meansq_part = log_variance_y0_losses(out.Y, gX)
            z_params = list(self._net.parameters())
            grads = torch.autograd.grad(var_part, z_params,
                                        retain_graph=self._y0_learned)
            if self._y0_learned:
                (self.y0_net.Y_0.grad,) = torch.autograd.grad(
                    meansq_part, [self.y0_net.Y_0])
            for p, g in zip(z_params, grads):
                p.grad = g
            loss = var_part + meansq_part
        else:
            loss = hjb_loss(self.loss_method, out.Y, gX, out.Z_sum,
                            adaptive=self.adaptive_forward_process,
                            phase=phase)
            loss = loss + torch.mean(out.add_loss)
            if loss.requires_grad:
                loss.backward()
            else:
                # a loss that reaches no parameter ('reparametrization'
                # with detach_forward): zero gradients, as JAX's grad
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        p.grad = torch.zeros_like(p)
        self.optimizer.step()
        metrics = {"loss": loss.detach(), "u_l2": out.u_l2.detach().mean()}
        if self.log_gradient and self.loss_method != "log-variance-y_0":
            # the net's gradient, flat in the order of its parameters
            metrics["grad_flat"] = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1) for p in self._net.parameters()])
        if self._y0_learned:
            metrics["Y_0"] = self.y0_net.Y_0.detach()[0].clone()
        if self._meta is not None:
            # the fraction of final states within eps of the target
            target, eps = self._meta
            dist = torch.sqrt(torch.sum((out.X.detach() - target) ** 2,
                                        dim=-1))
            metrics["meta_frac"] = torch.mean((dist < eps).to(torch.float32))
        return metrics

    def _record(self, m: dict):
        self.loss_log.append(m["loss"])
        self.u_L2_loss.append(m["u_l2"])
        if "Y_0" in m:
            self.Y_0_log.append(m["Y_0"])
        if "meta_frac" in m:
            self.particles_close_to_target.append(m["meta_frac"])
        if "grad_flat" in m:
            self.gradient_log.append(np.asarray(m["grad_flat"]))
        self._diagnose(self.iteration)

    def _diagnose(self, l: int):
        """The per-iteration diagnostics of pspde's loop after step l: the
        relative gradient errors every ``compute_gradient_variance`` steps
        (their mean absolute value into ``grads_rel_error_log``) and IS at
        ``IS_variance_K`` paths every ``IS_variance_iter`` steps (its RE
        into ``IS_rel_log``), each from its own generator."""
        cgv = self.compute_gradient_variance
        if cgv > 0 and l % cgv == 0:
            from ..eval.gradient_variance import gradient_variances
            rel = gradient_variances(self, self._gv_gen)
            self.grads_rel_error_log.append(
                float(torch.mean(torch.abs(rel))))
        if self.IS_variance_K > 0 and l % self.IS_variance_iter == 0:
            if self._is_runner is None:
                from ..eval.importance_sampling import make_is_runner
                self._is_runner = make_is_runner(self.problem, self,
                                                 self.IS_variance_K)
            _, _, rel = self._is_runner(self._is_gen)
            self.IS_rel_log.append(float(rel))

    def _diagnostic_generators(self) -> dict:
        return {"_gv_gen": self._gv_gen, "_is_gen": self._is_gen}

    def _maybe_print(self, done: int, n: int):
        first = done - n
        if self._stepwise:
            due = first % self.print_every == 0
        else:
            due = first == 0 or first // self.print_every != (
                done // self.print_every)
        if self.verbose and due:
            self._print(done - 1)

    def _print(self, l: int):
        s = ("%d - loss: %.4e - u L2: %.4e - time/iter: %.2fs"
             % (l, self.loss_log[-1], self.u_L2_loss[-1],
                np.mean(self.times[-self.print_every:])))
        if self.Y_0_log:
            s += " - Y_0: %.4e" % self.Y_0_log[-1]
        if self.IS_rel_log:
            s += " - rel IS: %.3e" % self.IS_rel_log[-1]
        print(s)

    def _early_stop(self, done: int) -> bool:
        """u-L2 plateau early stopping (pspde's rule)."""
        est = self.early_stopping_time
        if est is None or done <= est:
            return False
        return (np.std(self.u_L2_loss[-est:])
                / (self.u_L2_loss[-1] + 1e-30) < 0.02)

    @property
    def _chunkable(self) -> bool:
        """pspde's gate of chunked training: a loss without phases and no
        per-iteration diagnostic."""
        return (self.loss_method not in ("log-variance-repa",
                                         "relative_entropy_log-variance")
                and self.compute_gradient_variance == 0
                and self.IS_variance_K == 0)

    def train(self):
        if self.verbose:
            print("d = %d, L = %d, K = %d, delta_t = %.2e, lr = %s, %s, "
                  "%s, %s, %s, engine %s"
                  % (self.d, self.L, self.K, self.delta_t, lr_text(self.lr),
                     self.approx_method, self.time_approx, self.loss_method,
                     "adaptive" if self.adaptive_forward_process else "",
                     self.resolved_rollout_mode))
        chunkable = self._chunkable
        # pspde chunks where its gate lets it, and else runs its per-step
        # loop, which prints and checks the plateau after step done - 1
        self._stepwise = not (chunkable and
                              resolve_steps_per_call(self, chunkable) > 1)
        run_training(self, stop_check=lambda done: self._early_stop(
            done - 1 if self._stepwise else done), chunkable=chunkable)
        if self.save_results:
            self.save_logs()

    def train_LSE_with_reference(self, xb=2.0, n_grid=200):
        """Supervised least-squares fit of the control against the
        reference control on a 1-d grid (pspde's, solver.py:384-418): L
        Adam steps on sum_n sum_x |-Z(x, t_n) - u_ref(x, t_n)|^2 dt, the
        losses into ``loss_log``."""
        assert self.approx_method == "control" and self.u_l2_error_flag
        X = torch.linspace(-xb, xb, n_grid, dtype=torch.float32,
                           device=self.device)[:, None]
        control_fn, u_ref = self._control_fn(), self._u_ref
        dt = float(np.float32(self.delta_t))
        for l in range(self.L):
            t0 = time.time()
            apply_lr(self.optimizer, self._lrs, l)
            loss = torch.zeros((), device=self.device)
            for n in range(self.N):
                Z, _ = control_fn(X, n, step_time(n, dt))
                loss = loss + torch.sum((-Z - u_ref(X, n)) ** 2) * dt
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            self.loss_log.append(float(loss.detach()))
            self.times.append(time.time() - t0)
            if self.verbose and l % self.print_every == 0:
                print("%d - loss: %.3e - time/iter: %.2fs"
                      % (l, self.loss_log[-1],
                         np.mean(self.times[-self.print_every:])))

    _LOG_ATTRS = ("loss_log", "u_L2_loss", "Y_0_log", "IS_rel_log",
                  "times", "particles_close_to_target",
                  "grads_rel_error_log")

    def save_logs(self, model_name="model", log_dir="logs") -> str:
        """pspde's JSON log (solver.py:283-311), its keys; ``params`` holds
        each trained module's state dict as nested lists."""
        os.makedirs(log_dir, exist_ok=True)
        logs = {
            "name": self.name, "date": self.date, "d": self.d, "T": self.T,
            "seed": self.seed, "delta_t": self.delta_t, "N": self.N,
            "lr": self.lr if not callable(self.lr) else lr_text(self.lr),
            "K": self.K, "loss_method": self.loss_method,
            "learn_Y_0": self.learn_Y_0,
            "adaptive_forward_process": self.adaptive_forward_process,
            "Y_0_log": self.Y_0_log, "loss_log": self.loss_log,
            "u_L2_loss": self.u_L2_loss,
            "params": {name: {k: v.detach().cpu().tolist()
                              for k, v in mod.state_dict().items()}
                       for name, mod in self._chunk_modules().items()},
        }
        path = os.path.join(log_dir, "%s_%s_%s.json"
                            % (model_name, self.name, self.date))
        i = 1
        while os.path.isfile(path):
            i += 1
            path = os.path.join(log_dir, "%s_%s_%s_%d.json"
                                % (model_name, self.name, self.date, i))
        with open(path, "w") as f:
            json.dump(logs, f, indent=2)
        return path
