"""HJB / parabolic path-space solver (counterpart of
``pspde/solvers/hjb.py:HJBSolver``), the part that holds a model.

Ported: the constructor for ``approx_method='control'`` with the 'inner'
time approximation (the TanhMLP control net on [t, X] and the learnable
Y_0), ``_control_fn``, ``Z_n`` / ``u``, and ``load_jax_params`` to serve a
control trained by the JAX package.  Training is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ansatz import ScalarParam, TanhMLP
from ..utils.convert import (load_control_npz, scalar_param_from_flax,
                             tanh_mlp_from_flax)


class HJBSolver:
    """Holds the control model of a parabolic/HJB problem.

    Constructor arguments mirror ``pspde.solvers.HJBSolver``; the port
    adds ``device=``.  Parameters are initialised from a
    ``torch.Generator`` seeded with ``seed`` (N(0, 0.01) weights and
    biases, Y_0 = 0), not from the JAX initialisation: load trained
    parameters with ``load_jax_params``.
    """

    def __init__(self, name, problem, lr=0.001, L=10000, K=50, delta_t=0.05,
                 approx_method="control", loss_method="log-variance",
                 time_approx="outer", learn_Y_0=False,
                 adaptive_forward_process=True, detach_forward=False,
                 early_stopping_time=10000, seed=42, verbose=True,
                 control_net=None, lr_y0=None, device=None, **kwargs):
        if approx_method != "control":
            raise NotImplementedError(
                f"approx_method={approx_method!r} is not ported to "
                "pspde_torch yet (ROADMAP.md, Queue 1 item 6)")
        if time_approx != "inner":
            raise NotImplementedError(
                f"time_approx={time_approx!r} is not ported to pspde_torch "
                "yet (ROADMAP.md, Queue 1 item 6); use 'inner'")
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
        self.loss_method = loss_method
        self.approx_method = approx_method
        self.time_approx = time_approx
        self.learn_Y_0 = learn_Y_0
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.early_stopping_time = early_stopping_time
        self.verbose = verbose
        # options of the JAX solver that only training reads
        self.train_options = dict(kwargs)
        self.device = (problem.X_0.device if device is None
                       else torch.device(device))

        gen = torch.Generator().manual_seed(int(seed))
        if control_net is None:
            control_net = TanhMLP(self.d + 1, self.d, generator=gen)
        self.z_net = control_net.to(self.device)
        self.y0_net = ScalarParam(initial=0.0, device=self.device)

    def train(self):
        raise NotImplementedError(
            "HJBSolver.train is not ported to pspde_torch yet (ROADMAP.md, "
            "Queue 1 items 4-6 and Queue 2 item 1: the training step and "
            "its fused forward/backward kernels); train with pspde and "
            "load the parameters with load_jax_params")

    def _control_fn(self):
        """(X, n, t) -> (Z, None): the 'inner' control Z = net([t, X])."""
        net = self.z_net

        def fn(X, n, t):
            tX = torch.cat([torch.full((X.shape[0], 1), float(t),
                                       dtype=X.dtype, device=X.device), X],
                           dim=1)
            return net(tX), None

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

    def load_jax_params(self, tree_or_npz):
        """Load a JAX ``HJBSolver.params`` tree ({'z': ..., 'y0': ...},
        nested dicts of arrays) or the path of an exported ``.npz``.
        Returns the asset's metadata (empty for a tree)."""
        meta = {}
        tree = tree_or_npz
        if isinstance(tree_or_npz, str):
            tree, meta = load_control_npz(tree_or_npz)
        self.z_net = tanh_mlp_from_flax(tree["z"], device=self.device)
        if "y0" in tree:
            self.y0_net = scalar_param_from_flax(tree["y0"],
                                                 device=self.device)
        return meta
