"""``EigenSolver.estimate_lambda`` on a trained net against pspde's (CPU).

The net is ``pspde_torch/assets/fp_d5_refined_densenet.npz``: phase 21's
4000-step ``FokkerPlanckEigen(d=5)`` net after phase 38 (e)'s three stages
of ``eigen_power_refine``, written on the card by
``experiments/torch_fp_refined_net.py``, where the readout is lambda_hat
7.70e-3 (``tests/test_torch_eigen_train.py`` holds the readout on a
freshly initialised net, where it is ~7e-4).  Both packages load it; the
port's readout runs on JAX's own batches (fold_in(key, i) -> split -> kd,
kr: the domain points of kd, the noise normal(fold_in(kr, n), (K, d))),
on the scan and on 'fused_train' (on the CPU the stopped kernels' plain
versions on the batch's host noise).  lambda_hat and its error bar: rtol
1e-3, atol 1e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.fp_lambda_reference import ASSET, solver as jax_solver
from pspde.rollout.sampling import sample_domain as j_domain
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.solvers import EigenSolver as TSolver
from pspde_torch.utils.convert import flatten_tree, load_control_npz
from tests.torch_correctors import one_thread  # noqa: F401

D, N, KQ, N_BATCHES = 5, 20, 256, 3


@pytest.mark.parametrize("engine", ["scan", "fused_train"])
def test_estimate_lambda_on_the_refined_net_matches_jax(engine):
    js = jax_solver()
    tree = load_control_npz(ASSET)[0]
    # the asset is the flat tree of {'V': ..., 'lam': ...}
    with np.load(ASSET) as z:
        flat = flatten_tree(tree)
        assert sorted(flat) == sorted(z.files)
        assert all(np.array_equal(flat[k], z[k]) for k in z.files)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(tp.FokkerPlanckEigen(d=D, device="cpu"), "t", seed=42,
                     delta_t=1e-3, N=N, lr=1e-3, lr_lambda=0.01,
                     lambda_init=0.5, K=500, K_boundary=50,
                     alpha=(50.0, 1.0), normalization="center",
                     value_net=DenseNet(1, (10, 10, 10, 10), d_in=D,
                                        device="cpu"),
                     rollout_mode=engine, verbose=False, device="cpu")
        ts.load_jax_params(tree)
    ts.resolved_rollout_mode = engine
    # the same net in both packages
    X = torch.rand((64, D)) * 2 * np.pi
    np.testing.assert_allclose(
        ts.V(X).detach().numpy(),
        np.asarray(js.V_net.apply(js.params["V"], jnp.asarray(X.numpy()))
                   [:, 0]), rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(7)
    lam_j, se_j = js.estimate_lambda(K=KQ, n_batches=N_BATCHES, key=key)
    pj = js.problem
    batches = []
    for i in range(N_BATCHES):
        kd, kr = jax.random.split(jax.random.fold_in(key, i))
        X0 = np.array(j_domain(kd, pj.geometry, KQ, D))
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (KQ, D))) for n in range(N)])
        batches.append((torch.tensor(X0), torch.tensor(noise)))
    lam_t, se_t = ts.estimate_lambda(batches=batches)
    # a trained net: the readout is O(5e-3), not the fresh net's O(7e-4)
    assert abs(lam_j) > 2e-3
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(se_t, se_j, rtol=1e-3, atol=1e-6)
