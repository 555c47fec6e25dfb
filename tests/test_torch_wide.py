"""The HJB-family kernels past d ~ 200: the two memory plans (CPU).

A block of the serve and training kernels stages the net beside each of
its paths' arrays in shared memory (the shared plan).  At d=1000
(BASELINE config 5) that fits no tile, so the packers choose the device
plan: the net read from device memory, the per-path arrays in a [row][K]
workspace.  These tests pin the choice and its arguments, that the shared
plan at d=100 keeps its tile and bytes, and that 3 port ``HJBSolver``
steps at config 5's width match 3 JAX ``_build_step(0)`` steps on each
step's JAX noise (tolerances of tests/test_torch_hjb_train.py: loss and
u_L2 rtol 1e-3, z parameters atol 2e-5).  The kernels themselves run on
the card (chip_smoke.py phase 13); on the CPU the wrappers run their
plain versions.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.solvers import HJBSolver as JSolver
from pspde_torch.ansatz import TanhMLP
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.utils.convert import tanh_mlp_state_dict

TRAJ_RTOL, PARAM_ATOL = 1e-3, 2e-5


def _setup(d, N=200):
    pt = tp.LLGC(d=d, T=2.0, device="cpu")
    net = TanhMLP(d + 1, d, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    u_tab = torch.zeros((N, d))   # the table's values do not change packing
    return pt, net, u_tab


def _pack_train(pt, net, u_tab, K, backward, plan=None, N=200):
    fam = tk._check_train_family(pt, net, N, 1.0, u_tab, "binom")
    return tk._pack_train(
        pt, net, *fam, K, N, 0.01, None, backward=backward, host_noise=None,
        noise_sign=1.0, adaptive_forward=True, accumulate_kl=False,
        kl_ito_term=False, u_tab=u_tab, rng="binom", plan=plan)


def _pack_serve(pt, net, K, plan=None):
    drift, cost = tk._check_family(pt, net, True, 1.0)
    return tk._pack(pt, net, drift, cost, K, 200, 0.01, None, None, 1.0,
                    plan)


def test_packers_choose_the_device_plan_at_d1000():
    """At d=1000 no tile's block fits: the forward (and the serve kernel,
    which runs the forward's block) would need 563,232 bytes at tile 32,
    the backward 983,392.  Each packer chooses the device plan and a
    workspace of its per-path floats times K rounded up to tile 64; the
    serve at K=1000, which leaves the card idle, with 4 threads a path."""
    pt, net, u_tab = _setup(1000)
    K = 98304
    for backward, per_path in ((False, 2 * 1000 + 64),
                               (True, 3 * 1000 + 2 * 64)):
        p = _pack_train(pt, net, u_tab, K, backward)
        assert tk._plan_of(p) == "device"
        assert p.iargs[5] == 64 and p.iargs[-2:] == [1, K]
        assert p.ws_floats == per_path * K
        assert p.iargs[13] == 67120   # the net and X_0, read from P
    p = _pack_serve(pt, net, 1000)
    assert tk._plan_of(p) == "device"
    assert p.iargs[5] == 64 and p.iargs[-3:] == [4, 1, 1024]
    assert p.ws_floats == (2 * 1000 + 64) * 1024


def test_packers_keep_the_shared_plan_at_d100():
    """At d=100 both plans are on the card; the packers keep the shared
    plan with tile 64 and 7,856 staged floats in the packed prefix.  Both
    kernels' rows are at stride 68 for their mma fragment loads: the
    forward's block (the net staged in fragment order, 7,880 floats, and
    the exchange of its sums, three in each of 4 classes a path) takes
    108,576 bytes, two blocks an SM; the backward's 182,112 bytes, one
    block."""
    pt, net, u_tab = _setup(100, N=32)
    for backward, per_path, nbytes in ((False, 2 * 104 + 64, 108576),
                                       (True, 3 * 104 + 2 * 64, 182112)):
        p = _pack_train(pt, net, u_tab, 131072, backward, N=32)
        assert tk._plan_of(p) == "shared" and p.ws_floats == 0
        assert p.iargs[5] == 64 and p.iargs[13] == 7856
        assert p.iargs[-2:] == [0, 0]
        fixed = 7856 + p.iargs[21] if backward else 7880 + 3 * 4 * 64
        smem = tk._train_smem_bytes(fixed, per_path, 64)
        assert smem == nbytes <= tk._SMEM_LIMIT
    p = _pack_serve(pt, net, 2 ** 20)   # the forward's block, 64 x 4
    assert tk._plan_of(p) == "shared" and p.iargs[5] == 64
    assert p.iargs[-3] == 4
    # the device plan can be forced, at the same tile
    p = _pack_train(pt, net, u_tab, 1000, False, plan="device", N=32)
    assert tk._plan_of(p) == "device" and p.iargs[5] == 64
    assert p.iargs[-2:] == [1, 1024]


def test_plan_errors():
    pt, net, u_tab = _setup(1000)
    with pytest.raises(ValueError, match="plan='shared'.*the kernel covers"):
        _pack_train(pt, net, u_tab, 1024, False, plan="shared")
    with pytest.raises(ValueError, match="plan='shared'.*the kernel covers"):
        _pack_serve(pt, net, 1024, plan="shared")
    with pytest.raises(ValueError, match="32-bit indices"):
        _pack_train(pt, net, u_tab, 2 ** 20, False)
    with pytest.raises(ValueError, match="plan="):
        tk.fused_train_rollout(pt, net, 8, 200, 0.01, u_tab=u_tab,
                               plan="global")
    with pytest.raises(ValueError, match="plan="):
        tk.fused_controlled_rollout(pt, net, 8, 200, 0.01, plan="global")


def test_wrappers_take_a_plan_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions whatever the
    plan."""
    pt = tp.LLGC(d=8, T=0.03, device="cpu")
    net = TanhMLP(9, 8, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    a = tk.fused_controlled_rollout(pt, net, 16, 3, 0.01, seed=2,
                                    plan="device")
    b = tk.reference_controlled_rollout(pt, net, 16, 3, 0.01, seed=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = tk.fused_train_rollout(pt, net, 16, 3, 0.01, 2, plan="device")
    e = tk.reference_train_rollout(pt, net, 16, 3, 0.01, 2)
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(c, e))


def test_three_config5_width_steps_match_jax():
    """LLGC d=1000 (config 5's width) with N=8 steps of dt=0.01, K=32:
    the port's fused_train step (its plain version on the CPU) against
    JAX's step on the same noise."""
    d, K, steps = 1000, 32, 3
    kw = dict(lr=1e-2, L=steps, K=K, delta_t=0.01, time_approx="inner",
              loss_method="log-variance", detach_forward=True,
              learn_Y_0=True, verbose=False, early_stopping_time=None)
    js = JSolver("j", jp.LLGC(d=d, T=0.08), **kw)
    N = js.N
    assert N == 8
    step = jax.jit(js._build_step(0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver("t", tp.LLGC(d=d, T=0.08, device="cpu"),
                     rollout_mode="fused_train", device="cpu", **kw)
        ts.load_jax_params(jax.device_get(js.params))
    ts.resolved_rollout_mode = "fused_train"
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(5)
    j_loss, j_ul2 = [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (K, d), dtype=jnp.float32))
            for n in range(N)])
        params, opt, m = step(params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        ts.step(host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.u_L2_loss, j_ul2, rtol=TRAJ_RTOL)
    want = tanh_mlp_state_dict(jax.device_get(params["z"]))
    got = ts.z_net.state_dict()
    for name, val in want.items():
        np.testing.assert_allclose(got[name].numpy(), val.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
