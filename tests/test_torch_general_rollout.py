"""The time_stopping branch of the port's stopped rollout against pspde's
(CPU).

``stopped_rollout(time_stopping=True)`` with the space-time
``value_and_z`` (the net reads [X, t], Z is the gradient in x only)
against pspde's scan; ``fused_stopped_train_rollout(time_stopping=True)``
(on the CPU: its plain forward and the hand-written
``_reference_stopped_backward`` with t) against pspde's
``make_fused_stopped_train_rollout(time_stopping=True)`` in interpret mode,
outputs and diffusion-loss gradients; the hand backward against autograd's
double backward through the port's scan; the family check and the packed
arguments.  The DenseNet parameters are converted from the Flax tree and
the noise ``normal(fold_in(key, n), (K, d))`` is made by JAX and given to
both.

Tolerances are the JAX suite's (tests/test_fused_stopped.py:119-131,
193-194): X rtol 2e-5 atol 2e-6, Y rtol 2e-4 atol 1e-5; t, stopped and
hitting exact; gradients rtol 5e-3 atol 1e-5.  The hand backward against
autograd: 1e-5 of each leaf's largest entry.  Sizes: K=64, N=12, dt=0.01,
d = 3 and 5 (neither a multiple of 4), DenseNet (6, 5); T=0.15, so that
some paths leave the ball, some run out of time and some do neither.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.ansatz.transposed import transposed_apply
from pspde.rollout import sde as jsde
from pspde.rollout.kernels import make_fused_stopped_train_rollout
from pspde.rollout.sampling import inside_fn as j_inside, inside_fn_cols
from pspde.rollout.sampling import sample_domain as j_sample_domain
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout import sde as tsde
from pspde_torch.rollout.sampling import inside_fn as t_inside
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax
from tests.torch_outside_family import _TanhH

K, N, DT, T_END, ARCH = 64, 12, 0.01, 0.15, (6, 5)
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5

PROBLEMS = {
    "nonlinear": ("ExponentialOnSphereNonlinearParabolic",
                  dict(alpha=0.5, T=T_END)),
    "linear": ("ExponentialOnSphereParabolic", dict(alpha=0.5, T=T_END)),
    "heat": ("HeatEquation", dict(T=T_END)),
}


def _problems(case, d):
    cls, kw = PROBLEMS[case]
    return getattr(jp, cls)(d=d, **kw), getattr(tp, cls)(d=d, device="cpu",
                                                          **kw)


def _setup(pj, seed=3):
    """Flax DenseNet (6, 5) params of input width d + 1, the noise of key
    11, X0 and t0 of key 5."""
    d = pj.d
    net = JDenseNet(d_out=1, arch=ARCH)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d + 1)))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n), (K, d),
                                         dtype=jnp.float32)
                       for n in range(N)])
    kx, kt = jax.random.split(jax.random.PRNGKey(5))
    X0 = j_sample_domain(kx, pj.geometry, K, d)
    t0 = jax.random.uniform(kt, (K,)) * pj.T
    return net, params, key, noise, X0, t0


def _vg_j(problem, net):
    sig = problem.sigma_struct

    def fn(params, X, t):
        V, pull = jax.vjp(lambda x: net.apply(
            params, jnp.concatenate([x, t[:, None]], axis=-1))[:, 0], X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig.apply_T(gX)

    return fn


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _assert_outputs(port, X, Y, t, stopped, hitting):
    np.testing.assert_allclose(_np(port.X), np.asarray(X), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(port.Y), np.asarray(Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_array_equal(_np(port.t), np.asarray(t))
    np.testing.assert_array_equal(_np(port.stopped) > 0.5,
                                  np.asarray(stopped) > 0.5)
    np.testing.assert_array_equal(_np(port.hitting), np.asarray(hitting))


def _assert_mixed_exits(pj, stopped, t, X):
    """Some paths ran out of time, and on the ball some left it."""
    stopped, t = np.asarray(stopped) > 0.5, np.asarray(t)
    out_of_time = stopped & (t + np.float32(DT) > np.float32(pj.T))
    assert 0 < out_of_time.sum() < K
    if pj.geometry.bounded:
        assert (np.linalg.norm(np.asarray(X), axis=1) >= 1.0).sum() > 0
        assert (~stopped).sum() > 0


@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("case,adaptive", [("nonlinear", False),
                                           ("nonlinear", True),
                                           ("linear", False),
                                           ("heat", False)])
def test_scan_time_stopping_matches_jax_scan(case, adaptive, d):
    pj, pt = _problems(case, d)
    net, params, key, noise, X0, t0 = _setup(pj)
    cfg_kw = dict(N=N, delta_t=DT, adaptive_forward=adaptive,
                  detach_forward=True, time_stopping=True)
    ref = jsde.stopped_rollout(
        jsde.StoppedRolloutConfig(**cfg_kw), pj, _vg_j(pj, net), params, X0,
        jnp.zeros((K,)), t0, key, j_inside(pj.geometry))
    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw), pt,
        tsde.value_and_z(tnet, pt.sigma_struct, space_time=True),
        torch.tensor(np.asarray(X0)), torch.zeros(K),
        torch.tensor(np.asarray(t0)), t_inside(pt.geometry),
        host_noise=torch.tensor(np.asarray(noise)))
    _assert_mixed_exits(pj, ref.stopped, ref.t, ref.X)
    _assert_outputs(out, ref.X, ref.Y, ref.t, ref.stopped, ref.hitting)
    assert float(out.active_count) == float(ref.active_count)


def test_value_and_z_space_time_and_z_free():
    """Z is sigma^T times the gradient in the first d inputs; the Z-free
    variant returns the same V and zeros."""
    d = 3
    net = DenseNet(1, ARCH, weight_scale=0.5, d_in=d + 1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    sig = tp.HeatEquation(d=d, device="cpu").sigma_struct
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=8).astype(np.float32))
    V, Z = tsde.value_and_z(net, sig, space_time=True)(X, t)
    XT = torch.cat([X, t[:, None]], dim=-1).requires_grad_(True)
    (g,) = torch.autograd.grad(net(XT)[:, 0].sum(), XT)
    torch.testing.assert_close(V, net(XT)[:, 0])
    torch.testing.assert_close(Z.detach(), sig.apply_T(g[:, :d]))
    assert float(g[:, d].abs().max()) > 0
    V0, Z0 = tsde.value_and_z(net, sig, space_time=True, z_free=True)(X, t)
    torch.testing.assert_close(V0, V)
    assert Z0.shape == X.shape and float(Z0.abs().max()) == 0.0


def _jax_fused(pj, net, params, noise, adaptive):
    sig = pj.sigma_struct
    treedef = jax.tree.structure(params)

    def terms(leaves, XT, t_row):
        prm = jax.tree.unflatten(treedef, list(leaves))

        def v_of_xT(xT):
            return transposed_apply(
                net, prm, jnp.concatenate([xT, t_row], axis=0))[0, :]

        V, pull = jax.vjp(v_of_xT, XT)
        (gXT,) = pull(jnp.ones_like(V))
        ZT = sig.apply_T_cols(gXT)
        hv = pj.h_T(t_row[0, :], XT, V, ZT)
        return V.reshape(1, -1), ZT, hv.reshape(1, -1)

    return make_fused_stopped_train_rollout(
        pj, terms, tuple(jax.tree.leaves(params)), K, N, DT,
        inside_fn_T=inside_fn_cols(pj.geometry), adaptive_forward=adaptive,
        time_stopping=True, tile=32, interpret=True,
        host_noise=jnp.transpose(noise, (0, 2, 1)))


@pytest.mark.parametrize("case,adaptive,d", [("nonlinear", False, 3),
                                             ("nonlinear", True, 5),
                                             ("heat", False, 5),
                                             ("heat", True, 3)])
def test_fused_time_stopping_matches_pallas_interpret(case, adaptive, d):
    """Outputs of the kernel pair's CPU path against the Pallas kernel in
    interpret mode, and the diffusion-loss gradient through both custom
    VJPs (Y_0 = V(X_0, t_0) and V(X_tau, t_tau) outside, as the solvers add
    them)."""
    pj, pt = _problems(case, d)
    net, params, key, noise, X0, t0 = _setup(pj)
    run = _jax_fused(pj, net, params, noise, adaptive)
    treedef = jax.tree.structure(params)

    def loss_j(lv):
        prm = jax.tree.unflatten(treedef, list(lv))
        v_fn = lambda X, t: net.apply(
            prm, jnp.concatenate([X, t[:, None]], axis=-1))[:, 0]
        o = run(lv, X0.T, t0, jnp.float32(0))
        return jnp.mean((v_fn(o.XT.T, o.t) - v_fn(X0, t0) - o.Y) ** 2), o

    (l_j, oj), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        tuple(jax.tree.leaves(params)))
    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    X0t, t0t = torch.tensor(np.asarray(X0)), torch.tensor(np.asarray(t0))
    out = tk.fused_stopped_train_rollout(
        pt, tnet, X0t, t0t, N, DT, adaptive_forward=adaptive,
        host_noise=torch.tensor(np.asarray(noise)), time_stopping=True)
    _assert_mixed_exits(pj, oj.stopped, oj.t, oj.XT.T)
    _assert_outputs(out, oj.XT.T, oj.Y, oj.t, oj.stopped, oj.hitting)
    np.testing.assert_array_equal(_np(out.adv_steps), np.asarray(oj.adv_steps))
    assert float(out.v_l2.abs().max()) == 0.0     # no in-kernel reference

    def v_t(X, t):
        return tnet(torch.cat([X, t[:, None]], dim=-1))[:, 0]

    l_t = torch.mean((v_t(out.X, out.t) - v_t(X0t, t0t) - out.Y) ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    g_j = jax.tree.unflatten(treedef, list(g_j))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        assert a.shape == b.shape and a.shape[0] in (d + 1, d + 7, d + 12,
                                                     6, 5, 1)
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


def _torch_setup(case, d, arch=ARCH, seed=1):
    _, pt = _problems(case, d)
    net = DenseNet(1, arch, weight_scale=0.5, bias_init_value=0.1,
                   d_in=d + 1, generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    rng = np.random.default_rng(seed)
    X0 = rng.standard_normal((K, d)).astype(np.float32)
    X0 *= (rng.uniform(size=(K, 1)) ** (1.0 / d)
           / np.linalg.norm(X0, axis=1, keepdims=True)).astype(np.float32)
    t0 = (pt.T * rng.uniform(size=K)).astype(np.float32)
    return pt, net, torch.from_numpy(X0), torch.from_numpy(t0)


@pytest.mark.parametrize("case,adaptive,arch,rng,d", [
    ("nonlinear", False, (6, 5), "erfinv", 3),
    ("nonlinear", True, (6, 5), "binom", 5),
    ("linear", False, (5, 3, 7, 2), "erfinv", 5),
    ("heat", True, (9,), "erfinv", 3),
])
def test_reference_backward_with_t_matches_double_backward(case, adaptive,
                                                           arch, rng, d):
    """The hand-written plain backward (the primal sweep from [X, t], a
    zero in the tangent's t slot) against autograd's double backward
    through the port's scan, on the Philox stream."""
    pt, net, X0, t0 = _torch_setup(case, d, arch)
    gY = torch.from_numpy(np.random.default_rng(4).standard_normal(
        K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng, time_stopping=True)
    out = tk.reference_stopped_train_rollout(pt, net, X0, t0, N, DT, 7, **kw)
    params = list(net.parameters())
    # heat: h = 0, so Y reads grad V only and the output bias is unused
    want = [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, torch.autograd.grad(
                out.Y, params, gY, allow_unused=True))]
    fam = tk._check_stopped_family(pt, net, rng, time_stopping=True)
    call = tk._StoppedCall(pt, net, X0, t0, N, DT, 7, fam,
                           dict(kw, host_noise=None), None)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K or not pt.geometry.bounded
    assert float((out.t - t0).max()) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-12
    assert all(float(b.abs().max()) > 0 for b in want[:-1])
    # the wrapper's autograd.Function takes the same path on the CPU
    fo = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 7, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    torch.testing.assert_close(fo.t, out.t, rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, params, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_clock_stops_each_path_at_the_horizon():
    """A step advances only while fl(t + dt) <= T: on the unbounded heat
    problem every path takes min(N, steps its clock allows) steps, and
    without time_stopping the clock is returned as it came."""
    pt, net, X0, t0 = _torch_setup("heat", 3)
    out = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 5,
                                         time_stopping=True)
    dt = np.float32(DT)
    want_t, want_steps = [], []
    for t in t0.numpy():
        n = 0
        while n < N and np.float32(t + dt) <= np.float32(pt.T):
            t, n = np.float32(t + dt), n + 1
        want_t.append(t)
        want_steps.append(n)
    np.testing.assert_array_equal(out.t.numpy(), np.array(want_t))
    np.testing.assert_array_equal(out.adv_steps.numpy(),
                                  np.array(want_steps, dtype=np.float32))
    np.testing.assert_array_equal(out.stopped.numpy() > 0.5,
                                  np.array(want_steps) < N)
    ball, net_b, X0b, t0b = _torch_setup("linear", 3)
    net_x = DenseNet(1, ARCH, d_in=3, device="cpu")
    same = tk.fused_stopped_train_rollout(ball, net_x, X0b, t0b, N, DT, 5)
    torch.testing.assert_close(same.t, t0b, rtol=0, atol=0)
    assert float(same.adv_steps.max()) == N


class _NoHorizon(tp.ExponentialOnSphere):
    pass


def test_time_stopping_family_errors():
    """Outside STOPPED_KERNEL_FAMILY the wrapper raises on the CPU as on
    CUDA, naming the family: an h outside the 'ball_exp' family (tanh y), a
    net of input width d under time_stopping (and of width d + 1 without
    it), a problem without a horizon; the plain version takes that h, and
    AllenCahn's cubic h."""
    d = 3
    pt, net, X0, t0 = _torch_setup("nonlinear", d)
    net_x = DenseNet(1, ARCH, d_in=d, device="cpu")
    cases = [
        (_TanhH(d=d, device="cpu"), net, True, "h of _TanhH"),
        (pt, net_x, True, f"need {d + 1}, 1, False"),
        (pt, net, False, f"need {d}, 1, False"),
        (_NoHorizon(d=d, device="cpu"), net, True, "T=None"),
    ]
    for prob, v_net, timed, match in cases:
        with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
            tk.fused_stopped_train_rollout(prob, v_net, X0, t0, N, DT,
                                           time_stopping=timed)
        assert match in str(e.value)
    with pytest.raises(ValueError, match="EigenSolver"):
        tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT,
                                       time_stopping=True,
                                       lam=torch.zeros(()))
    assert "time_stopping" in tk.STOPPED_KERNEL_FAMILY
    assert "unbounded" in tk.STOPPED_KERNEL_FAMILY
    for prob in (_TanhH(d=d, device="cpu"), tp.AllenCahn(d=d, device="cpu")):
        out = tk.reference_stopped_train_rollout(prob, net, X0, t0, N, DT,
                                                 time_stopping=True)
        assert torch.isfinite(out.Y).all()


@pytest.mark.parametrize("d,arch,case,backward,smem", [
    (5, (6, 5), "nonlinear", False, None),
    (5, (6, 5), "heat", True, None),
    (50, (30, 30), "nonlinear", False, 4 * (4404 + 4 * 132 + 332 * 17)),
    (50, (30, 30), "nonlinear", True, 4 * (4 + 4404 + 514 * 68)),
    (50, (30, 30), "heat", True, 4 * (4 + 4404 + 514 * 68)),
])
def test_pack_stopped_time_stopping(d, arch, case, backward, smem):
    """State width d and net input width d + 1 part ways in the packed
    arguments: F and the hidden rows count from d_in, the first layer's
    gradient block has d + 2 rows (d + 1 inputs and the bias), and the
    horizon and h's time coefficient ride the float arguments.  At d=50,
    DenseNet (30, 30) the backward's 514 floats per path (at stride tile +
    4, after its 4 ballot words) fit tile 64 with the net staged; at
    K=4096 the forward spreads its paths over blocks of 16 lanes, its net
    staged with 4 pad floats a W row and 2 F + H + d floats a path."""
    cls, kw = PROBLEMS[case]
    pt = getattr(tp, cls)(d=d, device="cpu", **dict(kw, T=1.0))
    net = DenseNet(1, arch, d_in=d + 1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    fam = tk._check_stopped_family(pt, net, "erfinv", time_stopping=True)
    assert len(fam[0]) == 8 and fam[1] is None
    packed = tk._pack_stopped(pt, net, *fam, 4096, 20, 1e-3, None,
                              backward=backward, host_noise=None,
                              adaptive_forward=False, rng="erfinv",
                              time_stopping=True)
    ia, fa = packed.iargs, packed.fargs
    # StoppedArgs' ints and floats, then StoppedExt's 4 and 10
    assert len(ia) == 16 + 4 * tk._MAX_HIDDEN + 6 + 4 and len(fa) == 13 + 10
    lay = tk._stopped_layout(net)
    F, H = d + 1 + sum(arch), sum(arch)
    assert (ia[2], ia[4], ia[14]) == (d, F, 1)
    assert ia[15] == tk._GEOMETRIES.index(pt.geometry.kind)
    assert lay.F == F and ia[12] == 0           # no in-kernel reference
    assert fa[8] == 1.0 and fa[9] == fam[0][5]
    assert fa[9] == (2.0 if case == "nonlinear" else 0.0)
    n_params = sum(p.numel() for p in net.parameters())
    assert lay.n_grad == n_params == ia[13]
    assert lay.g_off[1] == (d + 2) * arch[0]
    per_path = 3 * F + 3 * H + 1 if backward else 2 * F + H + d
    assert (ia[5], ia[6]) == ((64, 1) if backward else (16, 1))
    if smem is not None:
        staged = ia[7] if backward else tk._stopped_fwd_net_floats(
            ia[7], list(arch), d + 1)
        assert tk._stopped_smem_bytes(staged, per_path, ia[5],
                                      backward) == smem
        assert smem <= tk._SMEM_LIMIT
    row = torch.arange(lay.n_grad, dtype=torch.float32)
    grads = tk._stopped_grads_from_row(net, lay, row)
    assert [g.shape for g in grads] == [p.shape for p in net.parameters()]
    # the t input's weights are row d of the first block
    torch.testing.assert_close(
        grads[0][:, d], row[d * arch[0]:(d + 1) * arch[0]])
    torch.testing.assert_close(
        grads[1], row[(d + 1) * arch[0]:(d + 2) * arch[0]])
    # without time_stopping the ball packs the x-only widths, and the
    # whole space is outside the family: no path would stop
    net_x = DenseNet(1, arch, d_in=d, device="cpu")
    if pt.geometry.bounded:
        fam_x = tk._check_stopped_family(pt, net_x, "erfinv")
        ia_x = tk._pack_stopped(pt, net_x, *fam_x, 4096, 20, 1e-3, None,
                                backward=backward, host_noise=None,
                                adaptive_forward=False, rng="erfinv").iargs
        assert (ia_x[4], ia_x[14], ia_x[15]) == (d + sum(arch), 0, 0)
    else:
        with pytest.raises(ValueError, match="no path would stop"):
            tk._check_stopped_family(pt, net_x, "erfinv")
