"""The stopped rollout's torus family (the eigen solver's domain leg)
against pspde's (CPU).

``FokkerPlanckEigen``: the square [0, 2 pi]^d whose exit is tested on the
proposal, the drift -cos(s) c sin(x), h = y (...) + lambda y.  The port's
plain stopped rollout on the lambda-shifted problem against pspde's
``stopped_rollout`` on ``_LambdaShiftedProblem``; the kernel pair's CPU
path (``fused_stopped_train_rollout`` with ``lam``: the plain forward and
the hand-written backward) against pspde's
``make_fused_stopped_train_rollout`` in interpret mode with
``EigenSolver._terms_math_T`` (lambda a leaf), outputs and the
diffusion-loss gradients with lambda's; the same DenseNet parameters
(converted from the Flax tree) and the same noise
(``normal(fold_in(key, n), (K, d))`` made by JAX and given to both).

Tolerances are the JAX suite's (tests/test_fused_stopped.py:224-286):
X rtol 2e-5 atol 2e-6, Y rtol 2e-4 atol 1e-5, stopped and hitting exact
at this size, gradients (lambda included) rtol 5e-3 atol 1e-5.  The hand
backward against autograd's double backward: 1e-5 of each leaf's largest
entry (float32 reordering; measured <= 1e-6), and the autograd.Function
path equal to it bit for bit.  Sizes: K=64, d=3 and 5, N=16, dt=0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.rollout import sde as jsde
from pspde.rollout.kernels import make_fused_stopped_train_rollout
from pspde.rollout.sampling import inside_fn as j_inside, inside_fn_cols
from pspde.rollout.sampling import sample_domain as j_sample_domain
from pspde.solvers import EigenSolver as JEigen
from pspde.solvers.eigen import _LambdaShiftedProblem as JShifted
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout import sde as tsde
from pspde_torch.rollout.sampling import inside_fn as t_inside
from pspde_torch.utils.convert import (eigen_params_from_flax,
                                       eigen_params_to_flax)

K, N, DT, LAM = 64, 16, 0.01, 0.3
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5

# the solver's default net (bias 0.8, the relu output clamp) and the FP
# notebook's (no clamp)
NETS = {"default": dict(bias_init_value=0.8, output_relu=True),
        "notebook": dict()}


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _setup(d, net_kw, seed=3):
    """The JAX eigen solver (its parameter tree, lambda = LAM), the noise
    of key 11 and X0 of key 5."""
    pj = jp.FokkerPlanckEigen(d=d)
    js = JEigen(pj, "j", seed=seed, L=1, K=K, N=N, delta_t=DT,
                lambda_init=LAM, verbose=False,
                value_net=JDenseNet(d_out=1, arch=(8, 8), **net_kw))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n),
                                         (K, d), dtype=jnp.float32)
                       for n in range(N)])
    X0 = j_sample_domain(jax.random.PRNGKey(5), pj.geometry, K, d)
    pt = tp.FokkerPlanckEigen(d=d, device="cpu")
    tnet, tlam = eigen_params_from_flax(
        jax.device_get(js.params), output_relu=bool(net_kw.get(
            "output_relu", False)), device="cpu")
    return pj, js, key, noise, X0, pt, tnet, tlam.Y_0


def _vg_j(js):
    sig = js.problem.sigma_struct

    def fn(prm, X, t):
        V, pull = jax.vjp(lambda x: js.V_net.apply(prm["V"], x)[:, 0], X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig.apply_T(gX)

    return fn


@pytest.mark.parametrize("net,adaptive", [("default", False),
                                          ("notebook", False),
                                          ("notebook", True)])
def test_shifted_scan_matches_jax(net, adaptive):
    """The port's stopped_rollout on the lambda-shifted torus problem (the
    plain version's forward) against pspde's: outputs, v_l2, and the
    diffusion-loss gradients of the net and of lambda."""
    d = 5
    pj, js, key, noise, X0, pt, tnet, tlam = _setup(d, NETS[net])
    cfg_kw = dict(N=N, delta_t=DT, adaptive_forward=adaptive,
                  detach_forward=True)
    zeros = jnp.zeros((K,))

    def loss_j(prm):
        o = jsde.stopped_rollout(
            jsde.StoppedRolloutConfig(**cfg_kw), JShifted(pj, js.lam(prm)),
            _vg_j(js), prm, X0, zeros, zeros, key, j_inside(pj.geometry),
            v_ref=pj.v_ref)
        v_fn = lambda X: js.V_net.apply(prm["V"], X)[:, 0]
        return jnp.mean((v_fn(o.X) - v_fn(X0) - o.Y) ** 2), o

    (l_j, ref), g_j = jax.value_and_grad(loss_j, has_aux=True)(js.params)
    X0t = torch.tensor(np.asarray(X0))
    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw),
        tsde.LambdaShiftedProblem(pt, tlam),
        tsde.value_and_z(tnet, pt.sigma_struct), X0t, torch.zeros(K),
        torch.zeros(K), t_inside(pt.geometry), v_ref=pt.v_ref,
        host_noise=torch.tensor(np.asarray(noise)))
    # the proposal's test stops some paths and leaves others running
    assert 0 < int(np.asarray(ref.stopped).sum()) < K
    np.testing.assert_allclose(_np(out.X), np.asarray(ref.X), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(out.Y), np.asarray(ref.Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_array_equal(_np(out.stopped), np.asarray(ref.stopped))
    np.testing.assert_array_equal(_np(out.hitting), np.asarray(ref.hitting))
    np.testing.assert_allclose(_np(out.v_l2), np.asarray(ref.v_l2),
                               rtol=2e-4, atol=1e-6)
    l_t = torch.mean((tnet(out.X)[:, 0] - tnet(X0t)[:, 0] - out.Y) ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()) + [tlam])
    got = eigen_params_to_flax(g_t[:-1], g_t[-1])
    assert abs(float(g_t[-1])) > 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


@pytest.mark.parametrize("d,net,adaptive", [(3, "default", False),
                                            (5, "notebook", False),
                                            (5, "notebook", True)])
def test_fused_eigen_matches_pallas_interpret(d, net, adaptive):
    """Outputs of the kernel pair's CPU path with lambda against the Pallas
    kernel in interpret mode with EigenSolver._terms_math_T, and the
    diffusion-loss gradients through both custom VJPs: the net's leaves and
    lambda's, which must be nonzero."""
    pj, js, key, noise, X0, pt, tnet, tlam = _setup(d, NETS[net])
    treedef = jax.tree.structure(js.params)
    leaves = tuple(jax.tree.leaves(js.params))
    run = make_fused_stopped_train_rollout(
        pj, js._terms_math_T(), leaves, K, N, DT,
        inside_fn_T=inside_fn_cols(pj.geometry), adaptive_forward=adaptive,
        v_ref_T=pj.v_ref_T, tile=32, interpret=True,
        host_noise=jnp.transpose(noise, (0, 2, 1)))
    zeros = jnp.zeros((K,))

    def loss_j(lv):
        prm = jax.tree.unflatten(treedef, list(lv))
        v_fn = lambda X: js.V_net.apply(prm["V"], X)[:, 0]
        o = run(lv, X0.T, zeros, jnp.float32(0))
        return jnp.mean((v_fn(o.XT.T) - v_fn(X0) - o.Y) ** 2), o

    (l_j, oj), g_j = jax.value_and_grad(loss_j, has_aux=True)(leaves)
    X0t = torch.tensor(np.asarray(X0))
    out = tk.fused_stopped_train_rollout(
        pt, tnet, X0t, torch.zeros(K), N, DT, adaptive_forward=adaptive,
        host_noise=torch.tensor(np.asarray(noise)), lam=tlam)
    assert 0 < int(np.asarray(oj.stopped).sum()) < K
    np.testing.assert_allclose(_np(out.X), np.asarray(oj.XT.T), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(out.Y), np.asarray(oj.Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    for name in ("stopped", "hitting", "adv_steps"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      np.asarray(getattr(oj, name)))
    np.testing.assert_allclose(_np(out.v_l2), np.asarray(oj.v_l2),
                               rtol=2e-4, atol=1e-6)
    l_t = torch.mean((tnet(out.X)[:, 0] - tnet(X0t)[:, 0] - out.Y) ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()) + [tlam])
    g_j = jax.tree.unflatten(treedef, list(g_j))
    # dict order {'V', 'lam'}: lambda's leaf is last in both flattenings
    assert abs(float(g_t[-1])) > 0.0
    got = eigen_params_to_flax(g_t[:-1], g_t[-1])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


def _torch_torus(d, arch, relu, out_bias, seed=1, K_=K):
    pt = tp.FokkerPlanckEigen(d=d, device="cpu")
    net = DenseNet(1, arch, output_relu=relu, d_in=d,
                   generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    with torch.no_grad():
        net.layers[-1].bias.fill_(out_bias)
    rng = np.random.default_rng(seed)
    X0 = torch.from_numpy(rng.uniform(0.0, 2.0 * np.pi, (K_, d)).astype(
        np.float32))
    return pt, net, X0


@pytest.mark.parametrize("d,arch,relu,out_bias,adaptive,rng", [
    (5, (10, 10, 10, 10), True, 0.8, False, "erfinv"),
    (5, (10, 10, 10, 10), False, 0.0, True, "binom"),
    (3, (7, 9), True, 0.3, True, "erfinv"),
    (6, (9,), True, -1.0, False, "binom"),
])
def test_reference_backward_lambda_clamp_matches_double_backward(
        d, arch, relu, out_bias, adaptive, rng):
    """The hand-written plain backward with lambda and the output clamp
    (the mask 1[V > 0] on both terms; d/dlambda = sum -gY adv V dt) against
    autograd's double backward through the plain forward, on the Philox
    stream."""
    pt, net, X0 = _torch_torus(d, arch, relu, out_bias)
    lam = torch.tensor([LAM], requires_grad=True)
    gY = torch.from_numpy(np.random.default_rng(4).standard_normal(
        K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng)
    out = tk.reference_stopped_train_rollout(pt, net, X0, torch.zeros(K), N,
                                             DT, 7, lam=lam, **kw)
    leaves = list(net.parameters()) + [lam]
    want = torch.autograd.grad(out.Y, leaves, gY)
    fam = tk._check_stopped_family(pt, net, rng, lam=lam)
    call = tk._StoppedCall(pt, net, X0, torch.zeros(K), N, DT, 7, fam,
                           dict(kw, host_noise=None), None, lam)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K
    if relu:   # the clamp is shut on some paths and open on others
        with torch.no_grad():
            V = net(X0)[:, 0]
        assert 0 < int((V > 0).sum()) < K
    assert abs(float(got[-1])) > 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-12
    # the wrapper's autograd.Function takes the same path on the CPU
    fo = tk.fused_stopped_train_rollout(pt, net, X0, torch.zeros(K), N, DT,
                                        7, lam=lam, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, leaves, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lambda_enters_affinely():
    """Y is affine in lambda at fixed V: Y(lam) = Y(0) - lam S with
    S = Y(0) - Y(1) on one seed (what estimate_lambda reads), and X, the
    masks and v_l2 do not depend on lambda."""
    pt, net, X0 = _torch_torus(5, (10, 10), True, 0.5)
    t0 = torch.zeros(K)
    outs = [tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 3,
                                           lam=torch.tensor([v]))
            for v in (0.0, 1.0, 0.37)]
    S = outs[0].Y - outs[1].Y
    torch.testing.assert_close(outs[2].Y, outs[0].Y - 0.37 * S, rtol=1e-5,
                               atol=1e-6)
    for name in ("X", "stopped", "hitting", "v_l2", "adv_steps"):
        torch.testing.assert_close(getattr(outs[0], name),
                                   getattr(outs[2], name), rtol=0, atol=0)
    # without lam the torus runs at lambda = 0
    none = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 3)
    torch.testing.assert_close(none.Y, outs[0].Y, rtol=0, atol=0)


class _OneSided(tp.FokkerPlanckEigen):
    def __init__(self, d):
        super().__init__(d=d, device="cpu")
        self.geometry = tp.Geometry(kind="square", X_l=0.0,
                                    X_r=2.0 * np.pi, one_boundary=True)


class _TorusSphere(tp.FokkerPlanckEigen):
    def __init__(self, d):
        super().__init__(d=d, device="cpu")
        self.geometry = tp.Geometry(kind="sphere", boundary_distance=2.0)


class _TorusBallH(tp.FokkerPlanckEigen):
    def h_family(self):
        return ("ball_exp", 1.0, 0.0, 0.0, "none")


def test_torus_family_errors():
    """Outside the torus family the wrapper raises naming the family: the
    Schrodinger problem with a relu^2 DenseNet (its family takes tanh
    features), a one-sided square, the
    torus drift on a sphere, another h, a non-uniform c, time_stopping, a
    lambda of two elements; the plain version takes them all."""
    d = 4
    pt, net, X0 = _torch_torus(d, (8,), True, 0.5)
    t0 = torch.zeros(K)
    nonuniform = tp.FokkerPlanckEigen(d=d, device="cpu")
    nonuniform.c = torch.linspace(0.1, 0.2, d)
    cases = [
        (dict(problem=tp.SchrodingerEigen(d=d, device="cpu")),
         "relu2 features"),
        (dict(problem=_OneSided(d)), "one-sided"),
        (dict(problem=_TorusSphere(d)), "geometry"),
        (dict(problem=_TorusBallH(d=d, device="cpu")), "'torus_fp'"),
        (dict(problem=nonuniform), "drift"),
        (dict(time_stopping=True), "time_stopping"),
    ]
    for kw, match in cases:
        args = dict(problem=pt, v_net=net)
        args.update(kw)
        prob, v_net = args.pop("problem"), args.pop("v_net")
        with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
            tk.fused_stopped_train_rollout(prob, v_net, X0, t0, N, DT, **args)
        assert match in str(e.value)
    with pytest.raises(ValueError, match="2 elements"):
        tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT,
                                       lam=torch.zeros(2))
    for prob in (tp.SchrodingerEigen(d=d, device="cpu"), _OneSided(d)):
        out = tk.reference_stopped_train_rollout(prob, net, X0, t0, N, DT,
                                                 lam=torch.tensor([0.5]))
        assert torch.isfinite(out.Y).all()


@pytest.mark.parametrize("backward,with_lam", [(False, True), (True, True),
                                               (True, False)])
def test_pack_stopped_torus(backward, with_lam):
    """The torus packs lambda into the net buffer after the output bias
    (not into the float arguments: no host sync per step), zero without a
    lambda leaf; the gradient row ends with d/dlambda; the square, c and the
    clamp reach the kernel's arguments; at d=5 with the notebook net the
    net is staged in shared memory, the backward's block 64 paths, the
    forward's at K=500 4 lanes of 16 threads."""
    d = 5
    pt, net, _ = _torch_torus(d, (10, 10, 10, 10), True, 0.8)
    lam = torch.tensor([0.25]) if with_lam else None
    fam = tk._check_stopped_family(pt, net, "erfinv", lam=lam)
    assert fam == (("torus_fp", float(np.float32(0.1))),) * 2
    packed = tk._pack_stopped(pt, net, *fam, 500, 20, 1e-3, None,
                              backward=backward, host_noise=None,
                              adaptive_forward=False, rng="erfinv", lam=lam)
    ia, fa = packed.iargs, packed.fargs
    # StoppedArgs' ints and floats, then StoppedExt's 4 and 10
    assert len(ia) == 16 + 4 * tk._MAX_HIDDEN + 6 + 4 and len(fa) == 13 + 10
    assert (ia[5], ia[6]) == ((64, 1) if backward else (4, 1))
    assert (ia[11], ia[12], ia[14], ia[15]) == (0, 1, 0, 2)
    relu, lam_off, g_lam = ia[-7:-4]
    lay = tk._stopped_layout(net, torch.zeros(1))
    n_net = sum(p.numel() for p in net.parameters())
    assert relu == 1 and (lam_off, g_lam) == (lay.lam_off, lay.g_lam)
    assert lam_off == lay.bL_off + 4 and ia[13] == n_net + 1 == g_lam + 1
    assert float(packed.params[lam_off]) == (0.25 if with_lam else 0.0)
    assert packed.params.numel() == lam_off + 4
    assert fa[10:13] == [0.0, float(2.0 * np.pi), float(np.float32(0.1))]
    # the gradient row: the net's leaves, then lambda's entry
    row = torch.arange(ia[13], dtype=torch.float32)
    grads = tk._stopped_grads_from_row(net, lay, row)
    assert [g.shape for g in grads] == [p.shape for p in net.parameters()]
    assert sum(g.numel() for g in grads) == g_lam
    assert max(float(g.max()) for g in grads) == g_lam - 1
