"""The port's stopped-path rollout against pspde's (CPU).

``stopped_rollout`` (the scan engine) against pspde's ``stopped_rollout``,
and ``fused_stopped_train_rollout`` (on the CPU: its plain forward and the
hand-written ``_reference_stopped_backward``) against pspde's
``make_fused_stopped_train_rollout`` in interpret mode, on the same
DenseNet parameters (converted from the Flax tree) and the same noise
(``normal(fold_in(key, n), (K, d))`` made by JAX and given to both).

Tolerances are the JAX suite's (tests/test_fused_stopped.py:119-131,
193-194): X rtol 2e-5 atol 2e-6, Y rtol 2e-4 atol 1e-5, stopped and
hitting exact at this size, t 1e-6, gradients rtol 5e-3 atol 1e-5.  The
hand backward against autograd's double backward: rtol 1e-5 per leaf of
the leaf's largest entry (measured <= 6e-7: float32 reordering).
Sizes as the JAX suite: K=64, d=4, N=16, dt=0.01, DenseNet (8, 8).
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
from pspde_torch.ansatz import DenseNet, TanhMLP
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout import sde as tsde
from pspde_torch.rollout.sampling import inside_fn as t_inside
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax

K, D, N, DT = 64, 4, 16, 0.01
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5

PROBLEMS = {
    "sphere": ("ExponentialOnSphere", dict(d=D, alpha=0.5)),
    "nonlinear": ("ExponentialOnBallNonlinear", dict(d=D, alpha=0.5)),
    "sin": ("ExponentialOnBallNonlinearSin", dict(d=D, alpha=0.5)),
}


def _problems(case):
    cls, kw = PROBLEMS[case]
    return getattr(jp, cls)(**kw), getattr(tp, cls)(**kw, device="cpu")


def _setup(problem_j, seed=3, d_in=D):
    """Flax DenseNet (8, 8) params, the noise of key 11, X0 of key 5."""
    net = JDenseNet(d_out=1, arch=(8, 8))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d_in)))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n),
                                         (K, D), dtype=jnp.float32)
                       for n in range(N)])
    X0 = j_sample_domain(jax.random.PRNGKey(5), problem_j.geometry, K, D)
    return net, params, key, noise, X0


def _vg_j(problem, net):
    sig = problem.sigma_struct

    def fn(params, X, t):
        V, pull = jax.vjp(lambda x: net.apply(params, x)[:, 0], X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig.apply_T(gX)

    return fn


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _assert_outputs(port, ref, adv_steps=None):
    np.testing.assert_allclose(_np(port.X), _np(ref.X), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(port.Y), _np(ref.Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_array_equal(_np(port.stopped) > 0.5, _np(ref.stopped))
    np.testing.assert_array_equal(_np(port.hitting), _np(ref.hitting))
    np.testing.assert_allclose(_np(port.t), _np(ref.t), rtol=1e-6,
                               atol=1e-6)
    if adv_steps is not None:
        assert float(adv_steps.sum()) == float(ref.active_count)


@pytest.mark.parametrize("case,adaptive,with_v_ref", [
    ("sphere", False, True),
    ("sphere", True, False),
    ("sin", False, True),
    ("nonlinear", True, True),
])
def test_stopped_rollout_matches_jax_scan(case, adaptive, with_v_ref):
    pj, pt = _problems(case)
    net, params, key, noise, X0 = _setup(pj)
    cfg_kw = dict(N=N, delta_t=DT, adaptive_forward=adaptive,
                  detach_forward=True)
    ref = jsde.stopped_rollout(
        jsde.StoppedRolloutConfig(**cfg_kw), pj, _vg_j(pj, net), params, X0,
        jnp.zeros((K,)), jnp.zeros((K,)), key, j_inside(pj.geometry),
        v_ref=pj.v_ref if with_v_ref else None)
    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw), pt,
        tsde.value_and_z(tnet, pt.sigma_struct), torch.tensor(
            np.asarray(X0)), torch.zeros(K), torch.zeros(K),
        t_inside(pt.geometry), v_ref=pt.v_ref if with_v_ref else None,
        host_noise=torch.tensor(np.asarray(noise)))
    assert 0 < int(np.asarray(ref.stopped).sum()) < K
    _assert_outputs(out, ref)
    assert float(out.active_count) == float(ref.active_count)
    np.testing.assert_allclose(_np(out.v_l2), _np(ref.v_l2), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True])
def test_scan_diffusion_loss_gradients_match_jax(adaptive):
    """The diffusion loss mean((V(X_tau) - V(X_0) - Y)^2) through the scan,
    differentiated through Z = sigma^T grad V (second order), against
    jax.grad of pspde's scan."""
    pj, pt = _problems("sphere")
    net, params, key, noise, X0 = _setup(pj)
    cfg_kw = dict(N=N, delta_t=DT, adaptive_forward=adaptive,
                  detach_forward=True)

    def loss_j(prm):
        v_fn = lambda X: net.apply(prm, X)[:, 0]
        o = jsde.stopped_rollout(
            jsde.StoppedRolloutConfig(**cfg_kw), pj, _vg_j(pj, net), prm, X0,
            v_fn(X0), jnp.zeros((K,)), key, j_inside(pj.geometry))
        return jnp.mean((v_fn(o.X) - o.Y) ** 2)

    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    X0t = torch.tensor(np.asarray(X0))
    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw), pt,
        tsde.value_and_z(tnet, pt.sigma_struct), X0t, tnet(X0t)[:, 0],
        torch.zeros(K), t_inside(pt.geometry),
        host_noise=torch.tensor(np.asarray(noise)))
    l_t = torch.mean((tnet(out.X)[:, 0] - out.Y) ** 2)
    l_j, g_j = jax.value_and_grad(loss_j)(params)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


@pytest.mark.parametrize("loss_method,remat", [
    ("BSDE-2", False), ("BSDE-3", False), ("BSDE-3", True),
    ("no_y_update", False), ("attached_adaptive", False)])
def test_stopped_rollout_options_match_jax(loss_method, remat):
    """The recursive y_in_h with the BSDE-2 step loss, the BSDE-3 one-step
    residual (with and without per-step recomputation), no_y_update, and
    an adaptive forward that is not detached (the gradient flows through
    the X chain too): outputs, the step loss and its gradient."""
    pj, pt = _problems("sin")
    net, params, key, noise, X0 = _setup(pj)
    cfg_kw = dict(N=N, delta_t=DT, detach_forward=True, remat=remat,
                  alpha0=0.7)
    if loss_method == "no_y_update":
        cfg_kw["no_y_update"] = True
    elif loss_method == "attached_adaptive":
        cfg_kw.update(adaptive_forward=True, detach_forward=False)
    else:
        cfg_kw["step_loss"] = loss_method
        cfg_kw["recursive_y_in_h"] = loss_method == "BSDE-2"
    X0t = torch.tensor(np.asarray(X0))

    def loss_j(prm):
        Y0 = net.apply(prm, X0)[:, 0]
        o = jsde.stopped_rollout(
            jsde.StoppedRolloutConfig(**cfg_kw), pj, _vg_j(pj, net), prm, X0,
            Y0, jnp.zeros((K,)), key, j_inside(pj.geometry))
        return o.step_loss + jnp.mean(o.Y ** 2), o

    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    Y0 = tnet(X0t)[:, 0]
    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw), pt,
        tsde.value_and_z(tnet, pt.sigma_struct), X0t, Y0, torch.zeros(K),
        t_inside(pt.geometry),
        host_noise=torch.tensor(np.asarray(noise)))
    (l_j, ref), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    _assert_outputs(out, ref)
    np.testing.assert_allclose(_np(out.step_loss), float(ref.step_loss),
                               rtol=Y_RTOL, atol=Y_ATOL)
    l_t = out.step_loss + torch.mean(out.Y ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


class _ParabolicSphere(tp.Problem):
    """The port-side twin of pspde's ExponentialOnSphereNonlinearParabolic,
    for the time_stopping branch of the scan."""

    def __init__(self, d, T=1.0, alpha=0.5):
        super().__init__(d=d, T=T, device="cpu")
        self.alpha = alpha
        self._sigma = tp.DiffusionMatrix(np.sqrt(2.0) * np.eye(d),
                                         device="cpu")
        self.geometry = tp.Geometry(kind="sphere")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return torch.zeros_like(x)

    def h(self, t, x, y, z):
        r2 = torch.sum(x * x, dim=-1)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d) - y
                + torch.sin(torch.exp(2.0 * self.alpha * r2 + 2.0 * t)
                            - y ** 2))


def test_stopped_rollout_time_stopping_matches_jax():
    pj = jp.ExponentialOnSphereNonlinearParabolic(d=D, alpha=0.5, T=0.05)
    pt = _ParabolicSphere(D, T=0.05)
    net = JDenseNet(d_out=1, arch=(8, 8))
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, D + 1)))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n),
                                         (K, D), dtype=jnp.float32)
                       for n in range(N)])
    X0 = j_sample_domain(jax.random.PRNGKey(5), pj.geometry, K, D)
    t0 = jax.random.uniform(jax.random.PRNGKey(6), (K,)) * pj.T
    sig_j = pj.sigma_struct

    def vg_j(prm, X, t):
        V, pull = jax.vjp(lambda x: net.apply(
            prm, jnp.concatenate([x, t[:, None]], axis=-1))[:, 0], X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig_j.apply_T(gX)

    cfg_kw = dict(N=N, delta_t=DT, detach_forward=True, time_stopping=True)
    ref = jsde.stopped_rollout(jsde.StoppedRolloutConfig(**cfg_kw), pj, vg_j,
                               params, X0, jnp.zeros((K,)), t0, key,
                               j_inside(pj.geometry))
    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")

    def vg_t(X, t):
        with torch.enable_grad():
            Xg = X.detach().requires_grad_(True)
            V = tnet(torch.cat([Xg, t[:, None]], dim=-1))[:, 0]
            (gX,) = torch.autograd.grad(V.sum(), Xg, create_graph=True)
        return V, pt.sigma_struct.apply_T(gX)

    out = tsde.stopped_rollout(
        tsde.StoppedRolloutConfig(**cfg_kw), pt, vg_t,
        torch.tensor(np.asarray(X0)), torch.zeros(K),
        torch.tensor(np.asarray(t0)), t_inside(pt.geometry),
        host_noise=torch.tensor(np.asarray(noise)))
    assert int(np.asarray(ref.stopped).sum()) > 0
    _assert_outputs(out, ref)


def _jax_fused(pj, net, params, noise, adaptive, with_v_ref):
    sig = pj.sigma_struct
    treedef = jax.tree.structure(params)

    def terms(leaves, XT, t_row):
        prm = jax.tree.unflatten(treedef, list(leaves))
        V, pull = jax.vjp(lambda xT: transposed_apply(net, prm, xT)[0, :], XT)
        (gXT,) = pull(jnp.ones_like(V))
        ZT = sig.apply_T_cols(gXT)
        hv = pj.h_T(XT, V, ZT)
        return V.reshape(1, -1), ZT, hv.reshape(1, -1)

    return make_fused_stopped_train_rollout(
        pj, terms, tuple(jax.tree.leaves(params)), K, N, DT,
        inside_fn_T=inside_fn_cols(pj.geometry), adaptive_forward=adaptive,
        v_ref_T=pj.v_ref_T if with_v_ref else None, tile=32, interpret=True,
        host_noise=jnp.transpose(noise, (0, 2, 1)))


@pytest.mark.parametrize("case,adaptive", [("sphere", False),
                                           ("sphere", True),
                                           ("sin", False)])
def test_fused_stopped_matches_pallas_interpret(case, adaptive):
    """Outputs of the kernel pair's CPU path against the Pallas kernel in
    interpret mode, and the diffusion-loss gradient through both custom
    VJPs (Y_0 = V(X_0) and V(X_tau) outside, as the solvers add them)."""
    pj, pt = _problems(case)
    net, params, key, noise, X0 = _setup(pj)
    run = _jax_fused(pj, net, params, noise, adaptive, with_v_ref=True)
    treedef = jax.tree.structure(params)
    t0 = jnp.zeros((K,))

    def loss_j(lv):
        prm = jax.tree.unflatten(treedef, list(lv))
        v_fn = lambda X: net.apply(prm, X)[:, 0]
        o = run(lv, X0.T, t0, jnp.float32(0))
        return jnp.mean((v_fn(o.XT.T) - v_fn(X0) - o.Y) ** 2), o

    (l_j, oj), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        tuple(jax.tree.leaves(params)))
    tnet = dense_net_from_flax(jax.device_get(params), device="cpu")
    X0t = torch.tensor(np.asarray(X0))
    out = tk.fused_stopped_train_rollout(
        pt, tnet, X0t, torch.zeros(K), N, DT, adaptive_forward=adaptive,
        host_noise=torch.tensor(np.asarray(noise)))
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
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    g_j = jax.tree.unflatten(treedef, list(g_j))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


def _torch_setup(case, arch=(8, 8), seed=1, d=D, K_=K):
    _, pt = _problems(case) if d == D else (None, getattr(
        tp, PROBLEMS[case][0])(d=d, alpha=0.5, device="cpu"))
    net = DenseNet(1, arch, weight_scale=0.5, bias_init_value=0.1, d_in=d,
                   generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    rng = np.random.default_rng(seed)
    X0 = rng.standard_normal((K_, d)).astype(np.float32)
    X0 *= (rng.uniform(size=(K_, 1)) ** (1.0 / d)
           / np.linalg.norm(X0, axis=1, keepdims=True)).astype(np.float32)
    return pt, net, torch.from_numpy(X0)


@pytest.mark.parametrize("case,adaptive,arch,rng", [
    ("sphere", False, (8, 8), "erfinv"),
    ("sin", True, (8, 8), "binom"),
    ("nonlinear", False, (5, 3, 7, 2), "erfinv"),
    ("sin", True, (9,), "erfinv"),
])
def test_reference_backward_matches_double_backward(case, adaptive, arch,
                                                    rng):
    """The hand-written plain backward (tangent sweep + reverse sweep over
    the pair) against autograd's double backward through the plain
    forward, on the Philox stream."""
    pt, net, X0 = _torch_setup(case, arch)
    gY = torch.from_numpy(np.random.default_rng(4).standard_normal(
        K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng)
    out = tk.reference_stopped_train_rollout(pt, net, X0, torch.zeros(K), N,
                                             DT, 7, **kw)
    params = list(net.parameters())
    want = torch.autograd.grad(out.Y, params, gY)
    fam = tk._check_stopped_family(pt, net, rng)
    call = tk._StoppedCall(pt, net, X0, torch.zeros(K), N, DT, 7, fam,
                           dict(kw, host_noise=None), None)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-12
    # the wrapper's autograd.Function takes the same path on the CPU
    fo = tk.fused_stopped_train_rollout(pt, net, X0, torch.zeros(K), N, DT,
                                        7, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, params, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_stopped_noise_stream_and_outputs():
    """Without host noise the plain version draws train_normals(seed, ...);
    the same noise given as host noise gives the same outputs; adv_steps
    is hitting less the exit step."""
    pt, net, X0 = _torch_setup("sin")
    t0 = torch.zeros(K)
    for rng in ("erfinv", "binom"):
        a = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 5,
                                           rng=rng)
        noise = torch.stack([tk.train_normals(5, K, n, D, rng)
                             for n in range(N)])
        b = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT,
                                           host_noise=noise)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(a.adv_steps, a.hitting - a.stopped)
    assert a.X.shape == (K, D) and a.Y.shape == (K,)
    assert not a.X.requires_grad and a.Y.requires_grad


class _SquareSin(tp.ExponentialOnBallNonlinearSin):
    def __init__(self, d):
        super().__init__(d=d, device="cpu")
        self.geometry = tp.Geometry(kind="square")


class _DiagSigma(tp.ExponentialOnSphere):
    """A diag sigma with a horizon: the kernels take a dense sigma only
    without time_stopping."""

    def __init__(self, d):
        super().__init__(d=d, device="cpu")
        self.T = 1.0
        self._sigma = tp.DiffusionMatrix(np.diag(np.arange(1.0, d + 1)),
                                         device="cpu")


class _YZ(tp.ExponentialOnSphere):
    def h_family(self):
        return None


def test_stopped_family_errors():
    """Outside STOPPED_KERNEL_FAMILY the wrapper raises on the CPU as on
    CUDA, naming the family; the plain version takes any problem and net."""
    pt, net, X0 = _torch_setup("sin")
    t0 = torch.zeros(K)
    cases = [
        (dict(problem=_SquareSin(D)), "geometry"),
        (dict(problem=_DiagSigma(D), time_stopping=True), "not scalar"),
        (dict(problem=_YZ(d=D, device="cpu")), "h of"),
        (dict(v_net=TanhMLP(D, 1, device="cpu")), "not a DenseNet"),
        (dict(v_net=DenseNet(2, (4,), output_relu=True, d_in=D,
                             device="cpu")), "output_relu"),
        (dict(v_net=DenseNet(1, (4,) * 5, d_in=D, device="cpu")),
         "5 hidden"),
        (dict(rng="boxmuller"), "rng"),
        (dict(problem=tp.ExponentialOnSphereNonlinearParabolic(
            d=D, device="cpu"), time_stopping=True),
         f"need {D + 1}, 1, False"),
        (dict(lam=torch.zeros(())), "EigenSolver"),
        (dict(problem=tp.LLGC(d=D, device="cpu")), "drift"),
    ]
    for kw, match in cases:
        args = dict(problem=pt, v_net=net)
        args.update(kw)
        prob, v_net = args.pop("problem"), args.pop("v_net")
        with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
            tk.fused_stopped_train_rollout(prob, v_net, X0, t0, N, DT, **args)
        assert match in str(e.value)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT,
                                       host_noise=torch.zeros(N, K, D + 1))
    with pytest.raises(ValueError, match="tile"):
        tk._stopped_tile(100, 100, 128)
    out = tk.reference_stopped_train_rollout(_SquareSin(D), net, X0, t0, N,
                                             DT)
    assert torch.isfinite(out.Y).all()


@pytest.mark.parametrize("arch,backward,tile,stage", [
    ((30, 30), False, 64, True),
    ((30, 30), True, 64, True),
    ((70, 50, 50, 50), False, 16, True),
    ((70, 50, 50, 50), True, 32, False),
])
def test_pack_stopped_layout(arch, backward, tile, stage):
    """At d=50 the (30, 30) net is staged in shared memory; the notebook
    net DenseNet(70, 50, 50, 50) (131 KB of weights) is staged by the
    forward's blocks of 16 lanes (of 16 threads) and read from device
    memory by the backward, which drops to 32 paths per block.  The
    gradient row maps back onto the parameters."""
    d = 50
    pt = tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.1, device="cpu")
    net = DenseNet(1, arch, d_in=d, generator=torch.Generator().manual_seed(
        0), device="cpu")
    fam = tk._check_stopped_family(pt, net, "erfinv")
    packed = tk._pack_stopped(pt, net, *fam, 65536, 20, 1e-3, None,
                              backward=backward, host_noise=None,
                              adaptive_forward=False, rng="erfinv")
    ia = packed.iargs
    # StoppedArgs' 38 ints and 13 floats, then StoppedExt's 4 and 10
    assert len(ia) == 16 + 4 * tk._MAX_HIDDEN + 6 + 4
    assert len(packed.fargs) == 13 + 10
    assert ia[14:16] == [0, 0]    # no clock, the sphere
    assert ia[-4:-2] == [-1, 0]   # no dense sigma, the exp reference
    assert ia[-2:] == [0, 0]      # relu^2 features, no Schroedinger h
    assert (ia[5], ia[6]) == (tile, int(stage))
    lay = tk._stopped_layout(net)
    assert lay.F == d + sum(arch) and ia[4] == lay.F
    n_params = sum(p.numel() for p in net.parameters())
    assert lay.n_grad == n_params == ia[13]
    # the packed buffer holds W as (in, out), padded to 8 columns
    wp = -(-arch[0] // 8) * 8
    W0 = packed.params[lay.w_off[0]:lay.w_off[0] + d * wp].reshape(d, wp)
    torch.testing.assert_close(W0[:, :arch[0]], net.layers[0].weight.T)
    row = torch.arange(lay.n_grad, dtype=torch.float32)
    grads = tk._stopped_grads_from_row(net, lay, row)
    flat = torch.cat([g.T.reshape(-1) if g.dim() == 2 and i % 2 == 0
                      and i < len(grads) - 2 else g.reshape(-1)
                      for i, g in enumerate(grads)])
    assert [g.shape for g in grads] == [p.shape for p in net.parameters()]
    torch.testing.assert_close(torch.sort(flat).values, row)
