"""The Schroedinger eigen slice of the port against pspde's (CPU):
``SchrodingerEigen`` in the stopped kernels' Schroedinger family (zero
drift on the square [0, 2 pi]^d whose exit is tested on the proposal, h =
-y^3 - y pot(x) + lambda y, v_ref (1/c) exp((1/d) sum cos x_j)) with a
``DenseNetTanh`` value net.

* the family tuples, pot(x), h, dh/dy and v_ref against pspde's
  (rtol 1e-6);
* the kernel pair's CPU path (``fused_stopped_train_rollout`` with
  ``lam``: the plain forward and the hand-written backward) against
  pspde's ``make_fused_stopped_train_rollout`` in interpret mode with
  ``EigenSolver._terms_math_T``, on SchrodingerEigen(d=4), DenseNetTanh
  (8, 8) with and without the output clamp, adaptive or not: the same
  parameters (converted from the Flax tree) and the same noise (made by
  JAX, given to both).  Tolerances are the JAX suite's and the torus
  tests' (tests/test_torch_eigen_rollout.py): X rtol 2e-5 atol 2e-6, Y and
  v_l2 rtol 2e-4, stopped and hitting exact, gradients (lambda included)
  rtol 5e-3 atol 1e-5;
* the hand backward with tanh features and the Schroedinger dh/dy against
  autograd's double backward through the plain forward: 1e-5 of each
  leaf's largest entry (float32 reordering);
* the packer's appended fields (StoppedExt's feat, hfam and the four
  constants, rounded to float32 as JAX's weak types round them), the
  shared plan with tile 64 at the notebook's d=10 net, the device plan's
  raise, and the family errors;
* 20 ``EigenSolver`` steps with ``normalization='l2_penalty'`` against
  JAX's ``_build_step()`` on each step's injected draws, on 'scan' and on
  'fused_train' (the kernels' plain versions): the loss, lambda and V_L2
  trajectories rtol 2e-4, the parameters atol 2e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNetTanh as JDenseNetTanh
from pspde.rollout.kernels import make_fused_stopped_train_rollout
from pspde.rollout.sampling import inside_fn_cols
from pspde.rollout.sampling import sample_boundary_reflected as j_reflected
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EigenSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import (DenseNet, DenseNetRelu, DenseNetTanh,
                                DenseNetTanh2)
from pspde_torch.problems.eigen import schrodinger_pot
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import EigenSolver as TSolver
from pspde_torch.utils.convert import (eigen_params_from_flax,
                                       eigen_params_to_flax)

K, N, DT, LAM = 64, 16, 0.01, -2.5
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _points(d, n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0 * np.pi, (n, d)).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, (n,)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("d", [4, 10])
def test_family_and_terms_match_jax(d):
    """The family tuples carry pspde's c; h, dh/dy = -3 y^2 - pot(x) (the
    kernels' and the plain backward's, against jax.grad of pspde's h) and
    v_ref against pspde's, rtol 1e-6."""
    pj, pt = jp.SchrodingerEigen(d=d), tp.SchrodingerEigen(d=d, device="cpu")
    assert pt.drift_family() == ("zero", None)
    assert pt.h_family() == pt.v_ref_family() == ("schrodinger", pj.c)
    x, y = _points(d)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    z = jnp.zeros_like(x)
    h_j = np.asarray(pj.h(jnp.asarray(x), jnp.asarray(y), z))
    np.testing.assert_allclose(_np(pt.h(xt, yt, None)), h_j, rtol=1e-6,
                               atol=1e-6 * np.abs(h_j).max())
    dh_j = np.asarray(jax.vmap(jax.grad(
        lambda xi, yi: pj.h(xi[None], yi[None], z[:1])[0], argnums=1))(
            jnp.asarray(x), jnp.asarray(y)))
    dh_t = -3.0 * yt * yt - schrodinger_pot(xt, pt.c, d)
    np.testing.assert_allclose(_np(dh_t), dh_j, rtol=1e-6,
                               atol=1e-6 * np.abs(dh_j).max())
    # pot itself: h at y = 1 is -1 - pot
    pot_j = -1.0 - np.asarray(pj.h(jnp.asarray(x), jnp.ones_like(y), z))
    np.testing.assert_allclose(_np(pt.pot(xt)), pot_j, rtol=1e-6)
    np.testing.assert_allclose(_np(pt.v_ref(xt)),
                               np.asarray(pj.v_ref(jnp.asarray(x))),
                               rtol=1e-6)


def _setup(d, clamp, seed=3):
    """The JAX eigen solver on SchrodingerEigen(d) with DenseNetTanh
    (8, 8) (lambda = LAM), its parameters in the port, the noise of key
    11 and X0 of key 5."""
    pj = jp.SchrodingerEigen(d=d)
    js = JSolver(pj, "j", seed=seed, L=1, K=K, N=N, delta_t=DT,
                 lambda_init=LAM, verbose=False,
                 normalization="l2_penalty",
                 value_net=JDenseNetTanh(d_out=1, arch=(8, 8),
                                         output_relu=clamp))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n),
                                         (K, d), dtype=jnp.float32)
                       for n in range(N)])
    X0 = j_domain(jax.random.PRNGKey(5), pj.geometry, K, d)
    pt = tp.SchrodingerEigen(d=d, device="cpu")
    tnet, tlam = eigen_params_from_flax(jax.device_get(js.params),
                                        output_relu=clamp, device="cpu",
                                        cls=DenseNetTanh)
    return pj, js, noise, X0, pt, tnet, tlam.Y_0


@pytest.mark.parametrize("clamp,adaptive", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_fused_schrodinger_matches_pallas_interpret(clamp, adaptive):
    """Outputs of the kernel pair's CPU path with lambda against the Pallas
    kernel in interpret mode with EigenSolver._terms_math_T, and the
    diffusion-loss gradients through both custom VJPs: the net's leaves and
    lambda's, which must be nonzero."""
    d = 4
    pj, js, noise, X0, pt, tnet, tlam = _setup(d, clamp, seed=1 + adaptive)
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
    if clamp:   # the clamp is shut on some paths and open on others
        with torch.no_grad():
            V = tnet(X0t)[:, 0]
        assert 0 < int((V > 0).sum()) < K
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
    assert abs(float(g_t[-1])) > 0.0
    got = eigen_params_to_flax(g_t[:-1], g_t[-1])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


def _torch_sch(d, arch, clamp, out_bias, seed=1):
    pt = tp.SchrodingerEigen(d=d, device="cpu")
    net = DenseNetTanh(1, arch, output_relu=clamp, d_in=d,
                       generator=torch.Generator().manual_seed(seed),
                       device="cpu")
    with torch.no_grad():
        net.layers[-1].bias.fill_(out_bias)
    rng = np.random.default_rng(seed)
    X0 = torch.from_numpy(rng.uniform(0.0, 2.0 * np.pi, (K, d)).astype(
        np.float32))
    return pt, net, X0


@pytest.mark.parametrize("d,arch,clamp,out_bias,adaptive,rng", [
    (4, (8, 8), True, 0.5, False, "erfinv"),
    (4, (8, 8), False, 0.0, True, "binom"),
    (10, (15, 15, 15, 15), True, 0.2, True, "erfinv"),
    (3, (7,), False, -0.3, False, "binom"),
])
def test_reference_backward_matches_double_backward(d, arch, clamp, out_bias,
                                                    adaptive, rng):
    """The hand-written plain backward with tanh features (f' = (1 - f^2)
    h', f'' = -2 f (1 - f^2)), the Schroedinger dh/dy = -3 V^2 - pot + lambda
    and the output clamp against autograd's double backward through the
    plain forward, on the Philox stream; the autograd.Function path takes
    the same computation on the CPU."""
    pt, net, X0 = _torch_sch(d, arch, clamp, out_bias)
    lam = torch.tensor([LAM], requires_grad=True)
    gY = torch.from_numpy(np.random.default_rng(4).standard_normal(
        K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng)
    out = tk.reference_stopped_train_rollout(pt, net, X0, torch.zeros(K), N,
                                             DT, 7, lam=lam, **kw)
    leaves = list(net.parameters()) + [lam]
    want = torch.autograd.grad(out.Y, leaves, gY)
    fam = tk._check_stopped_family(pt, net, rng, lam=lam)
    assert fam == (("schrodinger", pt.c),) * 2
    call = tk._StoppedCall(pt, net, X0, torch.zeros(K), N, DT, 7, fam,
                           dict(kw, host_noise=None), None, lam)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K
    if clamp:
        with torch.no_grad():
            V = net(X0)[:, 0]
        assert 0 < int((V > 0).sum()) < K
    assert abs(float(got[-1])) > 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-12
    fo = tk.fused_stopped_train_rollout(pt, net, X0, torch.zeros(K), N, DT,
                                        7, lam=lam, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, leaves, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("backward", [False, True])
def test_pack_schrodinger(backward):
    """The Schroedinger family packs like the torus (geometry 2, the
    square, lambda after the output bias, its gradient entry last, no
    c_tor) and appends StoppedExt's feat = 1 (tanh), hfam = 1 and -1/c^2,
    1/c, 2/d, 1/d as float32 rounds the Python floats; at d=10 with the
    notebook's DenseNetTanh (15, 15, 15, 15) the backward keeps 3 F + 3 H
    + 1 = 391 floats a path and at K=500 takes the lanes kernel (the
    device plan, its general rule): 8 lanes of 16 threads, the arrays in
    shared memory at stride 12, the net staged (29,808 bytes a block);
    forced, the shared plan keeps tile 64 and stride 68, the net staged
    (101,660 bytes of arrays); and the forward at K=500 takes 4 lanes of
    16 threads, one block a tile."""
    d = 10
    pt, net, _ = _torch_sch(d, (15, 15, 15, 15), True, 0.0)
    lam = torch.tensor([-2.25])
    fam = tk._check_stopped_family(pt, net, "erfinv", lam=lam)
    packed = tk._pack_stopped(pt, net, *fam, 500, 20, 1e-3, None,
                              backward=backward, host_noise=None,
                              adaptive_forward=False, rng="erfinv", lam=lam)
    ia, fa = packed.iargs, packed.fargs
    ni, nf = tk._STOPPED_N_INTS, tk._STOPPED_N_FLOATS
    assert len(ia) == tk._STOPPED_N_PACKED_INTS == ni + 4
    assert len(fa) == nf + tk._STOPPED_N_EXT_FLOATS == nf + 10
    assert (ia[12], ia[14], ia[15]) == (1, 0, 2)   # v_ref, no clock, square
    assert ia[ni:] == [-1, 0, 1, 1]
    c = pt.c
    want = [-1.0 / c ** 2, 1.0 / c, 2.0 / d, 1.0 / d]
    assert fa[nf + 6:] == want
    assert (np.asarray(fa[nf + 6:], np.float32)
            == np.float32(want)).all()
    assert fa[10:13] == [0.0, float(2.0 * np.pi), 0.0]   # X_l, X_r, c_tor
    lay = tk._stopped_layout(net, lam)
    relu, lam_off, g_lam = ia[ni - 3:ni]
    assert relu == 1 and (lam_off, g_lam) == (lay.lam_off, lay.g_lam)
    assert float(packed.params[lam_off]) == -2.25
    assert tk._stopped_instance(packed)[-2:] == (1, 1)
    F, H = lay.F, lay.F - d
    assert (F, H) == (70, 60)
    if backward:
        assert packed.layout == ("device", 16, 1) and (ia[5], ia[6]) == (8, 1)
        per_path = tk._stopped_bwd_per_path(packed)
        assert per_path == 3 * F + 3 * H + 1 == 391
        assert tk._stopped_bwd_ts(packed, 63) == 12
        assert tk._stopped_bwd_smem(packed, 12) == 29808
        for plan, want in (("device", ("device", 16, 1)),
                           ("shared", ("shared",))):
            forced = tk._pack_stopped(pt, net, *fam, 500, 20, 1e-3, None,
                                      backward=True, host_noise=None,
                                      adaptive_forward=False, rng="erfinv",
                                      lam=lam, plan=plan)
            assert forced.layout == want
        assert (forced.iargs[5], forced.iargs[6]) == (64, 1)
        assert tk._stopped_bwd_ts(forced) == 68
        assert 4 * per_path * 65 == 101660
    else:
        assert tk._FwdLayout(*packed.layout) == (4, 16, False)


def test_schrodinger_family_errors():
    """Outside the family the wrapper raises naming it: relu^2 features on
    the Schroedinger family, and DenseNetRelu (the d=10 notebook's --net
    relu) and DenseNetTanh2 there, tanh features on the ball and on the
    torus (ROADMAP.md Queue 2 item 4(g)), a one-sided square, a v_ref of
    another c; the plain version takes them."""
    d = 4
    pt, net, X0 = _torch_sch(d, (8,), True, 0.5)
    t0 = torch.zeros(K)
    lam = torch.tensor([LAM])
    relu2 = DenseNet(1, (8,), d_in=d, device="cpu")
    ball = tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.1, device="cpu")
    fp = tp.FokkerPlanckEigen(d=d, device="cpu")
    one_sided = tp.SchrodingerEigen(d=d, device="cpu")
    one_sided.geometry = tp.Geometry(kind="square", X_l=0.0,
                                     X_r=2.0 * np.pi, one_boundary=True)
    other_c = tp.SchrodingerEigen(d=d, device="cpu")
    other_c.v_ref_family = lambda: ("schrodinger", 1.0)
    cases = [
        (pt, relu2, lam, "relu2 features"),
        (pt, DenseNetRelu(1, (8,), d_in=d, device="cpu"), lam,
         "relu features"),
        (pt, DenseNetTanh2(1, (8,), d_in=d, device="cpu"), lam,
         "tanh2 features"),
        (ball, net, None, "4(g)"),
        (fp, net, lam, "tanh features"),
        (one_sided, net, lam, "one-sided"),
        (other_c, net, lam, "v_ref of"),
    ]
    for prob, v_net, lv, match in cases:
        with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
            tk.fused_stopped_train_rollout(prob, v_net, X0, t0, N, DT,
                                           lam=lv)
        assert match in str(e.value)
    out = tk.reference_stopped_train_rollout(pt, relu2, X0, t0, N, DT,
                                             lam=lam)
    assert torch.isfinite(out.Y).all()


D, KB, STEPS = 4, 16, 20
TRAJ_RTOL, PARAM_ATOL = 2e-4, 2e-5


def _draws(key, geom):
    """The JAX step's reflected boundary pair, domain points, penalty
    points and noise (pspde/solvers/eigen.py: kb, kd, kr, kn)."""
    kb, kd, kr, kn = jax.random.split(key, 4)
    Xb, Xb_r = (np.asarray(a) for a in j_reflected(kb, geom, KB, D))
    X0 = np.asarray(j_domain(kd, geom, K, D))
    X2 = np.asarray(j_domain(kn, geom, K, D))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    t = [torch.tensor(a) for a in (X0, Xb, Xb_r, X2, noise)]
    return t[0], (t[1], t[2]), t[3], t[4]


@pytest.mark.parametrize("engine,clamp", [("scan", True),
                                          ("fused_train", True),
                                          ("fused_train", False)])
def test_twenty_steps_match_jax(engine, clamp):
    """20 EigenSolver steps of the notebook's recipe ('l2_penalty',
    lambda_init -2, lr 1e-3) on SchrodingerEigen(d=4) with DenseNetTanh
    (8, 8), from the JAX solver's parameters, each step fed the JAX step's
    own draws: the loss, lambda and V_L2 trajectories and the parameters
    after 20 steps; the port keeps the DenseNetTanh class when it loads the
    tree."""
    kw = dict(delta_t=DT, N=N, L=STEPS, K=K, K_boundary=KB, lr=1e-3,
              lambda_init=-2.0, normalization="l2_penalty", verbose=False)
    pj = jp.SchrodingerEigen(d=D)
    pt = tp.SchrodingerEigen(d=D, device="cpu")
    js = JSolver(pj, "j", seed=5, value_net=JDenseNetTanh(
        d_out=1, arch=(8, 8), output_relu=clamp), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", rollout_mode=engine, device="cpu",
                     value_net=DenseNetTanh(1, (8, 8), output_relu=clamp,
                                            d_in=D, device="cpu"), **kw)
        ts.load_jax_params(jax.device_get(js.params))
    assert type(ts.V_net) is DenseNetTanh and ts.V_net.output_relu == clamp
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = engine
    step = jax.jit(js._build_step())
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    logs = {k: [] for k in ("loss", "lambda", "V_L2")}
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        X0, Xb, X2, noise = _draws(sub, pj.geometry)
        params, opt, aux = step(params, opt, sub)
        for k in logs:
            logs[k].append(float(aux[k]))
        ts.step(X0=X0, Xb=Xb, X2=X2, host_noise=noise)
    for k, port in (("loss", ts.loss_log), ("lambda", ts.lambda_log),
                    ("V_L2", ts.V_L2_log)):
        np.testing.assert_allclose(port, logs[k], rtol=TRAJ_RTOL, err_msg=k)
    assert all(np.isfinite(ts.V_L2_log))
    assert abs(ts.lambda_log[-1] - ts.lambda_log[0]) > 1e-3
    got = eigen_params_to_flax(list(ts.V_net.parameters()), ts.lam_net.Y_0)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_recipe_gates():
    """Off CUDA the notebook's recipe fails only the device gate and falls
    back to the scan with a warning; with the solver's default relu^2
    DenseNet it also fails the family's gate."""
    pt = tp.SchrodingerEigen(d=10, device="cpu")
    kw = dict(K=32, N=4, normalization="l2_penalty", lambda_init=-2.0,
              verbose=False, device="cpu", rollout_mode="fused_train")
    net = DenseNetTanh(1, (15, 15, 15, 15), output_relu=True, d_in=10,
                       device="cpu")
    with pytest.warns(UserWarning, match="problem on a CUDA device"):
        s = TSolver(pt, "t", value_net=net, **kw)
    assert s._fused_train_gates() == ["problem on a CUDA device"]
    assert s.resolved_rollout_mode == "scan"
    with pytest.warns(UserWarning, match="relu2 features"):
        default = TSolver(pt, "t", **kw)
    assert any("family" in g for g in default._fused_train_gates())
