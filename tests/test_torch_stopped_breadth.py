"""The stopped kernels' breadth families against pspde (CPU): the two
spheres with the committor's reference (``Committor``) and the dense sigma
with h's (sum x)^2 term (``ExponentialOnBallNonlinearSinHessian``).

* ``fused_stopped_train_rollout`` on the CPU (its plain forward and the
  hand-written backward) against pspde's
  ``make_fused_stopped_train_rollout`` in interpret mode with
  ``EllipticSolver._terms_math_T``, and its plain forward against pspde's
  scan, on the same DenseNet parameters (converted from the Flax tree) and
  the same noise (``normal(fold_in(key, n), (K, d))`` made by JAX):
  outputs, exact stopped and hitting, and the diffusion-loss gradients;
* the hand backward against autograd's double backward through the plain
  forward;
* ``_pack_stopped``'s new fields against ``StoppedExt`` parsed from
  ``csrc/stopped_rollout.cu`` (and the per-path rows the dense sigma adds);
* the forward's exchange of Z and the normals through the lane's rows,
  transcribed in numpy from the kernel, bitwise the backward's one-thread
  order for every threads-a-lane count;
* 20 ``EllipticSolver`` steps on 'fused_train' against JAX's scan steps.

Tolerances are the JAX suite's (tests/test_fused_stopped.py): X rtol 2e-5
atol 2e-6; Y, v_l2 and the loss rtol 2e-4; gradients rtol 5e-3 atol 1e-5;
the hand backward within 1e-5 of each leaf's largest entry (float32
reordering); parameters after 20 steps atol 2e-5.  Sizes: K=64, d=5,
N=16, dt=0.01, DenseNet (8, 8).
"""

import os
import re
import warnings

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
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EllipticSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout import sde as tsde
from pspde_torch.rollout.sampling import inside_fn as t_inside
from pspde_torch.solvers import EllipticSolver as TSolver
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax

K, D, N, DT = 64, 5, 16, 0.01
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5
# the stopped kernels' shared header, where their argument structs live
CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pspde_torch", "csrc", "stopped_common.cuh")

PROBLEMS = {
    "committor": ("Committor", dict(d=D)),
    "hessian": ("ExponentialOnBallNonlinearSinHessian", dict(d=D,
                                                              alpha=0.5)),
}


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _setup(case, seed=3):
    """Both problems, pspde's solver (for _terms_math_T and the Flax
    params), the noise of key 11, X0 of key 5, the port's net."""
    cls, kw = PROBLEMS[case]
    pj, pt = getattr(jp, cls)(**kw), getattr(tp, cls)(**kw, device="cpu")
    js = JSolver(pj, "j", seed=seed, value_net=JDenseNet(d_out=1,
                                                         arch=(8, 8)),
                 K=K, N=N, delta_t=DT, verbose=False)
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n),
                                         (K, D), dtype=jnp.float32)
                       for n in range(N)])
    X0 = j_domain(jax.random.PRNGKey(5), pj.geometry, K, D)
    tnet = dense_net_from_flax(jax.device_get(js.params), device="cpu")
    return pj, pt, js, key, noise, X0, tnet


def _assert_outputs(out, X, Y, stopped, hitting, v_l2=None):
    np.testing.assert_allclose(_np(out.X), np.asarray(X), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(out.Y), np.asarray(Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_array_equal(_np(out.stopped) > 0.5,
                                  np.asarray(stopped) > 0.5)
    np.testing.assert_array_equal(_np(out.hitting), np.asarray(hitting))
    if v_l2 is not None:
        np.testing.assert_allclose(_np(out.v_l2), np.asarray(v_l2),
                                   rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(PROBLEMS))
@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_breadth_matches_pallas_interpret(case, adaptive):
    """The kernel pair's CPU path against the Pallas kernel in interpret
    mode: outputs, and the diffusion-loss gradient through both custom
    VJPs (Y_0 = V(X_0) and V(X_tau) outside, as the solvers add them)."""
    pj, pt, js, key, noise, X0, tnet = _setup(case)
    treedef = jax.tree.structure(js.params)
    leaves = tuple(jax.tree.leaves(js.params))
    run = make_fused_stopped_train_rollout(
        pj, js._terms_math_T(), leaves, K, N, DT,
        inside_fn_T=inside_fn_cols(pj.geometry), adaptive_forward=adaptive,
        v_ref_T=pj.v_ref_T, tile=32, interpret=True,
        host_noise=jnp.transpose(noise, (0, 2, 1)))
    t0 = jnp.zeros((K,))

    def loss_j(lv):
        prm = jax.tree.unflatten(treedef, list(lv))
        v_fn = lambda X: js.V_net.apply(prm, X)[:, 0]
        o = run(lv, X0.T, t0, jnp.float32(0))
        return jnp.mean((v_fn(o.XT.T) - v_fn(X0) - o.Y) ** 2), o

    (l_j, oj), g_j = jax.value_and_grad(loss_j, has_aux=True)(leaves)
    X0t = torch.tensor(np.asarray(X0))
    out = tk.fused_stopped_train_rollout(
        pt, tnet, X0t, torch.zeros(K), N, DT, adaptive_forward=adaptive,
        host_noise=torch.tensor(np.asarray(noise)))
    assert 0 < int(np.asarray(oj.stopped).sum()) < K
    _assert_outputs(out, oj.XT.T, oj.Y, oj.stopped, oj.hitting, oj.v_l2)
    np.testing.assert_array_equal(_np(out.adv_steps),
                                  np.asarray(oj.adv_steps))
    l_t = torch.mean((tnet(out.X)[:, 0] - tnet(X0t)[:, 0] - out.Y) ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    g_j = jax.tree.unflatten(treedef, list(g_j))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


@pytest.mark.parametrize("case", list(PROBLEMS))
def test_plain_forward_matches_jax_scan(case):
    """The kernels' plain forward against pspde's scan with a detached
    forward from Y_0 = 0, v_ref the problem's."""
    pj, pt, js, key, noise, X0, tnet = _setup(case)
    sig = pj.sigma_struct

    def vg(prm, X, t):
        V, pull = jax.vjp(lambda x: js.V_net.apply(prm, x)[:, 0], X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig.apply_T(gX)

    ref = jsde.stopped_rollout(
        jsde.StoppedRolloutConfig(N=N, delta_t=DT, detach_forward=True), pj,
        vg, js.params, X0, jnp.zeros((K,)), jnp.zeros((K,)), key,
        j_inside(pj.geometry), v_ref=pj.v_ref)
    out = tk.reference_stopped_train_rollout(
        pt, tnet, torch.tensor(np.asarray(X0)), torch.zeros(K), N, DT,
        host_noise=torch.tensor(np.asarray(noise)))
    assert 0 < int(np.asarray(ref.stopped).sum()) < K
    _assert_outputs(out, ref.X, ref.Y, ref.stopped, ref.hitting, ref.v_l2)
    # the plain scan's own domain test is pspde's
    X = torch.tensor(np.asarray(X0))
    np.testing.assert_array_equal(
        _np(t_inside(pt.geometry)(X, X)),
        np.asarray(j_inside(pj.geometry)(X0, X0)))


@pytest.mark.parametrize("case,adaptive,relu,rng", [
    ("committor", False, False, "erfinv"),
    ("committor", True, True, "binom"),
    ("hessian", False, False, "binom"),
    ("hessian", True, False, "erfinv"),
    ("hessian", True, True, "erfinv"),
])
def test_reference_backward_matches_double_backward(case, adaptive, relu,
                                                    rng):
    """The hand-written plain backward (c_ys1 in dh/dy; w = gY adv sigma
    (xi sqrt(dt) + c dt) with the dense sigma) against autograd's double
    backward through the plain forward, on the Philox stream; the
    autograd.Function path is the hand backward bit for bit."""
    cls, kw = PROBLEMS[case]
    pt = getattr(tp, cls)(**kw, device="cpu")
    # the dense sigma moves every coordinate at once: a shorter step keeps
    # some paths inside for the N steps
    dt = DT if case == "committor" else 1e-3
    net = DenseNet(1, (8, 8), weight_scale=0.5, bias_init_value=0.1, d_in=D,
                   output_relu=relu,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    if relu:
        with torch.no_grad():
            net.layers[-1].bias.fill_(0.5)
    X0 = torch.tensor(np.asarray(j_domain(jax.random.PRNGKey(2),
                                          jp.Committor(d=D).geometry
                                          if case == "committor"
                                          else jp.ExponentialOnSphere(
                                              d=D).geometry, K, D)))
    gY = torch.from_numpy(np.random.default_rng(4).standard_normal(
        K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng)
    out = tk.reference_stopped_train_rollout(pt, net, X0, torch.zeros(K), N,
                                             dt, 7, **kw)
    params = list(net.parameters())
    want = torch.autograd.grad(out.Y, params, gY, allow_unused=True)
    fam = tk._check_stopped_family(pt, net, rng)
    call = tk._StoppedCall(pt, net, X0, torch.zeros(K), N, dt, 7, fam,
                           dict(kw, host_noise=None), None)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K
    top = max(float(b.abs().max()) for b in want if b is not None)
    for a, b in zip(got, want):
        b = torch.zeros_like(a) if b is None else b
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-3 * top)
    fo = tk.fused_stopped_train_rollout(pt, net, X0, torch.zeros(K), N, dt,
                                        7, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, params, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _cu_struct(name):
    """The field names of a struct of csrc/stopped_common.cuh, in order."""
    src = open(CU).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = decl.split(None, 1)[1]
        fields += [re.sub(r"\[.*\]", "", n).strip()
                   for n in names.split(",")]
    return fields, src


def _cu_int_fields(name):
    """The names of a struct's int fields in csrc/stopped_common.cuh."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, open(CU).read(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return {re.sub(r"\[.*\]", "", n).strip()
            for decl in body.split(";") if decl.split()[:1] == ["int"]
            for n in decl.split(None, 1)[1].split(",")}


def test_pack_breadth_fields_against_the_cu():
    """StoppedExt follows StoppedArgs' ints and floats in the wrapper's
    arrays, in the .cu's field order: the dense sigma's offset (and sigma
    row-major there, after the net), the reference's kind, the inner
    radius, c_ys1, the committor's constants and c_y3 (0: the cubic goes
    with the clock), then the feature map, the Schroedinger family and its
    four constants (ints, then floats, each after their kind's old ones;
    all 0 here); the two spheres' outer
    radius in StoppedArgs.radius, sigma's scalar 0 where it is dense; the
    per-path rows gain d (forward) and 2 d (backward) with a dense
    sigma."""
    fields, src = _cu_struct("StoppedExt")
    assert fields == ["sig_off", "vref", "r_in", "c_ys1", "vr_a2", "vr_ad",
                      "vr_den", "c_y3", "feat", "hfam", "sch_a", "sch_b",
                      "sch_2d", "sch_1d"]
    ints = _cu_int_fields("StoppedExt")
    assert ints == {"sig_off", "vref", "feat", "hfam"}
    n_ext_i = int(re.search(r"kNumExtInts = (\d+);", src).group(1))
    n_ext_f = int(re.search(r"kNumExtFloats = (\d+);", src).group(1))
    assert (n_ext_i, n_ext_f) == (4, 10)
    args, _ = _cu_struct("StoppedArgs")
    n_int = args.index("dt") + 3 * (args.index("X_l") > args.index("dt"))
    n_int += sum(3 for f in ("width", "w_off", "b_off", "g_off") if f in args)
    assert tk._STOPPED_N_INTS == 16 + 4 * tk._MAX_HIDDEN + 6
    com = tp.Committor(d=D, device="cpu")
    hes = tp.ExponentialOnBallNonlinearSinHessian(d=D, alpha=0.5,
                                                  device="cpu")
    net = DenseNet(1, (8, 8), d_in=D, device="cpu")
    ni, nf = tk._STOPPED_N_INTS, tk._STOPPED_N_FLOATS
    for prob in (com, hes):
        fam = tk._check_stopped_family(prob, net, "erfinv")
        for backward in (False, True):
            p = tk._pack_stopped(prob, net, *fam, 500, N, DT, None,
                                 backward=backward, host_noise=None,
                                 adaptive_forward=False, rng="erfinv")
            ia, fa = p.iargs, p.fargs
            assert len(ia) == ni + n_ext_i and len(fa) == nf + n_ext_f
            ext = dict(zip([f for f in fields if f in ints], ia[ni:]))
            ext.update(zip([f for f in fields if f not in ints], fa[nf:]))
            F, H = ia[4], ia[4] - D
            full = prob is hes
            per = tk._stopped_per_path(F, H, D, backward, full)
            assert per == ((3 * F + 3 * H + 1 if backward
                            else 2 * F + H + D) + (2 * D if backward
                                                   else D) * full)
            if prob is com:
                assert ia[15] == tk._GEOMETRIES.index("two_spheres") == 3
                assert (ext["sig_off"], ext["vref"], ext["r_in"]) == (-1, 1,
                                                                      1.0)
                assert fa[2] == 1.0 and fa[3] == 2.0 and ia[12] == 1
                assert (ext["vr_a2"], ext["vr_ad"]) == (1.0, 1.0)
                assert ext["vr_den"] == pytest.approx(1.0 - 2.0 ** (2 - D))
                assert ext["c_ys1"] == 0.0 and ia[11] == 0   # h = 0
            else:
                lay = tk._stopped_layout(net)
                assert ia[15] == 0 and ext["vref"] == 0 and fa[2] == 0.0
                assert ext["sig_off"] == lay.bL_off + 4   # after the net
                assert p.params.numel() == ext["sig_off"] + 28  # 25 to 4s
                torch.testing.assert_close(
                    p.params[ext["sig_off"]:ext["sig_off"] + D * D].reshape(
                        D, D),
                    hes.sigma_struct.mat, rtol=0, atol=0)
                assert ext["c_ys1"] == pytest.approx(-4 * 0.25)
                assert (fa[4], fa[5], fa[6]) == (-2 * 0.5 * D, 0.0, 1.0)
                assert ia[13] == lay.n_grad   # sigma takes no gradient
            assert ext["c_y3"] == 0.0
            assert [ext[f] for f in fields[8:]] == [0] * 2 + [0.0] * 4
            assert tk._stopped_instance(p)[3:] == (ext["sig_off"],
                                                   ext["vref"], full, False,
                                                   ext["feat"], ext["hfam"])


@pytest.mark.parametrize("case", ["hessian", "committor"])
def test_device_plan_of_a_dense_sigma_raises(case):
    """The backward's device plan (the lanes kernel) takes the committor
    (the two spheres, its reference: first, and forced) but not a dense
    sigma: the Hessian's backward stays on the shared plan, and
    plan='device' there raises naming ROADMAP.md Queue 2 item 4(f), at the
    pack and through fused_stopped_train_rollout's backward."""
    name, kw = PROBLEMS[case]
    prob = getattr(tp, name)(device="cpu", **kw)
    net = DenseNet(1, (8, 8), d_in=D, device="cpu")
    fam = tk._check_stopped_family(prob, net, "erfinv")

    def pack(**opts):
        return tk._pack_stopped(prob, net, *fam, 200, N, DT, None,
                                backward=True, host_noise=None,
                                adaptive_forward=False, rng="erfinv", **opts)

    if case == "committor":
        assert pack().layout[0] == "device"
        assert pack(plan="device").layout[0] == "device"
        assert pack(plan="shared").layout == ("shared",)
        return
    assert pack().layout == ("shared",)
    with pytest.raises(ValueError, match=r"dense sigma.*Queue 2 item 4\(f\)"):
        pack(plan="device")
    with pytest.raises(ValueError, match=r"Queue 2 item 4\(f\)"):
        pack(bwd_layout=(8, 16, True, True))


def _fma(a, b, c):
    """fmaf of float32s: the exact product and sum in float64, rounded."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _full_z(sg, g, d, j):
    z = np.float32(0.0)
    for i in range(d):
        z = _fma(sg[i * d + j], g[i], z)
    return z


def _full_step(sg, z, xs, d, j, adaptive, dt, sq_dt):
    row = sg[j * d:(j + 1) * d]
    sc = sx = np.float32(0.0)
    for i in range(d):
        if adaptive:
            sc = _fma(row[i], -z[i], sc)
        sx = _fma(row[i], xs[i], sx)
    return np.float32(np.float32(sc * np.float32(dt))
                      + np.float32(sx * np.float32(sq_dt)))


@pytest.mark.parametrize("d", [5, 20])
@pytest.mark.parametrize("adaptive", [False, True])
def test_forward_sigma_exchange_is_the_backward_order(d, adaptive):
    """The forward's lane with a dense sigma, transcribed from
    stopped_fwd_kernel: thread q of p draws the dimension groups q, q + p,
    ... and writes their normals and Z rows; the lane meets; each thread
    moves its own coordinates by full_step, which reads every row.  For
    every p in _STOPPED_FWD_TPP each row is written once before the
    meeting, and X and the increment's sums are bitwise the backward's
    replay (one thread: all Z, then every step)."""
    rng = np.random.default_rng(d)
    sg = (rng.standard_normal(d * d) * 0.3).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32)
    xi = rng.standard_normal(d).astype(np.float32)
    X = rng.uniform(-0.3, 0.3, d).astype(np.float32)
    dt = np.float32(1e-3)
    sq_dt = np.float32(np.sqrt(1e-3))
    # the backward: Z of every row, then each step
    z1 = np.array([_full_z(sg, g, d, j) for j in range(d)], np.float32)
    X1 = np.array([np.float32(X[j] + _full_step(sg, z1, xi, d, j, adaptive,
                                                dt, sq_dt))
                   for j in range(d)], np.float32)
    for p in tk._STOPPED_FWD_TPP:
        xs = np.full(d, np.nan, np.float32)
        zr = np.full(d, np.nan, np.float32)
        writes = np.zeros(d, int)
        for q in range(p):                       # before the meeting
            for gi in range(q, -(-d // 4), p):
                for j in range(4 * gi, min(4 * gi + 4, d)):
                    xs[j], zr[j] = xi[j], _full_z(sg, g, d, j)
                    writes[j] += 1
        assert (writes == 1).all() and not np.isnan(zr).any()
        Xp = X.copy()
        moved = np.zeros(d, int)
        for q in range(p):                       # after it
            for gi in range(q, -(-d // 4), p):
                for j in range(4 * gi, min(4 * gi + 4, d)):
                    Xp[j] = np.float32(Xp[j] + _full_step(
                        sg, zr, xs, d, j, adaptive, dt, sq_dt))
                    moved[j] += 1
        assert (moved == 1).all()
        assert np.array_equal(Xp.view(np.int32), X1.view(np.int32))
        assert np.array_equal(zr.view(np.int32), z1.view(np.int32))


STEPS, KB = 20, 16


@pytest.mark.parametrize("case,opts", [
    ("committor", dict(alpha=(10.0, 1.0), boundary_loss=False,
                       loss_with_stopped=True)),
    ("hessian", {}),
    ("hessian", dict(adaptive_forward_process=True)),
])
def test_twenty_fused_steps_match_jax(case, opts):
    """20 EllipticSolver steps on 'fused_train' (on the CPU: the kernels'
    plain versions and the hand backward) against JAX's scan steps, each
    fed the JAX step's own boundary points, domain points and noise (kb,
    kd, kr = split(key, 3)), from JAX's initial DenseNet (8, 8): the
    loss and V_L2 trajectories and the parameters after 20 steps.  The
    committor runs without its boundary term: g = 1[|x| > a] jumps on the
    inner sphere, where half the boundary samples lie, so float32 roundoff
    of |x| sets g there (JAX's jitted step and its eager g disagree on
    such points); and with ``loss_with_stopped``, whose (g(X_tau) - Y)^2
    of the exited paths keeps the loss O(1): the diffusion term alone
    reads ~1e-6 from JAX's small initial net, where Adam turns float32
    roundoff of the gradient into steps of lr."""
    cls, pkw = PROBLEMS[case]
    d = 4
    pj = getattr(jp, cls)(**dict(pkw, d=d))
    pt = getattr(tp, cls)(**dict(pkw, d=d), device="cpu")
    kw = dict(dict(delta_t=DT, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
                   loss_method="diffusion", loss_with_stopped=False,
                   verbose=False), **opts)
    js = JSolver(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)), **kw)
    step = jax.jit(js._build_step())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", rollout_mode="fused_train", device="cpu", **kw)
        ts.load_jax_params(jax.device_get(js.params))
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = "fused_train"
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_vl2 = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kd, kr = jax.random.split(sub, 3)
        Xb = torch.tensor(np.asarray(j_boundary(kb, pj.geometry, KB, d)))
        X0 = torch.tensor(np.asarray(j_domain(kd, pj.geometry, K, d)))
        noise = torch.tensor(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (K, d))) for n in range(N)]))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_vl2.append(float(aux["V_L2"]))
        ts.step(X0=X0, Xb=Xb, host_noise=noise)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=Y_RTOL)
    np.testing.assert_allclose(ts.V_L2_log, j_vl2, rtol=Y_RTOL)
    assert ts.K_log[0] > 0
    got = dense_net_to_flax(list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("half", ["outer", "inner"])
def test_committor_boundary_loss_matches_jax(half):
    """The committor's boundary term, the Dirichlet mean of (V - g)^2 with
    g = 1[|x| > a] (0 on the inner sphere, 1 on the outer), of the port's
    EllipticSolver against JAX's ``_boundary_loss`` from the same initial
    DenseNet (8, 8), value and gradient, on JAX's own boundary samples: the
    outer-sphere half as drawn (|x| = c, far from the jump), and the inner
    half moved off the jump at |x| = a by a margin (scaled to |x| = 0.99
    a), where float32 roundoff of |x| cannot set g (the 20-step tests run
    the committor without this term for that reason)."""
    pj, pt, js, *_ = _setup("committor")
    ts = TSolver(pt, "t", value_net=DenseNet(1, (8, 8), d_in=D,
                                             device="cpu"),
                 K=K, N=N, delta_t=DT, verbose=False, device="cpu")
    ts.load_jax_params(jax.device_get(js.params))
    Xb = np.asarray(j_boundary(jax.random.PRNGKey(8), pj.geometry, 4 * K,
                               D))
    r = np.linalg.norm(Xb, axis=1)
    mid = 0.5 * (pt.a + pt.c)
    if half == "outer":
        Xb = Xb[r > mid]
    else:
        Xb = Xb[r < mid] * np.float32(0.99)
    Xb = Xb.astype(np.float32)
    assert Xb.shape[0] >= K
    l_j, g_j = jax.value_and_grad(js._boundary_loss)(js.params,
                                                     jnp.asarray(Xb))
    Xt = torch.from_numpy(Xb)
    g = pt.g(Xt)
    assert torch.equal(g, torch.full_like(g, float(half == "outer")))
    l_t = ts._boundary_loss(Xt)
    assert float(l_t.detach()) > 0
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(jax.device_get(g_j))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)
