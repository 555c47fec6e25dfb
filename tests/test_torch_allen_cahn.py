"""The Allen-Cahn slice of the port against pspde (CPU).

``AllenCahn``'s h, f and its 'ball_exp' family tuple with the cubic's c_y3
against pspde's; ``fused_stopped_train_rollout(time_stopping=True)`` on
``AllenCahn(d=4)`` with a DenseNet (8, 8, 4) on [x, t] (on the CPU: the
plain forward and the hand-written ``_reference_stopped_backward``, whose
dh/dy gains 3 c_y3 V^2) against pspde's
``make_fused_stopped_train_rollout(time_stopping=True)`` in interpret
mode, outputs and diffusion-loss gradients; the hand backward against
autograd's double backward through the plain forward; the backward's
memory plan (``_stopped_bwd_plan``: the device plan for the notebook's
DenseNet (110, 110, 50) at d=100, the shared plan and its tile for the
older cells) and its launch against a fake library; 20 ``GeneralSolver``
steps against JAX's on each step's own draws and noise.

Tolerances are the JAX suite's (tests/test_fused_stopped.py:119-131,
193-194), as in test_torch_general_rollout.py: X rtol 2e-5 atol 2e-6, Y
rtol 2e-4 atol 1e-5; t, stopped and hitting exact; gradients rtol 5e-3
atol 1e-5; the hand backward against autograd 1e-5 of each leaf's largest
entry; 20 solver steps: the loss rtol 2e-4, the parameters atol 2e-5.
Sizes: K=64, N=12, dt=0.01, T=0.3, so that the paths whose t0 lies past
T - N dt run out of time and the others run all N steps.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.ansatz.transposed import transposed_apply
from pspde.rollout.kernels import make_fused_stopped_train_rollout
from pspde.rollout.sampling import inside_fn_cols
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import GeneralSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import GeneralSolver as TSolver
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax

D, K, N, DT, T_END, ARCH = 4, 64, 12, 0.01, 0.3, (8, 8, 4)
X_RTOL, X_ATOL, Y_RTOL, Y_ATOL = 2e-5, 2e-6, 2e-4, 1e-5
G_RTOL, G_ATOL = 5e-3, 1e-5
TRAJ_RTOL, PARAM_ATOL = 2e-4, 2e-5
# the notebook's net at d=100 (experiments/allen_cahn.py)
NOTEBOOK_ARCH = (110, 110, 50)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _problems(d=D):
    return jp.AllenCahn(d=d, T=T_END), tp.AllenCahn(d=d, T=T_END,
                                                    device="cpu")


@pytest.mark.parametrize("d", [4, 100])
def test_h_f_and_family_match_jax(d):
    """h = y - y^3 and f = 1 / (2 + 0.4 |x|^2) against pspde's; the family
    tuple ('ball_exp', 1, 0, 0, 'none', 0, 0, -1) states h as the kernels
    evaluate it, y (c_y + c_yr2 |x|^2) + c_y3 y^3; the kernels take it with
    the clock."""
    pj, pt = _problems(d)
    rng = np.random.default_rng(d)
    x = (2.0 * rng.standard_normal((K, d))).astype(np.float32)
    t = (T_END * rng.uniform(size=K)).astype(np.float32)
    y = rng.standard_normal(K).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    xt, tt, yt, zt = (torch.from_numpy(a) for a in (x, t, y, z))
    np.testing.assert_allclose(_np(pt.h(tt, xt, yt, zt)),
                               np.asarray(pj.h(jnp.asarray(t), x, y, z)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(pt.f_terminal(xt)),
                               np.asarray(pj.f_terminal(x)), rtol=1e-6)
    hfam = pt.h_family()
    assert hfam == ("ball_exp", 1.0, 0.0, 0.0, "none", 0.0, 0.0, -1.0)
    _, c_y, c_yr2, _, _, _, _, c_y3 = hfam
    r2 = torch.sum(xt * xt, dim=-1)
    torch.testing.assert_close(yt * (c_y + c_yr2 * r2) + c_y3 * yt ** 3,
                               pt.h(tt, xt, yt, zt))
    net = DenseNet(1, ARCH, d_in=d + 1, device="cpu")
    fam = tk._check_stopped_family(pt, net, "erfinv", time_stopping=True)
    assert fam == (hfam, None)
    assert "c_y3 y^3" in tk.STOPPED_KERNEL_FAMILY
    # without the clock the cubic stays outside the family (and the whole
    # space would stop no path)
    pt.geometry = tp.Geometry(kind="sphere", boundary_distance=1.0)
    with pytest.raises(ValueError, match="y\\^3 term"):
        tk._check_stopped_family(pt, DenseNet(1, ARCH, d_in=d,
                                              device="cpu"), "erfinv")


def _setup(pj, seed=3):
    """Flax DenseNet (8, 8, 4) params of input width d + 1, the noise of
    key 11, X0 and t0 of key 5."""
    net = JDenseNet(d_out=1, arch=ARCH)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, D + 1)))
    key = jax.random.PRNGKey(11)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, n), (K, D),
                                         dtype=jnp.float32)
                       for n in range(N)])
    kx, kt = jax.random.split(jax.random.PRNGKey(5))
    X0 = j_domain(kx, pj.geometry, K, D, uniform_square=True)
    t0 = jax.random.uniform(kt, (K,)) * pj.T
    return net, params, noise, X0, t0


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


@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_matches_pallas_interpret(adaptive):
    """Outputs of the kernel pair's CPU path on AllenCahn(d=4) against the
    Pallas kernel in interpret mode (JAX's h_T traced into it), and the
    diffusion-loss gradient through both custom VJPs (Y_0 = V(X_0, t_0) and
    V(X_tau, t_tau) outside, as the solvers add them)."""
    pj, pt = _problems()
    net, params, noise, X0, t0 = _setup(pj)
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
    stopped = np.asarray(oj.stopped) > 0.5
    assert 0 < stopped.sum() < K      # some paths run out of time
    np.testing.assert_allclose(_np(out.X), np.asarray(oj.XT.T), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(_np(out.Y), np.asarray(oj.Y), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_array_equal(_np(out.t), np.asarray(oj.t))
    np.testing.assert_array_equal(_np(out.stopped) > 0.5, stopped)
    np.testing.assert_array_equal(_np(out.hitting), np.asarray(oj.hitting))
    np.testing.assert_array_equal(_np(out.adv_steps),
                                  np.asarray(oj.adv_steps))

    def v_t(X, t):
        return tnet(torch.cat([X, t[:, None]], dim=-1))[:, 0]

    l_t = torch.mean((v_t(out.X, out.t) - v_t(X0t, t0t) - out.Y) ** 2)
    np.testing.assert_allclose(_np(l_t), float(l_j), rtol=Y_RTOL)
    g_t = torch.autograd.grad(l_t, list(tnet.parameters()))
    g_j = jax.tree.unflatten(treedef, list(g_j))
    for a, b in zip(jax.tree.leaves(dense_net_to_flax(g_t)),
                    jax.tree.leaves(g_j)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


@pytest.mark.parametrize("adaptive,relu,rng", [(False, False, "erfinv"),
                                               (True, False, "binom"),
                                               (False, True, "erfinv"),
                                               (True, True, "erfinv")])
def test_reference_backward_matches_double_backward(adaptive, relu, rng):
    """The hand-written plain backward with the cubic's dh/dy = 1 - 3 V^2
    against autograd's double backward through the plain forward, on the
    Philox stream, with and without the output clamp."""
    _, pt = _problems()
    net = DenseNet(1, ARCH, weight_scale=0.2, bias_init_value=0.1,
                   d_in=D + 1, output_relu=relu, device="cpu",
                   generator=torch.Generator().manual_seed(7))
    rng_np = np.random.default_rng(2)
    X0 = torch.from_numpy((rng_np.uniform(-2, 2, (K, D))).astype(np.float32))
    t0 = torch.from_numpy((T_END * rng_np.uniform(size=K)).astype(
        np.float32))
    gY = torch.from_numpy(rng_np.standard_normal(K).astype(np.float32))
    kw = dict(adaptive_forward=adaptive, rng=rng, time_stopping=True)
    out = tk.reference_stopped_train_rollout(pt, net, X0, t0, N, DT, 7, **kw)
    params = list(net.parameters())
    want = torch.autograd.grad(out.Y, params, gY)
    fam = tk._check_stopped_family(pt, net, rng, time_stopping=True)
    call = tk._StoppedCall(pt, net, X0, t0, N, DT, 7, fam,
                           dict(kw, host_noise=None), None)
    got = tk._reference_stopped_backward(call, gY)
    assert 0 < int(out.stopped.sum()) < K
    V = net(torch.cat([X0, t0[:, None]], dim=-1))[:, 0]
    assert float(V.detach().abs().max()) > 0.3   # the cubic term counts
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    fo = tk.fused_stopped_train_rollout(pt, net, X0, t0, N, DT, 7, **kw)
    torch.testing.assert_close(fo.Y, out.Y.detach(), rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(fo.Y, params, gY), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _notebook_call(K, arch=NOTEBOOK_ARCH, d=100, plan=None):
    pt = tp.AllenCahn(d=d, T=T_END, device="cpu")
    pt.geometry = tp.Geometry(kind="unbounded", boundary_distance=7.0)
    net = DenseNet(1, arch, d_in=d + 1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return tk._StoppedCall(
        pt, net, torch.zeros((K, d)), torch.zeros(K), 25, 1e-3, 3,
        tk._check_stopped_family(pt, net, "erfinv", time_stopping=True),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=True), None, plan=plan)


@pytest.mark.parametrize("K,grid,ws_bytes", [(200, 25, 0),
                                             (65536, 1024,
                                              1924 * 65536 * 4)])
def test_notebook_net_takes_the_device_plan(K, grid, ws_bytes):
    """At d=100 the notebook's net on [x, t] (F = 371, H = 270) keeps 3 F +
    3 H + 1 = 1,924 floats a path in the backward: 253,984 bytes at tile 32
    and stride 33, past the 232,448 of a block.  The front end takes the
    device plan (the lanes kernel), the net read from device memory, one
    block per tile on the whole space: at the notebook's K=200 8 lanes of
    16 threads a block, their arrays in shared memory at stride 12 (92,416
    bytes a block, no workspace); at K=65536 64 lanes of 4 threads and a
    workspace of 1,924 x grid x 64 floats (~504 MB), 64 shared bytes a
    block (the ballots).  plan='shared' raises, naming the family, and so
    does a workspace whose floats reach 2^31 (32-bit indices: K = 2^21).
    The forward's net is staged in no block either: it takes the block
    kernel (tiles of paths that step together, the weights streamed
    through shared memory), 2 paths a block at K=200, 16 at K=65536."""
    call = _notebook_call(K)
    packed = call.pack(backward=True)
    tile, tpp, smem = (8, 16, 1) if K == 200 else (64, 4, 0)
    assert packed.layout == ("device", tpp, smem)
    assert packed.iargs[5:8] == [tile, 0, 53576]
    assert tk._stopped_bwd_per_path(packed) == 1924
    g = tk._stopped_bwd_grid(packed, torch.device("cpu"))
    assert g == grid
    ts = tk._stopped_bwd_ts(packed, g)
    assert ts == (tile + 4 if smem else grid * tile)
    assert (0 if smem else 4 * 1924 * ts) == ws_bytes
    assert tk._stopped_bwd_smem(packed, ts) == (92_416 if smem else 64)
    assert tk._stopped_smem_bytes(0, 1924, 32, True, 33) == 253_984
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
        _notebook_call(K, plan="shared").pack(backward=True)
    assert "253984 bytes" in str(e.value)
    fwd = call.pack(backward=False)
    block = tk._stopped_fwd_block_of(fwd)
    assert block.tile == (2 if K == 200 else 16) and fwd.iargs[6] == 0
    assert tk._stopped_fwd_smem_bytes(fwd) <= tk._SMEM_LIMIT
    with pytest.raises(ValueError, match="32-bit indices"):
        tk._stopped_bwd_ws(1924, 64, 2 ** 21 // 64)


@pytest.mark.parametrize("case,d_in,arch,timed,tile,stride", [
    ("elliptic", 50, (30, 30), False, 64, 68),
    ("gen50", 51, (30, 30), True, 64, 68),
    ("heat", 51, (30, 30), True, 64, 68),
    ("notebook_elliptic", 50, (70, 50, 50, 50), False, 32, 36),
])
def test_older_cells_keep_the_shared_plan(case, d_in, arch, timed, tile,
                                          stride):
    """The older cells keep the shared plan, their tile, stride and staged
    net, and their packed arguments but for the appended c_y3 (0); forced,
    the device plan takes its own layout at K=4096 (16 lanes of 16
    threads, the arrays in shared memory at stride 20, the net staged
    beside them where it fits), at tile=64 4 threads a lane, and with the
    arrays forced into the workspace a stride of grid x tile."""
    problems = {
        "elliptic": tp.ExponentialOnBallNonlinearSin(d=50, alpha=0.1,
                                                      device="cpu"),
        "gen50": tp.ExponentialOnSphereNonlinearParabolic(d=50,
                                                          device="cpu"),
        "heat": tp.HeatEquation(d=50, T=0.2, device="cpu"),
        "notebook_elliptic": tp.ExponentialOnBallNonlinearSin(
            d=50, alpha=0.1, device="cpu")}
    prob = problems[case]
    net = DenseNet(1, arch, d_in=d_in, device="cpu")
    fam = tk._check_stopped_family(prob, net, "erfinv", time_stopping=timed)
    assert fam[0][7] == 0.0
    call = tk._StoppedCall(
        prob, net, torch.zeros((4096, 50)), torch.zeros(4096), 20, 1e-3, 3,
        fam, dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                  time_stopping=timed), None)
    packed = call.pack(backward=True)
    assert packed.layout == ("shared",) and packed.iargs[5] == tile
    assert tk._stopped_bwd_ts(packed) == stride
    assert packed.fargs[tk._STOPPED_N_FLOATS + 5] == 0.0   # c_y3
    assert len(packed.fargs) == 13 + 10
    assert packed.iargs[6] == int(case != "notebook_elliptic")
    forced = call._replace(plan="device").pack(backward=True)
    assert forced.layout == ("device", 16, 1) and forced.iargs[5] == 16
    assert forced.iargs[6] == int(case != "notebook_elliptic")
    assert forced.iargs[:5] == packed.iargs[:5]
    assert forced.fargs == packed.fargs
    assert tk._stopped_bwd_ts(forced, 7) == 20
    at64 = call._replace(plan="device", tile=64).pack(backward=True)
    assert at64.layout[:2] == ("device", 4) and at64.iargs[5] == 64
    ws = call._replace(bwd_layout=(64, 4, False, False)).pack(backward=True)
    assert tk._stopped_bwd_ts(ws, 7) == 7 * 64


def test_device_plan_launch(monkeypatch):
    """The device plan's launch, forced through
    ``fused_stopped_train_rollout(plan='device')``, against a fake library
    (the CPU backward routed to the kernel's wrapper): the slots asked
    once with the stride, an unread grid, the plan (1), tpp and the
    arrays' place after StoppedArgs' and StoppedExt's ints; the launch with
    the same ints and the grid, at K=500 8 lanes of 16 threads with the
    arrays in shared memory (stride 12, no workspace); with the arrays
    forced into the workspace a stride of grid x tile and a workspace of
    per-path rows x stride floats; the rows summed into the leaves'
    gradients, and the launch counted by plan."""
    n_ints = tk._STOPPED_N_INTS + 4
    asked, launched = [], []

    class FakeLib:
        def pspde_stopped_bwd_slots(self, iargs, fargs, index, out):
            asked.append(list(iargs[n_ints:]))
            out._obj.value = 3
            return 0

    def fake_launch(fn, who, packed, tensors, seed, dev):
        assert fn == "pspde_stopped_rollout_bwd"
        part, counts, ws = tensors[-3:]
        launched.append((packed.iargs[n_ints:], tuple(part.shape),
                         None if ws is None else ws.numel()))
        part.fill_(1.0)
        counts.fill_(1)

    monkeypatch.setattr(_build, "library", lambda: FakeLib())
    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tk, "_reference_stopped_backward",
                        tk._stopped_backward_kernel)
    prob = tp.ExponentialOnBallNonlinearSin(d=6, alpha=0.1, device="cpu")
    net = DenseNet(1, (6, 5), d_in=6, device="cpu")
    K = 500
    out = tk.fused_stopped_train_rollout(prob, net, torch.zeros((K, 6)),
                                         torch.zeros(K), 20, 1e-3, 3,
                                         plan="device")
    before = dict(tk.fused_stopped_train_rollout.backward_launches_by_plan)
    grads = torch.autograd.grad(out.Y.sum(), list(net.parameters()))
    after = tk.fused_stopped_train_rollout.backward_launches_by_plan
    per_path = 3 * (6 + 11) + 3 * 11 + 1
    n_grad = tk._stopped_layout(net).n_grad
    assert asked == [[12, 0, 1, 16, 1]]
    assert launched == [([12, 3, 1, 16, 1], (3, n_grad), None)]
    assert after["device"] == before["device"] + 1
    assert after["shared"] == before["shared"]
    assert all(torch.all(g == 3.0) for g in grads)
    call = tk._StoppedCall(
        prob, net, torch.zeros((K, 6)), torch.zeros(K), 20, 1e-3, 3,
        tk._check_stopped_family(prob, net, "erfinv"),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None,
        bwd_layout=(64, 2, False, False))
    tk._stopped_backward_rows(call, torch.zeros(K))
    assert asked[1] == [64, 0, 1, 2, 0]
    assert launched[1] == ([3 * 64, 3, 1, 2, 0], (3, n_grad),
                           per_path * 3 * 64)


STEPS, KB = 20, 16


@pytest.mark.parametrize("loss_method,alpha", [("diffusion", (10.0, 1.0,
                                                              1.0)),
                                               ("BSDE", (1.0, 1.0, 1.0))])
def test_twenty_steps_match_jax(loss_method, alpha):
    """20 GeneralSolver steps on 'fused_train' (on the CPU: the kernels'
    plain versions and the hand backward) against JAX's scan steps on
    AllenCahn(d=4), the notebook's options (uniform_square,
    loss_with_stopped=False), each step fed the JAX step's own domain
    points, start times and noise, from JAX's initial DenseNet (8, 8, 4):
    the loss trajectory and the parameters after 20 steps."""
    pj, pt = _problems()
    kw = dict(delta_t=DT, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
              loss_method=loss_method, alpha=alpha, uniform_square=True,
              loss_with_stopped=False, verbose=False)
    js = JSolver(pj, "j", value_net=JDenseNet(d_out=1, arch=ARCH), **kw)
    step = jax.jit(js._build_step())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", rollout_mode="fused_train", device="cpu",
                     value_net=DenseNet(1, ARCH, d_in=D + 1, device="cpu"),
                     **kw)
        ts.load_jax_params(jax.device_get(js.params))
    assert ts._fused_train_gates() == ["problem on a CUDA device"]
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = "fused_train"
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kbt, kd, kt, kr = jax.random.split(sub, 5)
        X0 = j_domain(kd, pj.geometry, K, D, uniform_square=True)
        t0 = jax.random.uniform(kt, (K,)) * pj.T
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        ts.step(X0=torch.tensor(np.asarray(X0)),
                t0=torch.tensor(np.asarray(t0)),
                host_noise=torch.tensor(noise))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    assert 0 < ts.K_log[0] < K * N
    got = dense_net_to_flax(list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
