"""The serve kernel's double-well drift (CPU).

The serve kernel (pspde_torch/csrc/controlled_rollout.cu) takes the
double well's drift b_j(x) = -4 kappa_j x_j (x_j^2 - 1) in its kDW
instantiations (train_step.cuh: euler_double_well, drift_kind 2, 4 kappa
packed at a_off), with sigma scalar and f zero; the training kernels and
the ladder refuse it.  Here, on the CPU:

* the plain version (``reference_controlled_rollout`` and the front end
  ``fused_controlled_rollout``, which takes it on CPU tensors) against
  pspde's Pallas ``fused_controlled_rollout`` in interpret mode, on
  ``DoubleWell`` (d=1) and ``DoubleWell_multidim`` (d=10) with the same
  numpy-made control and host noise: X, ito, riemann and f_int atol 2e-5;
  and ``importance_sampling_fused`` of a JAX-initialised 'inner' control
  against pspde's (interpret mode, host noise): mean, var and RE rtol
  1e-4 (var where it is a normal float32: at d=10 it is ~1e-40, which
  XLA on the CPU flushes to 0 and PyTorch keeps as a subnormal);
* the kernel's X chain (euler_double_well's float32 operations in its
  order) transcribed in numpy, bitwise equal to the plain rollout's;
* the pack: drift_kind 2 and 4 kappa at a_off in the parameter buffer,
  the elementwise update's per-path arrays, tile, threads per path and
  plan at the serve's shapes (K=2^20, N=200); the launch against a fake
  library; the C launcher's dispatch, read from the sources;
* the family: the training kernels refuse the drift, naming the serve
  kernel; a sigma that is not scalar raises.
The kernel itself is held against the plain version on the card by
chip_smoke.py (phase 23).
"""

import ctypes
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
import pspde.problems as jp
import pspde.rollout.kernels as jk
from pspde.eval import importance_sampling_fused as j_is_fused
from pspde.solvers import HJBSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import TanhMLP
from pspde_torch.eval import importance_sampling_fused as t_is_fused
from pspde_torch.problems.base import DiffusionMatrix
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.utils.convert import tanh_mlp_from_flax

CSRC = os.path.join(os.path.dirname(__file__), "..", "pspde_torch", "csrc")
ATOL, IS_RTOL = 2e-5, 1e-4


def _problem(m, d, **kw):
    if d == 1:
        return m.DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0, **kw)
    return m.DoubleWell_multidim(d=10, d_1=3, d_2=7, T=1.0, eta=3.0,
                                 kappa=5.0, **kw)


def _control(d, seed=0, scale=0.5):
    """A TanhMLP (30, 30) with N(0, scale^2 / fan_in) entries: the JAX
    u_apply over its leaves and the converted torch net."""
    rng = np.random.default_rng(seed)
    widths = (d + 1, 30, 30, d)
    tree = {"params": {f"Dense_{i}": {
        "kernel": (scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (scale * rng.standard_normal(b) / np.sqrt(a)).astype(
            np.float32)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}
    net = ja.TanhMLP(d_out=d)
    leaves, treedef = jax.tree.flatten(tree)

    def u_apply(leaves_t, tX):
        return -net.apply(jax.tree.unflatten(treedef, list(leaves_t)), tX)

    return u_apply, tuple(jnp.asarray(x) for x in leaves), \
        tanh_mlp_from_flax(tree, device="cpu")


@pytest.mark.parametrize("d,K,noise_sign", [(1, 512, 1.0), (1, 300, -1.0),
                                            (10, 512, 1.0), (10, 300, -1.0)])
def test_plain_matches_pallas_interpret(d, K, noise_sign):
    N, dt = 40, 0.005
    pj, pt = _problem(jp, d), _problem(tp, d, device="cpu")
    u_apply, leaves, net = _control(d)
    noise = np.random.default_rng(1).standard_normal((N, K, d)).astype(
        np.float32)
    ref = jk.fused_controlled_rollout(
        pj, u_apply, leaves, K, N, dt, seed=0, tile=256, interpret=True,
        host_noise=jnp.asarray(noise), noise_sign=noise_sign)
    noise_t = torch.from_numpy(noise)
    plain = tk.reference_controlled_rollout(pt, net, K, N, dt,
                                            host_noise=noise_t,
                                            noise_sign=noise_sign)
    front = tk.fused_controlled_rollout(pt, net, K, N, dt,
                                        host_noise=noise_t,
                                        noise_sign=noise_sign)
    for port in (plain, front):
        for name in ("X", "ito", "riemann", "f_int"):
            np.testing.assert_allclose(getattr(port, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=ATOL, err_msg=name)
    assert float(plain.X.std()) > 0.05 and float(plain.riemann.min()) > 0.0
    assert not plain.f_int.any()


@pytest.mark.parametrize("d", [1, 10])
def test_importance_sampling_fused_matches_jax(d):
    """The serve path on the double well: a JAX-initialised 'inner'
    control converted to the port, IS statistics on the same host noise
    against pspde's Pallas kernel in interpret mode."""
    K, dt = 1024, 0.01
    N = 100
    pj, pt = _problem(jp, d), _problem(tp, d, device="cpu")
    kw = dict(K=64, delta_t=dt, time_approx="inner", verbose=False,
              early_stopping_time=None, u_l2_error_flag=False)
    js = JSolver("j", pj, **kw)
    ts = TSolver("t", pt, device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    noise = np.random.default_rng(2).standard_normal((N, K, d)).astype(
        np.float32)
    orig = jk.fused_controlled_rollout

    def interpret(*a, **k):
        k.update(interpret=True)
        return orig(*a, **k)

    jk.fused_controlled_rollout = interpret
    try:
        want = j_is_fused(pj, js, K, delta_t=dt, tile=256,
                          host_noise=jnp.asarray(noise))
    finally:
        jk.fused_controlled_rollout = orig
    got = t_is_fused(pt, ts, K, delta_t=dt, host_noise=torch.from_numpy(
        noise))
    normal = [True, want[1] >= np.finfo(np.float32).tiny, True]
    np.testing.assert_allclose(np.asarray(got)[normal],
                               np.asarray(want)[normal], rtol=IS_RTOL)
    assert all(np.isfinite(got)) and got[0] > 0.0 and got[1] >= 0.0


def _euler_double_well(x, c4, u, xi, dt, sq_dt):
    """train_step.cuh's euler_double_well with sigma = 1, each float32
    operation rounded in its order: b = -(c4 x)(x x - 1), x + (b + u) dt +
    xi sqrt(dt)."""
    f = np.float32
    b = -(f(c4 * x) * f(f(x * x) - f(1.0)))
    return f(f(x + f(f(b + u) * dt)) + f(xi * sq_dt))


@pytest.mark.parametrize("d", [1, 10])
def test_kernel_x_chain_is_the_plain_one(d):
    """The kernel's update (euler_double_well) transcribed in numpy float32
    gives the plain rollout's X bitwise over 30 steps, Z from the same net:
    the kernel's X differs from the plain one only through Z (its 3xTF32
    products)."""
    pt = _problem(tp, d, device="cpu")
    _, _, net = _control(d, seed=3)
    K, N = 200, 30
    dt, sq_dt = tk.step_constants(0.005)
    noise = np.random.default_rng(4).standard_normal((N, K, d)).astype(
        np.float32)
    plain = tk.reference_controlled_rollout(pt, net, K, N, 0.005,
                                            host_noise=torch.from_numpy(noise))
    c4 = (4.0 * pt.drift_family()[1]).numpy().astype(np.float32)
    X = np.broadcast_to(pt.X_0.numpy(), (K, d)).astype(np.float32)
    with torch.no_grad():
        for n in range(N):
            t = tk.step_time(n, dt)
            tX = torch.cat([torch.full((K, 1), t), torch.from_numpy(X)], 1)
            u = (-net(tX)).numpy()
            X = _euler_double_well(X, c4, u, noise[n], np.float32(dt),
                                   np.float32(sq_dt))
    np.testing.assert_array_equal(X, plain.X.numpy())


def _serve_pack(problem, net, K, N=200, dt=0.005, tile=None, **kw):
    drift, cost = tk._check_family(problem, net, True, 1.0)
    return tk._pack(problem, net, drift, cost, K, N, dt, tile, None, 1.0,
                    **kw)


def _args(packed):
    with open(os.path.join(CSRC, "train_step.cuh")) as f:
        src = f.read()
    body = re.search(r"struct TrainArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.findall(r"^\s*int ([^;]*);", body, re.M):
        for item in decl.split(","):
            m = re.match(r"\s*(\w+)(\[kMaxLayers\])?", item)
            n = tk._MAX_LAYERS if m.group(2) else 1
            names += [m.group(1) if n == 1 else f"{m.group(1)}{i}"
                      for i in range(n)]
    return dict(zip(names, packed.iargs))


@pytest.mark.parametrize("d", [1, 10])
def test_serve_pack_of_the_double_well(d):
    """drift_kind 2 with 4 kappa at a_off (padded to dp with zeros), the
    elementwise update's arrays (X and Z, dp each, and the hidden rows),
    tile 64 x 4 threads a path in the shared plan at K=2^20, N=200; one
    dimension group at d=1 (dp = 8: the other three classes idle)."""
    pt = _problem(tp, d, device="cpu")
    net = TanhMLP(d + 1, d, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    packed = _serve_pack(pt, net, 2 ** 20)
    a = _args(packed)
    dp = 8 if d == 1 else 16
    assert (a["drift_kind"], a["dp"], a["d"], a["N"]) == (2, dp, d, 200)
    assert (a["tile"], a["tpp"], tk._plan_of(packed)) == (64, 4, "shared")
    assert a["sig_kind"] == 0 and a["f_kind"] == 0
    c4 = packed.params[a["a_off"]:a["a_off"] + dp]
    want = torch.zeros(dp)
    want[:d] = 4.0 * pt.drift_family()[1]
    assert torch.equal(c4, want)
    per_path = 2 * dp + 32 + 32
    net_floats = tk._train_fwd_net_floats(
        tk._layout(pt, net, *tk._check_family(pt, net, True, 1.0)), dp)
    assert tk._train_smem_bytes(net_floats + 3 * 4 * 64, per_path, 64) \
        <= tk._SMEM_LIMIT
    # forced layouts, as chip_smoke.py's bitwise check runs them
    for tpp in (1, 2, 4):
        for plan in tk.PLANS:
            p2 = _serve_pack(pt, net, 8192, tile=32, plan=plan, tpp=tpp)
            b = _args(p2)
            assert (b["tile"], b["tpp"], b["drift_kind"]) == (32, tpp, 2)
            assert tk._plan_of(p2) == plan


class _FakeLibrary:
    """The serve entry of the kernels' library: records the drift kind and
    the 4 kappa it was handed, and fills the output with the plain
    version's."""

    def __init__(self, fill):
        self.launches, self.fill = [], fill

    def pspde_controlled_rollout(self, params, noise, out, ws, iargs, fargs,
                                 seed, device, stream):
        ints = list(iargs)
        self.launches.append(ints)
        self.fill(out)
        return 0

    def pspde_cuda_error_string(self, err):
        return b"fake"


def test_serve_launch_against_a_fake_library(monkeypatch):
    pt = _problem(tp, 10, device="cpu")
    net = TanhMLP(11, 10, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    K, N = 700, 5
    plain = tk.reference_controlled_rollout(pt, net, K, N, 0.005, seed=3)
    want = torch.cat([plain.X, plain.ito[:, None], plain.riemann[:, None],
                      plain.f_int[:, None]], dim=1)
    fake = _FakeLibrary(lambda ptr: ctypes.memmove(
        ptr, want.data_ptr(), want.numel() * 4))
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(tk.fused_controlled_rollout, "launches", 0)
    monkeypatch.setattr(tk.fused_controlled_rollout, "launches_by_plan",
                        dict.fromkeys(tk.PLANS, 0))
    packed = _serve_pack(pt, net, K, N)
    out = tk._serve_kernel(packed, None, 3, torch.device("cpu"))
    for got, ref in zip(out, plain):
        assert torch.equal(got, ref)
    (ints,) = fake.launches
    assert ints == packed.iargs and _args(packed)["drift_kind"] == 2
    assert tk.fused_controlled_rollout.launches == 1


def test_launchers_dispatch_the_drift():
    """The serve's C entry picks the kDW instantiations by drift_kind 2 on
    both plans (launch and occupancy); the training kernels' and the
    ladder's entries refuse drift_kind 2."""
    with open(os.path.join(CSRC, "controlled_rollout.cu")) as f:
        serve = f.read()
    assert "const bool dw = a.drift_kind == 2;" in serve
    for what in ("launch", "occupancy"):
        for plan in ("true", "false"):
            assert f"{what}<{plan}, true>" in serve
            assert f"{what}<{plan}, false>" in serve
    assert re.search(r"train_forward_step<!kDevice, !kDevice, true, kSumIS, "
                     r"kDW>", serve)
    for src, n in (("train_rollout.cu", 3), ("roofline.cu", 1)):
        with open(os.path.join(CSRC, src)) as f:
            assert f.read().count("a.drift_kind == 2") == n, src


class _DiagWell(tp.DoubleWell_multidim):
    """Mixed double wells with a diagonal sigma: outside the serve's
    family."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._sigma = DiffusionMatrix(
            np.diag(np.linspace(1.0, 2.0, self.d)).astype(np.float32),
            device="cpu")


def test_double_well_family_errors():
    pt = _problem(tp, 1, device="cpu")
    _, _, net = _control(1)
    with pytest.raises(ValueError, match="serve kernel only"):
        tk.fused_train_rollout(pt, net, 8, 2, 0.1)
    diag = _DiagWell(d=4, d_1=2, d_2=2, device="cpu")
    assert diag.sigma_struct.kind == "diag"
    with pytest.raises(ValueError, match="sigma scalar and f zero"):
        tk.fused_controlled_rollout(diag, _control(4)[2], 8, 2, 0.1)
    # HJBSolver's 'fused_train' on the double well names its gates (a
    # warning on the CPU, a ValueError on the card)
    pt.compute_reference_solution(delta_t=0.05, nx=200)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s = TSolver("f", pt, delta_t=0.05, time_approx="inner",
                    detach_forward=True, rollout_mode="fused_train",
                    device="cpu")
    assert s.resolved_rollout_mode == "scan"
    assert any("u_ref_table" in str(x.message) for x in w)
    s2 = TSolver("f", pt, delta_t=0.05, time_approx="inner",
                 detach_forward=True, u_l2_error_flag=False, device="cpu")
    assert any("serve kernel only" in g for g in s2._fused_train_gates())
