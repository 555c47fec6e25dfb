"""The port's controlled rollout against pspde's (CPU).

The same numpy-made control weights and host noise go through the JAX
``reference_controlled_rollout`` (lax.scan), the JAX Pallas
``fused_controlled_rollout`` in interpret mode, and the port's plain
version and kernel front end (which takes the plain version on CPU
tensors).  Tolerance: atol 2e-5 on X, ito, riemann and f_int, the JAX
suite's own kernel-vs-scan tolerance (tests/test_pallas_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pspde.ansatz as ja
import pspde.problems as jp
import pspde.rollout.kernels as jk
import pspde_torch.problems as tp
from pspde_torch.rollout import kernels as tk
from pspde_torch.utils.convert import tanh_mlp_from_flax

ATOL = 2e-5

def _on_cpu(m):
    """The port's constructors take device="cpu"; pspde's take none."""
    return {"device": "cpu"} if m is tp else {}


PROBLEMS = {
    "llgc_scalar_sigma": lambda m: m.LLGC(d=4, T=1.0, **_on_cpu(m)),
    "llgc_full_sigma": lambda m: m.LLGC(d=4, T=1.0, off_diag=0.1,
                                        **_on_cpu(m)),
    "lqgc": lambda m: m.LQGC(d=4, T=1.0, off_diag=0.1, **_on_cpu(m)),
}


def _control(d, seed=0, hidden=(30, 30)):
    """A TanhMLP control with N(0, 1/fan_in) weights: the Flax tree, the
    JAX u_apply over its leaves, and the converted torch net."""
    rng = np.random.default_rng(seed)
    widths = (d + 1,) + hidden + (d,)
    tree = {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (rng.standard_normal(b) / np.sqrt(a)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}
    net = ja.TanhMLP(d_out=d, hidden=hidden)
    leaves, treedef = jax.tree.flatten(tree)

    def u_apply(leaves_t, tX):
        return -net.apply(jax.tree.unflatten(treedef, list(leaves_t)), tX)

    return u_apply, tuple(jnp.asarray(x) for x in leaves), \
        tanh_mlp_from_flax(tree, device="cpu")


def _noise(N, K, d, seed=1):
    return np.random.default_rng(seed).standard_normal((N, K, d)).astype(
        np.float32)


def _assert_match(port, jax_out):
    for name in ("X", "ito", "riemann", "f_int"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jax_out, name)),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case,K,noise_sign", [
    ("llgc_scalar_sigma", 512, 1.0),
    ("llgc_full_sigma", 512, 1.0),
    ("lqgc", 512, 1.0),
    ("llgc_scalar_sigma", 700, 1.0),     # K that the tile does not divide
    ("llgc_full_sigma", 512, -1.0),
    ("lqgc", 300, -1.0),
])
def test_rollout_matches_jax(case, K, noise_sign):
    N, dt = 20, 0.05
    pj, pt = PROBLEMS[case](jp), PROBLEMS[case](tp)
    u_apply, leaves, net = _control(pj.d)
    noise = _noise(N, K, pj.d)
    ref_j = jk.reference_controlled_rollout(
        pj, u_apply, leaves, K, N, dt, jax.random.PRNGKey(0),
        host_noise=noise_sign * noise)
    fused_j = jk.fused_controlled_rollout(
        pj, u_apply, leaves, K, N, dt, seed=0, tile=256, interpret=True,
        host_noise=jnp.asarray(noise), noise_sign=noise_sign)
    noise_t = torch.from_numpy(noise)
    plain = tk.reference_controlled_rollout(pt, net, K, N, dt,
                                            host_noise=noise_t,
                                            noise_sign=noise_sign)
    front = tk.fused_controlled_rollout(pt, net, K, N, dt,
                                        host_noise=noise_t,
                                        noise_sign=noise_sign)
    assert front.X.shape == (K, pj.d) and front.ito.shape == (K,)
    for port in (plain, front):
        _assert_match(port, ref_j)
        _assert_match(port, fused_j)
    if case == "lqgc":
        assert float(plain.f_int.abs().min()) > 0.0


def test_philox_known_answer():
    """Random123's known-answer vectors for Philox4x32-10."""
    def words(c, k):
        cs = [torch.tensor([v], dtype=torch.int64) for v in c]
        return [int(w) for w in tk.philox4x32_10(*cs, *k)]

    assert words((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    m = 0xFFFFFFFF
    assert words((m, m, m, m), (m, m)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                 (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_normals_moments():
    """2^18 draws: mean, variance and skewness within 5 standard errors
    of N(0, 1); the stream is a pure function of (seed, k, n, j)."""
    z = tk.philox_normals(seed=2024, K=2 ** 16, n=3, d=4).double()
    n = z.numel()
    assert n == 2 ** 18
    mean = float(z.mean())
    var = float(z.var())
    skew = float(((z - mean) ** 3).mean() / var ** 1.5)
    assert abs(mean) < 5 / np.sqrt(n)
    assert abs(var - 1.0) < 5 * np.sqrt(2.0 / n)
    assert abs(skew) < 5 * np.sqrt(6.0 / n)
    again = tk.philox_normals(seed=2024, K=8, n=3, d=4)
    torch.testing.assert_close(again, z[:8].float(), rtol=0, atol=0)
    other = tk.philox_normals(seed=2024, K=8, n=4, d=4)
    assert not torch.equal(other, again)
    # d not a multiple of 4 keeps the first d words of each group run
    torch.testing.assert_close(tk.philox_normals(2024, 8, 3, 3),
                               again[:, :3], rtol=0, atol=0)


def test_normals_from_bits_edges():
    bits = torch.tensor([0, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    z = tk.normals_from_bits(bits)
    assert torch.isfinite(z).all()
    assert float(z[0]) < -5.0 and float(z[1]) > 5.0
    assert float(z[2]) == 0.0


def test_rollout_philox_stream_and_antithetic_pairs():
    """Without host noise the plain version draws philox_normals, and two
    runs with noise_sign +1 / -1 on the same seed equal runs on the host
    stream and its negation."""
    pt = tp.LLGC(d=4, T=1.0, device="cpu")
    _, _, net = _control(4)
    K, N, dt, seed = 64, 6, 0.05, 99
    noise = torch.stack([tk.philox_normals(seed, K, n, 4) for n in range(N)])
    for sign in (1.0, -1.0):
        a = tk.fused_controlled_rollout(pt, net, K, N, dt, seed=seed,
                                        noise_sign=sign)
        b = tk.reference_controlled_rollout(pt, net, K, N, dt,
                                            host_noise=sign * noise)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


class _CubicDrift(tp.Problem):
    """dX = -X^3 dt + dW: a drift outside the kernel family."""

    def __init__(self, d):
        super().__init__(d=d, T=1.0, device="cpu")
        self._sigma = tp.DiffusionMatrix(np.eye(d), device="cpu")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return -x ** 3


def test_outside_kernel_family_raises():
    pt = tp.LLGC(d=4, T=1.0, device="cpu")
    _, _, net = _control(4)
    with pytest.raises(ValueError, match="the kernel covers"):
        tk.fused_controlled_rollout(_CubicDrift(4), net, 8, 2, 0.1)
    relu = nn.Sequential(nn.Linear(5, 4), nn.ReLU(), nn.Linear(4, 4))
    with pytest.raises(ValueError, match="not a TanhMLP"):
        tk.fused_controlled_rollout(pt, relu, 8, 2, 0.1)
    with pytest.raises(ValueError, match="noise_sign"):
        tk.fused_controlled_rollout(pt, net, 8, 2, 0.1, noise_sign=0.5)
    _, _, wide = _control(5)
    with pytest.raises(ValueError, match="do not match"):
        tk.fused_controlled_rollout(pt, wide, 8, 2, 0.1)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_controlled_rollout(pt, net, 8, 2, 0.1,
                                    host_noise=torch.zeros(2, 8, 3))
    with pytest.raises(ValueError, match="float32"):
        tk.fused_controlled_rollout(
            pt, net, 8, 2, 0.1,
            host_noise=torch.zeros(2, 8, 4, dtype=torch.float64))
    # the plain version takes any control
    tk.reference_controlled_rollout(pt, relu, 8, 2, 0.1)


@pytest.mark.parametrize("case,tile", [("llgc_d100", 64),
                                       ("lqgc_d100_dense", 32)])
def test_kernel_layout_at_serve_shapes(case, tile):
    """The serve kernel's arguments are the HJB training forward's
    (TrainArgs) with the serve's flags: the net as it is (the kernel's
    step computes Z, and u = -Z is the adaptive update's control), the
    adaptive update, the erfinv map, no u_tab, f where the cost has one
    (c_h 0, f_coef 1), float4-aligned sections, widths padded to the
    chunk; LLGC at K=2^20 as the wrapper lays it out, tile 64 x 4 threads
    a path, the dense LQGC at K=8192 at tile 32 (the tile chip_smoke.py's
    phase 3 forces beside the wrapper's 64), 4 threads a path; each block
    within the 227 KB a block may use."""
    if case == "llgc_d100":
        pt = tp.LLGC(d=100, T=1.0, device="cpu")
        K = 2 ** 20
    else:
        pt = tp.LQGC(d=100, T=1.0, off_diag=0.05, device="cpu")
        K = 8192
    net = tk.TanhMLP(101, 100, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    drift, cost = tk._check_family(pt, net, True, 1.0)
    packed = tk._pack(pt, net, drift, cost, K=K, N=100, delta_t=0.01,
                      tile=None if tile == 64 else tile, host_noise=None,
                      noise_sign=1.0)
    ia, M = packed.iargs, tk._MAX_LAYERS
    assert ia[:6] == [K, 100, 100, 104, 3, tile]
    n_layers = ia[4]
    cols = ia[22 + M:22 + M + n_layers]
    w_off = ia[22 + 2 * M:22 + 3 * M][:n_layers]
    b_off = ia[22 + 3 * M:22 + 4 * M][:n_layers]
    assert cols == [32, 32, 104]
    assert all(o % 4 == 0 for o in w_off + b_off + ia[7:13:2])
    last = net.layers[-1]
    W2 = packed.params[w_off[2]:w_off[2] + 32 * 104].reshape(32, 104)
    torch.testing.assert_close(W2[:30, :100], last.weight.detach().T)
    assert float(W2[30:].abs().sum() + W2[:, 100:].abs().sum()) == 0.0
    dense = case != "llgc_d100"
    # drift_kind, sig_kind, f_kind
    assert (ia[6], ia[8], ia[10]) == ((1, 2, 1) if dense else (0, 0, 0))
    # have_u, host_noise, adaptive, accumulate_kl, kl_ito, rng (erfinv)
    assert ia[15:21] == [0, 0, 1, 0, 0, 0]
    # backward, tpp, plan (shared), ws_stride
    assert ia[-4:] == [0, 4, 0, 0] and tk._plan_of(packed) == "shared"
    dt, sq_dt = float(np.float32(0.01)), float(np.float32(0.1))
    assert packed.fargs == [dt, sq_dt, 1.0, 0.0 if dense else 1.0, 0.0, 1.0]
    per_path = 104 * (3 if dense else 2) + 64
    net_floats = tk._train_fwd_net_floats(
        tk._layout(pt, net, drift, cost), 104)
    smem = tk._train_smem_bytes(net_floats + 3 * tk._SUM_CLASSES * tile,
                                per_path, tile)
    assert smem <= tk._SMEM_LIMIT
    assert tile * ia[-3] <= tk._FWD_THREADS
