"""Shared parts of the correctors' parity tests (test_torch_refine.py,
test_torch_picard.py, test_torch_eigen_power.py; not a test module: pytest
collects test_*.py only): JAX's draws as the port's hooks take them, the
net conversions, the comparisons, the nets, and the test problems: a
pair whose h reads t, y and z, the committor's spheres with a continuous
g, and pspde's h = y problem of tests/test_refine.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.problems.base import DiffusionMatrix as JDiffusion
from pspde.problems.base import Geometry as JGeometry
from pspde.problems.base import Problem as JProblem
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for each test of a module that imports this: the
    correctors' refits are thousands of small ops, which a thread pool
    shared with other test workers slows several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the tolerances of the slice: paths rtol 2e-5; targets, values and stderr
# rtol 2e-4; refit parameters atol 2e-5 against optax.adam
PATH_RTOL, VALUE_RTOL, PARAM_ATOL = 2e-5, 2e-4, 2e-5


def tt(a) -> torch.Tensor:
    """A JAX (or numpy) array as a CPU float32 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


@jax.jit
def _normal(key, n, shape_like):
    return jax.random.normal(jax.random.fold_in(key, n), shape_like.shape)


def jax_noise(key, R, d):
    """n -> jax.random.normal(jax.random.fold_in(key, n), (R, d)), the
    normals of step n of every JAX corrector chain, as a tensor."""
    like = jnp.zeros((R, d), jnp.float32)
    return lambda n: tt(_normal(key, n, like))


def close(got, want, rtol=VALUE_RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().cpu().numpy()
                                          if torch.is_tensor(got) else got,
                                          dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def means_close(got, want):
    """Averages over paths (targets): rtol 2e-4, with a floor of 1e-6 of
    the largest entry for an average that cancels to near 0."""
    want = np.asarray(want, dtype=np.float64)
    close(got, want, atol=1e-6 * float(np.abs(want).max()))


def paths_close(got, want):
    """Per-path outputs: rtol 2e-5 with a floor of 2e-5 of the largest."""
    want = np.asarray(want, dtype=np.float64)
    close(got, want, rtol=PATH_RTOL,
          atol=PATH_RTOL * float(np.abs(want).max()))


def to_torch_net(net_j, params, cls):
    """The port's concat-skip net of class ``cls`` carrying ``params``."""
    return dense_net_from_flax(jax.device_get(params), device="cpu",
                               cls=cls, output_relu=getattr(
                                   net_j, "output_relu", False))


def params_close(net_t, params_j, atol=PARAM_ATOL):
    got = dense_net_to_flax(list(net_t.parameters()))["params"]
    want = jax.device_get(params_j)["params"]
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][leaf],
                                       np.asarray(want[name][leaf]),
                                       rtol=0.0, atol=atol,
                                       err_msg=f"{name}/{leaf}")


class JaxZH(JProblem):
    """Unbounded test problem with drift -x/2, a diagonal sigma and
    h = y/2 - |z|^2/10 + t/5 (t a scalar or per-row vector)."""

    def __init__(self, d=3, T=0.2):
        super().__init__(d=d, T=T)
        self._sigma = JDiffusion(jnp.diag(jnp.linspace(0.8, 1.2, d)))
        self.geometry = JGeometry(kind="unbounded", boundary_distance=1.5)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return -0.5 * x

    def h(self, t, x, y, z):
        zz = 0.0 if z is None else 0.1 * jnp.sum(z * z, axis=-1)
        return 0.5 * y - zz + 0.2 * t

    def f_terminal(self, x):
        return 0.5 * jnp.sum(x * x, axis=-1)


class TorchZH(tp.Problem):
    """The port's counterpart of ``JaxZH``."""

    def __init__(self, d=3, T=0.2):
        super().__init__(d=d, T=T, device="cpu")
        self._sigma = tp.DiffusionMatrix(np.diag(np.asarray(
            jnp.linspace(0.8, 1.2, d))), device="cpu")
        self.geometry = tp.Geometry(kind="unbounded", boundary_distance=1.5)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return -0.5 * x

    def h(self, t, x, y, z):
        zz = 0.0 if z is None else 0.1 * torch.sum(z * z, dim=-1)
        return 0.5 * y - zz + 0.2 * t

    def f_terminal(self, x):
        return 0.5 * torch.sum(x * x, dim=-1)


def space_time_net(d, seed=0):
    net = JDenseNet(d_out=1, arch=(12, 8))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d + 1)))
    tnet = to_torch_net(net, params, DenseNet)

    def vj(X, t):
        return net.apply(params, jnp.concatenate([X, t[:, None]], -1))[:, 0]

    def vt(X, t):
        return tnet(torch.cat([X, t[:, None]], -1))[:, 0]

    return vj, vt


def ball_net(d, seed=0):
    net = JDenseNet(d_out=1, arch=(12, 8))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))
    tnet = to_torch_net(net, params, DenseNet)
    return (lambda X: net.apply(params, X)[:, 0],
            lambda X: tnet(X)[:, 0])


class _JaxCommittorR2(jp.Committor):
    """The committor's two spheres with a continuous g = |x|^2 / 4: its
    own g, the indicator |x| > 1, flips on the inner sphere with the last
    bit of the projected radius, which XLA and PyTorch round apart."""

    def g(self, x):
        return 0.25 * jnp.sum(x * x, axis=-1)


class _TorchCommittorR2(tp.Committor):
    def g(self, x):
        return 0.25 * torch.sum(x * x, dim=-1)


ELLIPTIC = {
    "committor": lambda: (_JaxCommittorR2(d=3),
                          _TorchCommittorR2(d=3, device="cpu")),
    "ball_sin": lambda: (jp.ExponentialOnBallNonlinearSin(d=3, alpha=1.0),
                         tp.ExponentialOnBallNonlinearSin(d=3, alpha=1.0,
                                                          device="cpu")),
}


class LinearH(tp.Problem):
    """h = y: v = e^(T-t) (|x|^2 + 2 (T-t) d) (tests/test_refine.py)."""

    def __init__(self, d=3, T=0.25):
        super().__init__(d=d, T=T, device="cpu")
        self._sigma = tp.DiffusionMatrix(np.sqrt(2.0) * np.eye(d),
                                         device="cpu")
        self.geometry = tp.Geometry(kind="unbounded", boundary_distance=1.0)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return torch.zeros_like(x)

    def h(self, t, x, y, z):
        return y

    def f_terminal(self, x):
        return torch.sum(x * x, dim=-1)

    def v_true(self, x, t):
        return torch.exp(self.T - t) * (torch.sum(x * x, dim=-1)
                                        + 2.0 * (self.T - t) * self.d)
