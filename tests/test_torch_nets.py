"""The rest of ``pspde/ansatz/nets.py`` in the port (``DenseNetTanh``,
``DenseNetTanh2``, ``DenseNetRelu``, ``BatchNormMLP``, ``ReluMLP1d``,
``Sines``, ``ConstantVector``, ``Affine``) against the Flax modules on
converted parameters (CPU).

Each Flax tree is the module's own ``init`` with every leaf redrawn from a
numpy seed (kernels N(0, 1/fan_in), the rest N(0, 0.25), BatchNorm's
scales 1 + N(0, 0.01)), so that zero-initialised leaves (biases, Affine)
are exercised too; ``flax_state_dict`` carries it into the port's module,
and the gradients of sum(out * C), C a fixed numpy draw, are compared leaf
by leaf after the same map.  Tolerances: outputs rtol 1e-6 with an
absolute floor of 1e-6 x sqrt(n) x the largest output, n the longest
float32 sum of the net (the features of the last layer, the sines, the
batch of a normalization): XLA and PyTorch sum in another order, and the
reordering's rounding grows like sqrt(n) ulps (Sines at M=25 reads 1.4e-6
of its largest output).  Parameter gradients rtol 1e-5 with a floor of
1e-5 x the largest gradient entry of all leaves: BatchNormMLP's first two
bn_bias leaves get none by construction (the next normalization subtracts
the batch mean) and read float32 roundoff.  Each net runs at two
widths.  The port's
initialisers are held to Flax's laws by moments, and the concat-skip nets
to one base class whose feature map the stopped kernels read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
from pspde_torch import ansatz as ta
from pspde_torch.utils.convert import (dense_net_from_flax,
                                       eigen_params_from_flax,
                                       flax_state_dict)

B = 64
OUT_RTOL, GRAD_RTOL = 1e-6, 1e-5


def _concat(cls, jcls, clamp=False):
    def build(d_in, arch):
        jkw = dict(output_relu=True) if clamp else {}
        return (jcls(d_out=1, arch=arch, **jkw),
                cls(1, arch, d_in=d_in, device="cpu", **jkw), d_in)
    return build


# name: (builder (d_in, width) -> (Flax module, port module, input width),
#        the two (d_in, width, longest sum))
CASES = {
    "DenseNetTanh": (_concat(ta.DenseNetTanh, ja.DenseNetTanh),
                     [(4, (8, 8), 20), (10, (15, 15, 15, 15), 70)]),
    "DenseNetTanh_clamp": (_concat(ta.DenseNetTanh, ja.DenseNetTanh, True),
                           [(4, (8,), 12), (10, (15, 15, 15, 15), 70)]),
    "DenseNetTanh2": (_concat(ta.DenseNetTanh2, ja.DenseNetTanh2),
                      [(3, (6,), 9), (10, (30, 30), 70)]),
    "DenseNetRelu": (_concat(ta.DenseNetRelu, ja.DenseNetRelu),
                     [(3, (6,), 9), (10, (15, 15, 15, 15), 70)]),
    "BatchNormMLP": (lambda d_in, w: (ja.BatchNormMLP(d_out=2, hidden=w),
                                      ta.BatchNormMLP(2, w, d_in=d_in,
                                                      device="cpu"), d_in),
                     [(3, 5, B), (8, 20, B)]),
    "ReluMLP1d": (lambda d_in, w: (ja.ReluMLP1d(hidden=w),
                                   ta.ReluMLP1d(w, d_in=d_in, device="cpu"),
                                   d_in), [(1, 16, 16), (3, 40, 40)]),
    "Sines": (lambda d_in, w: (ja.Sines(M=w), ta.Sines(w, device="cpu"), 1),
              [(1, 10, 10), (1, 25, 25)]),
    "ConstantVector": (lambda d_in, w: (ja.ConstantVector(d=w),
                                        ta.ConstantVector(w, device="cpu"),
                                        d_in), [(2, 3, 1), (5, 12, 1)]),
    "Affine": (lambda d_in, w: (ja.Affine(d_out=w),
                                ta.Affine(w, d_in=d_in, device="cpu"), d_in),
               [(3, 2, 3), (10, 7, 10)]),
}


def _redraw(tree, seed):
    """Every leaf of a Flax tree redrawn: kernels N(0, 1/fan_in),
    BatchNorm's scales 1 + N(0, 0.01), the rest N(0, 0.25)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "kernel" in name:
            return (rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
                    ).astype(np.float32)
        if "bn_scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


@pytest.mark.parametrize("name,width", [(n, i) for n in CASES
                                        for i in range(2)])
def test_net_matches_flax(name, width):
    """Outputs and the parameters' gradients of one net against Flax on
    converted parameters."""
    build, widths = CASES[name]
    d_in, w, n_sum = widths[width]
    jnet, tnet, d_x = build(d_in, w)
    rng = np.random.default_rng(width)
    x = rng.uniform(-2.0, 2.0, (B, d_x)).astype(np.float32)
    tree = _redraw(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                   seed=7 + width)
    want = np.asarray(jnet.apply(tree, jnp.asarray(x)))
    C = rng.standard_normal(want.shape).astype(np.float32)
    g_want = jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x))
                                        * C))(tree)
    tnet.load_state_dict(flax_state_dict(tnet, tree))
    got = tnet(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=OUT_RTOL,
        atol=OUT_RTOL * np.sqrt(n_sum) * float(np.abs(want).max()))
    names = [n for n, _ in tnet.named_parameters()]
    g_got = torch.autograd.grad((got * torch.from_numpy(C)).sum(),
                                list(tnet.parameters()))
    g_ref = flax_state_dict(tnet, jax.device_get(g_want))
    assert set(names) <= set(g_ref)
    top = max(float(g_ref[n].abs().max()) for n in names)
    for n, g in zip(names, g_got):
        np.testing.assert_allclose(g.numpy(), g_ref[n].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_RTOL * top,
                                   err_msg=n)


@pytest.mark.parametrize("cls,feature,kw", [
    (ta.DenseNet, "relu2", dict(output_relu=True)),
    (ta.DenseNetTanh, "tanh", dict(output_relu=True)),
    (ta.DenseNetTanh2, "tanh2", {}),
    (ta.DenseNetRelu, "relu", {}),
])
def test_concat_skip_nets_share_the_layout(cls, feature, kw):
    """The four concat-skip nets are one ConcatSkipNet with their feature
    map: the DenseNet's state-dict names and widths, d_in/arch/d_out, the
    clamp where Flax has one; the converters rebuild each class from its
    tree, and the eigen solver's tree with lambda."""
    net = cls(1, (6, 4), d_in=3, device="cpu", **kw)
    assert isinstance(net, ta.ConcatSkipNet) and net.feature == feature
    assert [n for n, _ in net.named_parameters()] == [
        f"layers.{i}.{k}" for i in range(3) for k in ("weight", "bias")]
    assert [tuple(lin.weight.shape) for lin in net.layers] == [
        (6, 3), (4, 9), (1, 13)]
    assert (net.d_in, net.arch, net.d_out) == (3, (6, 4), 1)
    assert net.output_relu == bool(kw)
    tree = {"params": {f"Dense_{i}": {
        "kernel": np.asarray(lin.weight.detach().T),
        "bias": np.asarray(lin.bias.detach())}
        for i, lin in enumerate(net.layers)}}
    back = dense_net_from_flax(tree, output_relu=bool(kw), device="cpu",
                               cls=cls)
    assert type(back) is cls and back.output_relu == bool(kw)
    x = torch.randn(5, 3)
    torch.testing.assert_close(back(x), net(x), rtol=0, atol=0)
    V, lam = eigen_params_from_flax(
        {"V": tree, "lam": {"params": {"Y_0": np.array([-2.0], np.float32)}}},
        output_relu=bool(kw), device="cpu", cls=cls)
    assert type(V) is cls and float(lam.Y_0.detach()[0]) == -2.0
    again = net.redraw(torch.Generator().manual_seed(3))
    assert type(again) is cls and again.output_relu == net.output_relu


def test_initialisers_follow_flax():
    """Moments of the port's initialisers against Flax's distributions:
    DenseNetTanh and ReluMLP1d lecun_normal weights (a truncated normal of
    variance 1/fan_in, within [-2, 2] standard deviations of the truncated
    law's scale) and zero biases; DenseNetTanh2 0.1 N(0, 1), zero bias;
    DenseNetRelu 0.01 N(0, 1) + 0.01, bias 0.1; BatchNormMLP N(0, 1)
    weights, scales 1, biases 0; Sines' and ConstantVector's N(0, 1);
    Affine zero.  Seeded inits repeat."""
    g = torch.Generator().manual_seed(0)
    t = ta.DenseNetTanh(1, (400, 400), d_in=300, generator=g, device="cpu")
    W = t.layers[1].weight.detach()
    std = (1.0 / 700) ** 0.5
    assert abs(float(W.std()) / std - 1.0) < 0.02
    assert float(W.abs().max()) <= 2.0 * std / .87962566103423978 + 1e-7
    assert all(float(lin.bias.abs().max()) == 0.0 for lin in t.layers)
    r1 = ta.ReluMLP1d(2000, d_in=50, generator=g, device="cpu")
    assert abs(float(r1.layers[0].weight.std()) / 50 ** -0.5 - 1.0) < 0.02
    t2 = ta.DenseNetTanh2(1, (500,), d_in=400, generator=g, device="cpu")
    assert abs(float(t2.layers[0].weight.std()) - 0.1) < 0.002
    dr = ta.DenseNetRelu(1, (500,), d_in=400, generator=g, device="cpu")
    w = dr.layers[0].weight.detach()
    assert abs(float(w.mean()) - 0.01) < 0.0005
    assert abs(float(w.std()) - 0.01) < 0.0005
    assert float(dr.layers[0].bias[0]) == pytest.approx(0.1)
    bn = ta.BatchNormMLP(300, 400, d_in=200, generator=g, device="cpu")
    assert abs(float(bn.layers[0].weight.std()) - 1.0) < 0.02
    assert float(bn.bn_scale_1.sum()) == 400 and float(
        bn.bn_bias_2.abs().sum()) == 0.0
    s = ta.Sines(20000, generator=g, device="cpu")
    assert abs(float(s.alpha.std()) - 1.0) < 0.03
    assert torch.equal(s.omega[0, :3], torch.tensor([1.0, 2.0, 3.0]))
    c = ta.ConstantVector(20000, generator=g, device="cpu")
    assert abs(float(c.c.std()) - 1.0) < 0.03
    a = ta.Affine(3, d_in=4, device="cpu")
    assert float(a.A.abs().sum() + a.b.abs().sum()) == 0.0
    for cls, args in ((ta.DenseNetTanh, (1, (5,))), (ta.Sines, (4,))):
        kw = dict(d_in=3) if cls is ta.DenseNetTanh else {}
        p1, p2 = (list(cls(*args, **kw, device="cpu",
                           generator=torch.Generator().manual_seed(9))
                       .parameters()) for _ in range(2))
        for x, y in zip(p1, p2):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
