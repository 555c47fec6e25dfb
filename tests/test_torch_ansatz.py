"""pspde_torch ansatz modules on converted Flax parameters against Flax
``apply`` (CPU), and the exported control asset.

Tolerance: atol 1e-6 on outputs of size O(1)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
from pspde_torch.ansatz import DenseNet, ScalarParam, TanhMLP
from pspde_torch.solvers import HJBSolver
from pspde_torch.utils.convert import (dense_net_from_flax,
                                       dense_net_to_flax, load_control_npz,
                                       scalar_param_from_flax,
                                       tanh_mlp_from_flax,
                                       tanh_mlp_state_dict, unflatten_tree)

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "pspde_torch", "assets", "llgc_d100_tanhmlp.npz")


def _flax_tanh_mlp(d_in, d_out, hidden, seed):
    """Flax TanhMLP params with N(0, 1/fan_in) entries, so activations are
    O(1) (the N(0, 0.01) init would leave every tanh in its linear
    range)."""
    net = ja.TanhMLP(d_out=d_out, hidden=hidden)
    tree = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d_in)))
    rng = np.random.default_rng(seed)
    fan_in = dict(zip([f"Dense_{i}" for i in range(len(hidden) + 1)],
                      (d_in,) + tuple(hidden)))
    tree = {"params": {
        name: {k: (rng.standard_normal(a.shape) / np.sqrt(fan_in[name]))
               .astype(np.float32) for k, a in layer.items()}
        for name, layer in jax.device_get(tree)["params"].items()}}
    return net, tree


@pytest.mark.parametrize("d_in,d_out,hidden", [(101, 100, (30, 30)),
                                               (5, 3, (7,)),
                                               (9, 8, (13, 6, 11))])
def test_tanh_mlp_matches_flax(d_in, d_out, hidden):
    jnet, tree = _flax_tanh_mlp(d_in, d_out, hidden, seed=d_in)
    x = np.random.default_rng(1).standard_normal((64, d_in)).astype(
        np.float32)
    want = np.asarray(jnet.apply(tree, jnp.asarray(x)))
    tnet = tanh_mlp_from_flax(tree, device="cpu")
    assert tnet.hidden == hidden
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_tanh_mlp_state_dict_layout():
    _, tree = _flax_tanh_mlp(4, 2, (3,), seed=0)
    state = tanh_mlp_state_dict(tree)
    k0 = tree["params"]["Dense_0"]["kernel"]
    assert state["layers.0.weight"].shape == (3, 4)       # (out, in)
    np.testing.assert_array_equal(state["layers.0.weight"].numpy(), k0.T)
    net = TanhMLP(4, 2, hidden=(3,), device="cpu")
    net.load_state_dict(state)


def test_tanh_mlp_seeded_init():
    a = TanhMLP(5, 4, generator=torch.Generator().manual_seed(3),
                device="cpu")
    b = TanhMLP(5, 4, generator=torch.Generator().manual_seed(3),
                device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w = torch.cat([p.detach().flatten() for p in a.parameters()])
    assert 0.005 < float(w.std()) < 0.02   # N(0, 0.01^2) weights and biases


def test_scalar_param_matches_flax():
    jnet = ja.ScalarParam(initial=0.0)
    tree = {"params": {"Y_0": np.array([1.25], dtype=np.float32)}}
    x = np.zeros((7, 1), dtype=np.float32)
    want = np.asarray(jnet.apply(tree, jnp.asarray(x)))
    got = scalar_param_from_flax(tree, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    assert ScalarParam(initial=0.5, device="cpu")(
        torch.zeros(3, 1)).shape == (3,)


def test_load_control_npz_round_trip(tmp_path):
    from experiments.export_llgc_control import flatten_tree
    _, z = _flax_tanh_mlp(6, 5, (4, 4), seed=2)
    tree = {"z": z, "y0": {"params": {"Y_0": np.array([0.5], np.float32)}}}
    path = str(tmp_path / "control.npz")
    np.savez(path, __meta__=np.array('{"d": 5}'), **flatten_tree(tree))
    back, meta = load_control_npz(path)
    assert meta == {"d": 5}
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert unflatten_tree({"a/b": 1, "a/c": 2}) == {"a": {"b": 1, "c": 2}}


def test_exported_asset_serves_as_flax_control():
    tree, meta = load_control_npz(ASSET)
    assert meta["d"] == 100 and meta["problem"] == "LLGC"
    assert tree["z"]["params"]["Dense_0"]["kernel"].shape == (101, 30)
    assert tree["z"]["params"]["Dense_2"]["kernel"].shape == (30, 100)
    from pspde_torch.problems import LLGC
    solver = HJBSolver("asset", LLGC(d=100, T=1.0, device="cpu"), K=64,
                       delta_t=meta["delta_t"], time_approx="inner",
                       learn_Y_0=True, device="cpu")
    assert solver.load_jax_params(ASSET) == meta
    x = np.random.default_rng(0).standard_normal((32, 100)).astype(
        np.float32)
    tX = np.concatenate([np.full((32, 1), 0.25, np.float32), x], axis=1)
    want = -np.asarray(ja.TanhMLP(d_out=100).apply(tree["z"],
                                                   jnp.asarray(tX)))
    got = solver.u(torch.from_numpy(x), 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        float(solver.y0_net.Y_0.detach()[0]),
        float(tree["y0"]["params"]["Y_0"][0]), rtol=0)


@pytest.mark.parametrize("d,arch,bias,output_relu", [
    (50, (30, 30), 0.0, False),
    (50, (70, 50, 50, 50), 0.0, False),
    (3, (5,), 0.8, True),
])
def test_dense_net_matches_flax(d, arch, bias, output_relu):
    """DenseNet forward and grad_x V on converted Flax parameters, rtol
    1e-5 (float32 sums in another order; relu^2 features)."""
    jnet = ja.DenseNet(d_out=1, arch=arch, bias_init_value=bias,
                       output_relu=output_relu, weight_scale=0.3)
    tree = jax.device_get(jnet.init(jax.random.PRNGKey(d), jnp.zeros((1,
                                                                      d))))
    x = (np.random.default_rng(2).standard_normal((64, d)) / np.sqrt(d)
         ).astype(np.float32)
    v_of_x = lambda X: jnet.apply(tree, X)[:, 0]
    want_v = np.asarray(v_of_x(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda X: jnp.sum(v_of_x(X)))(
        jnp.asarray(x)))
    tnet = dense_net_from_flax(tree, output_relu=output_relu, device="cpu")
    assert tnet.arch == arch and tnet.d_in == d and tnet.d_out == 1
    xt = torch.from_numpy(x).requires_grad_(True)
    v = tnet(xt)[:, 0]
    (g,) = torch.autograd.grad(v.sum(), xt)
    scale = float(np.abs(want_v).max())
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))
    back = dense_net_to_flax(list(tnet.parameters()))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_dense_net_init_and_layout():
    a = DenseNet(1, (6, 4), d_in=3, generator=torch.Generator().manual_seed(
        5), device="cpu")
    b = DenseNet(1, (6, 4), d_in=3, generator=torch.Generator().manual_seed(
        5), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert [tuple(lin.weight.shape) for lin in a.layers] == [(6, 3), (4, 9),
                                                             (1, 13)]
    assert all(float(lin.bias.detach().abs().max()) == 0.0
               for lin in a.layers)
    c = DenseNet(2, (4,), bias_init_value=0.1, d_in=3, device="cpu")
    assert float(c.layers[0].bias[0]) == pytest.approx(0.1)
    assert c(torch.zeros(7, 3)).shape == (7, 2)
    bad = {"params": {"Dense_0": {"kernel": np.zeros((3, 4), np.float32),
                                  "bias": np.zeros(4, np.float32)},
                      "Dense_1": {"kernel": np.zeros((4, 1), np.float32),
                                  "bias": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError, match="concat-skip"):
        dense_net_from_flax(bad, device="cpu")
