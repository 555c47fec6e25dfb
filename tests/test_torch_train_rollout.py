"""The port's training rollout against pspde's (CPU).

* ``pspde_torch.rollout.sde.hjb_rollout`` (plain autograd loop) against
  ``pspde.rollout.sde.hjb_rollout`` (lax.scan) on the JAX noise stream
  ``normal(fold_in(key, n), (K, d))``, injected into the port: outputs and
  the parameter gradients of a log-variance (+ KL) loss.
* ``fused_train_rollout`` on CPU tensors (its plain forward and replay
  backward through the ``autograd.Function``) against pspde's
  ``make_fused_train_rollout`` in interpret mode on the same host noise,
  as tests/test_fused_training.py runs it.
* the binom and erfinv bit maps against a numpy transcription of
  ``pspde/rollout/kernels.py:_normals_from_bits_*`` on fixed bits.

Tolerances are the JAX suite's own kernel-vs-scan ones
(tests/test_fused_training.py): X 2e-5, Y / u_l2 / Z_sum 2e-4, gradients
rtol 5e-3 with atol 5e-6.  Sizes: d=6, K=64, N=12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from torch import nn

import pspde.ansatz as ja
import pspde.problems as jp
from pspde.losses.pathspace import log_variance_loss as j_logvar
from pspde.rollout import sde as jsde
import pspde_torch.problems as tp
from pspde_torch.losses import log_variance_loss as t_logvar
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout import sde as tsde
from pspde_torch.utils.convert import tanh_mlp_from_flax, tanh_mlp_to_flax

K, D, N, DT = 64, 6, 12, 1.0 / 12
X_TOL, Y_TOL, G_RTOL, G_ATOL = 2e-5, 2e-4, 5e-3, 5e-6

def _on_cpu(m):
    """The port's constructors take device="cpu"; pspde's take none."""
    return {"device": "cpu"} if m is tp else {}


PROBLEMS = {
    "llgc": lambda m: m.LLGC(d=D, T=1.0, **_on_cpu(m)),
    "lqgc": lambda m: m.LQGC(d=D, T=1.0, off_diag=0.1, **_on_cpu(m)),
}


def _tree(seed=0, hidden=(30, 30), scale=0.3):
    """A TanhMLP parameter tree with N(0, scale^2 / fan_in) entries."""
    rng = np.random.default_rng(seed)
    widths = (D + 1,) + hidden + (D,)
    return {"params": {f"Dense_{i}": {
        "kernel": (scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (scale * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}


def _jax_noise(key, K_draw):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, n), (K_draw, D), dtype=jnp.float32))
        for n in range(N)])


def _loss_j(p, out, kl):
    gX = p.g(out.X)
    loss = j_logvar(out.Y, gX)
    return loss + jnp.mean(out.Z_sum + gX) if kl else loss


def _loss_t(p, out, kl):
    gX = p.g(out.X)
    loss = t_logvar(out.Y, gX)
    return loss + torch.mean(out.Z_sum + gX) if kl else loss


def _assert_grads(t_grads, j_tree):
    t_tree = tanh_mlp_to_flax(t_grads)
    for a, b in zip(jax.tree.leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL)


@pytest.mark.parametrize("case,adaptive,detach,kl,ito,antithetic,remat", [
    ("llgc", True, True, False, False, False, False),
    ("llgc", False, True, False, False, False, False),
    ("llgc", True, False, True, False, False, True),
    ("llgc", True, True, True, True, True, False),
    ("lqgc", True, True, True, False, False, False),
    ("lqgc", False, False, True, True, True, False),
])
def test_hjb_rollout_matches_jax(case, adaptive, detach, kl, ito, antithetic,
                                 remat):
    pj, pt = PROBLEMS[case](jp), PROBLEMS[case](tp)
    tree = _tree()
    net_j = ja.TanhMLP(d_out=D)
    net_t = tanh_mlp_from_flax(tree, device="cpu")
    cfg_kw = dict(N=N, delta_t=DT, adaptive_forward=adaptive,
                  detach_forward=detach, accumulate_kl=kl, kl_ito_term=ito,
                  antithetic=antithetic, remat=remat)
    cfg_j = jsde.HJBRolloutConfig(**cfg_kw)
    cfg_t = tsde.HJBRolloutConfig(**cfg_kw)
    ts = np.arange(N) * DT
    u_ref_j, u_ref_t = pj.u_ref_fn(ts), pt.u_ref_fn(ts)
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(_jax_noise(key, K // 2 if antithetic else K))
    Y0 = np.full((K,), 0.25, np.float32)

    def ctrl_j(params, X, n, t):
        tX = jnp.concatenate([jnp.zeros((X.shape[0], 1)) + t, X], axis=1)
        return net_j.apply(params, tX), None

    def run_j(params):
        out = jsde.hjb_rollout(cfg_j, pj, ctrl_j, params,
                               jnp.broadcast_to(pj.X_0, (K, D)),
                               jnp.asarray(Y0), key, u_ref=u_ref_j)
        return _loss_j(pj, out, kl), out

    def ctrl_t(X, n, t):
        tX = torch.cat([torch.full((X.shape[0], 1), t), X], dim=1)
        return net_t(tX), None

    (_, out_j), g_j = jax.value_and_grad(run_j, has_aux=True)(tree)
    out_t = tsde.hjb_rollout(cfg_t, pt, ctrl_t, pt.X_0.expand(K, D),
                             torch.from_numpy(Y0), u_ref=u_ref_t,
                             host_noise=noise)
    np.testing.assert_allclose(out_t.X.detach(), out_j.X, rtol=X_TOL,
                               atol=X_TOL)
    for name in ("Y", "Z_sum", "u_l2"):
        np.testing.assert_allclose(getattr(out_t, name).detach(),
                                   getattr(out_j, name), rtol=Y_TOL,
                                   atol=Y_TOL, err_msg=name)
    assert float(out_t.u_l2.min()) > 0.0
    g_t = torch.autograd.grad(_loss_t(pt, out_t, kl),
                              list(net_t.parameters()))
    _assert_grads(g_t, g_j)


@pytest.mark.parametrize("kl,sign,adaptive", [(False, 1.0, True),
                                              (True, -1.0, False)])
def test_fused_train_rollout_matches_jax_kernel(kl, sign, adaptive):
    """The port's fused_train_rollout on CPU tensors against
    make_fused_train_rollout(interpret=True, host_noise=...): outputs and
    the gradients of its custom VJP."""
    from pspde.ansatz.transposed import make_transposed_apply
    from pspde.rollout.kernels import make_fused_train_rollout

    pj, pt = jp.LLGC(d=D, T=1.0), tp.LLGC(d=D, T=1.0, device="cpu")
    tree = _tree(seed=1)
    net_t = tanh_mlp_from_flax(tree, device="cpu")
    noise = _jax_noise(jax.random.PRNGKey(3), K)             # (N, K, d)
    ts = np.arange(N) * DT
    u_tab = None if kl else pt.u_ref_table(ts)
    leaves_ex, z_apply_T = make_transposed_apply(ja.TanhMLP(d_out=D), tree)
    run = make_fused_train_rollout(
        pj, z_apply_T, leaves_ex, K, N, DT, adaptive_forward=adaptive,
        accumulate_kl=kl, kl_ito_term=kl,
        u_tab=None if kl else pj.u_ref_table(ts), tile=32, interpret=True,
        host_noise=jnp.transpose(jnp.asarray(noise), (0, 2, 1)),
        noise_sign=sign)
    leaves = tuple(jax.tree.leaves(tree))
    out_j = run(leaves, jnp.float32(0))
    out_t = tk.fused_train_rollout(
        pt, net_t, K, N, DT, adaptive_forward=adaptive, accumulate_kl=kl,
        kl_ito_term=kl, u_tab=u_tab, noise_sign=sign,
        host_noise=torch.from_numpy(noise))
    assert not out_t.X.requires_grad and not out_t.u_l2.requires_grad
    np.testing.assert_allclose(out_t.X, np.asarray(out_j.XT).T, rtol=X_TOL,
                               atol=X_TOL)
    for name in ("Y", "Z_sum", "u_l2"):
        np.testing.assert_allclose(getattr(out_t, name).detach(),
                                   getattr(out_j, name), rtol=Y_TOL,
                                   atol=Y_TOL, err_msg=name)

    def loss_j(lv):
        o = run(lv, jnp.float32(0))
        gX = pj.g(o.XT.T)
        return j_logvar(o.Y, gX) + (jnp.mean(o.Z_sum + gX) if kl else 0.0)

    g_j = jax.tree.unflatten(jax.tree.structure(tree),
                             list(jax.grad(loss_j)(leaves)))
    gX = pt.g(out_t.X)
    loss_t = t_logvar(out_t.Y, gX) + (torch.mean(out_t.Z_sum + gX) if kl
                                      else 0.0)
    _assert_grads(torch.autograd.grad(loss_t, list(net_t.parameters())),
                  g_j)


def test_fused_train_rollout_cotangents_and_antithetic_pairs():
    """Y alone, Z_sum alone (a None cotangent is zeros), and two calls with
    one seed and signs +1/-1 equal the plain version on the Philox stream
    and its negation."""
    pt = tp.LLGC(d=D, T=1.0, device="cpu")
    net = tanh_mlp_from_flax(_tree(seed=2), device="cpu")
    params = list(net.parameters())
    kw = dict(accumulate_kl=True, rng="erfinv")
    out = tk.fused_train_rollout(pt, net, K, N, DT, seed=11, **kw)
    ref = tk.reference_train_rollout(pt, net, K, N, DT, seed=11, **kw)
    for field in ("Y", "Z_sum"):
        a = torch.autograd.grad(getattr(out, field).sum(), params,
                                retain_graph=True)
        b = torch.autograd.grad(getattr(ref, field).sum(), params,
                                retain_graph=True)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)
    noise = torch.stack([tk.train_normals(11, K, n, D, "binom")
                         for n in range(N)])
    for sign in (1.0, -1.0):
        a = tk.fused_train_rollout(pt, net, K, N, DT, seed=11,
                                   noise_sign=sign)
        b = tk.reference_train_rollout(pt, net, K, N, DT,
                                       host_noise=sign * noise)
        for x, y in zip(a, b):
            torch.testing.assert_close(x.detach(), y.detach(), rtol=0,
                                       atol=0)


def _np_erfinv_map(bits):
    u01 = ((bits >> 9) | 0x3F800000).astype(np.uint32).view(
        np.float32) - np.float32(1.0)
    u = np.clip(np.float32(2.0) * u01 - np.float32(1.0),
                np.float32(-1.0 + 1e-7), np.float32(1.0 - 1e-7))
    return np.float32(np.sqrt(2.0)) * scipy.special.erfinv(
        u.astype(np.float64))


def _np_binom_map(b1, b2):
    pc = np.array([bin(int(b)).count("1") for b in b1], np.int32)
    u = (b2 & 0x7FFF).astype(np.float32) * np.float32(2.0 ** -15)
    return (((pc - 16).astype(np.float32) + u) - np.float32(0.5)) \
        * np.float32(1.0 / np.sqrt(8.0 + 1.0 / 12.0))


def test_bit_maps_match_numpy_transcription():
    rng = np.random.default_rng(5)
    b1 = np.concatenate([[0, 0xFFFFFFFF, 0x80000000, 0x7FFF, 1],
                         rng.integers(0, 2 ** 32, 995)]).astype(np.uint32)
    b2 = np.concatenate([[0, 0xFFFFFFFF, 0x8000, 0x7FFF, 0xFFFF8000],
                         rng.integers(0, 2 ** 32, 995)]).astype(np.uint32)
    t1 = torch.from_numpy(b1.astype(np.int64))
    t2 = torch.from_numpy(b2.astype(np.int64))
    binom = tk.normals_from_bits_binom(t1, t2).numpy()
    np.testing.assert_array_equal(binom, _np_binom_map(b1, b2))
    assert binom[0] == np.float32(-16.5 / np.sqrt(8.0 + 1.0 / 12.0))
    erfinv = tk.normals_from_bits(t1).numpy()
    np.testing.assert_allclose(erfinv, _np_erfinv_map(b1), rtol=2e-6,
                               atol=1e-6)
    # the Philox streams: binom draws word 3 = 0 and 1, erfinv word 3 = 0
    w0 = tk.philox_bits(9, 16, 4, D, 0)
    w1 = tk.philox_bits(9, 16, 4, D, 1)
    torch.testing.assert_close(tk.train_normals(9, 16, 4, D, "binom"),
                               tk.normals_from_bits_binom(w0, w1),
                               rtol=0, atol=0)
    torch.testing.assert_close(tk.train_normals(9, 16, 4, D, "erfinv"),
                               tk.philox_normals(9, 16, 4, D), rtol=0,
                               atol=0)


class _YDependentH(tp.LLGC):
    """LLGC whose h reads Y: outside the training kernels' family."""

    def h_family(self):
        return None


def test_outside_train_kernel_family_raises():
    llgc = tp.LLGC(d=D, T=1.0, device="cpu")
    lqgc = tp.LQGC(d=D, T=1.0, device="cpu")
    net = tanh_mlp_from_flax(_tree(), device="cpu")
    u_tab = llgc.u_ref_table(np.arange(N) * DT)
    relu = nn.Sequential(nn.Linear(D + 1, 4), nn.ReLU(), nn.Linear(4, D))
    with pytest.raises(ValueError, match="not a TanhMLP.*the kernel covers"):
        tk.fused_train_rollout(llgc, relu, K, N, DT)
    with pytest.raises(ValueError, match="state-dependent"):
        tk.fused_train_rollout(lqgc, net, K, N, DT, u_tab=u_tab)
    with pytest.raises(ValueError, match="h of _YDependentH"):
        tk.fused_train_rollout(_YDependentH(d=D, T=1.0, device="cpu"), net,
                               K, N, DT)
    with pytest.raises(ValueError, match="rng="):
        tk.fused_train_rollout(llgc, net, K, N, DT, rng="boxmuller")
    with pytest.raises(ValueError, match="u_tab has shape"):
        tk.fused_train_rollout(llgc, net, K, N, DT, u_tab=u_tab[:3])
    # the repa phases run on the plain rollout (the port has them), and
    # the solver's 'fused_train' gate refuses them, as JAX's does
    for phase in (0, 1):
        out = tsde.hjb_rollout(
            tsde.HJBRolloutConfig(N=2, delta_t=0.1, repa_phase=phase),
            llgc, lambda X, n, t: (net(torch.cat(
                [torch.full((X.shape[0], 1), t), X], dim=1)), None),
            llgc.X_0.expand(4, D), torch.zeros(4),
            generator=torch.Generator().manual_seed(phase))
        assert torch.isfinite(out.Y).all()
    from pspde_torch.solvers import HJBSolver
    with pytest.warns(UserWarning, match="fell back"):
        repa = HJBSolver("r", llgc, K=8, delta_t=0.25, time_approx="inner",
                         loss_method="log-variance-repa", detach_forward=True,
                         rollout_mode="fused_train", device="cpu")
    assert any("repa phases" in g for g in repa._fused_train_gates())
    # the plain version takes any control
    tk.reference_train_rollout(llgc, relu, 8, 2, 0.1)
    assert (llgc.h_family(), lqgc.h_family()) == (
        ("quadratic_z", -1.0, 0.0), ("quadratic_z", -1.0, -1.0))


@pytest.mark.parametrize("case,tile", [("llgc_d100", 64),
                                       ("lqgc_d100_dense", 64)])
def test_train_kernel_layout_at_bench_shapes(case, tile):
    """The training kernels' arguments at d=100: the net is not negated,
    the staged prefix ends after X_0, both kernels' per-path arrays sit at
    the row stride tile + 4 (their mma fragment loads are then free of bank
    conflicts), and each block fits: the forward's (tile 64, 4 threads a
    path) stages the net in fragment order beside its arrays and the
    exchange of its per-path sums (three in each of 4 classes), the
    backward's (one thread a path) the
    prefix and its gradient buffer."""
    if case == "llgc_d100":
        pt = tp.LLGC(d=100, T=1.0, device="cpu")
        u_tab = pt.u_ref_table(np.arange(32) / 32)
    else:
        pt, u_tab = tp.LQGC(d=100, T=1.0, off_diag=0.05,
                                  device="cpu"), None
    net = tk.TanhMLP(101, 100, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    fam = tk._check_train_family(pt, net, 32, 1.0, u_tab, "binom")
    dense = case == "lqgc_d100_dense"
    for backward in (False, True):
        packed = tk._pack_train(
            pt, net, *fam, 131072, 32, 1 / 32, None, backward=backward,
            host_noise=None, noise_sign=1.0, adaptive_forward=True,
            accumulate_kl=False, kl_ito_term=False, u_tab=u_tab, rng="binom")
        ia = packed.iargs
        assert len(ia) == 26 + 5 * tk._MAX_LAYERS
        t = tile
        assert ia[5] == t and ia[13] == ia[12] + 104   # n_stage
        assert ia[21] == 102 * 32 + 33 * 32 + 33 * 104   # n_grad
        tpp = 1 if backward else 4
        assert ia[-4:] == [int(backward), tpp, 0, 0]
        per_path = (104 * ((4 if backward else 3) if dense
                           else (3 if backward else 2))
                    + (2 if backward else 1) * 64)
        # the forward's staged net: t row, biases, fragments
        net_floats = 32 + (32 + 32 + 104) + (104 * 32 + 32 * 32 + 32 * 104)
        fixed = ia[13] + ia[21] if backward else net_floats + 3 * 4 * t
        smem = tk._train_smem_bytes(fixed, per_path, t)
        assert smem == 4 * (fixed + per_path * (t + 4)) <= tk._SMEM_LIMIT
        w2 = ia[22 + 2 * tk._MAX_LAYERS + 2]
        W2 = packed.params[w2:w2 + 32 * 104].reshape(32, 104)
        torch.testing.assert_close(W2[:30, :100],
                                   net.layers[-1].weight.detach().T)
        if u_tab is not None:
            U = packed.params[ia[14]:ia[14] + 32 * 104].reshape(32, 104)
            torch.testing.assert_close(U[:, :100], u_tab)
