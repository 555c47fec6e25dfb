"""pspde_torch problems against pspde on the same inputs (CPU).

Tolerance: rtol 1e-6 with atol 1e-6 for the O(1) quantities compared here;
the atol covers entries near zero, where float32 sums taken in another
order (XLA vs PyTorch) differ by an ulp of the summands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp

RTOL, ATOL = 1e-6, 1e-6

CASES = {
    "llgc": (jp.LLGC, tp.LLGC, dict(d=6, T=1.0)),
    "llgc_off_diag": (jp.LLGC, tp.LLGC, dict(d=6, T=1.0, off_diag=0.1)),
    "lqgc": (jp.LQGC, tp.LQGC, dict(d=5, T=1.0, off_diag=0.1,
                                    delta_t=0.05)),
}


def _pair(case):
    jcls, tcls, kw = CASES[case]
    return jcls(**kw), tcls(**kw, device="cpu")


def _inputs(d, K=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, d)).astype(np.float32)
    y = rng.standard_normal((K,)).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    return x, y, z


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_coefficients_match(case):
    pj, pt = _pair(case)
    x, y, z = _inputs(pj.d)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(pj.b(xj), pt.b(xt))
    _close(pj.f(xj, 0.3), pt.f(xt, 0.3))
    _close(pj.g(xj), pt.g(xt))
    _close(pj.h(0.3, xj, jnp.asarray(y), jnp.asarray(z)),
           pt.h(0.3, xt, torch.from_numpy(y), torch.from_numpy(z)))
    _close(pj.X_0, pt.X_0)
    assert pt.h_is_y_free == pj.h_is_y_free
    assert pt.X_0.dtype == torch.float32


@pytest.mark.parametrize("case", list(CASES))
def test_diffusion_matrix_matches(case):
    pj, pt = _pair(case)
    sj, st = pj.sigma_struct, pt.sigma_struct
    assert st.kind == sj.kind
    x, _, _ = _inputs(pj.d, seed=1)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(sj.apply(xj), st.apply(xt))
    _close(sj.apply_T(xj), st.apply_T(xt))
    _close(sj.inv_apply(xj), st.inv_apply(xt))
    _close(sj.apply_cols(xj.T), st.apply_cols(xt.T))


def test_diffusion_matrix_kinds():
    d = 4
    for mat, kind in ((2.0 * np.eye(d), "scalar"),
                      (np.diag(np.arange(1.0, d + 1)), "diag"),
                      (np.eye(d) + 0.1 * np.ones((d, d)), "full")):
        sj, st = jp.DiffusionMatrix(mat), tp.DiffusionMatrix(mat, device="cpu")
        assert st.kind == sj.kind == kind
        x, _, _ = _inputs(d, seed=2)
        _close(sj.apply(jnp.asarray(x)), st.apply(torch.from_numpy(x)))
        _close(sj.inv_apply(jnp.asarray(x)),
               st.inv_apply(torch.from_numpy(x)))


@pytest.mark.parametrize("case", ["llgc", "llgc_off_diag"])
def test_llgc_reference_solutions_match(case):
    pj, pt = _pair(case)
    ts = np.arange(20) * 0.05
    x, _, _ = _inputs(pj.d, seed=3)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(pj.u_ref_table(ts), pt.u_ref_table(ts))
    _close(pj.u_ref_fn(ts)(xj, 7), pt.u_ref_fn(ts)(xt, 7))
    _close(pj.v_ref(xj, 0.3), pt.v_ref(xt, 0.3))
    ts_v = ts[::5]
    _close(pj.v_ref_fn(ts_v)(xj, 2), pt.v_ref_fn(ts_v)(xt, 2))


def test_lqgc_reference_solutions_match():
    pj, pt = _pair("lqgc")
    ts = np.arange(20) * 0.05
    x, _, _ = _inputs(pj.d, seed=4)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(pj.u_ref_fn(ts)(xj, 7), pt.u_ref_fn(ts)(xt, 7))
    _close(pj.v_ref_fn(ts)(xj, 7), pt.v_ref_fn(ts)(xt, 7))
    _close(pj.F, pt.F)
    _close(pj.G, pt.G)


def test_kernel_family_flags():
    assert tp.LLGC(d=3, device="cpu").drift_family() == ("neg_identity", None)
    kind, A = tp.LLGC(d=3, off_diag=0.1, device="cpu").drift_family()
    assert kind == "matrix" and A.shape == (3, 3)
    assert tp.LLGC(d=3, device="cpu").running_cost_family() == ("zero", None)
    kind, P = tp.LQGC(d=3, device="cpu").running_cost_family()
    assert kind == "quadratic" and P.shape == (3, 3)


def test_default_device_is_the_card(monkeypatch):
    """With no device given a constructor resolves to CUDA; where CUDA is
    absent it raises and names device="cpu", which builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.LLGC(d=4)
    p = tp.LLGC(d=4, device="cpu")
    assert p.X_0.device.type == "cpu" and p.A.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from pspde_torch.utils import resolve_device
    assert resolve_device(None) == torch.device("cuda")
