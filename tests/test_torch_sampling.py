"""The port's geometry samplers and exit tests (CPU).

``inside_fn`` against pspde's on the same points, exactly, for every
geometry (the reference's quirk: spheres test the current state, squares
the proposal).  The samplers draw from a torch.Generator, so they are
held to their laws: radius within the boundary, the r^d radial law of the
ball, the fixed-K annulus, points on the sphere, the pinned square face."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pspde.problems.base import Geometry as JGeometry
from pspde.rollout.sampling import inside_fn as j_inside
from pspde_torch.problems import Geometry
from pspde_torch.rollout.sampling import (inside_fn, sample_boundary,
                                          sample_boundary_reflected,
                                          sample_domain)

GEOMS = {
    "sphere": dict(kind="sphere", boundary_distance=1.0),
    "two_spheres": dict(kind="two_spheres", boundary_distance_1=1.0,
                        boundary_distance_2=2.0),
    "square": dict(kind="square", X_l=-1.0, X_r=1.0),
    "square_one": dict(kind="square", X_l=-1.0, X_r=1.0, one_boundary=True),
    "square-corner": dict(kind="square-corner", X_l=-1.0, X_r=1.0,
                          X_corner=0.0),
    "unbounded": dict(kind="unbounded"),
    "unbounded_square": dict(kind="unbounded_square"),
}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", list(GEOMS))
def test_inside_fn_matches_jax(name):
    rng = np.random.default_rng(3)
    X = (1.6 * rng.uniform(-1, 1, (512, 5))).astype(np.float32)
    Xp = (X + 0.5 * rng.standard_normal((512, 5))).astype(np.float32)
    want = np.asarray(j_inside(JGeometry(**GEOMS[name]))(jnp.asarray(X),
                                                          jnp.asarray(Xp)))
    got = inside_fn(Geometry(**GEOMS[name]))(torch.from_numpy(X),
                                             torch.from_numpy(Xp))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() <= 512


def test_sphere_domain_law():
    d, K = 5, 20000
    x = sample_domain(_gen(1), Geometry(kind="sphere",
                                        boundary_distance=2.0), K, d)
    r = torch.linalg.norm(x, dim=1)
    assert x.shape == (K, d) and x.dtype == torch.float32
    assert float(r.max()) <= 2.0
    # P(r <= 2 s) = s^d
    for s in (0.5, 0.8, 0.95):
        np.testing.assert_allclose(float((r <= 2.0 * s).float().mean()),
                                   s ** d, atol=0.01)
    assert abs(float(x.mean())) < 0.02
    again = sample_domain(_gen(1), Geometry(kind="sphere",
                                            boundary_distance=2.0), K, d)
    torch.testing.assert_close(again, x, rtol=0, atol=0)


def test_annulus_and_uniform_square():
    d, K = 3, 20000
    geom = Geometry(kind="two_spheres", boundary_distance_1=1.0,
                    boundary_distance_2=2.0)
    r = torch.linalg.norm(sample_domain(_gen(2), geom, K, d), dim=1)
    assert float(r.min()) >= 1.0 - 1e-5 and float(r.max()) <= 2.0 + 1e-5
    # fixed-K annulus: P(r <= rho) = (rho^d - 1) / (2^d - 1)
    np.testing.assert_allclose(float((r <= 1.5).float().mean()),
                               (1.5 ** d - 1) / (2 ** d - 1), atol=0.01)
    xs = sample_domain(_gen(3), Geometry(kind="sphere"), K, d,
                       uniform_square=True)
    rs = torch.linalg.norm(xs, dim=1)
    # the ablation's radius is uniform, not r^d
    np.testing.assert_allclose(float((rs <= 0.5).float().mean()), 0.5,
                               atol=0.01)


def test_boundary_samplers():
    d, K = 4, 1000
    xb = sample_boundary(_gen(4), Geometry(kind="sphere",
                                           boundary_distance=1.5), K, d)
    torch.testing.assert_close(torch.linalg.norm(xb, dim=1),
                               torch.full((K,), 1.5), rtol=1e-5, atol=1e-5)
    two = sample_boundary(_gen(5), Geometry(kind="two_spheres"), K, d)
    rr = torch.linalg.norm(two, dim=1)
    torch.testing.assert_close(rr[:K // 2], torch.ones(K // 2), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(rr[K // 2:], torch.full((K // 2,), 2.0),
                               rtol=1e-5, atol=1e-5)
    sq = Geometry(kind="square", X_l=-1.0, X_r=3.0)
    xs = sample_boundary(_gen(6), sq, K, d)
    on_l = (xs == -1.0).sum(dim=1)
    on_r = (xs == 3.0).sum(dim=1)
    # one pinned coordinate per point: first half on X_l, second on X_r
    assert bool((on_l[:K // 2] >= 1).all()) and bool((on_r[K // 2:] >= 1)
                                                     .all())
    assert float(xs.min()) >= -1.0 and float(xs.max()) <= 3.0
    a, b = sample_boundary_reflected(_gen(7), sq, K, d)
    pinned = a != b
    assert bool((pinned.sum(dim=1) == 1).all())
    torch.testing.assert_close(a[pinned] + b[pinned],
                               torch.full((K,), 2.0))
    corner = Geometry(kind="square-corner", X_l=-1.0, X_r=1.0, X_corner=0.0)
    xc = sample_domain(_gen(8), corner, K, d)
    assert not bool((xc > 0.0).all(dim=1).any())
    with pytest.raises(ValueError):
        sample_domain(_gen(9), Geometry(kind="torus"), 4, d)
