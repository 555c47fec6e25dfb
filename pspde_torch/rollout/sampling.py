"""Geometry samplers for domain and boundary points (counterpart of
``pspde/rollout/sampling.py``), drawing from an explicit
``torch.Generator``.

Kept from the JAX package: the fixed-K annulus (the reference rejects
points inside the inner sphere and shrinks the batch, solver.py:699-703;
drawing r = (r1^d + U (r2^d - r1^d))^{1/d} with a Gaussian direction is
the same law at a fixed K), the square boundary sampler that pins one
uniformly chosen coordinate of each point to a face (first half X_l,
second half X_r, solver.py:656-665) and its reflected variant, and the
exit-test quirk of ``inside_fn``.  Samples are made on ``device``, by
default the generator's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..problems.base import Geometry
from ..utils.device import resolve_device


def _device(generator: Optional[torch.Generator], device):
    if device is None and generator is not None:
        return generator.device
    return resolve_device(device)


def _uniform(gen, shape, dev):
    return torch.rand(shape, generator=gen, device=dev)


def _unit_directions(gen, K, d, dev):
    x = torch.randn((K, d), generator=gen, device=dev)
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def sample_domain(generator: Optional[torch.Generator], geom: Geometry,
                  K: int, d: int, uniform_square: bool = False,
                  device=None) -> torch.Tensor:
    """Uniform sample in the domain interior, (K, d) float32."""
    dev = _device(generator, device)
    kind = geom.kind
    if kind in ("sphere", "unbounded"):
        if uniform_square:
            # solver.py:689-690: cube direction x uniform radius (the
            # intentionally non-uniform ablation)
            x = _uniform(generator, (K, d), dev) * 2.0 - 1.0
            x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
            r = _uniform(generator, (K, 1), dev)
            return geom.boundary_distance * x * r
        dirs = _unit_directions(generator, K, d, dev)
        r = _uniform(generator, (K, 1), dev) ** (1.0 / d)
        return geom.boundary_distance * dirs * r
    if kind == "two_spheres":
        r1, r2 = geom.boundary_distance_1, geom.boundary_distance_2
        if uniform_square:
            # solver.py:696-697 verbatim formula (per-coordinate radius)
            x = _uniform(generator, (K, d), dev) * 2.0 - 1.0
            x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
            r = _uniform(generator, (K, d), dev) * (r2 - r1) + r1
            return x * r
        dirs = _unit_directions(generator, K, d, dev)
        u = _uniform(generator, (K, 1), dev)
        r = (r1 ** d + u * (r2 ** d - r1 ** d)) ** (1.0 / d)
        return dirs * r
    if kind in ("square", "unbounded_square"):
        return ((geom.X_r - geom.X_l) * _uniform(generator, (K, d), dev)
                + geom.X_l)
    if kind == "square-corner":
        x = ((geom.X_r - geom.X_l) * _uniform(generator, (K, d), dev)
             + geom.X_l)
        in_corner = torch.all(x > geom.X_corner, dim=-1, keepdim=True)
        return torch.where(in_corner, -x, x)
    raise ValueError(kind)


def _first_half(K, dev):
    return torch.arange(K, device=dev)[:, None] < K // 2


def _face_mask(gen, K, d, dev):
    face_dim = torch.randint(0, d, (K,), generator=gen, device=dev)
    return torch.nn.functional.one_hot(face_dim, d).to(torch.bool)


def sample_boundary(generator: Optional[torch.Generator], geom: Geometry,
                    K: int, d: int, device=None) -> torch.Tensor:
    """Uniform sample on the boundary (solver.py:647-673), (K, d)."""
    dev = _device(generator, device)
    kind = geom.kind
    if kind in ("sphere", "unbounded"):
        return geom.boundary_distance * _unit_directions(generator, K, d, dev)
    if kind == "two_spheres":
        dirs = _unit_directions(generator, K, d, dev)
        radii = torch.where(_first_half(K, dev), geom.boundary_distance_1,
                            geom.boundary_distance_2)
        return radii * dirs
    if kind in ("square", "unbounded_square", "square-corner"):
        lo = geom.X_corner if kind == "square-corner" else geom.X_l
        x = (geom.X_r - lo) * _uniform(generator, (K, d), dev) + lo
        onehot = _face_mask(generator, K, d, dev)
        if kind == "square-corner":
            face_val = torch.full((K, 1), geom.X_corner, device=dev)
        elif geom.one_boundary:
            face_val = torch.full((K, 1), geom.X_r, device=dev)
        else:
            face_val = torch.where(_first_half(K, dev), geom.X_l, geom.X_r)
        return torch.where(onehot, face_val, x)
    raise ValueError(kind)


def sample_boundary_reflected(generator: Optional[torch.Generator],
                              geom: Geometry, K: int, d: int, device=None):
    """Square boundary sample plus its periodic reflection (the pinned
    coordinate moved to the opposite face) - FP-eigenvalue nb cell 4."""
    dev = _device(generator, device)
    x = ((geom.X_r - geom.X_l) * _uniform(generator, (K, d), dev)
         + geom.X_l)
    onehot = _face_mask(generator, K, d, dev)
    first = _first_half(K, dev)
    face_val = torch.where(first, geom.X_l, geom.X_r)
    face_val_reflect = torch.where(first, geom.X_r, geom.X_l)
    return (torch.where(onehot, face_val, x),
            torch.where(onehot, face_val_reflect, x))


def inside_fn(geom: Geometry):
    """Domain-membership test of the stopped rollout, (X, X_prop) -> (K,)
    bool.

    Reference quirk kept: sphere/two_spheres test the CURRENT state
    (solver.py:750-753) while the square variants test the PROPOSAL
    (solver.py:754-760).  Unbounded geometries never stop.
    """
    kind = geom.kind

    def fn(X, X_prop):
        if kind in ("unbounded", "unbounded_square"):
            return torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
        if kind == "sphere":
            return (torch.sqrt(torch.sum(X * X, dim=-1))
                    < geom.boundary_distance)
        if kind == "two_spheres":
            r = torch.sqrt(torch.sum(X * X, dim=-1))
            return ((r > geom.boundary_distance_1)
                    & (r < geom.boundary_distance_2))
        if kind == "square":
            if geom.one_boundary:
                return torch.all(X_prop <= geom.X_r, dim=-1)
            return torch.all((X_prop >= geom.X_l) & (X_prop <= geom.X_r),
                             dim=-1)
        if kind == "square-corner":
            return torch.any(X_prop <= geom.X_r, dim=-1)
        raise ValueError(kind)

    return fn
