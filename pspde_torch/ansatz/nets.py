"""Function-space (ansatz) modules (counterpart of ``pspde/ansatz/nets.py``).

Ported so far: ``TanhMLP`` (the default 'inner' control net),
``ScalarParam`` (Y_0), ``DenseNet`` (the relu^2 concat-skip value net of
the elliptic solver and the default 'outer' control and value net of the
HJB solver), and the LQ-structured linear controls ``LinearLQ`` and
``LinearLQTime``.  The other nets wait for their slices.  Modules are
created on ``device=``, the CUDA card when None (``utils/device.py``).

Layouts follow PyTorch: ``nn.Linear.weight`` is (out, in), where a Flax
``Dense`` kernel is (in, out); ``pspde_torch.utils.convert`` maps one to
the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.device import resolve_device


class _Redraw:
    """``redraw(generator)``: a module of this one's configuration with a
    fresh initialisation (pspde's ``module.init`` under a new key, as
    ``init_stacked`` draws one set a step); ``_config`` holds the
    constructor's arguments but the generator and the device."""

    _random_init = True

    def redraw(self, generator: Optional[torch.Generator] = None):
        device = next(self.parameters()).device
        kw = {"generator": generator} if self._random_init else {}
        return type(self)(**self._config, device=device, **kw)


class TanhMLP(_Redraw, nn.Module):
    """[d_in, *hidden, d_out] tanh MLP with N(0, init_scale^2) weight AND
    bias init (``pspde.ansatz.TanhMLP``); the output layer is linear."""

    def __init__(self, d_in: int, d_out: int, hidden: Sequence[int] = (30, 30),
                 init_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(d_in=d_in, d_out=d_out, hidden=hidden,
                            init_scale=init_scale)
        self.d_in, self.d_out = int(d_in), int(d_out)
        self.hidden = tuple(int(w) for w in hidden)
        widths = (self.d_in,) + self.hidden + (self.d_out,)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(widths[:-1],
                                                           widths[1:]))
        g_dev = "cpu" if generator is None else generator.device
        with torch.no_grad():
            for lin in self.layers:
                for p in (lin.weight, lin.bias):
                    p.copy_(init_scale * torch.randn(
                        p.shape, generator=generator, device=g_dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = torch.tanh(lin(x))
        return self.layers[-1](x)


class ScalarParam(nn.Module):
    """Single learnable scalar broadcast over the batch (``Y_0``)."""

    def __init__(self, initial: Optional[float] = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        if initial is None:
            init = torch.randn((1,), generator=generator)
        else:
            init = torch.full((1,), float(initial))
        self.Y_0 = nn.Parameter(init.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Y_0.expand(x.shape[0])


class DenseNet(_Redraw, nn.Module):
    """Concat-skip DenseNet with relu^2 hidden features
    (``pspde.ansatz.DenseNet``, function_space.py:116-140).

    Hidden layer i maps the running feature vector (width d_in +
    sum(arch[:i])) through a dense layer; its output relu(.)^2 is
    concatenated onto the features, and a last dense layer maps all
    d_in + sum(arch) features to d_out.  Weights are weight_scale * N(0, 1),
    biases bias_init_value.  The constructor is Flax's plus ``d_in``
    (Flax infers it at init) and the port's ``generator`` and ``device``.
    ``layers`` holds the hidden layers and then the output layer.
    """

    def __init__(self, d_out: int = 1, arch: Sequence[int] = (30, 30),
                 weight_scale: float = 0.1, bias_init_value: float = 0.0,
                 output_relu: bool = False, *, d_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(d_out=d_out, arch=arch, weight_scale=weight_scale,
                            bias_init_value=bias_init_value,
                            output_relu=output_relu, d_in=d_in)
        self.d_in, self.d_out = int(d_in), int(d_out)
        self.arch = tuple(int(w) for w in arch)
        self.output_relu = bool(output_relu)
        widths, n_in = [], self.d_in
        for w in self.arch:
            widths.append((n_in, w))
            n_in += w
        widths.append((n_in, self.d_out))
        self.layers = nn.ModuleList(nn.Linear(a, b, device=device)
                                    for a, b in widths)
        g_dev = "cpu" if generator is None else generator.device
        with torch.no_grad():
            for lin in self.layers:
                lin.weight.copy_(weight_scale * torch.randn(
                    lin.weight.shape, generator=generator, device=g_dev))
                lin.bias.fill_(float(bias_init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for lin in self.layers[:-1]:
            feats = torch.cat([feats, torch.relu(lin(feats)) ** 2], dim=-1)
        out = self.layers[-1](feats)
        return torch.relu(out) if self.output_relu else out


def _lq_gain(B, Q, device) -> torch.Tensor:
    """Q^{-1} B^T in float32, as pspde's nets form it."""
    B = torch.as_tensor(B, dtype=torch.float32).to(device)
    Q = torch.as_tensor(Q, dtype=torch.float32).to(device)
    return torch.linalg.inv(Q) @ B.T


class LinearLQ(_Redraw, nn.Module):
    """LQ-structured linear control u = Q^{-1} B^T F x with a learnable
    (d, d) F, N(0, init_scale^2) at init (``pspde.ansatz.LinearLQ``).
    ``B`` and ``Q`` are fixed (d, d) matrices (a problem's ``B`` and
    ``Q``)."""

    def __init__(self, B, Q, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(B=B, Q=Q, init_scale=init_scale)
        self.register_buffer("gain", _lq_gain(B, Q, device))
        d = self.gain.shape[0]
        self.F = nn.Parameter(init_scale * torch.randn(
            (d, d), generator=generator).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ (self.gain @ self.F).T


class LinearLQTime(_Redraw, nn.Module):
    """Time-conditioned LQ-structured linear control on [t, x]
    (``pspde.ansatz.LinearLQTime``):

        u(t, x) = Q^{-1} B^T F_hat(t) x,
        F_hat(t) = sum_j T_j(2 t / T - 1) F_j

    with a Chebyshev basis over ``degree + 1`` learnable (d, d) matrices,
    zero at init."""

    _random_init = False

    def __init__(self, B, Q, T: float, degree: int = 8, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(B=B, Q=Q, T=T, degree=degree)
        self.register_buffer("gain", _lq_gain(B, Q, device))
        self.T, self.degree = float(T), int(degree)
        d = self.gain.shape[0]
        self.F = nn.Parameter(torch.zeros((self.degree + 1, d, d),
                                          device=device))

    def forward(self, tx: torch.Tensor) -> torch.Tensor:
        t, x = tx[:, :1], tx[:, 1:]
        s = 2.0 * t / self.T - 1.0
        feats = [torch.ones_like(s), s]
        for _ in range(self.degree - 1):
            feats.append(2.0 * s * feats[-1] - feats[-2])
        phi = torch.cat(feats[: self.degree + 1], dim=1)        # (K, J)
        xF = torch.einsum("ke,jde->kjd", x, self.F)
        return torch.einsum("kj,kjd->kd", phi, xF) @ self.gain.T
