"""Function-space (ansatz) modules (counterpart of ``pspde/ansatz/nets.py``).

Every net of pspde's: ``TanhMLP`` (the default 'inner' control net),
``ScalarParam`` (Y_0 and lambda), the four concat-skip nets
(``ConcatSkipNet``: ``DenseNet``, the relu^2 value net of the elliptic
solver and the default 'outer' control and value net of the HJB solver;
``DenseNetTanh``, the Schroedinger eigen notebook's; ``DenseNetTanh2``;
``DenseNetRelu``), ``BatchNormMLP``, ``ReluMLP1d``, ``Sines``,
``ConstantVector``, ``Affine`` and the LQ-structured linear controls
``LinearLQ`` and ``LinearLQTime``.  Initialisers follow Flax's
distributions (``nn.Dense``'s default kernel is ``lecun_normal``, its bias
zero), drawn from a ``torch.Generator``.  Modules are created on
``device=``, the CUDA card when None (``utils/device.py``).

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


def _truncated_normal(shape, generator, g_dev) -> torch.Tensor:
    """Standard normals truncated to [-2, 2], by redrawing the ones outside
    (the law of ``jax.random.truncated_normal(key, -2, 2, shape)``)."""
    x = torch.randn(shape, generator=generator, device=g_dev)
    while True:
        out = x.abs() > 2.0
        if not bool(out.any()):
            return x
        x[out] = torch.randn(int(out.sum()), generator=generator,
                             device=g_dev)


def lecun_normal(shape, generator=None, g_dev="cpu") -> torch.Tensor:
    """Flax ``nn.Dense``'s default kernel init for an (out, in) weight: a
    truncated normal of variance 1 / fan_in (``variance_scaling(1.0,
    'fan_in', 'truncated_normal')``: stddev sqrt(1 / fan_in) / 0.8796...,
    the truncated law's own deviation divided out)."""
    std = (1.0 / shape[-1]) ** 0.5 / .87962566103423978
    return std * _truncated_normal(shape, generator, g_dev)


class ConcatSkipNet(_Redraw, nn.Module):
    """The concat-skip nets of function_space.py:116-158 and the notebooks
    (``DenseNet``, ``DenseNetTanh``, ``DenseNetTanh2``, ``DenseNetRelu``),
    which differ only in their feature map and initialisers.

    Hidden layer i maps the running feature vector (width d_in +
    sum(arch[:i])) through a dense layer; its output phi(.) is
    concatenated onto the features, and a last dense layer maps all
    d_in + sum(arch) features to d_out, clamped at 0 with
    ``output_relu``.  ``feature`` names phi ('relu2', 'tanh', 'tanh2' or
    'relu'); the stopped kernels read it.  ``layers`` holds the hidden
    layers and then the output layer.  Constructors are Flax's plus
    ``d_in`` (Flax infers it at init) and the port's ``generator`` and
    ``device``."""

    feature: str = ""

    def _build(self, d_out, arch, output_relu, d_in, config, device):
        self._config = config
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

    def _init(self, weight, bias: float, generator):
        """Each layer's weight from ``weight(shape, generator, device)`` and
        its bias filled with ``bias``, layer by layer."""
        g_dev = "cpu" if generator is None else generator.device
        with torch.no_grad():
            for lin in self.layers:
                lin.weight.copy_(weight(lin.weight.shape, generator, g_dev))
                lin.bias.fill_(float(bias))

    def phi(self, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for lin in self.layers[:-1]:
            feats = torch.cat([feats, self.phi(lin(feats))], dim=-1)
        out = self.layers[-1](feats)
        return torch.relu(out) if self.output_relu else out


def _scaled_normal(scale, shift=0.0):
    def init(shape, generator, g_dev):
        w = scale * torch.randn(shape, generator=generator, device=g_dev)
        return w + shift if shift else w
    return init


class DenseNet(ConcatSkipNet):
    """Concat-skip DenseNet with relu^2 hidden features
    (``pspde.ansatz.DenseNet``, function_space.py:116-140): weights
    weight_scale * N(0, 1), biases bias_init_value."""

    feature = "relu2"

    def __init__(self, d_out: int = 1, arch: Sequence[int] = (30, 30),
                 weight_scale: float = 0.1, bias_init_value: float = 0.0,
                 output_relu: bool = False, *, d_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._build(d_out, arch, output_relu, d_in,
                    dict(d_out=d_out, arch=arch, weight_scale=weight_scale,
                         bias_init_value=bias_init_value,
                         output_relu=output_relu, d_in=d_in),
                    resolve_device(device))
        self._init(_scaled_normal(weight_scale), bias_init_value, generator)

    def phi(self, h):
        return torch.relu(h) ** 2


class DenseNetTanh(ConcatSkipNet):
    """Concat-skip net with tanh hidden features (``pspde.ansatz.
    DenseNetTanh``, function_space.py:143-158) and Flax ``nn.Dense``'s
    default init (``lecun_normal`` weights, zero biases); ``output_relu``
    is the Schroedinger notebook's ``DenseNet_2`` for nonnegative
    eigenfunctions."""

    feature = "tanh"

    def __init__(self, d_out: int = 1, arch: Sequence[int] = (30, 30),
                 output_relu: bool = False, *, d_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._build(d_out, arch, output_relu, d_in,
                    dict(d_out=d_out, arch=arch, output_relu=output_relu,
                         d_in=d_in), resolve_device(device))
        self._init(lecun_normal, 0.0, generator)

    def phi(self, h):
        return torch.tanh(h)


class DenseNetTanh2(ConcatSkipNet):
    """Concat-skip net with tanh(.)^2 features, weights weight_scale *
    N(0, 1), zero biases (``pspde.ansatz.DenseNetTanh2``, the committor
    notebook's cell 1)."""

    feature = "tanh2"

    def __init__(self, d_out: int = 1, arch: Sequence[int] = (30, 30),
                 weight_scale: float = 0.1, *, d_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._build(d_out, arch, False, d_in,
                    dict(d_out=d_out, arch=arch, weight_scale=weight_scale,
                         d_in=d_in), resolve_device(device))
        self._init(_scaled_normal(weight_scale), 0.0, generator)

    def phi(self, h):
        return torch.tanh(h) ** 2


class DenseNetRelu(ConcatSkipNet):
    """Concat-skip net with plain relu features, weights 0.01 N(0, 1) +
    0.01 and biases 0.1, linear output (``pspde.ansatz.DenseNetRelu``, the
    d=10 Schroedinger notebook's ``DenseNet_relu``)."""

    feature = "relu"

    def __init__(self, d_out: int = 1, arch: Sequence[int] = (30, 30), *,
                 d_in: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self._build(d_out, arch, False, d_in,
                    dict(d_out=d_out, arch=arch, d_in=d_in),
                    resolve_device(device))
        self._init(_scaled_normal(0.01, 0.01), 0.1, generator)

    def phi(self, h):
        return torch.relu(h)


class BatchNormMLP(_Redraw, nn.Module):
    """[d_in, hidden, d_out] MLP with a normalization before each dense
    layer and after the last (``pspde.ansatz.BatchNormMLP``, ``NN`` of
    function_space.py:82-113): each normalizes with the batch's own mean
    and (biased) variance, as the reference trains it, and keeps no
    running averages; its scale and bias (``bn_scale_i``, ``bn_bias_i``,
    Flax's names) start at 1 and 0.  The dense layers have no bias and
    N(0, 1) weights; relu after the middle normalization."""

    def __init__(self, d_out: int, hidden: int = 20, *, d_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(d_out=d_out, hidden=hidden, d_in=d_in)
        widths = (int(d_in), int(hidden), int(d_out))
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=False, device=device)
            for a, b in zip(widths[:-1], widths[1:]))
        for i, w in enumerate(widths):
            self.register_parameter(f"bn_scale_{i}", nn.Parameter(
                torch.ones(w, device=device)))
            self.register_parameter(f"bn_bias_{i}", nn.Parameter(
                torch.zeros(w, device=device)))
        g_dev = "cpu" if generator is None else generator.device
        with torch.no_grad():
            for lin in self.layers:
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=generator,
                                             device=g_dev))

    def _bn(self, v: torch.Tensor, i: int) -> torch.Tensor:
        mu = torch.mean(v, dim=0, keepdim=True)
        var = torch.var(v, dim=0, unbiased=False, keepdim=True)
        return (getattr(self, f"bn_scale_{i}") * (v - mu)
                / torch.sqrt(var + 1e-5) + getattr(self, f"bn_bias_{i}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers[0](self._bn(x, 0))
        x = self.layers[1](torch.relu(self._bn(x, 1)))
        return self._bn(x, 2)


class ReluMLP1d(_Redraw, nn.Module):
    """Two-layer relu net [d_in, hidden, 1] (``pspde.ansatz.ReluMLP1d``,
    ``NN_Nik`` of function_space.py:161-174; d_in = 1 there) with Flax
    ``nn.Dense``'s default init."""

    def __init__(self, hidden: int = 16, *, d_in: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(hidden=hidden, d_in=d_in)
        self.layers = nn.ModuleList([
            nn.Linear(int(d_in), int(hidden), device=device),
            nn.Linear(int(hidden), 1, device=device)])
        g_dev = "cpu" if generator is None else generator.device
        with torch.no_grad():
            for lin in self.layers:
                lin.weight.copy_(lecun_normal(lin.weight.shape, generator,
                                              g_dev))
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](torch.relu(self.layers[0](x)))


class Sines(_Redraw, nn.Module):
    """A linear combination of the M sines sin(omega x), omega = 1 .. M,
    for d = 1 (``pspde.ansatz.Sines``, function_space.py:66-79): the
    weights ``alpha`` (M, 1), N(0, 1) at init."""

    def __init__(self, M: int = 10,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(M=M)
        self.register_buffer("omega", torch.linspace(
            1.0, float(M), int(M), device=device)[None, :])
        self.alpha = nn.Parameter(torch.randn(
            (int(M), 1), generator=generator).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(x @ self.omega) @ self.alpha


class ConstantVector(_Redraw, nn.Module):
    """A learnable constant d-vector broadcast over the batch
    (``pspde.ansatz.ConstantVector``, ``Constant`` of
    function_space.py:24-34), N(0, 1) at init."""

    def __init__(self, d: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(d=d)
        self.c = nn.Parameter(torch.randn((int(d),),
                                          generator=generator).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c.expand(x.shape[0], -1)


class Affine(_Redraw, nn.Module):
    """The affine map A x + b, zero at init (``pspde.ansatz.Affine``,
    function_space.py:51-63): A (d_out, d_in), b (1, d_out)."""

    _random_init = False

    def __init__(self, d_out: int, *, d_in: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self._config = dict(d_out=d_out, d_in=d_in)
        self.A = nn.Parameter(torch.zeros((int(d_out), int(d_in)),
                                          device=device))
        self.b = nn.Parameter(torch.zeros((1, int(d_out)), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.A.T + self.b


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
