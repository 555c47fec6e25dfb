"""Function-space (ansatz) modules (counterpart of ``pspde/ansatz/nets.py``).

Ported so far: ``TanhMLP`` (the default 'inner' control net),
``ScalarParam`` (Y_0) and ``DenseNet`` (the relu^2 concat-skip value net
of the elliptic solver).  The other nets wait for their slices.  Modules
are created on ``device=``, the CUDA card when None (``utils/device.py``).

Layouts follow PyTorch: ``nn.Linear.weight`` is (out, in), where a Flax
``Dense`` kernel is (in, out); ``pspde_torch.utils.convert`` maps one to
the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.device import resolve_device


class TanhMLP(nn.Module):
    """[d_in, *hidden, d_out] tanh MLP with N(0, init_scale^2) weight AND
    bias init (``pspde.ansatz.TanhMLP``); the output layer is linear."""

    def __init__(self, d_in: int, d_out: int, hidden: Sequence[int] = (30, 30),
                 init_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
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


class DenseNet(nn.Module):
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
