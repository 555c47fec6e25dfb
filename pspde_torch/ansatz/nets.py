"""Function-space (ansatz) modules (counterpart of ``pspde/ansatz/nets.py``).

Ported so far: ``TanhMLP`` (the default 'inner' control net) and
``ScalarParam`` (Y_0).  The other nets wait for their slices.

Layouts follow PyTorch: ``nn.Linear.weight`` is (out, in), where a Flax
``Dense`` kernel is (in, out); ``pspde_torch.utils.convert`` maps one to
the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class TanhMLP(nn.Module):
    """[d_in, *hidden, d_out] tanh MLP with N(0, init_scale^2) weight AND
    bias init (``pspde.ansatz.TanhMLP``); the output layer is linear."""

    def __init__(self, d_in: int, d_out: int, hidden: Sequence[int] = (30, 30),
                 init_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
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
        if initial is None:
            init = torch.randn((1,), generator=generator)
        else:
            init = torch.full((1,), float(initial))
        self.Y_0 = nn.Parameter(init.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Y_0.expand(x.shape[0])
