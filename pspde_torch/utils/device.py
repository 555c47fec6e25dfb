"""The port's default device.

Every constructor of ``pspde_torch`` that places tensors (problems, nets,
converters, solvers) takes ``device=`` and resolves it here: a given device
is used as it is; ``None`` means the CUDA card.  Without a card, ``None``
raises instead of quietly running the plain versions on the CPU, so a
CPU run is always one the caller asked for with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)``, or ``torch.device("cuda")`` for None;
    raises RuntimeError for None when CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pspde_torch runs on the CUDA card by default, and CUDA is not "
            "available here; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def solver_device(problem, device=None) -> torch.device:
    """A solver's device: ``resolve_device(device)``, which must be the
    device the problem lives on (returned with its index)."""
    dev = resolve_device(device)
    pdev = problem.X_0.device
    if dev.type != pdev.type or (dev.index is not None
                                 and pdev.index is not None
                                 and dev.index != pdev.index):
        raise ValueError(f"the problem lives on {pdev} and the solver's "
                         f"device is {dev}; build both on one device")
    return pdev
