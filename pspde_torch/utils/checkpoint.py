"""Checkpoint and resume on ``torch.save`` (counterpart of
``pspde/utils/checkpoint.py``, which saves through orbax).

``save_params`` / ``load_params`` keep what ``save_networks`` /
``load_networks`` keep: the state dict of each module a solver trains
(``solver._chunk_modules()``) and the optimizer's state dict (Adam's
moments and step counts; on CUDA the ``capturable`` Adam's device step
tensors).  ``save_training_state`` adds everything the next step draws
from, so that a solver loaded from it trains on exactly as the
uninterrupted run does: the state of every generator of the solver (the
ones its steps draw from, ``_chunk_generators()``; the kernels' seed
stream ``_seed_gen``; the diagnostics' generators,
``_diagnostic_generators()``), the iteration counter and, in a JSON
sidecar as pspde writes it (``<path>.logs.json``: {"step": ..., "logs":
{...}}), the logs named by the solver's ``_LOG_ATTRS``.

Files are read onto the CPU; loading copies into the solver's own
modules and optimizer (Adam's state moves to its parameters' device) and
drops a captured CUDA graph (``release_graph()``): the optimizer's state
tensors are new, so the next chunked ``train()`` captures anew.  The
optimizer's learning rates stay the solver's own objects (0-d device
tensors on CUDA), set to the schedule's value at the loaded iteration.
"""

from __future__ import annotations

import json
import os

import torch

from .schedule import apply_lr


def _generators(solver) -> dict:
    gens = dict(solver._chunk_generators())
    gens["_seed_gen"] = solver._seed_gen
    gens.update(getattr(solver, "_diagnostic_generators", dict)())
    return gens


def _payload(solver) -> dict:
    return {"modules": {name: mod.state_dict() for name, mod in
                        solver._chunk_modules().items()},
            "optimizer": solver.optimizer.state_dict()}


def _load_payload(solver, payload: dict):
    for name, mod in solver._chunk_modules().items():
        mod.load_state_dict(payload["modules"][name])
    groups = solver.optimizer.param_groups
    lrs = [g["lr"] for g in groups]
    solver.optimizer.load_state_dict(payload["optimizer"])
    for g, lr in zip(solver.optimizer.param_groups, lrs):
        g["lr"] = lr
    apply_lr(solver.optimizer, solver._lrs, solver.iteration)
    solver.release_graph()


def save_params(path: str, solver) -> str:
    """The modules' and the optimizer's state dicts, to ``path``."""
    path = os.path.abspath(path)
    torch.save(_payload(solver), path)
    return path


def load_params(path: str, solver):
    """Load a ``save_params`` file into ``solver``'s modules and
    optimizer."""
    _load_payload(solver, torch.load(os.path.abspath(path),
                                     map_location="cpu", weights_only=True))
    return solver


def save_training_state(path: str, solver) -> str:
    """The full resume checkpoint: ``save_params``' payload, the states of
    the solver's generators and its iteration (``path``), and its logs
    (``path + '.logs.json'``)."""
    path = os.path.abspath(path)
    payload = _payload(solver)
    payload["generators"] = {name: g.get_state()
                             for name, g in _generators(solver).items()}
    payload["step"] = int(solver.iteration)
    torch.save(payload, path)
    logs = {name: getattr(solver, name) for name in solver._LOG_ATTRS}
    with open(path + ".logs.json", "w") as f:
        json.dump({"step": int(solver.iteration), "logs": logs}, f)
    return path


def load_training_state(path: str, solver):
    """Restore a ``save_training_state`` checkpoint into ``solver``."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with open(path + ".logs.json") as f:
        meta = json.load(f)
    solver.iteration = int(payload["step"])
    for name, g in _generators(solver).items():
        g.set_state(payload["generators"][name])
    _load_payload(solver, payload)
    for name, value in meta["logs"].items():
        setattr(solver, name, value)
    return solver


__all__ = ["load_params", "load_training_state", "save_params",
           "save_training_state"]
