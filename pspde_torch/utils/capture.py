"""The cyclic garbage collector around a CUDA graph capture.

A solver and its captured ``StepGraph`` refer to each other, so a solver
that is dropped lives on until the cyclic collector finds it.  If that
happens while another graph is being captured, the dead graph's
``cudaGraphDestroy`` runs inside the capture, which CUDA refuses, and the
capture is invalidated (``cudaErrorStreamCaptureInvalidated``) at
whatever op comes next.  ``torch.cuda.graph`` no longer collects before
it captures, so every capture in the port runs inside ``gc_held()``.
"""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def gc_held():
    """Collect what is dead now, then hold the cyclic collector off until
    the block ends; its earlier state (enabled or not) comes back."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


__all__ = ["gc_held"]
