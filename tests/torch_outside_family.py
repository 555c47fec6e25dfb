"""Test problems of the port that lie outside the stopped kernels' family,
shared by the test files that hold the kernels' family errors and the
solvers' fallback to the scan (not a test module: pytest collects
test_*.py only)."""

import torch

import pspde_torch.problems as tp


class _TanhH(tp.AllenCahn):
    """A space-time problem outside STOPPED_KERNEL_FAMILY: h = tanh(y)."""

    def h(self, t, x, y, z):
        return torch.tanh(y)

    def h_family(self):
        return None
