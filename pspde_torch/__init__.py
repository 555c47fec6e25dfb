"""pspde_torch - the PyTorch and CUDA port of ``pspde``.

The package mirrors ``pspde``'s module names so each counterpart is easy to
find.  It imports ``torch``, ``numpy`` and ``scipy`` only; the CUDA kernels
under ``csrc/`` are compiled with ``nvcc`` on first use on a CUDA tensor
(``rollout/_build.py``), so importing the package needs neither a compiler
nor a GPU.

Ported so far: the serve path (importance sampling with a learned
control), the HJB training step (``HJBSolver``), the stopped-path elliptic
training step (``EllipticSolver``), the space-time parabolic training step
(``GeneralSolver``, the ``time_stopping`` branch of the stopped kernels),
the eigenvalue training step (``EigenSolver`` on ``FokkerPlanckEigen``, the
torus family of the stopped kernels with the lambda leaf) and the measured
roofline (``utils/roofline.py``).
"""
