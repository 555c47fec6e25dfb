"""pspde_torch - the PyTorch and CUDA port of ``pspde``.

The package mirrors ``pspde``'s module names so each counterpart is easy to
find.  It imports ``torch``, ``numpy`` and ``scipy`` only; the CUDA kernels
under ``csrc/`` are compiled with ``nvcc`` on first use on a CUDA tensor
(``rollout/_build.py``), so importing the package needs neither a compiler
nor a GPU.

The serve path is ported so far: problems (``LLGC``, ``LQGC``), the
``TanhMLP`` control, the fused controlled-rollout kernel, and importance
sampling with a learned control.  Training waits for a later slice.
"""
