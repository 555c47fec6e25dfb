"""Build and load the port's CUDA kernels.

The sources in ``pspde_torch/csrc/*.cu`` are compiled with ``nvcc`` for
``sm_90a`` (one process per source, in parallel) and linked into one
shared library with a plain C interface, on first use,
into ``build/pspde_torch/`` at the repository root (listed in
``.gitignore``).  The file name carries a hash of the sources and flags,
so an edited source is rebuilt.  The library is loaded with ``ctypes``;
pointers and the stream are passed as ``c_void_p``.  Importing this
module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pspde_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# filled by library(): path, sources, seconds (0.0 when loaded from an
# existing build), log (nvcc's output, -Xptxas -v register report included;
# kept beside the library as <library>.log and read back with it)
build_info: dict = {}
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("pspde_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from pspde_torch/csrc on "
                       "first use on a CUDA tensor")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the kernels' library."""
    vp = ctypes.c_void_p
    tail = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_ulonglong, ctypes.c_int, vp]
    # (params, host_noise, outputs..., [workspace,] iargs, fargs, seed,
    # device, stream): the serve's seed by value; the training kernels' the
    # pointer of a 0-d int64 device tensor (read when the kernel runs), then
    # the pointer of their launch count's 64-bit device word
    fn = lib.pspde_controlled_rollout
    fn.argtypes = [vp] * 4 + tail
    fn.restype = ctypes.c_int
    for name, n_ptr in (("pspde_train_rollout_fwd", 7),
                        ("pspde_train_rollout_bwd", 6),
                        ("pspde_stopped_rollout_fwd", 7),
                        ("pspde_stopped_rollout_fwd_block", 8),
                        ("pspde_stopped_rollout_bwd", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + tail[:2] + [vp, vp] + tail[3:]
        fn.restype = ctypes.c_int
    # the roofline kernels (csrc/roofline.cu)
    c_int = ctypes.c_int
    lib.pspde_ablation.argtypes = [vp, vp, vp, c_int] + tail
    lib.pspde_fma_chain.argtypes = [vp, c_int, c_int, c_int,
                                    ctypes.POINTER(ctypes.c_float), c_int, vp]
    lib.pspde_normals_sum.argtypes = [vp, c_int, c_int, c_int, c_int,
                                      ctypes.c_ulonglong, c_int, vp]
    for name in ("pspde_stopped_bwd_slots", "pspde_train_fwd_occupancy",
                 "pspde_stopped_fwd_occupancy",
                 "pspde_stopped_fwd_block_occupancy",
                 "pspde_serve_occupancy"):
        getattr(lib, name).argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            c_int, ctypes.POINTER(ctypes.c_int)]
    for name in ("pspde_ablation", "pspde_fma_chain", "pspde_normals_sum",
                 "pspde_stopped_bwd_slots", "pspde_train_fwd_occupancy",
                 "pspde_stopped_fwd_occupancy",
                 "pspde_stopped_fwd_block_occupancy",
                 "pspde_serve_occupancy"):
        getattr(lib, name).restype = ctypes.c_int
    lib.pspde_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pspde_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _run(cmd, proc=None) -> str:
    """Wait for ``proc`` (or run ``cmd``); raise with nvcc's output on
    failure, else return that output."""
    proc = proc or subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"pspde_torch: nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    return log


def _compile_and_link(sources, out: str) -> str:
    """One nvcc per source, all started together, then one link into
    ``out``; returns the concatenated compiler output."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        log = "".join(_run(c, p) for c, p in zip(cmds, procs))
        tmp = f"{out}.{tag}"
        log += _run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs])
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{out}.log")
        os.replace(tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def library() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + f.read())
        out = os.path.join(BUILD_DIR,
                           f"libpspde_torch_{h.hexdigest()[:16]}.so")
        seconds, log = 0.0, ""
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            log = _compile_and_link(sources, out)
            seconds = time.perf_counter() - t0
        elif os.path.isfile(f"{out}.log"):
            with open(f"{out}.log") as f:
                log = f.read()
        build_info.update(path=out, sources=sources, seconds=seconds, log=log)
        _lib = bind(ctypes.CDLL(out))
        return _lib
