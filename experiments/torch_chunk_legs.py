#!/usr/bin/env python3
"""Phase 36 of chip_smoke.py alone: steps_per_call on the six training legs.

    python3 experiments/torch_chunk_legs.py

Builds the kernels' library (printing the registers and spill bytes that
ptxas reports for the four training kernels' instantiations, which now read
their seed from a device word), then runs ``chip_smoke.chunk_phase``: each
leg trained from one seed at one step per call and at 50 per call (one
captured CUDA graph, replayed), held bitwise equal, each mode's step time
(CUDA events over whole chunks) and idle share (torch.profiler) printed
beside the card's name and power limit, and the capture of a step with a
host sync held to raise naming the op.  Needs one CUDA card.
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_chunk_legs: no CUDA card")
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"built {os.path.basename(info['path'])} in "
          f"{info['seconds']:.1f} s of nvcc ({time.perf_counter() - t0:.1f}"
          " s with loading)")
    for kernel in ("train_forward_kernel", "train_backward_kernel",
                   "stopped_fwd_kernel", "stopped_bwd_kernel"):
        use = chip_smoke.ptxas_usage(info["log"], kernel)
        print(f"  ptxas {kernel} (registers, spill store and load bytes): "
              f"{sorted(use.values())}")
    dev = torch.device("cuda:0")
    llgc = LLGC(d=chip_smoke.D, T=chip_smoke.T_END, device=dev)
    chip_smoke.chunk_phase(dev, smi, llgc)
    print(f"torch_chunk_legs: done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
