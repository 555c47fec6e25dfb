#!/usr/bin/env python3
"""Where a block-step of the block forward (``stopped_fwd_block_kernel``)
goes, from clock64() counters in a copy of the kernel.

Copies the tree's ``pspde_torch`` under ``build/fwd_block_phases/``, adds
to the block kernel counters of SM clock cycles that block 0's thread 0
spends in each part of its steps (the exit test, the value sweep, V and
the exit, grad V, the normals and the move of X, the increment's sums),
the cycles it waits in the products' ring (cp.async.wait_group and the
barrier after it), runs their rows' loops and their epilogues (with the
barrier before them), printed from the kernel when it ends (the last
three summed over the process's launches); then runs
the Allen-Cahn forward (AllenCahn d=100, T=0.3, the sampling ball of
radius 7, DenseNet (110, 110, 50) on [x, t], N=25) at each (K, layout)
of CASES once and prints what block 0 counted.  The copy's kernel is the
tree's with the counters added; its outputs are not checked.

    python3 experiments/torch_fwd_block_phases.py [--root DIR] [--sass OUT]

``--sass OUT`` also writes the tree's own build of the kernel's SASS (the
Allen-Cahn instantiation) to OUT and prints its opcodes' counts.
"""

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (K, forced block layout or None for the chosen one)
CASES = ((200, None), (200, (1, 64, 16, 3)), (65536, None),
         (65536, (32, 256, 16, 3)))
PATCHES = (
    ("  const int G = (d + 3) / 4;   // dimension groups of the normals\n"
     "  __syncthreads();\n",
     "  const int G = (d + 3) / 4;   // dimension groups of the normals\n"
     "  __syncthreads();\n"
     "  long long tk_[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long t_last = clock64();\n"
     "  int steps_ = 0;\n"
     "#define PHASE_TICK(i) { const long long now_ = clock64(); "
     "tk_[i] += now_ - t_last; t_last = now_; }\n"),
    ("    if (!__syncthreads_or(need)) break;   // every path has ended\n",
     "    if (!__syncthreads_or(need)) break;   // every path has ended\n"
     "    PHASE_TICK(0); ++steps_;\n"),
    ("    // V, v_l2 and the exit, one thread a path\n",
     "    PHASE_TICK(1);\n    // V, v_l2 and the exit, one thread a path\n"),
    ("    if (!__syncthreads_or(adv)) continue;\n",
     "    PHASE_TICK(2);\n    if (!__syncthreads_or(adv)) continue;\n"),
    ("    // the normals, and off the square the move of X, by (path, dimension\n",
     "    PHASE_TICK(3);\n"
     "    // the normals, and off the square the move of X, by (path, dimension\n"),
    ("    // the increment's sums over j, in order, one thread a path\n",
     "    PHASE_TICK(4);\n"
     "    // the increment's sums over j, in order, one thread a path\n"),
    ("      if (kTimed) t = __fadd_rn(t, a.dt);\n    }\n  }\n  __syncthreads();\n",
     "      if (kTimed) t = __fadd_rn(t, a.dt);\n    }\n    PHASE_TICK(5);\n"
     "  }\n  __syncthreads();\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    printf(\"block 0: %d steps; cycles exit %lld, value %lld, V %lld, \"\n"
     "           \"grad %lld, normals %lld, sums %lld; ring waits %llu, \"\n"
     "           \"rows %llu, epilogues %llu\\n\",\n"
     "           steps_, tk_[0], tk_[1], tk_[2], tk_[3], tk_[4], tk_[5],\n"
     "           g_ring_wait, g_rows, g_epi);\n"),
    ("template <int kM, typename Epi>\n"
     "__device__ __forceinline__ void product_pass(",
     "__device__ unsigned long long g_ring_wait = 0, g_rows = 0, "
     "g_epi = 0;\n"
     "template <int kM, typename Epi>\n"
     "__device__ __forceinline__ void product_pass("),
    ("#pragma unroll(kM == 1 ? 8 : kM == 2 ? 4 : 1)\n",
     "    const long long r0_ = clock64();\n"
     "#pragma unroll(kM == 1 ? 8 : kM == 2 ? 4 : 1)\n"),
    ("    }\n  }\n  __syncthreads();   // every read of the ring done\n",
     "    }\n    if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "      g_rows += clock64() - r0_;\n  }\n"
     "  const long long e0_ = clock64();\n"
     "  __syncthreads();   // every read of the ring done\n"),
    ("    if (c < n_chunks) epi(p, c * kChunk, acc[m]);\n  }\n}\n",
     "    if (c < n_chunks) epi(p, c * kChunk, acc[m]);\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_epi += clock64() - e0_;\n"
     "}\n"),
    ("    cp_async_wait_ring(ring.stages);\n"
     "    __syncthreads();   // slice k in, and every read of slice k - 1 done\n",
     "    const long long w0_ = clock64();\n"
     "    cp_async_wait_ring(ring.stages);\n"
     "    __syncthreads();   // slice k in, and every read of slice k - 1 done\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "      g_ring_wait += clock64() - w0_;\n"),
)


def patched_copy(root):
    dst = os.path.join(HERE, "build", "fwd_block_phases")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pspde_torch"),
                    os.path.join(dst, "pspde_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(dst, "pspde_torch", "csrc", "stopped_rollout.cu")
    with open(cu) as f:
        src = f.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"patch site not found once: {old[:60]!r}")
        src = src.replace(old, new)
    src = src.replace("#include <cuda_runtime.h>\n",
                      "#include <cuda_runtime.h>\n#include <cstdio>\n", 1)
    with open(cu, "w") as f:
        f.write(src)
    return dst


def run(root):
    sys.path.insert(0, root)
    import torch
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import AllenCahn, Geometry
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(30)
    ac = AllenCahn(d=100, T=0.3, device=dev)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)
    net = DenseNet(1, (110, 110, 50), d_in=101, weight_scale=0.05,
                   device=dev, generator=torch.Generator(dev).manual_seed(5))
    for K, lay in CASES:
        X0 = sample_domain(gen, ac.geometry, K, 100, uniform_square=True)
        t0 = torch.rand(K, generator=gen, device=dev) * ac.T
        call = km._StoppedCall(
            ac, net, X0, t0, 25, 1e-3, 17,
            km._check_stopped_family(ac, net, "erfinv", time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None, fwd_block=lay)
        km._stopped_forward_kernel(call)
        torch.cuda.synchronize()
        print(f"K={K}, layout {tuple(call.pack(False).layout)} (above)",
              flush=True)


def sass(root, out):
    """The SASS of the tree's block kernel at the Allen-Cahn family
    (<true, false, false, true>) into ``out``, and its opcodes' counts."""
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    from pspde_torch.rollout import _build
    from chip_smoke import sass_of
    _build.library()
    insts = sass_of(_build.build_info["path"],
                    "stopped_fwd_block_kernelILb1ELb0ELb0ELb1E")
    with open(out, "w") as f:
        f.write("\n".join(f"{a:06x} {i}" for a, i in insts))
    counts = {}
    for _, i in insts:
        op = i.split()[0] if not i.startswith("@") else i.split()[1]
        counts[op] = counts.get(op, 0) + 1
    print(f"SASS of the Allen-Cahn instantiation: {len(insts)} "
          f"instructions; " + ", ".join(
              f"{k} {v}" for k, v in sorted(counts.items(),
                                            key=lambda kv: -kv[1])[:30]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--sass", metavar="OUT",
                    help="also write the tree's block kernel's SASS (the "
                         "Allen-Cahn instantiation) to OUT")
    args = ap.parse_args()
    if args.run:
        run(os.path.abspath(args.root))
        return
    if args.sass:
        sass(os.path.abspath(args.root), args.sass)
    dst = patched_copy(os.path.abspath(args.root))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                    "--root", dst], check=True)


if __name__ == "__main__":
    main()
