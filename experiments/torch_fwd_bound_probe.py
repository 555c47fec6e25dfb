#!/usr/bin/env python3
"""What bounds the stopped forward's lanes kernel on the Allen-Cahn net.

The lanes kernel (``stopped_fwd_kernel``) reads the notebook's DenseNet
(110, 110, 50) on [x, t] at d = 100 (214 KB, staged in no block) from
device memory, each lane the whole net twice a step.  This script times
that forward (device ms a launch, ``torch.profiler``) at the Allen-Cahn
cell (AllenCahn d=100, T=0.3 on the sampling ball of radius 7, N=25, the
clock from t0 ~ U[0, T), erfinv noise) at K=65536 and at the notebook's
K=200, in two builds of one tree:

  * ``as is``: the kernel as the tree has it;
  * ``window``: a copy of the tree's ``pspde_torch`` under
    ``build/fwd_bound_probe/`` whose forward reads every row of each W_l
    at row 0 (``FwdNet::stride`` multiplied by ``a.lam_off + 1``, 0 off the
    torus, which the compiler cannot fold): the same instructions and
    loads, but the net's footprint one row a layer, which L1 serves.

If the window build is much faster, the loads that miss L1 (L2 bandwidth
or latency) bound the kernel, not its shared-memory wavefronts or its
FMAs.  The window build's outputs are not the net's (its rows are wrong);
on the whole space with the clock no control flow reads them.

    python3 experiments/torch_fwd_bound_probe.py [--root DIR]

prints one JSON line: the card, and per build and K the device ms.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE = "    return padded(a.width[l]) + pad;\n"
WINDOW = "    return (a.lam_off + 1) * (padded(a.width[l]) + pad);\n"


def window_copy(root):
    """The tree's pspde_torch with the window patch, under build/."""
    dst = os.path.join(HERE, "build", "fwd_bound_probe")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pspde_torch"),
                    os.path.join(dst, "pspde_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(dst, "pspde_torch", "csrc", "stopped_rollout.cu")
    with open(cu) as f:
        src = f.read()
    if src.count(STRIDE) != 1:
        raise SystemExit("FwdNet::stride not found once in " + cu)
    with open(cu, "w") as f:
        f.write(src.replace(STRIDE, WINDOW))
    return dst


def times(root):
    """{K: device ms} of the lanes forward at the Allen-Cahn cell, the
    pspde_torch of ``root``."""
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "experiments"))
    import torch
    from torch_kernel_times import device_ms
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
    out = {}
    for K, reps in ((65536, 3), (200, 10)):
        X0 = sample_domain(gen, ac.geometry, K, 100, uniform_square=True)
        t0 = torch.rand(K, generator=gen, device=dev) * ac.T
        call = km._StoppedCall(
            ac, net, X0, t0, 25, 1e-3, 17,
            km._check_stopped_family(ac, net, "erfinv", time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None)
        if "fwd_kernel" in km._StoppedCall._fields:
            call = call._replace(fwd_kernel="lanes")
        out[K] = device_ms(lambda: km._stopped_forward_kernel(call), reps,
                           "stopped_fwd")[0]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose pspde_torch is probed")
    ap.add_argument("--times", action="store_true",
                    help="print {K: device ms} of --root and stop")
    args = ap.parse_args()
    if args.times:
        print(json.dumps(times(os.path.abspath(args.root))))
        return
    root = os.path.abspath(args.root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"card": smi}
    for name, tree in (("as is", root), ("window", window_copy(root)),
                       ("as is again", root)):
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--times", "--root", tree],
                             capture_output=True, text=True)
        if got.returncode != 0:
            raise SystemExit(got.stdout + got.stderr)
        res[name] = json.loads(got.stdout.strip().splitlines()[-1])
        print(f"{name}: {res[name]}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
