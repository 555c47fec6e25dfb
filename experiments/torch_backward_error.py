#!/usr/bin/env python3
"""Where the HJB training kernels' gradient differences come from, on one
CUDA card: a table of per-leaf max |a - b| / max |b|.

    python3 experiments/torch_backward_error.py

The cases are ``chip_smoke.py``'s phases 6 and 7 at K=8192, N=32: LLGC
d=100 with the exported control and u_tab, and LQGC d=100 with a random
TanhMLP [101, 50, 37, 100] and the KL term; four draws of host noise and
the Philox stream (binom and erfinv, signs +1 and -1).  Per case:

  loss       the log-variance loss gradients through both training kernels
             against those through the plain version (each side's own
             forward outputs give its cotangents);
  shared,    the backward kernel on the plain outputs' cotangents (gY, gKL)
  device     against the plain backward on them, in each memory plan;
  permuted   the plain backward against itself on the same paths in
             another order (float32 reordering alone);
  kern perm  the backward kernel on those permuted paths;
  tf32       the plain backward with cuBLAS TF32 products against it
             without: a control of what TF32 arithmetic reads.

The last lines give each column's largest value per problem.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pspde_torch.ansatz import TanhMLP  # noqa: E402
from pspde_torch.problems import LLGC, LQGC  # noqa: E402
from pspde_torch.rollout import _build, kernels as km  # noqa: E402
from pspde_torch.solvers import HJBSolver  # noqa: E402

N, DT, K = cs.N_TRAIN, cs.DT_TRAIN, cs.K_TRAIN_CHECK


def rels(got, want):
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]


def plain_cotangents(prob, net, kw):
    """The plain outputs' loss gradients through both training kernels,
    through the plain version, and the cotangents (gY, gKL) of the loss
    at the plain outputs."""
    params = list(net.parameters())
    kern = km.fused_train_rollout(prob, net, K, N, DT, **kw)
    g_kern = torch.autograd.grad(cs.train_loss(prob, kern, kw), params)
    plain = km.reference_train_rollout(prob, net, K, N, DT, **kw)
    g_plain = torch.autograd.grad(cs.train_loss(prob, plain, kw), params)
    Y = plain.Y.detach().requires_grad_()
    Zs = plain.Z_sum.detach().requires_grad_()
    gY, gKL = torch.autograd.grad(
        cs.train_loss(prob, plain._replace(Y=Y, Z_sum=Zs), kw), [Y, Zs],
        allow_unused=True)
    return g_kern, g_plain, gY, torch.zeros_like(gY) if gKL is None else gKL


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_backward_error: needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.library()
    llgc = LLGC(d=cs.D, T=cs.T_END, device=dev)
    solver = HJBSolver("llgc_d100", llgc, K=1024, delta_t=DT,
                       time_approx="inner", learn_Y_0=True, device=dev)
    solver.load_jax_params(os.path.join(ROOT, "pspde_torch", "assets",
                                        "llgc_d100_tanhmlp.npz"))
    lqgc = LQGC(d=cs.D, T=cs.T_END, off_diag=0.05, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    lqgc_net = TanhMLP(cs.D + 1, cs.D, hidden=(50, 37), init_scale=0.1,
                       generator=gen, device=dev)
    u_tab = llgc.u_ref_table(np.arange(N) * DT)
    worst = {}
    for tag, prob, net, base in (
            ("LLGC", llgc, solver.z_net, dict(u_tab=u_tab)),
            ("LQGC", lqgc, lqgc_net,
             dict(accumulate_kl=True, kl_ito_term=True))):
        draws = [(f"host {i}", lambda: dict(base, host_noise=torch.randn(
            (N, K, cs.D), generator=gen, device=dev))) for i in range(4)]
        draws += [(f"{rng} {s:+.0f}", lambda rng=rng, s=s: dict(
            base, seed=4321, rng=rng, noise_sign=s))
            for rng in ("binom", "erfinv") for s in (1.0, -1.0)]
        for name, make in draws:
            kw = make()
            g_kern, g_plain, gY, gKL = plain_cotangents(prob, net, kw)
            call = cs.train_call(prob, net, K, N, DT, kw)
            b_plain = km._reference_train_backward(call, gY, gKL)
            res = {"loss": rels(g_kern, g_plain)}
            for plan in ("shared", "device"):
                b_kern = km._train_backward_kernel(
                    cs.train_call(prob, net, K, N, DT, dict(kw, plan=plan)),
                    gY, gKL)
                res[plan] = rels(b_kern, b_plain)
            if "host_noise" in kw:
                perm = torch.randperm(K, generator=gen, device=dev)
                kwp = dict(kw, host_noise=kw["host_noise"][:, perm]
                           .contiguous())
                callp = cs.train_call(prob, net, K, N, DT, kwp)
                res["permuted"] = rels(km._reference_train_backward(
                    callp, gY[perm], gKL[perm]), b_plain)
                res["kern perm"] = rels(km._train_backward_kernel(
                    callp, gY[perm], gKL[perm]), b_plain)
            torch.backends.cuda.matmul.allow_tf32 = True
            res["tf32"] = rels(km._reference_train_backward(call, gY, gKL),
                               b_plain)
            torch.backends.cuda.matmul.allow_tf32 = False
            print(f"{tag} {name:9s} " + "  ".join(
                f"{k} [{' '.join('%.1e' % v for v in r)}]"
                for k, r in res.items()), flush=True)
            for k, r in res.items():
                worst[(tag, k)] = max(worst.get((tag, k), 0.0), max(r))
    for (tag, k), v in worst.items():
        print(f"largest {tag} {k}: {v:.2e}")


if __name__ == "__main__":
    main()
