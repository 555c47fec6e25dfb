"""The JAX package's corrector readouts that ``chip_smoke.py`` (phase 38)
holds the port's against.

Runs ``pspde.eval``'s correctors on the CPU from JAX's own trained nets and
prints one JSON line per run and one summary line per part:

* ``ac`` (check (b)): the Allen-Cahn diffusion legs of
  ``experiments/allen_cahn_reference.py`` (the committed initial net,
  sampling seeds 42, 43, 44, 1000 steps), each read directly at (0, 0), by
  ``feynman_kac_refine`` (dt 1e-3, N=300) and by ``picard_refine`` (3
  stages, 'tube' anchors, reg_steps 3000), against the literature's
  0.052802.  Cut for the CPU: the readouts' K from 10^6 to 10^5 and the
  Picard anchors from M=4096, K_inner=1024 to M=512, K_inner=128.
* ``heat`` (check (d)): BASELINE config 2 (``experiments/
  baseline_configs.py:config_2``, HeatEquation(d=50, T=0.2) on the radius-6
  ball, DenseNet (30, 30), diffusion, dt 2e-3, N=100, K=4096,
  K_boundary=2048, cosine_decay_schedule(1e-2, 3000, alpha=3e-4)) for the 5
  steps that phase 19 takes, from the port's own initial net (its
  ``GeneralSolver(seed=2)`` default, built here with ``pspde_torch`` and
  converted), then ``picard_refine(anchors='domain')`` with 2 stages at
  M=32768, reg_steps 8000 and the mean relative test error of
  ``compute_test_error`` ('parabolic', K=16384).  Cut for the CPU: K_inner
  from 256 to 32 (the anchors, not K_inner, set this floor:
  experiments/baseline_configs.py's anchor-count study).  Three seeds
  (the training's and the refinement's keys).
* ``fp`` (check (e)): the 4000-step net of ``experiments/
  eigen_fp_reference.py`` (seed 42) refined by ``eigen_power_refine``
  (3 stages, T_horizon 1.5, M=8192, K_inner=256, dt 2e-3, reg_steps 6000;
  no cut) under three keys, then ``estimate_lambda`` and
  ``estimate_lambda_richardson`` (K=8192, 16 batches) and the fresh MSE
  against v_ref on 10^5 uniform points.
* ``committor_g``: how often pspde's committor reads g = 1 at exits that
  ``bgk_closures``' projection puts on the inner sphere (jitted, as its
  correctors run it), at d = 3 and 10 on 2*10^5 points with radii
  uniform in [0.97, 1.05], beside the port's projection, which moves such
  a point out of the domain.

    JAX_PLATFORMS=cpu python experiments/refine_reference.py [--part ac]
        [--ac-seeds 44 --ac-read-k 1000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from pspde.ansatz import DenseNet  # noqa: E402
from pspde.eval import (eigen_power_refine, feynman_kac_refine,  # noqa: E402
                        picard_refine)
from pspde.eval.test_error import compute_test_error  # noqa: E402

LITERATURE = 0.052802
AC_SEEDS = (42, 43, 44)
AC_L, AC_READ_K, AC_M, AC_K_INNER = 1000, 100_000, 512, 128
HEAT_SEEDS = (0, 1, 2)
HEAT_STEPS, HEAT_M, HEAT_K_INNER = 5, 32768, 32
FP_KEYS = (1, 2, 3)
SMOKE = False


def sized(full, smoke):
    return smoke if SMOKE else full


def emit(rec):
    print(json.dumps(rec), flush=True)


def part_ac():
    import allen_cahn_reference as acr

    with np.load(acr.ASSET) as z:
        from pspde_torch.utils.convert import unflatten_tree
        init = unflatten_tree({k: z[k] for k in z.files})
    rows = []
    for seed in AC_SEEDS:
        t0 = time.perf_counter()
        s = acr.solver(seed, AC_L)
        s.params = jax.tree_util.tree_map(jnp.array, init)
        s.opt_state = s.tx.init(s.params)
        s.train()
        direct = acr.v_at_origin(s)
        p = s.problem
        fk = feynman_kac_refine(p, lambda X, t: s._v_fn(s.params)(X, t),
                                jnp.zeros((acr.D,)), K=AC_READ_K,
                                delta_t=1e-3,
                                key=jax.random.PRNGKey(seed + 1000))
        val, se, _ = picard_refine(
            p, s.V_net, s.params, jnp.zeros((acr.D,)), n_stages=3,
            M=AC_M, K_inner=AC_K_INNER, delta_t=1e-3,
            reg_steps=sized(3000, 5),
            readout_K=AC_READ_K, key=jax.random.PRNGKey(seed + 2000))
        err = {k: abs(v - LITERATURE) for k, v in (
            ("direct", direct), ("refine", float(fk.value)),
            ("picard", float(val)))}
        rec = {"part": "ac", "seed": seed, "read_K": AC_READ_K,
               "direct": direct,
               "refine": float(fk.value), "refine_se": float(fk.stderr),
               "picard": float(val), "picard_se": float(se), "err": err,
               "check": err["refine"] <= 0.5 * err["direct"]
               and err["picard"] <= 0.5 * err["direct"],
               "seconds": time.perf_counter() - t0}
        emit(rec)
        rows.append(rec)
    emit({"part": "ac", "summary": True,
          "check_all": all(r["check"] for r in rows),
          "direct": [r["direct"] for r in rows],
          "refine": [r["refine"] for r in rows],
          "picard": [r["picard"] for r in rows]})


def _port_initial_heat_net():
    """The port's config-2 initial net (its GeneralSolver's default at
    seed 2: DenseNet (30, 30) on [x, t] from a CPU generator) as a Flax
    tree."""
    import torch

    from pspde_torch.ansatz import DenseNet as TorchDenseNet
    from pspde_torch.utils.convert import dense_net_to_flax

    net = TorchDenseNet(d_out=1, d_in=51, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    return dense_net_to_flax(list(net.parameters()))


def part_heat():
    from pspde.problems import HeatEquation
    from pspde.problems.base import Geometry
    from pspde.solvers import GeneralSolver

    init = _port_initial_heat_net()
    rows = []
    for seed in HEAT_SEEDS:
        t0 = time.perf_counter()
        p = HeatEquation(d=50, T=0.2)
        p.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
        s = GeneralSolver(
            p, f"config2-{seed}", seed=seed, L=HEAT_STEPS,
            lr=optax.cosine_decay_schedule(1e-2, 3000, alpha=3e-4),
            value_net=DenseNet(d_out=1, arch=(30, 30)), delta_t=2e-3,
            N=100, K=4096, K_boundary=2048, K_test_log=16384,
            loss_method="diffusion", verbose=False)
        # a copy a leg: training donates its parameters' buffers
        s.params = jax.tree_util.tree_map(jnp.array, init)
        s.opt_state = s.tx.init(s.params)
        s.train()

        def mre(params):
            return float(compute_test_error(
                lambda XT: s.V_net.apply(params, XT)[:, 0], p, 16384,
                jax.random.PRNGKey(5), modus="parabolic")[2])

        before = mre(s.params)
        _, _, refined = picard_refine(
            p, s.V_net, s.params, x0=None, anchors="domain", n_stages=2,
            M=HEAT_M, K_inner=HEAT_K_INNER, delta_t=2e-3,
            reg_steps=sized(8000, 5),
            key=jax.random.PRNGKey(seed + 77))
        rec = {"part": "heat", "seed": seed, "steps": len(s.loss_log),
               "mre_before": before, "mre": mre(refined),
               "seconds": time.perf_counter() - t0}
        emit(rec)
        rows.append(rec)
    emit({"part": "heat", "summary": True,
          "mre": [r["mre"] for r in rows],
          "mre_before": [r["mre_before"] for r in rows]})


def part_fp():
    from pspde.problems import FokkerPlanckEigen
    from pspde.solvers import EigenSolver

    p = FokkerPlanckEigen(d=5)
    s = EigenSolver(p, "fp-eigen-ref", seed=42, delta_t=1e-3, N=20, lr=1e-3,
                    lr_lambda=0.01, lambda_init=0.5, L=sized(4000, 2),
                    K=500,
                    K_boundary=50, alpha=(50.0, 1.0), normalization="center",
                    value_net=DenseNet(d_out=1, arch=(10, 10, 10, 10)),
                    steps_per_call=100, verbose=False)
    t0 = time.perf_counter()
    s.train()
    trained = s.params
    Xt = 2 * np.pi * jax.random.uniform(jax.random.PRNGKey(123),
                                        (100000, p.d))

    def mse(V):
        return float(jnp.mean((s.V_net.apply(V, Xt)[:, 0]
                               - p.v_ref(Xt)) ** 2))

    lam0, se0 = s.estimate_lambda(K=sized(8192, 256), n_batches=16)
    emit({"part": "fp", "trained": True, "seconds": time.perf_counter() - t0,
          "lambda_tail_mean": s.lambda_tail_mean(), "lambda": lam0,
          "lambda_se": se0, "mse": mse(trained["V"])})
    rows = []
    for k in FP_KEYS:
        t0 = time.perf_counter()
        refined, hist = eigen_power_refine(
            p, s.V_net, trained["V"], n_stages=sized(3, 1), T_horizon=1.5,
            M=sized(8192, 64), K_inner=sized(256, 4), delta_t=2e-3,
            reg_steps=sized(6000, 5), K_center=sized(65536, 256),
            key=jax.random.PRNGKey(42 + k))
        s.params = {**trained, "V": refined}
        lam, se = s.estimate_lambda(K=sized(8192, 256), n_batches=16)
        lam_r, se_r = s.estimate_lambda_richardson(K=sized(8192, 256),
                                                   n_batches=16)
        rec = {"part": "fp", "key": 42 + k, "lambda": lam, "lambda_se": se,
               "lambda_richardson": lam_r, "lambda_richardson_se": se_r,
               "mse_before": mse(trained["V"]), "mse": mse(refined),
               "lambda_growth": [h["lambda_growth"] for h in hist],
               "seconds": time.perf_counter() - t0}
        emit(rec)
        rows.append(rec)
    emit({"part": "fp", "summary": True,
          "lambda": [(r["lambda"], r["lambda_se"]) for r in rows],
          "lambda_richardson": [(r["lambda_richardson"],
                                 r["lambda_richardson_se"]) for r in rows],
          "mse": [r["mse"] for r in rows]})


def part_committor_g():
    import torch

    from pspde.eval.refine import bgk_closures
    from pspde.problems import Committor
    import pspde_torch.problems as tp
    from pspde_torch.eval.refine import bgk_closures as port_closures

    for d in (3, 10):
        p = Committor(d=d)
        _, project = bgk_closures(p, 1e-3)
        rng = np.random.default_rng(d)
        X = rng.standard_normal((200_000, d))
        X *= rng.uniform(0.97, 1.05, (200_000, 1)) / np.linalg.norm(
            X, axis=1, keepdims=True)
        X = X.astype(np.float32)
        g_jax = np.asarray(jax.jit(lambda X: p.g(project(X)))(
            jnp.asarray(X)))
        pt = tp.Committor(d=d, device="cpu")
        g_port = pt.g(port_closures(pt, 1e-3)[1](torch.from_numpy(X)))
        emit({"part": "committor_g", "d": d,
              "jax_inner_reads_1": float(g_jax.mean()),
              "port_inner_reads_1": float(g_port.mean())})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("ac", "heat", "fp", "committor_g",
                                       "all"), default="all")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, to check that every part runs")
    ap.add_argument("--ac-seeds", type=int, nargs="+", default=None,
                    help="the Allen-Cahn legs to run (default 42 43 44)")
    ap.add_argument("--ac-read-k", type=int, default=None,
                    help="the Allen-Cahn readouts' K (default 10^5)")
    args = ap.parse_args()
    global AC_SEEDS, AC_L, AC_READ_K, AC_M, AC_K_INNER
    global HEAT_STEPS, HEAT_M, HEAT_K_INNER, SMOKE
    if args.smoke:
        AC_L, AC_READ_K, AC_M, AC_K_INNER = 2, 2048, 16, 8
        HEAT_STEPS, HEAT_M, HEAT_K_INNER = 1, 256, 4
        SMOKE = True
    if args.ac_seeds:
        AC_SEEDS = tuple(args.ac_seeds)
    if args.ac_read_k:
        AC_READ_K = args.ac_read_k
    parts = {"heat": part_heat, "fp": part_fp, "ac": part_ac,
             "committor_g": part_committor_g}
    for name, fn in parts.items():
        if args.part in (name, "all"):
            fn()


if __name__ == "__main__":
    main()
