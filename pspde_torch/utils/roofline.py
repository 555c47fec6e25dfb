"""Measured roofline of the HJB training step on the card (counterpart of
``pspde/utils/roofline.py``).

The JAX package measures, on the TPU, the two machine rates that its
fused training step spends its time on, counts the step's work per
path-step, and splits the forward kernel's time by ablation.  The port does
the same on the H100, with three hand-written CUDA kernels in
``pspde_torch/csrc/roofline.cu`` and a plain PyTorch version beside each:

* ``vpu_fma_rate`` -> ``fma_chain`` (``reference_fma_chain``): the card's
  sustained FP32 FMA rate;
* ``prng_normals_rate`` -> ``normals_sum`` (``reference_normals_sum``):
  the rate of the training kernels' own normals (Philox4x32-10 through the
  erfinv or the binom map, ``rollout/kernels.py:train_normals``);
* ``fused_ablation_rates`` -> ``ablation`` (``reference_ablation``): the
  training forward stage by stage, on its own per-step device code
  (``csrc/train_step.cuh``) and at its block size and memory plan.

``count_vpu_work`` and ``fused_train_vpu_roofline`` count the step's work
on an aten graph traced on the CPU (``make_fx``) and charge it at the
measured rates.  Every rate is measured on a CUDA card: the measuring
functions raise on another device.  The kernel wrappers take CPU tensors
(their plain versions), which is how the tests reach them.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np
import torch

from ..ansatz import TanhMLP
from ..rollout import kernels as _k
from ..rollout.sde import step_constants, step_time
from .device import resolve_device

__all__ = ["ABLATION_STAGES", "FMA_P", "NORMALS_P", "ablation",
           "count_vpu_work", "fma_chain", "fused_ablation_rates",
           "fused_train_vpu_roofline", "normals_sum", "prng_normals_rate",
           "reference_ablation", "reference_fma_chain",
           "reference_normals_sum", "vpu_fma_rate"]


def _block(out):
    """Wait for the card's work behind ``out`` (``block_until_ready``)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def _marginal_rate(build_f, arg, P, work_per_pass, reps=5, outer=3):
    """Two-point marginal rate: time the kernel at P and at 2P passes and
    divide the extra work by the extra time, best of ``outer``; a fixed
    per-call cost (launch, allocation) cancels.  Host clock around calls
    that end in ``torch.cuda.synchronize``."""
    f1, f2 = build_f(P), build_f(2 * P)
    _block(f1(arg))
    _block(f2(arg))
    best = 0.0
    for _ in range(outer):
        t0 = time.perf_counter()
        for _ in range(reps):
            o1 = f1(arg)
        _block(o1)
        t1 = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            o2 = f2(arg)
        _block(o2)
        t2 = (time.perf_counter() - t0) / reps
        if t2 > t1:
            best = max(best, P * work_per_pass / (t2 - t1))
    return best


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline measures a CUDA card, not {dev}")
    return dev


def _call(fn_name: str, who: str, *args):
    from ..rollout._build import library
    lib = library()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed: "
                           + lib.pspde_cuda_error_string(err).decode())


def _stream_args(dev: torch.device):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


# -- the FMA rate (kernel 6) ---------------------------------------------------

CHAINS = (1, 4, 16)   # csrc/roofline.cu: pspde_fma_chain
# passes at which one call on an H100 lasts a millisecond or more (JAX's
# P=512 is too short to time there): the rates' defaults in
# fused_train_vpu_roofline
FMA_P, NORMALS_P = 4096, 2048


def _chain_consts(chain: int) -> np.ndarray:
    """c_j = -1.75 + 1e-6 j in float32: the quadratic map's bounded chaotic
    regime, |x| <= (1 + sqrt(8)) / 2 = 1.914 for x_0 in it."""
    if chain not in CHAINS:
        raise ValueError(f"chain={chain} must be one of {CHAINS}")
    return (np.float32(-1.75) + np.float32(1e-6)
            * np.arange(chain, dtype=np.float32)).astype(np.float32)


@torch.no_grad()
def reference_fma_chain(x: torch.Tensor, P: int,
                        chain: int = 16) -> torch.Tensor:
    """Plain version of ``fma_chain``: x <- x * x + c_j (two roundings
    where the kernel's fmaf has one), in place."""
    v = x.clone()
    for _ in range(P):
        for c in _chain_consts(chain):
            v = v * v + float(c)
    return x.copy_(v)


def fma_chain(x: torch.Tensor, P: int, chain: int = 16) -> torch.Tensor:
    """P passes of ``chain`` dependent links x <- fmaf(x, x, c_j) on every
    element of the float32 tensor x, in place; returns x.  CPU: the plain
    version; CUDA: the kernel (``fma_chain.launches``)."""
    consts = _chain_consts(chain)
    _k._check_tensor("x", x, x.shape, x.device)
    if P < 0:
        raise ValueError(f"P={P} must be >= 0")
    if x.device.type == "cpu":
        return reference_fma_chain(x, P, chain)
    c = (ctypes.c_float * chain)(*consts.tolist())
    _call("pspde_fma_chain", "fma_chain", x.data_ptr(), x.numel(), int(P),
          chain, c, *_stream_args(x.device))
    fma_chain.launches += 1
    return x


fma_chain.launches = 0


def vpu_fma_rate(d=100, tile=4096, P=512, chain=16, reps=5, device=None):
    """Sustained FP32 FMA rate of the card, in flops/s (2 per FMA).

    ``fma_chain`` on a (d, tile) carry from x = 0.3: each element runs
    ``chain`` dependent FMAs per pass, x <- x * x + c_j, a quadratic map
    no compiler can collapse, with the c_j in the kernel's constant bank,
    so the FP32 pipes do nothing else.  The JAX version adds a per-pass
    term 1e-7 i to c_j so that Mosaic cannot fold its loop; with P a
    runtime trip count nvcc cannot fold it either, and that term would
    cost one more FP32 instruction per link.  Two-point marginal rate
    over P and 2P passes (``_marginal_rate``)."""
    dev = _card(device)
    x = torch.full((d, tile), 0.3, dtype=torch.float32, device=dev)

    def build(p):
        return lambda t: fma_chain(t, p, chain)

    return _marginal_rate(build, x, P, 2.0 * d * tile * chain, reps=reps)


# -- the normals rate (kernel 7) -----------------------------------------------

@torch.no_grad()
def reference_normals_sum(seed: int, d: int, tile: int, P: int,
                          rng: str = "erfinv", device=None) -> torch.Tensor:
    """Plain version of ``normals_sum``: sum over the P passes of
    ``train_normals(seed, tile, p, d, rng)`` summed over d."""
    acc = torch.zeros(tile, dtype=torch.float32, device=device)
    for p in range(P):
        acc += _k.train_normals(seed, tile, p, d, rng, device).sum(dim=1)
    return acc


def normals_sum(seed: int, d: int, tile: int, P: int, rng: str = "erfinv",
                device=None) -> torch.Tensor:
    """(tile,) per-column sums of P passes of d normals of the training
    kernels' stream (path k = column, step n = pass).  CPU: the plain
    version; CUDA: the kernel (``normals_sum.launches``)."""
    if rng not in _k.RNG_MAPS:
        raise ValueError(f"rng={rng!r} must be one of {_k.RNG_MAPS}")
    if min(d, tile) <= 0 or P < 0:
        raise ValueError(f"d={d}, tile={tile}, P={P}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return reference_normals_sum(seed, d, tile, P, rng, dev)
    acc = torch.empty(tile, dtype=torch.float32, device=dev)
    _call("pspde_normals_sum", "normals_sum", acc.data_ptr(), tile, d,
          int(P), _k.RNG_MAPS.index(rng), int(seed) & 0xFFFFFFFFFFFFFFFF,
          *_stream_args(dev))
    normals_sum.launches += 1
    return acc


normals_sum.launches = 0


def prng_normals_rate(d=100, tile=4096, P=512, reps=5, rng="erfinv",
                      device=None):
    """Sustained normals/s of the training kernels' noise: Philox4x32-10
    and the ``rng`` map ('erfinv', JAX's map and the default, or 'binom',
    the port's training default, two Philox blocks per four draws).  An
    erfinv rate is no bound for a binom kernel (``bench.py:270-281``).
    Two-point marginal rate of ``normals_sum``."""
    dev = _card(device)

    def build(p):
        return lambda seed: normals_sum(seed, d, tile, p, rng, dev)

    return _marginal_rate(build, 7, P, d * tile, reps=reps)


# -- the work count ------------------------------------------------------------

# aten ops by kind; an op's name is its overload packet's (aten.mul.Tensor:
# "mul").  Elementwise ops count their output elements, transcendentals
# also into "sfu", matmuls 2 k per output element, reductions their input
# elements; layout and bookkeeping ops count nothing.
_SFU = {"exp", "log", "tanh", "erfinv", "sqrt", "rsqrt", "sin", "cos",
        "pow", "div", "sigmoid", "reciprocal"}
_ELEMENTWISE = _SFU | {
    "add", "sub", "rsub", "mul", "neg", "abs", "maximum", "minimum",
    "where", "clamp", "square", "sign", "floor", "ceil", "round",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_right_shift", "bitwise_left_shift", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not",
    "tanh_backward", "sigmoid_backward", "threshold_backward"}
_MATMUL = {"mm", "bmm", "addmm"}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin"}
_SKIP = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
         "expand", "unsqueeze", "squeeze", "slice", "select", "cat",
         "stack", "split", "clone", "detach", "alias", "full", "zeros",
         "ones", "zeros_like", "ones_like", "full_like", "empty",
         "empty_like", "new_zeros", "new_ones", "new_full", "new_empty",
         "_to_copy", "lift_fresh_copy", "copy", "copy_", "scalar_tensor",
         "sym_size", "_reshape_alias", "as_strided", "fill"}


def _numel(node) -> float:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return float(val.numel()) if isinstance(val, torch.Tensor) else 0.0


def count_vpu_work(graph) -> dict:
    """Count the work of an aten graph (a ``torch.fx.GraphModule`` from
    ``make_fx``, or its ``.graph``): elementwise element-ops ("elem"),
    the transcendental share of them ("sfu"), matmul FLOPs ("mm_flops", 2
    per multiply-add) and reduction input elements ("reduce").  Ops in no
    table go to "unknown" (name -> output elements).  JAX's TPU weights per
    primitive (``_ELEM_WEIGHT``) do not carry over: every elementwise op
    counts 1 per element."""
    g = getattr(graph, "graph", graph)
    out = {"elem": 0.0, "sfu": 0.0, "mm_flops": 0.0, "reduce": 0.0,
           "unknown": {}}
    for node in g.nodes:
        if node.op != "call_function" or not isinstance(
                node.target, torch._ops.OpOverload):
            continue
        name = node.target.overloadpacket.__name__.rstrip("_")
        if name in _SKIP:
            continue
        if name in _MATMUL:
            a, b = node.args[-2], node.args[-1]
            k = a.meta["val"].shape[-1]
            out["mm_flops"] += 2.0 * k * _numel(node)
            if name == "addmm":   # the bias add
                out["elem"] += _numel(node)
        elif name in _REDUCE:
            out["reduce"] += _numel(node.args[0])
        elif name in _ELEMENTWISE:
            out["elem"] += _numel(node)
            if name in _SFU:
                out["sfu"] += _numel(node)
        else:
            out["unknown"][name] = out["unknown"].get(name, 0.0) + \
                _numel(node)
    return out


def fused_train_vpu_roofline(problem, solver, *, fma_rate=None,
                             normals_rate=None, micro_kw=None):
    """Path-steps/s ceiling of the fused TRAINING step from its counted
    work and the card's measured rates.

    Traces the training forward's step math (``step_math``) and its
    per-step VJP replay (``bwd_math``) with ``make_fx`` on the CPU at a
    4096-path tile, counts them (``count_vpu_work``) and charges

        t_ps = 2 d / R_normals + (elem + reduce) / (R_fma / 2)
               + mm_flops / R_fma

    per path-step: the d normals are drawn twice (forward, and the
    backward's replay).  One deliberate difference from the JAX model: the
    port's kernels run the net's products on the FP32 FMA pipes, not on a
    matrix unit, so matmul FLOPs are charged at ``fma_rate`` too
    (``mm_flops_per_path_step``).  ``fma_rate`` and ``normals_rate``
    default to ``vpu_fma_rate`` and ``prng_normals_rate`` of the solver's
    noise map (on the card), at ``FMA_P`` and ``NORMALS_P`` passes;
    ``micro_kw`` (JAX's name) goes to both and overrides those.  Returns
    JAX's keys and ``mm_flops_per_path_step`` and ``sfu_per_path_step``."""
    from torch.func import functional_call, vjp
    from torch.fx.experimental.proxy_tensor import make_fx

    d, tile = problem.d, 4096
    net = solver.z_net
    names = [n for n, _ in net.named_parameters()]
    dt, sq_dt = step_constants(solver.delta_t)
    sig = problem.sigma_struct

    def step_math(X, t, xi, *params):
        T = X.shape[0]
        tX = torch.cat([t.expand(T, 1), X], dim=1)
        Z = functional_call(net, dict(zip(names, params)), (tX,))
        c = -Z.detach()
        X_new = (X + (problem.b(X) + sig.apply(c)) * dt
                 + sig.apply(xi) * sq_dt).detach()
        Zc = torch.sum(Z * c, dim=1)
        Zxi = torch.sum(Z * xi, dim=1)
        hv = problem.h(t, X_new, torch.zeros_like(Zc), Z)
        return X_new, (-hv + Zc) * dt + Zxi * sq_dt

    def bwd_math(X, t, xi, gy, *params):
        (X_new, _), pull = vjp(lambda *ps: step_math(X, t, xi, *ps),
                               *params)
        return (X_new,) + tuple(pull((torch.zeros_like(X), gy)))

    X = torch.zeros((tile, d), dtype=torch.float32)
    t = torch.zeros((), dtype=torch.float32)
    gy = torch.zeros((tile,), dtype=torch.float32)
    params = [p.detach().cpu() for p in net.parameters()]
    wf = count_vpu_work(make_fx(step_math, tracing_mode="fake")(
        X, t, X, *params))
    wb = count_vpu_work(make_fx(bwd_math, tracing_mode="fake")(
        X, t, X, gy, *params))

    micro_kw = micro_kw or {}
    if fma_rate is None:
        fma_rate = vpu_fma_rate(**{"P": FMA_P, **micro_kw})
    if normals_rate is None:
        normals_rate = prng_normals_rate(**{
            "P": NORMALS_P,
            "rng": getattr(solver, "fused_rng", None) or "binom",
            **micro_kw})

    normals_per_ps = 2.0 * d
    elem_per_ps = (wf["elem"] + wb["elem"] + wf["reduce"]
                   + wb["reduce"]) / tile
    mm_per_ps = (wf["mm_flops"] + wb["mm_flops"]) / tile
    t_ps = (normals_per_ps / normals_rate + elem_per_ps / (fma_rate / 2.0)
            + mm_per_ps / fma_rate)
    return {
        "vpu_fma_flops_per_sec": fma_rate,
        "prng_normals_per_sec": normals_rate,
        "normals_per_path_step": normals_per_ps,
        "elem_ops_per_path_step": elem_per_ps,
        "mm_flops_per_path_step": mm_per_ps,
        "sfu_per_path_step": (wf["sfu"] + wb["sfu"]) / tile,
        "fwd_elem_per_tile_step": wf["elem"] + wf["reduce"],
        "bwd_elem_per_tile_step": wb["elem"] + wb["reduce"],
        "unknown_prims": {**wf["unknown"], **wb["unknown"]},
        "roofline_path_steps_per_sec": 1.0 / t_ps,
    }


# -- the ablation ladder (kernel 8) --------------------------------------------

# csrc/roofline.cu: Stage
ABLATION_STAGES = ("noise", "euler", "net", "full", "full_nonoise",
                   "full_rawbits", "full_binom")


def _stage_noise(stage, seed, K, n, d, dev, host_noise):
    if stage == "full_nonoise":
        v = np.float32(0.01) * (np.float32(1.0)
                                + np.float32(1e-6) * np.float32(n))
        return torch.full((K, d), float(v), dtype=torch.float32, device=dev)
    if host_noise is not None:
        return host_noise[n]
    if stage == "full_rawbits":
        bits = _k.philox_bits(seed, K, n, d, 0, dev)
        return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.5
    return _k.train_normals(seed, K, n, d,
                            "binom" if stage == "full_binom" else "erfinv",
                            dev)


@torch.no_grad()
def reference_ablation(stage: str, problem, z_net, K: int, N: int,
                       delta_t: float, seed: int = 0,
                       host_noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain version of one ladder stage (the JAX ladder's math,
    ``pspde/utils/roofline.py:271-325``): K paths from X_0 = 0.1 over N
    steps, returning acc + sum_j X_j per path (K,).

      noise         acc += sum_j xi_j (X stays)
      euler         X <- X + b(X) dt + sigma xi sqrt(dt)
      net           Z = net([t, X]), c = -Z, X <- X + (b(X) + sigma c) dt
                    + sigma xi sqrt(dt), acc += Z.xi
      full          as net, acc += (-h(t, X', 0, Z) + Z.c) dt
                    + (Z.xi) sqrt(dt): the training forward's Y
      full_nonoise  full with xi = 0.01 (1 + 1e-6 n)
      full_rawbits  full with xi = (bits >> 9 | 1.0f) - 1.5
      full_binom    full on the binom map

    xi is the erfinv stream of ``train_normals`` (binom for full_binom),
    or ``host_noise`` (N, K, d) where given (not for full_nonoise)."""
    if stage not in ABLATION_STAGES:
        raise ValueError(f"stage={stage!r} must be one of {ABLATION_STAGES}")
    d = problem.d
    dev = problem.X_0.device
    dt, sq_dt = step_constants(delta_t)
    sig = problem.sigma_struct
    X = torch.full((K, d), 0.1, dtype=torch.float32, device=dev)
    acc = torch.zeros(K, dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(X)
    for n in range(N):
        t = step_time(n, dt)
        xi = _stage_noise(stage, seed, K, n, d, dev, host_noise)
        if stage == "noise":
            acc = acc + xi.sum(dim=1)
            continue
        c, Z = zeros, None
        if stage != "euler":
            tX = torch.cat([torch.full((K, 1), t, dtype=torch.float32,
                                       device=dev), X], dim=1)
            Z = z_net(tX)
            c = -Z
        X = X + (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        if stage == "net":
            acc = acc + torch.sum(Z * xi, dim=1)
        elif stage != "euler":
            hv = problem.h(t, X, torch.zeros_like(acc), Z)
            acc = (acc + (-hv + torch.sum(Z * c, dim=1)) * dt
                   + torch.sum(Z * xi, dim=1) * sq_dt)
    return acc + X.sum(dim=1)


def _pack_ablation(stage, problem, z_net, K, N, delta_t, tile, plan):
    """The training forward's arguments for one stage: its block size,
    memory plan and shared memory; no u_L2, no KL; adaptive but for
    euler."""
    fam = _k._check_train_family(problem, z_net, N, 1.0, None, "erfinv")
    return _k._pack_train(
        problem, z_net, *fam, K, N, delta_t, tile, backward=False,
        host_noise=None, noise_sign=1.0,
        adaptive_forward=stage != "euler", accumulate_kl=False,
        kl_ito_term=False, u_tab=None, rng="erfinv", plan=plan)


def ablation(stage: str, problem, z_net, K: int, N: int, delta_t: float,
             seed: int = 0, tile: Optional[int] = None,
             plan: Optional[str] = None) -> torch.Tensor:
    """One ladder stage over K paths and N steps (``reference_ablation``
    says what each computes), on the problem's device: CPU the plain
    version, CUDA the kernel (``ablation.launches``, per plan
    ``.launches_by_plan``), launched as the
    training forward would be at this shape (``tile``, ``plan`` as
    ``fused_train_rollout`` takes them).  The problem and net must be in
    the training kernels' family (``TRAIN_KERNEL_FAMILY``)."""
    if stage not in ABLATION_STAGES:
        raise ValueError(f"stage={stage!r} must be one of {ABLATION_STAGES}")
    if not isinstance(z_net, TanhMLP):
        raise _k._train_outside(f"control net {type(z_net).__name__} is "
                                "not a TanhMLP")
    dev = problem.X_0.device
    packed = _pack_ablation(stage, problem, z_net, K, N, delta_t, tile, plan)
    if dev.type == "cpu":
        return reference_ablation(stage, problem, z_net, K, N, delta_t, seed)
    out = torch.empty(K, dtype=torch.float32, device=dev)
    ws = _k._workspace(packed, dev)
    iargs = (ctypes.c_int * len(packed.iargs))(*packed.iargs)
    fargs = (ctypes.c_float * len(packed.fargs))(*packed.fargs)
    _call("pspde_ablation", "ablation", packed.params.data_ptr(),
          out.data_ptr(), 0 if ws is None else ws.data_ptr(),
          ABLATION_STAGES.index(stage), iargs, fargs,
          int(seed) & 0xFFFFFFFFFFFFFFFF, *_stream_args(dev))
    ablation.launches += 1
    ablation.launches_by_plan[_k._plan_of(packed)] += 1
    return out


ablation.launches = 0
ablation.launches_by_plan = dict.fromkeys(_k.PLANS, 0)


def fused_ablation_rates(problem, solver, *, K=131072, tile=None, reps=10):
    """Path-steps/s of each ladder stage (``ABLATION_STAGES``) at the
    solver's net, N and dt, on the card of the problem.

    Every stage launches with the training forward's block size, memory
    plan (shared where a block fits, else device) and shared memory, so
    the stages differ in work only; the deltas between them attribute the
    forward's time, and ``noise / 2`` is the training step's structural
    ceiling (the backward replays the noise).  Each stage is built and run
    once (a stage that fails to build or launch raises), then timed with
    CUDA events over ``reps`` launches in three interleaved rounds; the
    best rate per stage is kept.  JAX's ``unroll`` is a Mosaic lever with
    no counterpart here: nvcc unrolls the inner loops it can."""
    dev = problem.X_0.device
    if dev.type != "cuda":
        raise ValueError(f"the roofline measures a CUDA card, not {dev}")
    N, dt, net = solver.N, solver.delta_t, solver.z_net
    tile = tile if tile is not None else getattr(solver, "fused_tile", None)

    def run(stage):
        return ablation(stage, problem, net, K, N, dt, seed=11, tile=tile)

    for stage in ABLATION_STAGES:
        _block(run(stage))
    out = {}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for stage in ABLATION_STAGES:
            start.record()
            for _ in range(reps):
                run(stage)
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / reps
            out[stage] = max(out.get(stage, 0.0), K * N / (ms * 1e-3))
    return out
