"""The serve kernel on the HJB training forward's step (CPU).

The serve kernel (pspde_torch/csrc/controlled_rollout.cu) runs the HJB
training forward's block and step code (train_step.cuh): tile x tpp
threads, the net as block-cooperative 3xTF32 tensor-core products, and the
importance-sampling sums (train_forward_step<..., kSumIS>) kept in 4
classes of dimension groups and added in class order.  Its arguments are
the forward's TrainArgs, packed by ``_pack_train`` with the serve's flags.

Here: the pack at the serve's shapes (LLGC d=100 at K=2^20, dense LQGC
d=100 with TanhMLP [101 -> 50 -> 37 -> 100] at K=8192, LLGC d=1000 at
K=8192) against the kernel's block formulas; the launch against a fake
library behind ``_launch`` (grid, block = tile x tpp, the ints in the order
of train_step.cuh's TrainArgs, read from the source); the class split of
the sums transcribed in numpy against the plain rollout on host noise; the
layout rule.  The kernel's own products are held on the card by
chip_smoke.py; the net's 3xTF32 arithmetic by
tests/test_torch_train_forward_mma.py.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import pspde_torch.problems as tp
from pspde_torch.ansatz import TanhMLP
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk

CSRC = os.path.join(os.path.dirname(__file__), "..", "pspde_torch", "csrc")
SERVE_CASES = {
    # (problem, hidden, K, tile, tpp, plan)
    "llgc_d100": (lambda: tp.LLGC(d=100, T=1.0, device="cpu"), (30, 30),
                  2 ** 20, 64, 4, "shared"),
    "lqgc_d100_dense": (lambda: tp.LQGC(d=100, T=1.0, off_diag=0.05,
                                        device="cpu"), (50, 37), 8192, 64,
                        4, "shared"),
    "llgc_d1000": (lambda: tp.LLGC(d=1000, T=2.0, device="cpu"), (30, 30),
                   8192, 64, 4, "device"),
}


def _serve_pack(problem, net, K, N=100, dt=0.01, host_noise=None, **kw):
    drift, cost = tk._check_family(problem, net, True, 1.0)
    return tk._pack(problem, net, drift, cost, K, N, dt, None, host_noise,
                    1.0, **kw)


def _train_args_ints():
    """The int fields of train_step.cuh's TrainArgs, in order, arrays
    expanded to kMaxLayers entries."""
    with open(os.path.join(CSRC, "train_step.cuh")) as f:
        src = f.read()
    body = re.search(r"struct TrainArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.findall(r"^\s*int ([^;]*);", body, re.M):
        for item in decl.split(","):
            m = re.match(r"\s*(\w+)(\[kMaxLayers\])?", item)
            n = tk._MAX_LAYERS if m.group(2) else 1
            names += [m.group(1) if n == 1 else f"{m.group(1)}{i}"
                      for i in range(n)]
    return names


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_pack_at_the_serve_shapes(case):
    """Tile, threads per path and plan by the serve's rule; one block's
    bytes (train_step.cuh:train_smem_floats: the staged net in fragment
    order, the arrays at stride tile + 4, the exchange of the sums' 4
    classes) within 232,448, the staged net's floats those of
    ``_train_fwd_net_floats``; the device plan's workspace."""
    make, hidden, K, tile, tpp, plan = SERVE_CASES[case]
    pt = make()
    d = pt.d
    net = TanhMLP(d + 1, d, hidden=hidden,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    packed = _serve_pack(pt, net, K)
    a = dict(zip(_train_args_ints(), packed.iargs))
    assert len(packed.iargs) == len(a) == 26 + 5 * tk._MAX_LAYERS
    assert (a["tile"], a["tpp"], tk._plan_of(packed)) == (tile, tpp, plan)
    assert a["backward"] == 0 and a["adaptive"] == 1 and a["rng"] == 0
    dp = -(-d // 8) * 8
    cols = [-(-w // 8) * 8 for w in hidden] + [dp]
    k_rows = [dp] + cols[:-1]
    net_floats = cols[0] + sum(c + k * c for k, c in zip(k_rows, cols))
    drift, cost = tk._check_family(pt, net, True, 1.0)
    assert net_floats == tk._train_fwd_net_floats(
        tk._layout(pt, net, drift, cost), dp)
    dense = case == "lqgc_d100_dense"
    per_path = dp * (3 if dense else 2) + sum(cols[:-1])
    sums = 3 * 4 * tile
    if plan == "shared":
        smem = 4 * (net_floats + per_path * (tile + 4) + sums)
        assert smem == tk._train_smem_bytes(net_floats + sums, per_path,
                                            tile)
        assert smem <= 232_448
        assert packed.ws_floats == 0 and a["ws_stride"] == 0
    else:
        assert 4 * sums <= 232_448
        assert tk._train_smem_bytes(net_floats + 3 * 4 * 32, per_path, 32) \
            > 232_448
        assert a["ws_stride"] == -(-K // tile) * tile
        assert packed.ws_floats == per_path * a["ws_stride"]
    if case == "llgc_d100":
        assert smem == 108_576   # the forward's block: two an SM
    if dense:
        assert smem == 163_968   # one block an SM


class _FakeLibrary:
    """Stands in for the kernels' library: its serve entry reads the
    arguments as pspde_controlled_rollout does (TrainArgs' ints, six
    floats), records the launch it would make (grid, block, bytes of
    shared memory) and fills the output with the plain version's."""

    def __init__(self, fill):
        self.launches, self.fill = [], fill

    def pspde_controlled_rollout(self, params, noise, out, ws, iargs, fargs,
                                 seed, device, stream):
        ints = list(iargs)
        a = dict(zip(_train_args_ints(), ints))
        assert len(ints) == len(a)
        assert len(list(fargs)) == 6   # dt, sq_dt, sign, sig_scale, c_h,
        #                                f_coef
        L = a["n_layers"]
        dense = a["drift_kind"] == 1 or a["sig_kind"] == 2
        per_path = (a["dp"] * (3 if dense else 2)
                    + sum(a[f"cols{l}"] for l in range(L - 1)))
        k_rows = [a["dp"]] + [a[f"rows{l}"] for l in range(1, L)]
        net = a["cols0"] + sum(a[f"cols{l}"] * (1 + k_rows[l])
                               for l in range(L))
        sums = 3 * 4 * a["tile"]
        smem = 4 * (sums if a["plan"] == 1
                    else net + per_path * (a["tile"] + 4) + sums)
        self.launches.append({
            "grid": -(-a["K"] // a["tile"]), "block": a["tile"] * a["tpp"],
            "smem": smem, "seed": seed, "ws": ws, **a})
        self.fill(out)
        return 0

    def pspde_cuda_error_string(self, err):
        return b"fake"


def test_serve_launch_against_a_fake_library(monkeypatch):
    """``_serve_kernel`` hands ``_launch`` the packed ints in TrainArgs'
    order; the launch is one block of tile x tpp threads per tile paths,
    within the card's 256-thread forward block and its shared memory, the
    device plan with its workspace; the counters count it."""
    pt = tp.LLGC(d=12, T=1.0, device="cpu")
    net = TanhMLP(13, 12, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    K, N = 1000, 5
    plain = tk.reference_controlled_rollout(pt, net, K, N, 0.1, seed=3)
    want = torch.cat([plain.X, plain.ito[:, None], plain.riemann[:, None],
                      plain.f_int[:, None]], dim=1)

    def fill(ptr):
        ctypes.memmove(ptr, want.data_ptr(), want.numel() * 4)

    fake = _FakeLibrary(fill)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(tk.fused_controlled_rollout, "launches", 0)
    monkeypatch.setattr(tk.fused_controlled_rollout, "launches_by_plan",
                        dict.fromkeys(tk.PLANS, 0))
    for plan in ("shared", "device"):
        packed = _serve_pack(pt, net, K, N, 0.1, plan=plan)
        out = tk._serve_kernel(packed, None, 3, torch.device("cpu"))
        for got, ref in zip(out, plain):
            assert torch.equal(got, ref)
    shared, device = fake.launches
    for launch in (shared, device):
        assert launch["grid"] == 16 and launch["tile"] == 64
        assert launch["block"] == 256 and launch["tpp"] == 4
        assert launch["grid"] * launch["tile"] >= K
        assert (launch["K"], launch["N"], launch["d"], launch["dp"]) == \
            (K, N, 12, 16)
        assert launch["seed"] == 3 and launch["smem"] <= tk._SMEM_LIMIT
    assert shared["ws"] == 0 and shared["plan"] == 0   # no workspace
    assert device["ws"] != 0 and device["plan"] == 1
    assert device["ws_stride"] == 1024 and device["smem"] == 4 * 3 * 4 * 64
    assert tk.fused_controlled_rollout.launches == 2
    assert tk.fused_controlled_rollout.launches_by_plan == {"shared": 1,
                                                            "device": 1}


def _np_net(net, tX):
    h = tX.astype(np.float32)
    for l, lin in enumerate(net.layers):
        W = lin.weight.detach().numpy().astype(np.float32)
        b = lin.bias.detach().numpy().astype(np.float32)
        h = (h @ W.T + b).astype(np.float32)
        if l + 1 < len(net.layers):
            h = np.tanh(h).astype(np.float32)
    return h


def classed_serve(problem, net, noise, N, dt):
    """The serve kernel's step and sums in numpy float32: Z = net([t, X]),
    u = -Z, the adaptive Euler update; per class r of kSumClasses = 4 the
    terms of the dimension groups g = r mod 4 (dimensions 4g .. 4g + 3)
    for -Z.xi sqrt(dt) and |Z|^2 dt, and of the row chunks j0 / 8 = r mod
    4 for f(X', t) dt, each class summed over the steps, then the classes
    added in class order (train_path_sums)."""
    K, d = noise.shape[1], noise.shape[2]
    f32 = np.float32
    dt32, sq = f32(dt), f32(np.sqrt(dt))
    X = np.broadcast_to(problem.X_0.numpy().astype(f32), (K, d)).copy()
    drift = problem.drift_family()
    sig = problem.sigma_struct
    cost = problem.running_cost_family()
    groups = np.arange(d) // 4 % 4
    chunks = np.arange(d) // 8 % 4
    acc = np.zeros((3, 4, K), f32)
    for n in range(N):
        t = f32(n) * dt32
        Z = _np_net(net, np.concatenate([np.full((K, 1), t, f32), X], 1))
        xi = noise[n]
        u = -Z
        if sig.kind == "full":
            S = sig.mat.numpy().astype(f32)
            s_u, s_xi = u @ S.T, xi @ S.T
        else:
            s = f32(sig.scale) if sig.kind == "scalar" else \
                sig.diag.numpy().astype(f32)
            s_u, s_xi = s * u, s * xi
        b = -X if drift[0] == "neg_identity" else \
            X @ drift[1].numpy().astype(f32).T
        X = (X + (b + s_u) * dt32 + s_xi * sq).astype(f32)
        f_terms = np.zeros_like(X)
        if cost[0] == "quadratic":
            f_terms = X * (X @ cost[1].numpy().astype(f32).T)
        for r in range(4):
            g, c = groups == r, chunks == r
            acc[0, r] += -np.sum(Z[:, g] * xi[:, g], 1, dtype=f32) * sq
            acc[1, r] += np.sum(Z[:, g] * Z[:, g], 1, dtype=f32) * dt32
            acc[2, r] += np.sum(f_terms[:, c], 1, dtype=f32) * dt32
    total = ((acc[:, 0] + acc[:, 1]) + acc[:, 2]) + acc[:, 3]
    return X, total


@pytest.mark.parametrize("case", ["llgc_d10", "lqgc_d21_dense"])
def test_class_split_sums_match_the_plain_rollout(case):
    """The sums as the kernel keeps them (4 classes, added in class order),
    transcribed in numpy, against the plain rollout's ito, riem and f_int on
    the same host noise, rtol 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(11)
    if case == "llgc_d10":
        pt, d = tp.LLGC(d=10, T=1.0, device="cpu"), 10
    else:
        pt, d = tp.LQGC(d=21, T=1.0, off_diag=0.1, device="cpu"), 21
    net = TanhMLP(d + 1, d, hidden=(30, 30),
                  generator=torch.Generator().manual_seed(2), device="cpu")
    K, N, dt = 96, 20, 0.05
    noise = rng.standard_normal((N, K, d)).astype(np.float32)
    X, (ito, riem, fint) = classed_serve(pt, net, noise, N, dt)
    ref = tk.reference_controlled_rollout(pt, net, K, N, dt,
                                          host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(X, ref.X.numpy(), rtol=1e-5, atol=1e-6)
    for got, want in ((ito, ref.ito), (riem, ref.riemann),
                      (fint, ref.f_int)):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    if case == "llgc_d10":
        assert np.all(fint == 0.0)
    else:
        assert np.abs(fint).max() > 0.0


@pytest.mark.parametrize("tile", [32, 64, 96, 128])
def test_serve_threads_per_path_at_each_tile(tile):
    """Where K gives 4 x 132 blocks or more (the device plan's 64 x 2
    blocks then fill an H100 at the register cap): the plan's threads per
    path, 4 shared and 2 device (the forward's fastest at config 5); where
    K leaves the card idle (K=8192 at d=1000: 128 blocks of 64 paths),
    4 in both plans.  Every tpp divides the 4 classes of sums and tile x
    tpp stays within the 256-thread block."""
    cap = 256 // tile
    full = 4 * 132 * tile
    for plan, big in (("shared", 4), ("device", 2)):
        assert tk._serve_tpp(tile, plan, 2 ** 20) == min(big, cap)
        assert tk._serve_tpp(tile, plan, full) == min(big, cap)
        assert tk._serve_tpp(tile, plan, full - tile) == min(4, cap)
        assert tk._serve_tpp(tile, plan, 8192) == min(4, cap)
        for K in (1, 8192, full, 2 ** 20):
            tpp = tk._serve_tpp(tile, plan, K)
            assert 4 % tpp == 0 and tile * tpp <= tk._FWD_THREADS


def test_forced_threads_per_path():
    """A forced tpp is taken where it divides the 4 classes and fits the
    block, and raises otherwise."""
    pt = tp.LLGC(d=12, T=1.0, device="cpu")
    net = TanhMLP(13, 12, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    for tpp in (1, 2, 4):
        assert _serve_pack(pt, net, 500, tpp=tpp).iargs[-3] == tpp
    with pytest.raises(ValueError, match="tpp=3"):
        _serve_pack(pt, net, 500, tpp=3)
    drift, cost = tk._check_family(pt, net, True, 1.0)
    with pytest.raises(ValueError, match="tpp=4"):
        tk._pack(pt, net, drift, cost, 500, 10, 0.1, 128, None, 1.0,
                 tpp=4)
