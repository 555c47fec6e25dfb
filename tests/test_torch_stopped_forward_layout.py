"""The stopped forward's layout, launch, work split and lane schedule (CPU).

The forward kernel (pspde_torch/csrc/stopped_rollout.cu: stopped_fwd_kernel)
runs blocks of ``tile`` lanes of ``tpp`` threads: a lane carries one path at
a time, its threads split the value net by output chunk and the gradient by
row, and a lane whose path ends takes the next one.  The kernel cannot run
here: these tests hold the wrapper's side (the layout chosen at the cells of
chip_smoke.py, the raise past one block's shared memory, the ints and the
queue passed to the library), the kernel's split of the net transcribed in
Python (every output chunk and every gradient row owned by one thread of
the lane), and the numpy model of the lane schedule
(chip_smoke.py: ``stopped_fwd_lane_schedule``).  On the card chip_smoke.py
holds every layout's outputs bitwise equal to one thread a path at one tile
a block, and the lanes' trips to the paths' steps.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout.sampling import sample_domain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

N_INTS = 16 + 4 * tk._MAX_HIDDEN + 6 + 4  # StoppedArgs', StoppedExt's
CHUNK = 8                               # csrc kChunk


def _cell(kind, K, arch=(30, 30), d=50):
    """A call at one of the stopped cells (sphere, gen, heat, torus), at
    K paths."""
    g = torch.Generator().manual_seed(0)
    lam, timed = None, False
    if kind == "sphere":
        prob = tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.1, device="cpu")
        d_in = d
    elif kind == "gen":
        prob = tp.ExponentialOnSphereNonlinearParabolic(d=d, device="cpu")
        d_in, timed = d + 1, True
    elif kind == "heat":
        prob = tp.HeatEquation(d=d, T=0.2, device="cpu")
        prob.geometry = tp.Geometry(kind="unbounded", boundary_distance=6.0)
        d_in, timed = d + 1, True
    else:
        prob = tp.FokkerPlanckEigen(d=d, device="cpu")
        d_in, lam = d, torch.full((1,), 0.3)
    net = DenseNet(1, arch, d_in=d_in, device="cpu", generator=g)
    X0 = sample_domain(g, prob.geometry, K, d)
    t0 = torch.zeros(K)
    fam = tk._check_stopped_family(prob, net, "erfinv", timed, lam)
    return tk._StoppedCall(prob, net, X0, t0, 20, 1e-3, 17, fam,
                           dict(adaptive_forward=False, rng="erfinv",
                                host_noise=None, time_stopping=timed),
                           None, lam)


class FakeLib:
    """The library's occupancy query as the runtime answers it: blocks per
    SM by shared memory (227 KB of 228, 1 KB reserved a block) and threads
    (2048 an SM), on 132 SMs; counts the queries."""

    def __init__(self):
        self.asked = []

    def pspde_stopped_fwd_occupancy(self, iargs, fargs, index, out):
        ia = list(iargs)
        self.asked.append(ia[N_INTS])
        lay = _LAST[0]
        threads = lay.tile * lay.tpp
        smem = _LAST[1]
        out[0] = min(233472 // (smem + 1024), 2048 // threads)
        out[1], out[2], out[3] = threads, smem, 132
        return 0


_LAST = [None, None]


def _fake_grid(monkeypatch, call):
    """The forward's layout, stage, shared bytes a block and grid, with the
    occupancy answered by FakeLib."""
    lib = FakeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_STOPPED_FWD_OCC", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    packed = call.pack(backward=False)
    lay = tk._FwdLayout(*packed.layout)
    smem = tk._stopped_fwd_smem_bytes(packed)
    _LAST[:] = [lay, smem]
    grid = tk._stopped_fwd_grid(packed, torch.device("cpu"))
    return lay, bool(packed.iargs[6]), smem, grid, lib


# (kind, K, arch, d): the shapes of PERF.md row 4, and what the wrapper
# chooses there, the fastest layouts by device time on an H100
# (experiments/torch_kernel_times.py --layouts stopped): (tile, tpp,
# refill, staged, bytes a block, grid on 132 SMs).  Bytes: the staged net
# (the packed floats and 4 pad floats a W row) and 2 F + H + d floats a
# path at stride tile + 1.
ROW4 = {
    "elliptic": (("sphere", 65536, (30, 30), 50),
                 (64, 4, True, True, 4 * (4340 + 4 * 130 + 330 * 65), 264)),
    "notebook": (("sphere", 65536, (70, 50, 50, 50), 50),
                 (16, 16, True, True,
                  4 * (32676 + 4 * 560 + 810 * 17), 132)),
    "gen50": (("gen", 65536, (30, 30), 50),
              (64, 4, True, True, 4 * (4404 + 4 * 132 + 332 * 65), 264)),
    "heat": (("heat", 4096, (30, 30), 50),
             (16, 8, False, True, 4 * (4404 + 4 * 132 + 332 * 17), 256)),
    "torus K=500": (("torus", 500, (10, 10, 10, 10), 5),
                    (4, 16, False, True, 4 * (1400 + 4 * 80 + 135 * 5), 125)),
    "torus K=65536": (("torus", 65536, (10, 10, 10, 10), 5),
                      (64, 2, False, True, 4 * (1400 + 4 * 80 + 135 * 65),
                       1024)),
}


@pytest.mark.parametrize("shape", list(ROW4))
def test_layout_at_row4_shapes(monkeypatch, shape):
    """The forward's tile, threads a lane, grid and bytes a block at the
    cells it is timed at; every block within one block's shared memory, the
    lanes' threads a multiple of 32 up to the block's limit."""
    (kind, K, arch, d), want = ROW4[shape]
    call = _cell(kind, K, arch, d)
    lay, staged, smem, grid, lib = _fake_grid(monkeypatch, call)
    assert (lay.tile, lay.tpp, lay.refill, staged, smem, grid) == want
    assert smem <= tk._SMEM_LIMIT
    threads = lay.tile * lay.tpp
    assert threads % 32 == 0 and threads <= tk._STOPPED_FWD_THREADS
    # the occupancy is asked only for a refilled grid, and once
    tk._stopped_fwd_grid(call.pack(backward=False), torch.device("cpu"))
    assert lib.asked == ([lay.tpp] if lay.refill else [])
    # the backward keeps its own tile
    assert call.pack(backward=True).iargs[5] in tk._STOPPED_TILES


def test_forced_layouts_and_the_raise():
    """A forced layout packs its tile; a layout the kernel does not take
    raises; so does a net whose forward arrays fit no block even at the
    smallest tile (the backward raises before it)."""
    call = _cell("sphere", 1000)
    for lay in ((64, 1, False), (32, 8, True), (4, 8, True), (8, 4, False)):
        packed = call._replace(fwd_layout=lay).pack(backward=False)
        assert packed.iargs[5] == lay[0]
        assert tuple(packed.layout) == lay
    for bad in ((64, 8, True), (16, 1, True), (24, 4, True), (32, 3, True)):
        with pytest.raises(ValueError, match="forward layout"):
            call._replace(fwd_layout=bad).pack(backward=False)
    # per-path floats 2 F + H + d past one block at every tile
    per_path = tk._SMEM_LIMIT // (4 * 5) + 1
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY"):
        tk._stopped_fwd_layout([1000] * 4, "sphere", 65536, 0, per_path)
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY"):
        tk._stopped_fwd_layout([30, 30], "sphere", 65536, 0, 100_000,
                               layout=(64, 1, False))
    # the widest net the forward takes: at tile 4, 16 threads a lane
    lay, stage = tk._stopped_fwd_layout([1000] * 4, "sphere", 65536, 10 ** 6,
                                        per_path - 1)
    assert (lay.tile, lay.tpp, stage) == (4, 16, False)


@pytest.mark.parametrize("K,layout,slots", [
    (1000, (64, 4, True), 3), (1000, (8, 4, True), 200),
    (97, (16, 2, False), None), (65536, (32, 8, True), 2)])
def test_forward_launch(monkeypatch, K, layout, slots):
    """The wrapper passes tpp and the grid after StoppedArgs' ints, and a
    zeroed queue of 1 + grid x tile ints (the path counter, then each
    lane's trips); a refilled grid is at most the blocks the card holds,
    one block per tile otherwise; the outputs and the (grid, tile) trips
    come back."""
    call = _cell("sphere", K, arch=(6, 5), d=6)
    launched = []

    class Lib:
        def pspde_stopped_fwd_occupancy(self, iargs, fargs, index, out):
            out[0], out[1], out[2], out[3] = slots, 0, 0, 1
            return 0

    def fake_launch(fn, who, packed, tensors, seed, dev):
        assert fn == "pspde_stopped_rollout_fwd"
        assert len(packed.iargs) == N_INTS + 2
        queue = tensors[-1]
        assert queue.dtype == torch.int32 and int(queue.abs().sum()) == 0
        launched.append((packed.iargs[N_INTS:], queue.numel()))
        X, acc = tensors[4], tensors[5]
        X.fill_(1.0)
        acc.fill_(2.0)
        queue[1:] = torch.arange(1, queue.numel(), dtype=torch.int32)

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_FWD_OCC", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    c = call._replace(fwd_layout=layout)
    tile, tpp, refill = layout
    T = -(-K // tile)
    grid = min(T, slots) if refill else T
    before = tk.fused_stopped_train_rollout.launches
    out, trips = tk._stopped_forward_launch(c)
    assert tk.fused_stopped_train_rollout.launches == before + 1
    assert launched == [([tpp, grid], 1 + grid * tile)]
    assert out.X.shape == (K, 6) and float(out.Y.sum()) == 2.0 * K
    assert tuple(trips.shape) == (grid, tile)
    assert int(trips[0, 0]) == 1 and int(trips[-1, -1]) == grid * tile


def _chunk_owners(wp, p):
    """The output chunks thread q of a lane computes in value_forward:
    j0 = q kChunk, (q + p) kChunk, ... below the padded width."""
    return {q: list(range(q * CHUNK, wp, p * CHUNK)) for q in range(p)}


def _grad_rows(widths, d_in, p):
    """The rows thread q writes in value_grad, phase by phase: the copy of
    wL (rows i = q, q + p, ...), each layer's elementwise step (rows o + j
    for j from (q - o) & (p - 1) by p) and its row sums (rows i < o from q
    by p)."""
    F = d_in + sum(widths)
    phases = [("copy", {q: list(range(q, F, p)) for q in range(p)})]
    o = F
    for w in reversed(widths):
        o -= w
        phases.append(("elementwise", {
            q: [o + j for j in range((q - o) & (p - 1), w, p)]
            for q in range(p)}))
        phases.append(("sums", {q: list(range(q, o, p)) for q in range(p)}))
    return F, phases


NETS = [((30, 30), 50), ((70, 50, 50, 50), 50), ((10, 10, 10, 10), 5),
        ((30, 30), 51)]


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("widths,d_in", NETS)
def test_net_split_owns_each_output_once(widths, d_in, p):
    """value_forward: every output chunk of every hidden layer is computed
    by exactly one thread of the lane (each output's sum over the input
    rows stays in one thread, in one order).  value_grad: in each phase
    every row is written by exactly one thread, and always by thread
    row mod p, so the elementwise step reads and writes only the thread's
    own rows (no meeting before it); the row sums read the layer's outputs,
    which other threads wrote, after the lane meets."""
    for w in widths:
        wp = -(-w // CHUNK) * CHUNK
        owners = _chunk_owners(wp, p)
        got = sorted(j0 for js in owners.values() for j0 in js)
        assert got == list(range(0, wp, CHUNK))
    F, phases = _grad_rows(widths, d_in, p)
    o = F
    layers = iter(reversed(widths))
    for what, rows in phases:
        every = sorted(i for rs in rows.values() for i in rs)
        if what == "copy":
            assert every == list(range(F))
        elif what == "elementwise":
            w = next(layers)
            o -= w
            assert every == list(range(o, o + w))
        else:
            assert every == list(range(o))
        for q, rs in rows.items():
            assert all(i % p == q for i in rs)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [5, 6, 50])
def test_noise_split_owns_each_coordinate_once(d, p):
    """The step's normals: thread q draws the dimension groups q, q + p,
    ... (4 coordinates each, the Philox block of the plain version), so
    every coordinate is drawn and moved by one thread."""
    coords = [4 * gi + c for q in range(p) for gi in range(q, -(-d // 4), p)
              for c in range(4) if 4 * gi + c < d]
    assert sorted(coords) == list(range(d))


def _check_fwd_schedule(steps, tile, grid):
    """The lane model carries every path once, on one lane, back to back
    from the lane's first trip; the first round is path i on lane i; the
    queue's paths start in order; and no lane idles while paths are left:
    a lane ends its last path no earlier than the last path starts."""
    steps = np.asarray(steps, dtype=np.int64)
    K, lanes = steps.shape[0], grid * tile
    out = chip_smoke.stopped_fwd_lane_schedule(steps, tile, grid,
                                               max(1, 32 // tile))
    runs, trips = out["runs"], out["trips"].reshape(-1)
    assert all(r is not None for r in runs)
    assert int(trips.sum()) == int(steps.sum())
    per_lane = {}
    for k, (lane, start, n) in enumerate(runs):
        assert 0 <= lane < lanes and n == steps[k]
        if k < lanes:
            assert (lane, start) == (k, 0)
        per_lane.setdefault(lane, []).append((start, n))
    for lane, rs in per_lane.items():
        at = 0
        for start, n in rs:
            assert start == at
            at += n
        assert at == trips[lane]
    starts = [r[1] for r in runs[lanes:]]
    assert starts == sorted(starts)
    if K > lanes:
        last = max(starts)
        assert all(trips[i] >= last for i in range(lanes))
    return out


def test_fwd_lane_schedule_on_the_plain_rollout():
    """Ball: paths exit after a few steps.  One block per tile runs each
    warp as long as its longest path; a refilled grid carries the paths on
    fewer lanes back to back, and its warps' busy lane-trips fall."""
    K = 1000
    call = _cell("sphere", K, arch=(6, 5), d=6)
    with torch.no_grad():
        hit = call.plain().hitting.long().numpy()
    one = _check_fwd_schedule(hit, 64, -(-K // 64))
    padded = np.zeros(64 * -(-K // 64), dtype=np.int64)
    padded[:K] = hit
    assert one["busy"] == 32 * int(padded.reshape(-1, 32).max(axis=1).sum())
    for tile, grid, tpp in ((8, 4, 4), (16, 3, 2), (64, 1, 1)):
        out = chip_smoke.stopped_fwd_lane_schedule(hit, tile, grid, tpp)
        _check_fwd_schedule(hit, tile, grid)
        assert int(hit.sum()) <= out["busy"] < one["busy"]


def test_fwd_lane_schedule_torus_and_edges():
    """Torus: most paths run all N steps; one block per tile gives each
    lane one path.  Paths past the lanes wait in the queue; a single lane
    carries every path."""
    rng = np.random.default_rng(0)
    steps = rng.integers(1, 21, size=300)
    out = _check_fwd_schedule(steps, 16, -(-300 // 16))
    assert sorted(out["trips"].reshape(-1)[:300]) == sorted(steps)
    out = _check_fwd_schedule(steps, 4, 1)
    assert out["trips"].sum() == steps.sum()
    _check_fwd_schedule(steps[:1], 8, 1)
    out = _check_fwd_schedule(np.ones(100, dtype=np.int64), 1, 1)
    assert int(out["trips"][0, 0]) == 100
