"""The stopped backward's grid and lane schedule (CPU).

The replay-backward kernel (pspde_torch/csrc/stopped_rollout.cu:
stopped_bwd_kernel) launches at most the blocks the card holds at once;
each block owns a contiguous range of the K paths, and its lanes take the
range's next paths as theirs stop.  The kernel cannot run here: these tests
hold the wrapper's side of that contract (``_stopped_grid``,
``_stopped_ranges``, the stride, the gradient rows and block counts sized
to the grid, the rows summed) and the numpy model of the lane schedule
(chip_smoke.py: ``stopped_lane_schedule``, the prediction that the
kernel's own block-steps and busy lanes are held to on the card) fed the
plain rollout's step counts.  The kernel's own schedule is held on the card
by chip_smoke.py (the backward against the plain backward, K not a multiple
of the tile on a grid smaller than ceil(K / tile), its counts against the
model).
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

# SM counts of a few cards, times the blocks per SM the shared memory
# allows (1 at d=50, DenseNet (30, 30); 3 on the torus)
SLOTS = (1, 2, 7, 132, 396)


@pytest.mark.parametrize("K", [1, 63, 64, 65, 500, 8192, 65536])
@pytest.mark.parametrize("tile", [32, 64])
def test_ranges_partition_the_paths(K, tile):
    """Every grid's ranges are contiguous, nonempty and cover [0, K) once,
    in whole tiles (the last cut at K) whose counts differ by at most one;
    the grid never exceeds the slots nor ceil(K / tile)."""
    T = -(-K // tile)
    for slots in SLOTS:
        grid = tk._stopped_grid(K, tile, slots)
        assert 1 <= grid <= min(slots, T)
        ranges = tk._stopped_ranges(K, tile, grid)
        assert len(ranges) == grid
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
            assert hi == nlo and hi % tile == 0
        tiles = [-(-(hi - lo) // tile) for lo, hi in ranges]
        assert min(tiles) >= 1 and max(tiles) - min(tiles) <= 1
        assert sum(tiles) == T
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        np.testing.assert_array_equal(covered, np.arange(K))


def _ball_call(K, d=6, arch=(6, 5), seed=0, N=20, adaptive=False):
    prob = tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.1, device="cpu")
    net = DenseNet(1, arch, d_in=d, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    X0 = sample_domain(torch.Generator().manual_seed(seed + 1),
                       prob.geometry, K, d)
    return tk._StoppedCall(
        prob, net, X0, torch.zeros(K), N, 1e-3, 4321,
        tk._check_stopped_family(prob, net, "erfinv"),
        dict(adaptive_forward=adaptive, rng="erfinv", host_noise=None), None)


N_INTS = 16 + 4 * tk._MAX_HIDDEN + 6 + 4  # StoppedArgs', StoppedExt's


@pytest.mark.parametrize("K,slots", [(65, 1), (500, 3), (500, 132),
                                     (8192 + 37, 132)])
def test_backward_rows_sized_to_the_grid(monkeypatch, K, slots):
    """The wrapper asks the library once for the slots of an
    instantiation (StoppedArgs' ints, the stride, a grid it does not read
    and the plan), sizes the gradient rows and the block counts to the
    grid, passes the stride, the grid and the plan (0: shared) after
    StoppedArgs' ints and no workspace, and sums the rows it gets back."""
    asked = []

    class FakeLib:
        def pspde_stopped_bwd_slots(self, iargs, fargs, index, out):
            asked.append((index, len(iargs), iargs[N_INTS]))
            out._obj.value = slots
            return 0

    launched = []

    def fake_launch(fn, who, packed, tensors, seed, dev):
        assert fn == "pspde_stopped_rollout_bwd"
        part, counts, ws = tensors[-3:]
        assert counts.dtype == torch.int32 and ws is None
        launched.append((packed.iargs[N_INTS:], tuple(part.shape),
                         tuple(counts.shape)))
        assert len(packed.iargs) == N_INTS + 3
        part.copy_(torch.arange(1, part.shape[0] + 1,
                                dtype=torch.float32)[:, None].expand_as(part))
        counts.fill_(1)

    monkeypatch.setattr(_build, "library", lambda: FakeLib())
    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    call = _ball_call(K)
    n_grad = tk._stopped_layout(call.v_net).n_grad
    gY = torch.ones(K)
    for _ in range(2):
        grads = tk._stopped_backward_kernel(call, gY)
    tile = call.pack(backward=True).iargs[5]
    grid = tk._stopped_grid(K, tile, slots)
    assert asked == [(0, N_INTS + 3, tile + 4)]
    assert launched == [([tile + 4, grid, 0], (grid, n_grad),
                         (grid, 2))] * 2
    total = grid * (grid + 1) / 2
    for g in grads:
        assert torch.all(g == total)


def _check_schedule(steps, tile, grid):
    """Run the lane model and check that it carries every path once, from
    its first step to its last, on one lane of its own block; that a lane
    carries one path at a time; that no lane idles while its block's range
    has paths left; and that the block-steps are what the runs occupy."""
    steps = np.asarray(steps, dtype=np.int64)
    K = steps.shape[0]
    out = chip_smoke.stopped_lane_schedule(steps, tile, grid)
    runs = out["runs"]
    ranges = tk._stopped_ranges(K, tile, grid)
    assert all(r is not None for r in runs)
    assert out["lane_steps"] == int(steps.sum())
    total = 0
    for b, (lo, hi) in enumerate(ranges):
        busy = {}
        end = 0
        first = []
        for k in range(lo, hi):
            rb, lane, start, n = runs[k]
            assert rb == b and 0 <= lane < tile and n == steps[k]
            first.append(start)
            for s in range(start, start + n):
                assert (lane, s) not in busy, (k, lane, s)
                busy[(lane, s)] = k
            end = max(end, start + n)
        # paths start in the order of the range
        assert first == sorted(first)
        # while paths of the range wait, every lane is busy
        last_start = max(first) if first else 0
        for s in range(last_start):
            assert all((lane, s) in busy for lane in range(tile)), (b, s)
        total += end
    assert out["block_steps"] == total
    return out


@pytest.mark.parametrize("tile", [32, 64])
def test_lane_schedule_on_the_plain_rollout(tile):
    """Ball: a path occupies a lane for its advancing steps.  At one block
    per tile paths and the active steps (hitting) the model counts what the
    kernel ran before the refill: the most hitting of each block's paths.
    With the refill the same paths need fewer block-steps."""
    K = 704
    call = _ball_call(K)
    with torch.no_grad():
        out = call.plain()
    adv = out.adv_steps.long().numpy()
    hit = out.hitting.long().numpy()
    assert np.array_equal(hit - out.stopped.long().numpy(), adv)
    before = sum(int(hit[lo:lo + tile].max()) for lo in range(0, K, tile))
    if K % tile == 0:
        assert _check_schedule(hit, tile, K // tile)["block_steps"] == before
    for grid in (1, 3, -(-K // tile)):
        new = _check_schedule(adv, tile, grid)
        assert new["block_steps"] * tile >= adv.sum()
        if grid < -(-K // tile):
            assert new["block_steps"] < before


def test_lane_schedule_one_path_per_lane():
    """With one block per tile paths (K a multiple of the tile) each lane
    carries one path: a block's block-steps are its paths' most steps."""
    rng = np.random.default_rng(0)
    steps = rng.integers(0, 8, size=256)
    out = _check_schedule(steps, 64, 4)
    assert out["block_steps"] == sum(int(steps[lo:lo + 64].max())
                                     for lo in range(0, 256, 64))


def test_lane_schedule_torus():
    """Torus: a path occupies a lane for its active steps (the step whose
    proposal leaves is spent); paths that run all N steps fill the lanes."""
    K, d = 300, 5
    fp = tp.FokkerPlanckEigen(d=d, device="cpu")
    net = DenseNet(1, (10, 10), d_in=d, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    X0 = sample_domain(torch.Generator().manual_seed(1), fp.geometry, K, d)
    lam = torch.full((1,), 0.3)
    with torch.no_grad():
        out = tk.reference_stopped_train_rollout(fp, net, X0, torch.zeros(K),
                                                 20, 1e-3, 17, lam=lam)
    hit = out.hitting.long().numpy()
    assert hit.max() == 20
    for tile, grid in ((32, 2), (64, 5), (64, 1)):
        _check_schedule(hit, tile, grid)


def test_lane_schedule_paths_without_steps():
    """A path that takes no step frees its lane within the same refill."""
    steps = np.array([0, 3, 0, 0, 2, 0, 1, 0, 0, 4])
    out = _check_schedule(steps, 32, 1)
    assert out["block_steps"] == 4
    out = chip_smoke.stopped_lane_schedule(np.zeros(100, dtype=np.int64),
                                           32, 2)
    assert out["block_steps"] == 0 and out["lane_steps"] == 0


@pytest.mark.parametrize("arch,tile,stride", [
    ((30, 30), 64, 68),            # the elliptic cell: staged, tile 64
    ((70, 50, 50, 50), 32, 36),    # the notebook net
    ((85, 85, 85), 32, 33),        # 1,681 floats a path: only at tile + 1
])
def test_backward_stride(arch, tile, stride):
    """The backward's arrays sit at stride tile + 4 where a block fits and
    at the forward's tile + 1 where only that fits, so that every net the
    forward takes at d=50 the backward takes too; the packed call's shared
    memory stays within one block's limit."""
    d = 50
    call = _ball_call(64, d=d, arch=arch)
    fwd, bwd = call.pack(backward=False), call.pack(backward=True)
    assert bwd.iargs[5] == tile
    assert tk._stopped_bwd_ts(bwd) == stride
    F, H = d + sum(arch), sum(arch)
    n_stage = bwd.iargs[7] if bwd.iargs[6] else 0
    assert tk._stopped_smem_bytes(n_stage, 3 * F + 3 * H + 1, tile, True,
                                  stride) <= tk._SMEM_LIMIT
    # the forward's own block (its tile lanes of tpp threads) fits too
    assert fwd.iargs[5] in tk._STOPPED_FWD_TILES
    assert tk._stopped_fwd_smem_bytes(fwd) <= tk._SMEM_LIMIT


def test_backward_too_wide_raises():
    """A net whose backward arrays exceed one block even at tile 32 and
    stride 33 stays outside the shared plan: plan='shared' raises, naming
    the kernel family, and by default the backward takes the device plan
    (at K=64 8 lanes of 16 threads, their arrays in shared memory, the
    net's 47,468 floats read from device memory: they do not fit beside
    the arrays)."""
    call = _ball_call(64, d=50, arch=(100, 100, 100))
    call.pack(backward=False)
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY"):
        call._replace(plan="shared").pack(backward=True)
    packed = call.pack(backward=True)
    assert packed.layout == ("device", 16, 1) and packed.iargs[5:8] == [
        8, 0, 47468]


def _grid_call(kind, K):
    """A call of the family ``kind`` (sphere, whole space, torus) at K."""
    g = torch.Generator().manual_seed(3)
    lam, timed = None, False
    if kind == "sphere":
        prob = tp.ExponentialOnBallNonlinearSin(d=6, alpha=0.1, device="cpu")
        d_in = 6
    elif kind == "unbounded":
        prob = tp.HeatEquation(d=6, T=0.2, device="cpu")
        prob.geometry = tp.Geometry(kind="unbounded", boundary_distance=2.0)
        d_in, timed = 7, True
    else:
        prob = tp.FokkerPlanckEigen(d=5, device="cpu")
        d_in, lam = 5, torch.full((1,), 0.3)
    net = DenseNet(1, (6, 5), d_in=d_in, device="cpu", generator=g)
    X0 = sample_domain(g, prob.geometry, K, prob.d)
    return tk._StoppedCall(
        prob, net, X0, torch.zeros(K), 20, 1e-3, 4321,
        tk._check_stopped_family(prob, net, "erfinv", timed, lam),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=timed), None, lam)


@pytest.mark.parametrize("kind", ["sphere", "unbounded", "square"])
@pytest.mark.parametrize("K,slots", [(500, 3), (8192 + 37, 132),
                                     (65536, 396)])
def test_backward_grid_per_family(monkeypatch, kind, K, slots):
    """The backward's grid: on the sphere, where paths exit after a few
    steps, at most the blocks the card holds (the slots, asked of the
    library once) with lanes refilled from each block's range; on the whole
    space and the torus, where paths run their N steps and a refill gains
    nothing, one block per tile paths, the library not asked.  Either grid
    partitions the paths into ranges of whole tiles."""
    asked = []

    class FakeLib:
        def pspde_stopped_bwd_slots(self, iargs, fargs, index, out):
            asked.append(index)
            out._obj.value = slots
            return 0

    monkeypatch.setattr(_build, "library", lambda: FakeLib())
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    packed = _grid_call(kind, K).pack(backward=True)
    tile = packed.iargs[5]
    grids = [tk._stopped_bwd_grid(packed, torch.device("cpu"))
             for _ in range(2)]
    T = -(-K // tile)
    if kind == "sphere":
        assert grids == [min(T, slots)] * 2 and asked == [0]
    else:
        assert grids == [T] * 2 and asked == []
        assert tk._stopped_ranges(K, tile, T) == [
            (lo, min(K, lo + tile)) for lo in range(0, K, tile)]
