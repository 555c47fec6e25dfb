"""The stopped backward's device plan: lanes of several threads (CPU).

The device plan's kernel (pspde_torch/csrc/stopped_bwd_lanes.cu:
stopped_bwd_lane_kernel) replays each path on a lane of tpp threads: the
value and tangent sweeps split their output chunks, grad V and the reverse
pair sweep their rows, and the threads meet where one reads what another
wrote.  The kernel cannot run here.  These tests hold the wrapper's side
(the layout chosen for the Allen-Cahn notebook's net and for the elliptic
net with the plan forced, the byte formulas against the .cu's, the ints and
the workspace passed to the library) and the split itself, transcribed in
numpy float32: for every tpp each sweep is bitwise the one-thread sweep,
and no thread reads a row another thread wrote before the lane meets.  On
the card chip_smoke.py holds the kernel against the plain backward (phase
30), bitwise against the shared plan at tile 64 (phase 31), and every
layout of one tile bitwise alike (phase 32).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet, DenseNetTanh
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk

CSRC = Path(tk.__file__).resolve().parents[1] / "csrc"
# the lanes kernel's source and the stopped kernels' shared header
CU = (CSRC / "stopped_bwd_lanes.cu", CSRC / "stopped_common.cuh")
N_INTS = 16 + 4 * tk._MAX_HIDDEN + 6 + 4   # StoppedArgs', StoppedExt's
CHUNK = 8                                 # csrc kChunk
NOTEBOOK = (110, 110, 50)                 # experiments/allen_cahn.py's net


def _allen_cahn_call(K, arch=NOTEBOOK, d=100, **kw):
    pt = tp.AllenCahn(d=d, T=0.3, device="cpu")
    pt.geometry = tp.Geometry(kind="unbounded", boundary_distance=7.0)
    net = DenseNet(1, arch, d_in=d + 1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return tk._StoppedCall(
        pt, net, torch.zeros((K, d)), torch.zeros(K), 25, 1e-3, 3,
        tk._check_stopped_family(pt, net, "erfinv", time_stopping=True),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=True), None, **kw)


def _elliptic_call(K, arch=(30, 30), d=50, **kw):
    prob = tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.1, device="cpu")
    net = DenseNet(1, arch, d_in=d, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return tk._StoppedCall(
        prob, net, torch.zeros((K, d)), torch.zeros(K), 20, 1e-3, 3,
        tk._check_stopped_family(prob, net, "erfinv"),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None,
        **kw)


# (K, layout, grid, workspace bytes, shared bytes a block): the notebook's
# net (d=100, [x, t], 1,924 floats a path, 56,108 staged floats) at the
# notebook's K, at chip_smoke.py's check K and at its timing K
@pytest.mark.parametrize("K,layout,grid,ws_bytes,smem_bytes", [
    (200, (8, 16, True, False), 25, 0, 4 * (16 + 1924 * 12)),
    (8192, (32, 8, False, False), 256, 4 * 1924 * 8192, 64),
    (65536, (64, 4, False, False), 1024, 4 * 1924 * 65536, 64)])
def test_notebook_layout(K, layout, grid, ws_bytes, smem_bytes):
    """The notebook net's backward takes the device plan at the layout the
    sweep found fastest: at K=200 16 threads a lane, 8 lanes a block (25
    blocks) and the lanes' arrays in shared memory; at K=8192 8 threads
    and 32 lanes, at K=65536 4 and 64, the arrays in the workspace (they
    fit no block at those tiles) and the net read from device memory."""
    packed = _allen_cahn_call(K).pack(backward=True)
    lay = tk._stopped_bwd_lane_of(packed)
    assert tuple(lay) == layout
    assert packed.layout == ("device", layout[1], int(layout[2]))
    assert packed.iargs[5:8] == [layout[0], int(layout[3]), 53576]
    g = tk._stopped_bwd_grid(packed, torch.device("cpu"))
    ts = tk._stopped_bwd_ts(packed, g)
    assert g == grid
    assert ts == (layout[0] + 4 if layout[2] else grid * layout[0])
    assert (4 * 1924 * ts if not layout[2] else 0) == ws_bytes
    assert tk._stopped_bwd_smem(packed, ts) == smem_bytes <= tk._SMEM_LIMIT


@pytest.mark.parametrize("K,layout", [
    (500, (8, 16, True, True)), (8192, (32, 8, True, True)),
    (65536, (64, 4, True, True))])
def test_elliptic_layout_forced(K, layout):
    """With the plan forced at the elliptic cell's net (d=50, DenseNet
    (30, 30): 511 floats a path) the arrays sit in shared memory and the
    net is staged beside them at every tile; tile=64 forces the tile (4
    threads a lane), as phase 31 holds it against the shared plan."""
    call = _elliptic_call(K, plan="device")
    lay = tk._stopped_bwd_lane_of(call.pack(backward=True))
    assert tuple(lay) == layout
    forced = tk._stopped_bwd_lane_of(
        call._replace(tile=64).pack(backward=True))
    assert tuple(forced) == (64, 4, True, True)
    assert tk._stopped_bwd_ts(call._replace(tile=64).pack(backward=True),
                              7) == 68
    # the shared plan is untouched
    shared = _elliptic_call(K).pack(backward=True)
    assert shared.layout == ("shared",) and shared.iargs[5] == 64


def test_forced_layouts_and_the_raises():
    """A forced layout is taken as given; one the kernel does not take (a
    tile or tpp off its lists, a block past 256 threads or not a multiple
    of 32, arrays past one block's shared memory) raises, and so does a
    forced tile off the list."""
    call = _allen_cahn_call(200)
    for lay in ((64, 2, False, False), (16, 16, False, True),
                (8, 32, True, False)):
        assert tuple(tk._stopped_bwd_lane_of(
            call._replace(bwd_layout=lay).pack(backward=True))) == lay
    for lay in ((128, 2, False, False), (16, 3, False, False),
                (64, 8, False, False), (8, 2, False, False),
                (32, 4, True, False), (8, 16, True, True)):
        with pytest.raises(ValueError, match="backward layout"):
            call._replace(bwd_layout=lay).pack(backward=True)
    with pytest.raises(ValueError, match="tile=48"):
        call._replace(plan="device", tile=48).pack(backward=True)


def _sch_call(K, **kw):
    """The Schroedinger notebook's cell: SchrodingerEigen(d=10),
    DenseNetTanh (15, 15, 15, 15) with the clamp, lambda, N=20."""
    prob = tp.SchrodingerEigen(d=10, device="cpu")
    net = DenseNetTanh(1, (15, 15, 15, 15), d_in=10, output_relu=True,
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))
    lam = torch.full((1,), -2.5)
    return tk._StoppedCall(
        prob, net, torch.zeros((K, 10)), torch.zeros(K), 20, 1e-3, 3,
        tk._check_stopped_family(prob, net, "erfinv", lam=lam),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=False), None, lam, **kw)


def _committor_call(K, **kw):
    """The committor notebook's cell: Committor(d=10) between the spheres 1
    and 2, DenseNet (30, 30), N=50."""
    prob = tp.Committor(d=10, device="cpu")
    net = DenseNet(1, (30, 30), d_in=10, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return tk._StoppedCall(
        prob, net, torch.zeros((K, 10)), torch.zeros(K), 50, 1e-3, 3,
        tk._check_stopped_family(prob, net, "erfinv"),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None,
        **kw)


NEW_FAMILY_CALLS = {"schrodinger": _sch_call, "committor": _committor_call}
# packed floats of the two nets and their staged floats (the forward's 4
# pads after each W row: 10 + 25 + 40 + 55 rows, and 10 + 40)
NEW_FAMILY_NETS = {"schrodinger": (2224, 2224 + 4 * 130),
                   "committor": (1740, 1740 + 4 * 50)}
# (family, K, layout, grid with the card's 264 slots, shared bytes a block):
# the device plan's general rule at the notebooks' K, chip_smoke.py's check
# K and its timing K; 391 floats a path in both nets.  On the square the
# grid is one block a tile; on the two spheres at most the slots
NEW_FAMILY_CELLS = [
    ("schrodinger", 500, (8, 16, True, True), 63, 4 * (16 + 2744 + 391 * 12)),
    ("schrodinger", 8192, (32, 8, True, True), 256,
     4 * (16 + 2744 + 391 * 36)),
    ("schrodinger", 65536, (64, 4, True, True), 1024,
     4 * (16 + 2744 + 391 * 68)),
    ("committor", 200, (8, 16, True, True), 25, 4 * (16 + 1940 + 391 * 12)),
    ("committor", 8192, (32, 8, True, True), 256,
     4 * (16 + 1940 + 391 * 36)),
    ("committor", 65536, (64, 4, True, True), 264,
     4 * (16 + 1940 + 391 * 68))]


@pytest.mark.parametrize("family,K,layout,grid,smem_bytes", NEW_FAMILY_CELLS)
def test_new_family_layout(monkeypatch, family, K, layout, grid,
                           smem_bytes):
    """The Schroedinger family's and the committor's backward take the
    lanes kernel first, at the device plan's general rule
    (_stopped_bwd_lane_layout: at the notebooks' K 8 lanes of 16 threads,
    at K=8192 32 lanes of 8, at K=65536 64 lanes of 4; the arrays in
    shared memory, the net staged beside them), its grid, stride and bytes
    a block, and hand the library [tile + 4, grid, 1, tpp, 1] after the
    packed ints; a forced tile takes the general rule at that tile, and a
    forced shared plan its one-thread tile 64 at stride 68, the net
    staged."""
    monkeypatch.setattr(tk, "_stopped_bwd_slots", lambda packed, dev: 264)
    call = NEW_FAMILY_CALLS[family](K)
    packed = call.pack(backward=True)
    n_params, n_stage = NEW_FAMILY_NETS[family]
    tile, tpp, smem, stage = layout
    assert tuple(tk._stopped_bwd_lane_of(packed)) == layout
    assert packed.layout == ("device", tpp, int(smem))
    assert packed.iargs[5:8] == [tile, int(stage), n_params]
    assert tk._stopped_bwd_per_path(packed) == 391
    g = tk._stopped_bwd_grid(packed, torch.device("cpu"))
    ts = tk._stopped_bwd_ts(packed, g)
    assert (g, ts) == (grid, tile + 4)
    assert tk._stopped_bwd_smem(packed, ts) == smem_bytes <= tk._SMEM_LIMIT
    assert smem_bytes == 4 * (tk._STOPPED_LANE_BALLOT_WORDS
                              + n_stage * stage + 391 * (tile + 4) * smem)
    assert tk._stopped_bwd_layout_ints(packed, ts, g) == [ts, g, 1, tpp,
                                                          int(smem)]
    forced = tk._stopped_bwd_lane_of(
        call._replace(plan="device", tile=64).pack(backward=True))
    assert tuple(forced) == (64, 4, True, True)
    shared = call._replace(plan="shared").pack(backward=True)
    assert shared.layout == ("shared",) and shared.iargs[5:7] == [64, 1]
    assert tk._stopped_bwd_ts(shared) == 68


def _cu_int(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def _cu_function(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def test_byte_formulas_against_the_cu():
    """The wrapper's shared and workspace bytes follow the .cu's
    lane_smem_floats (the ballots, 2 words per warp of kLaneThreads; the
    staged net with the forward's kRowPad floats after each W row; the
    arrays at the stride) and its constants, and its layout limits
    (unpack_lane_layout, lane_smem_floats)."""
    src = "".join(path.read_text() for path in CU)
    threads = _cu_int(src, "kLaneThreads")
    assert threads == tk._STOPPED_LANE_THREADS
    assert re.search(r"kLaneWarps = kLaneThreads / 32;", src)
    assert re.search(r"kLaneBallotWords = 2 \* kLaneWarps;", src)
    assert tk._STOPPED_LANE_BALLOT_WORDS == 2 * threads // 32
    assert _cu_int(src, "kRowPad") == tk._STOPPED_ROW_PAD
    lane = _cu_function(src, "size_t lane_smem_floats(")
    assert "const size_t per_path = 3 * a.F + 3 * H + 1;" in lane
    assert ("return kLaneBallotWords + staged_net_floats(a, true) +\n"
            "         (in_smem ? per_path * static_cast<size_t>(ts) : 0);"
            in lane)
    staged = _cu_function(src, "size_t staged_net_floats(")
    assert "net += kRowPad * n_in;" in staged
    layout = _cu_function(src, "bool unpack_lane_layout(")
    assert "t >= 8 && t <= 64" in layout and "t * p <= kLaneThreads" in layout
    assert "lay->ts == t + 4" in layout
    assert max(tk._STOPPED_LANE_TILES) == 64 and min(tk._STOPPED_LANE_TILES) == 8
    # the formula, by hand, at the notebook's net: 53,576 packed floats
    # and 4 pads after each of the 101 + 211 + 321 W rows
    n_stage = tk._stopped_fwd_net_floats(53576, list(NOTEBOOK), 101)
    assert n_stage == 53576 + 4 * (101 + 211 + 321)
    for lay, floats in (((8, 16, True, False), 16 + 1924 * 12),
                        ((64, 4, False, True), 16 + n_stage),
                        ((16, 16, True, False), 16 + 1924 * 20)):
        assert tk._stopped_bwd_lane_bytes(
            n_stage, 1924, tk._BwdLayout(*lay)) == 4 * floats
    assert 4 * (16 + 1924 * 20) == 153_984


# -- the split, transcribed ---------------------------------------------------


def _fma(a, b, c):
    """fmaf of float32s: the exact product and sum in float64, rounded."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


class _Lane:
    """p threads of one lane over named float32 rows.  Each thread runs a
    generator that yields where the kernel's lane meets (ln.sync()); between
    two meetings a thread reads the rows as they were at the last meeting,
    or as it wrote them itself, and may not read nor write a row that
    another thread wrote since: the transcription fails where the kernel
    would race."""

    def __init__(self, p, mem):
        self.p, self.mem = p, mem

    def run(self, sweep, *args):
        writes = [{} for _ in range(self.p)]
        outs = [None] * self.p

        def reader(q):
            def read(name, i):
                key = (name, i)
                if key in writes[q]:
                    return writes[q][key]
                for o in range(self.p):
                    assert o == q or key not in writes[o], (
                        f"thread {q} reads {key}, which thread {o} wrote "
                        "before the lane met")
                return self.mem[name][i]
            return read

        def writer(q):
            def write(name, i, v):
                for o in range(self.p):
                    assert o == q or (name, i) not in writes[o], (
                        f"threads {q} and {o} both write {(name, i)}")
                writes[q][(name, i)] = np.float32(v)
            return write

        gens = [sweep(q, self.p, reader(q), writer(q), *args)
                for q in range(self.p)]
        live = [True] * self.p
        while any(live):
            for q, g in enumerate(gens):
                try:
                    next(g)
                except StopIteration as e:
                    live[q] = False
                    outs[q] = e.value
            assert all(live) or not any(live), "the lane met unevenly"
            for w in writes:
                for (name, i), v in w.items():
                    self.mem[name][i] = v
                w.clear()
        return outs


def _net(widths, d_in, seed):
    rng = np.random.default_rng(seed)
    Ws, bs, n_in = [], [], d_in
    for w in widths:
        wp = -(-w // CHUNK) * CHUNK
        W = np.zeros((n_in, wp), np.float32)
        W[:, :w] = rng.standard_normal((n_in, w)) / np.sqrt(n_in)
        b = np.zeros(wp, np.float32)
        b[:w] = rng.standard_normal(w) * 0.1
        Ws.append(W)
        bs.append(b)
        n_in += w
    wL = (rng.standard_normal(n_in) / np.sqrt(n_in)).astype(np.float32)
    return Ws, bs, wL, np.float32(0.1)


# one-thread sweeps: value_forward, value_grad, the tangent and the pair
# sweep of stopped_bwd_kernel, in its order

def _unit(pre, tanh):
    """One hidden unit of h = pre: (its r row, its feature): relu(h) and
    relu(h)^2, or (tanh) the slope 1 - tanh(h)^2 and tanh(h)."""
    if tanh:
        tv = np.tanh(np.float32(pre))
        return np.float32(1 - np.float32(tv * tv)), tv
    rv = max(np.float32(pre), np.float32(0))
    return rv, np.float32(rv * rv)


def _d_unit(rv, x, tanh):
    """A unit's derivative times x: 2 relu(h) x, or (tanh) the slope x."""
    return np.float32(rv * x) if tanh else np.float32(np.float32(2 * rv) * x)


def _value_forward(net, widths, d_in, f, r, tanh=False):
    Ws, bs, wL, bL = net
    n_in = d_in
    for l, w in enumerate(widths):
        W = Ws[l]
        for j0 in range(0, W.shape[1], CHUNK):
            acc = [np.float32(0)] * CHUNK
            for i in range(n_in):
                acc = [_fma(f[i], W[i, j0 + c], acc[c]) for c in range(CHUNK)]
            for c in range(CHUNK):
                j = j0 + c
                if j < w:
                    r[n_in - d_in + j], f[n_in + j] = _unit(
                        np.float32(acc[c] + bs[l][j]), tanh)
        n_in += w
    v = np.float32(0)
    for i in range(len(f)):
        v = _fma(f[i], wL[i], v)
    return np.float32(v + bL)


def _value_grad(net, widths, d_in, r, g, tanh=False):
    Ws, _, wL, _ = net
    F = len(g)
    g[:] = wL
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for j in range(w):
            g[o + j] = _d_unit(r[o - d_in + j], g[o + j], tanh)
        for i in range(o):
            s = np.float32(0)
            for j in range(w):
                s = _fma(Ws[l][i, j], g[o + j], s)
            g[i] = np.float32(g[i] + s)


def _tangent(net, widths, d_in, r, fd, hd, tanh=False):
    Ws = net[0]
    n_in = d_in
    for l, w in enumerate(widths):
        W = Ws[l]
        for j0 in range(0, W.shape[1], CHUNK):
            acc = [np.float32(0)] * CHUNK
            for i in range(n_in):
                acc = [_fma(fd[i], W[i, j0 + c], acc[c])
                       for c in range(CHUNK)]
            for c in range(CHUNK):
                j = j0 + c
                if j < w:
                    hd[n_in - d_in + j] = acc[c]
                    fd[n_in + j] = _d_unit(r[n_in - d_in + j], acc[c], tanh)
        n_in += w


def _pair_cot(rv, ab, hv, adb):
    """The pair's cotangents of one relu^2 unit (rows kept apart so that
    both versions form them alike)."""
    two_rv = np.float32(2 * rv)
    gbv = (np.float32(np.float32(two_rv * ab)
                      + np.float32(np.float32(2 * hv) * adb))
           if rv > 0 else np.float32(0))
    return gbv, np.float32(two_rv * adb)


def _pair_cot_tanh(sl, tv, ab, hv, adb):
    """The pair's cotangents of one tanh unit, f = tanh(h) with slope s =
    1 - f^2: s fbar - 2 f s h' fbar' and s fbar' (stopped_bwd_kernel's
    kTanh branch, each product rounded)."""
    curv = np.float32(np.float32(np.float32(-2 * tv) * sl) * hv)
    return (np.float32(np.float32(sl * ab) + np.float32(curv * adb)),
            np.float32(sl * adb))


def _pair_reverse(net, widths, d_in, r, hd, gb, gdb, alpha, f=None):
    """The pair sweep; with the features ``f`` the tanh units' (f their
    tanh values, r their slopes), else the relu^2 units'."""
    Ws, _, wL, _ = net
    F = len(gb)
    for i in range(d_in, F):
        gb[i] = np.float32(alpha * wL[i])
        gdb[i - d_in] = wL[i]
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for j in range(w):
            if f is not None:
                gb[o + j], gdb[o + j - d_in] = _pair_cot_tanh(
                    r[o - d_in + j], f[o + j], gb[o + j], hd[o - d_in + j],
                    gdb[o + j - d_in])
                continue
            gb[o + j], gdb[o + j - d_in] = _pair_cot(
                r[o - d_in + j], gb[o + j], hd[o - d_in + j],
                gdb[o + j - d_in])
        for i in range(d_in, o):
            s = sd = np.float32(0)
            for j in range(w):
                s = _fma(Ws[l][i, j], gb[o + j], s)
                sd = _fma(Ws[l][i, j], gdb[o + j - d_in], sd)
            gb[i] = np.float32(gb[i] + s)
            gdb[i - d_in] = np.float32(gdb[i - d_in] + sd)


# the lane's sweeps, as the kernel splits them (lane_value_forward,
# lane_value_grad, lane_tangent, lane_pair_reverse): generators that yield
# at each ln.sync()

def _lane_value_forward(q, p, read, write, net, widths, d_in, F,
                        tanh=False):
    Ws, bs, wL, bL = net
    n_in = d_in
    for l, w in enumerate(widths):
        W = Ws[l]
        for j0 in range(q * CHUNK, W.shape[1], p * CHUNK):
            acc = [np.float32(0)] * CHUNK
            for i in range(n_in):
                a = read("f", i)
                acc = [_fma(a, W[i, j0 + c], acc[c]) for c in range(CHUNK)]
            for c in range(CHUNK):
                j = j0 + c
                if j < w:
                    rv, fv = _unit(np.float32(acc[c] + bs[l][j]), tanh)
                    write("r", n_in - d_in + j, rv)
                    write("f", n_in + j, fv)
        n_in += w
        yield
    v = np.float32(0)
    for i in range(F):
        v = _fma(read("f", i), wL[i], v)
    return np.float32(v + bL)


def _lane_value_grad(q, p, read, write, net, widths, d_in, F, tanh=False):
    Ws, _, wL, _ = net
    for i in range(q, F, p):
        write("g", i, wL[i])
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for j in range((q - o) & (p - 1), w, p):
            write("g", o + j, _d_unit(read("r", o - d_in + j),
                                      read("g", o + j), tanh))
        yield
        for i in range(q, o, 2 * p):
            i2 = i + p
            s = s2 = np.float32(0)
            for j in range(w):
                gj = read("g", o + j)
                s = _fma(Ws[l][i, j], gj, s)
                s2 = _fma(Ws[l][min(i2, o - 1), j], gj, s2)
            write("g", i, np.float32(read("g", i) + s))
            if i2 < o:
                write("g", i2, np.float32(read("g", i2) + s2))
    yield


def _lane_tangent(q, p, read, write, net, widths, d_in, tanh=False):
    Ws = net[0]
    n_in = d_in
    for l, w in enumerate(widths):
        W = Ws[l]
        for j0 in range(q * CHUNK, W.shape[1], p * CHUNK):
            acc = [np.float32(0)] * CHUNK
            for i in range(n_in):
                a = read("fd", i)
                acc = [_fma(a, W[i, j0 + c], acc[c]) for c in range(CHUNK)]
            for c in range(CHUNK):
                j = j0 + c
                if j < w:
                    write("hd", n_in - d_in + j, acc[c])
                    write("fd", n_in + j, _d_unit(
                        read("r", n_in - d_in + j), acc[c], tanh))
        n_in += w
        yield


def _lane_pair_reverse(q, p, read, write, net, widths, d_in, F, alpha,
                       tanh=False):
    Ws, _, wL, _ = net
    i0 = d_in + ((q - d_in) & (p - 1))
    for i in range(i0, F, p):
        write("gb", i, np.float32(alpha * wL[i]))
        write("gdb", i - d_in, wL[i])
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for j in range((q - o) & (p - 1), w, p):
            if tanh:   # the features' rows lie F rows before r's
                gbv, gdbv = _pair_cot_tanh(
                    read("r", o - d_in + j), read("f", o + j),
                    read("gb", o + j), read("hd", o - d_in + j),
                    read("gdb", o + j - d_in))
            else:
                gbv, gdbv = _pair_cot(read("r", o - d_in + j),
                                      read("gb", o + j),
                                      read("hd", o - d_in + j),
                                      read("gdb", o + j - d_in))
            write("gb", o + j, gbv)
            write("gdb", o + j - d_in, gdbv)
        yield
        for i in range(i0, o, 2 * p):
            i2 = i + p
            s = sd = s2 = sd2 = np.float32(0)
            for j in range(w):
                gj, gdj = read("gb", o + j), read("gdb", o + j - d_in)
                s = _fma(Ws[l][i, j], gj, s)
                sd = _fma(Ws[l][i, j], gdj, sd)
                s2 = _fma(Ws[l][min(i2, o - 1), j], gj, s2)
                sd2 = _fma(Ws[l][min(i2, o - 1), j], gdj, sd2)
            write("gb", i, np.float32(read("gb", i) + s))
            write("gdb", i - d_in, np.float32(read("gdb", i - d_in) + sd))
            if i2 < o:
                write("gb", i2, np.float32(read("gb", i2) + s2))
                write("gdb", i2 - d_in,
                      np.float32(read("gdb", i2 - d_in) + sd2))
    yield


SPLIT_NETS = [((12, 10), 5), ((9, 17, 6), 7), ((8, 8, 8, 8), 4)]


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("widths,d_in", SPLIT_NETS)
def test_lane_sweeps_are_the_one_thread_sweeps(widths, d_in, p):
    """For each tpp the lane's value, grad V, tangent and pair sweeps, run
    thread by thread between the lane's meetings (a thread reading a row
    that another wrote since the last meeting, or two threads writing one
    row, fails), give the one-thread sweeps' values bitwise: V in every
    thread, the features and relu rows, grad V's rows, h' and the
    features' tangents, and the pair's cotangents of every hidden row."""
    net = _net(widths, d_in, seed=len(widths) + d_in)
    F, H = d_in + sum(widths), sum(widths)
    rng = np.random.default_rng(p)
    x = rng.uniform(-1.0, 1.0, d_in).astype(np.float32)
    w_dir = rng.standard_normal(d_in).astype(np.float32)
    alpha = np.float32(-0.37)
    # one thread
    f1, r1 = np.zeros(F, np.float32), np.zeros(H, np.float32)
    f1[:d_in] = x
    v1 = _value_forward(net, widths, d_in, f1, r1)
    g1 = np.zeros(F, np.float32)
    _value_grad(net, widths, d_in, r1, g1)
    fd1, hd1 = np.zeros(F, np.float32), np.zeros(H, np.float32)
    fd1[:d_in] = w_dir
    _tangent(net, widths, d_in, r1, fd1, hd1)
    gb1, gdb1 = np.zeros(F, np.float32), np.zeros(H, np.float32)
    _pair_reverse(net, widths, d_in, r1, hd1, gb1, gdb1, alpha)
    # the lane
    mem = {"f": np.zeros(F, np.float32), "r": np.zeros(H, np.float32),
           "g": np.zeros(F, np.float32), "fd": np.zeros(F, np.float32),
           "hd": np.zeros(H, np.float32), "gb": np.zeros(F, np.float32),
           "gdb": np.zeros(H, np.float32)}
    mem["f"][:d_in] = x
    mem["fd"][:d_in] = w_dir
    lane = _Lane(p, mem)
    vs = lane.run(_lane_value_forward, net, widths, d_in, F)
    lane.run(_lane_value_grad, net, widths, d_in, F)
    lane.run(_lane_tangent, net, widths, d_in)
    lane.run(_lane_pair_reverse, net, widths, d_in, F, alpha)

    def bits(a):
        return np.asarray(a, np.float32).view(np.int32)

    assert all(bits(v) == bits(v1) for v in vs)
    for name, want in (("f", f1), ("r", r1), ("g", g1), ("fd", fd1),
                       ("hd", hd1)):
        np.testing.assert_array_equal(bits(mem[name]), bits(want), name)
    np.testing.assert_array_equal(bits(mem["gb"][d_in:]), bits(gb1[d_in:]))
    np.testing.assert_array_equal(bits(mem["gdb"]), bits(gdb1))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_lane_model_catches_a_missing_meeting(p):
    """The transcription's memory model is not vacuous: the pair sweep with
    its first meeting dropped reads rows another thread wrote."""
    widths, d_in = (12, 10), 5
    net = _net(widths, d_in, seed=1)
    F, H = d_in + sum(widths), sum(widths)
    mem = {n: np.ones(F if n in ("gb",) else H, np.float32)
           for n in ("gb", "gdb", "r", "hd")}

    def racy(q, p, read, write, *a):
        gen = _lane_pair_reverse(q, p, read, write, *a)
        next(gen)            # the first layer's pairs, no meeting after
        yield from gen

    with pytest.raises(AssertionError, match="which thread"):
        _Lane(p, mem).run(racy, net, widths, d_in, F, np.float32(0.5))


# the tanh features' nets: the Schroedinger notebook's DenseNetTanh (15, 15,
# 15, 15) at d=10 (2 chunks of 8 outputs a layer) and a narrower one
TANH_NETS = [((15, 15, 15, 15), 10), ((6, 5), 3)]


def _tanh_sweeps(widths, d_in, net, x, w_dir, alpha):
    """The one-thread sweeps with tanh features: (V, f, r, g, fd, hd, gb,
    gdb)."""
    F, H = d_in + sum(widths), sum(widths)
    f, r = np.zeros(F, np.float32), np.zeros(H, np.float32)
    f[:d_in] = x
    v = _value_forward(net, widths, d_in, f, r, tanh=True)
    g = np.zeros(F, np.float32)
    _value_grad(net, widths, d_in, r, g, tanh=True)
    fd, hd = np.zeros(F, np.float32), np.zeros(H, np.float32)
    fd[:d_in] = w_dir
    _tangent(net, widths, d_in, r, fd, hd, tanh=True)
    gb, gdb = np.zeros(F, np.float32), np.zeros(H, np.float32)
    _pair_reverse(net, widths, d_in, r, hd, gb, gdb, alpha, f=f)
    return v, f, r, g, fd, hd, gb, gdb


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("widths,d_in", TANH_NETS)
def test_lane_tanh_sweeps_are_the_one_thread_sweeps(widths, d_in, p):
    """The lanes kernel's kTanh sweeps (the Schroedinger family's
    DenseNetTanh) split as the relu^2 ones: for each tpp, run thread by
    thread between the lane's meetings, the value, grad V, tangent and
    pair sweeps give the one-thread sweeps' values bitwise (V in every
    thread, tanh(h) and its slope, grad V, h' and (1 - f^2) h', and the
    pair's cotangents s fbar - 2 f s h' fbar', s fbar' of every hidden
    row), though the width-15 layers give 2 of 16 threads a chunk."""
    net = _net(widths, d_in, seed=len(widths) + d_in)
    F, H = d_in + sum(widths), sum(widths)
    rng = np.random.default_rng(10 + p)
    x = rng.uniform(0.0, 2.0 * np.pi, d_in).astype(np.float32)
    w_dir = rng.standard_normal(d_in).astype(np.float32)
    alpha = np.float32(0.61)
    v1, f1, r1, g1, fd1, hd1, gb1, gdb1 = _tanh_sweeps(widths, d_in, net, x,
                                                       w_dir, alpha)
    mem = {"f": np.zeros(F, np.float32), "r": np.zeros(H, np.float32),
           "g": np.zeros(F, np.float32), "fd": np.zeros(F, np.float32),
           "hd": np.zeros(H, np.float32), "gb": np.zeros(F, np.float32),
           "gdb": np.zeros(H, np.float32)}
    mem["f"][:d_in] = x
    mem["fd"][:d_in] = w_dir
    lane = _Lane(p, mem)
    vs = lane.run(_lane_value_forward, net, widths, d_in, F, True)
    lane.run(_lane_value_grad, net, widths, d_in, F, True)
    lane.run(_lane_tangent, net, widths, d_in, True)
    lane.run(_lane_pair_reverse, net, widths, d_in, F, alpha, True)

    def bits(a):
        return np.asarray(a, np.float32).view(np.int32)

    assert all(bits(v) == bits(v1) for v in vs)
    for name, want in (("f", f1), ("r", r1), ("g", g1), ("fd", fd1),
                       ("hd", hd1)):
        np.testing.assert_array_equal(bits(mem[name]), bits(want), name)
    np.testing.assert_array_equal(bits(mem["gb"][d_in:]), bits(gb1[d_in:]))
    np.testing.assert_array_equal(bits(mem["gdb"]), bits(gdb1))
    assert np.abs(gb1[d_in:]).max() > 0 and np.abs(gdb1).max() > 0


@pytest.mark.parametrize("widths,d_in", TANH_NETS)
def test_tanh_pair_sweep_is_the_directional_derivative(widths, d_in):
    """The one-thread tanh sweeps' weight gradients - per hidden layer
    hbar f^T + hbar' f'^T over its input rows and hbar, hbar' for its
    bias; alpha f + f' and alpha for the output row - are the gradients of
    alpha V(x) + D_x V(x)[w] by autograd on the plain net in float64
    (DenseNetTanh's concat-skip features), within rtol 1e-5 of each
    leaf's largest entry."""
    net = _net(widths, d_in, seed=3 + d_in)
    Ws, bs, wL, bL = net
    rng = np.random.default_rng(d_in)
    x = rng.uniform(0.0, 2.0 * np.pi, d_in).astype(np.float32)
    w_dir = rng.standard_normal(d_in).astype(np.float32)
    alpha = np.float32(-0.83)
    _, f, _, _, fd, _, gb, gdb = _tanh_sweeps(widths, d_in, net, x, w_dir,
                                              alpha)
    f64, fd64 = f.astype(np.float64), fd.astype(np.float64)
    got, n_in = [], d_in
    for l, w in enumerate(widths):
        hb = gb[n_in:n_in + w].astype(np.float64)
        hdb = gdb[n_in - d_in:n_in - d_in + w].astype(np.float64)
        got += [np.outer(f64[:n_in], hb) + np.outer(fd64[:n_in], hdb), hb]
        n_in += w
    got += [alpha * f64 + fd64, np.float64(alpha)]
    leaves = []
    for l, w in enumerate(widths):
        leaves += [torch.tensor(Ws[l][:, :w], dtype=torch.float64,
                                requires_grad=True),
                   torch.tensor(bs[l][:w], dtype=torch.float64,
                                requires_grad=True)]
    leaves += [torch.tensor(wL, dtype=torch.float64, requires_grad=True),
               torch.tensor(float(bL), dtype=torch.float64,
                            requires_grad=True)]
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)

    def value(xv):
        feats = xv
        for l in range(len(widths)):
            feats = torch.cat([feats, torch.tanh(feats @ leaves[2 * l]
                                                 + leaves[2 * l + 1])])
        return feats @ leaves[-2] + leaves[-1]

    (gx,) = torch.autograd.grad(value(xt), [xt], create_graph=True)
    S = (float(alpha) * value(xt)
         + gx @ torch.tensor(w_dir, dtype=torch.float64))
    want = torch.autograd.grad(S, leaves)
    for g, t in zip(got, want):
        t = t.numpy()
        assert np.abs(np.asarray(g) - t).max() <= 1e-5 * np.abs(t).max()


@pytest.mark.parametrize("p", [2, 4, 8])
def test_lane_model_catches_a_missing_meeting_tanh(p):
    """The memory model fails the tanh pair sweep too where its first
    meeting is dropped."""
    widths, d_in = (15, 15), 10
    net = _net(widths, d_in, seed=2)
    F, H = d_in + sum(widths), sum(widths)
    mem = {n: np.ones(F if n in ("gb", "f") else H, np.float32)
           for n in ("gb", "gdb", "r", "hd", "f")}

    def racy(q, p, read, write, *a):
        gen = _lane_pair_reverse(q, p, read, write, *a)
        next(gen)            # the first layer's pairs, no meeting after
        yield from gen

    with pytest.raises(AssertionError, match="which thread"):
        _Lane(p, mem).run(racy, net, widths, d_in, F, np.float32(0.5), True)


@pytest.mark.parametrize("family,K", [("schrodinger", 500),
                                      ("committor", 200)])
def test_new_family_launch_through_a_fake_library(monkeypatch, family, K):
    """The Schroedinger notebook's and the committor notebook's backward
    through ``fused_stopped_train_rollout`` with the CPU backward routed to
    the kernel's wrapper, no plan forced: one launch of
    pspde_stopped_rollout_bwd with the lanes kernel's ints [tile + 4,
    grid, 1, tpp, 1] (the committor's grid from the slots asked once, the
    Schroedinger's one block a tile of the square), no workspace, the rows
    sized to the grid and summed, counted on the device plan."""
    asked, launched = [], []

    class FakeLib:
        def pspde_stopped_bwd_slots(self, iargs, fargs, index, out):
            asked.append(list(iargs[N_INTS:]))
            out._obj.value = 3
            return 0

    def fake_launch(fn, who, packed, tensors, seed, dev):
        assert fn == "pspde_stopped_rollout_bwd"
        part, counts, ws = tensors[-3:]
        launched.append((packed.iargs[N_INTS:], tuple(part.shape),
                         None if ws is None else ws.numel()))
        part.fill_(1.0)
        counts.fill_(1)

    monkeypatch.setattr(_build, "library", lambda: FakeLib())
    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tk, "_reference_stopped_backward",
                        tk._stopped_backward_kernel)
    call = NEW_FAMILY_CALLS[family](K)
    lay = tk._stopped_bwd_lane_of(call.pack(backward=True))
    net = call.v_net
    lam = None if call.lam is None else call.lam.clone().requires_grad_()
    leaves = list(net.parameters()) + ([lam] if lam is not None else [])
    out = tk.fused_stopped_train_rollout(
        call.problem, net, call.X0, call.t0, call.N, call.delta_t, 3,
        lam=lam)
    before = dict(tk.fused_stopped_train_rollout.backward_launches_by_plan)
    grads = torch.autograd.grad(out.Y.sum(), leaves)
    after = tk.fused_stopped_train_rollout.backward_launches_by_plan
    n_grad = tk._stopped_layout(net, lam).n_grad
    grid = 3 if family == "committor" else -(-K // lay.tile)
    ts = lay.tile + 4
    assert asked == ([[ts, 0, 1, lay.tpp, 1]] if family == "committor"
                     else [])
    assert launched == [([ts, grid, 1, lay.tpp, 1], (grid, n_grad), None)]
    assert after["device"] == before["device"] + 1
    assert after["shared"] == before["shared"]
    assert all(torch.all(g == grid) for g in grads)


def test_launch_through_a_fake_library(monkeypatch):
    """The device plan's launch through ``fused_stopped_train_rollout(
    plan='device')`` with the CPU backward routed to the kernel's wrapper:
    the slots asked once with [tile + 4, 0, 1, tpp, 1] (the arrays in
    shared memory, no workspace), the launch's ints [tile + 4, grid, 1,
    tpp, 1] after StoppedArgs' and StoppedExt's, the rows sized to the
    grid and summed, the launch counted on the device plan; a forced
    workspace layout passes [grid x tile, grid, 1, tpp, 0] and a
    workspace of per-path rows x grid x tile floats."""
    asked, launched = [], []

    class FakeLib:
        def pspde_stopped_bwd_slots(self, iargs, fargs, index, out):
            asked.append(list(iargs[N_INTS:]))
            out._obj.value = 3
            return 0

    def fake_launch(fn, who, packed, tensors, seed, dev):
        assert fn == "pspde_stopped_rollout_bwd"
        part, counts, ws = tensors[-3:]
        launched.append((packed.iargs[N_INTS:], tuple(part.shape),
                         None if ws is None else ws.numel()))
        part.fill_(1.0)
        counts.fill_(1)

    monkeypatch.setattr(_build, "library", lambda: FakeLib())
    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tk, "_reference_stopped_backward",
                        tk._stopped_backward_kernel)
    prob = tp.ExponentialOnBallNonlinearSin(d=6, alpha=0.1, device="cpu")
    net = DenseNet(1, (6, 5), d_in=6, device="cpu")
    K = 500
    out = tk.fused_stopped_train_rollout(prob, net, torch.zeros((K, 6)),
                                         torch.zeros(K), 20, 1e-3, 3,
                                         plan="device")
    before = dict(tk.fused_stopped_train_rollout.backward_launches_by_plan)
    grads = torch.autograd.grad(out.Y.sum(), list(net.parameters()))
    after = tk.fused_stopped_train_rollout.backward_launches_by_plan
    n_grad = tk._stopped_layout(net).n_grad
    assert asked == [[12, 0, 1, 16, 1]]
    assert launched == [([12, 3, 1, 16, 1], (3, n_grad), None)]
    assert after["device"] == before["device"] + 1
    assert all(torch.all(g == 3.0) for g in grads)
    call = _elliptic_call(K, d=6, arch=(6, 5), bwd_layout=(8, 16, False,
                                                           False))
    tk._stopped_backward_rows(call, torch.zeros(K))
    per_path = 3 * (6 + 11) + 3 * 11 + 1
    assert asked[1] == [8, 0, 1, 16, 0]
    assert launched[1] == ([3 * 8, 3, 1, 16, 0], (3, n_grad),
                           per_path * 3 * 8)
