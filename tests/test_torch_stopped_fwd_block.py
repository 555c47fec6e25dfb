"""The stopped forward for nets that no block stages: the block kernel (CPU).

The block kernel (pspde_torch/csrc/stopped_rollout.cu:
stopped_fwd_block_kernel) carries a tile of T paths a block, which step
together; each layer of the value sweep and of grad V is one
block-cooperative product over the tile's paths, its weights (W_l, and the
wrapper's W_l^T for grad V) streamed through a ring of shared-memory
buffers by cp.async, each (path, output) sum one thread's fmaf chain in the
one-thread order.  The kernel cannot run here.  These tests hold the
wrapper's side (the chooser: the Allen-Cahn notebook's net takes the block
kernel, the staged cells keep the lanes kernel; the byte formula against
the .cu's; the ints, the transposed net and the counts passed to the
library; the raise outside the kernel's families) and the split itself,
transcribed in numpy float32 thread by thread (the passes, the slices, the
ring with its copy groups, the register tiles, the barriers): every layout
gives the one-thread value_forward and value_grad bitwise, and no thread
reads a row another thread wrote, or a ring buffer whose copy has not
landed, before the block meets.  On the card chip_smoke.py holds the kernel
against the plain version (phase 30) and bitwise against the lanes kernel
forced on the same inputs (phases 30-31).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import kernels as tk

CU = Path(tk.__file__).resolve().parents[1] / "csrc" / "stopped_rollout.cu"
N_INTS = 16 + 4 * tk._MAX_HIDDEN + 6 + 4   # StoppedArgs', StoppedExt's
CHUNK = 8                                 # csrc kChunk
NOTEBOOK = (110, 110, 50)                 # experiments/allen_cahn.py's net

_spec = importlib.util.spec_from_file_location(
    "fwd_layout_tests",
    Path(__file__).resolve().parent / "test_torch_stopped_forward_layout.py")
fwd_layout_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fwd_layout_tests)


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


def _cu_int(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def _cu_function(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


# -- the chooser ----------------------------------------------------------------


@pytest.mark.parametrize("K,layout,grid", [(200, (2, 128, 16, 3), 100),
                                           (8192, (32, 256, 16, 3), 256),
                                           (65536, (16, 128, 8, 2), 4096)])
def test_notebook_net_takes_the_block_kernel(K, layout, grid):
    """The notebook's net (d=100, [x, t]; 53,576 packed floats, staged in no
    block beside any lanes' arrays) takes the block kernel at the
    notebook's K=200, chip_smoke.py's check K=8192 and the timing K=65536,
    at the layout the sweep found fastest (tile, threads, slice rows of its
    widest matrix W_2^T, 321 input rows padded to 328, ring buffers), one
    block a tile, the net from device memory (stage 0)."""
    packed = _allen_cahn_call(K).pack(backward=False)
    lay = tk._stopped_fwd_block_of(packed)
    tile, threads, rows, stages = layout
    assert lay == tk._FwdBlockLayout(*layout)
    assert packed.iargs[5:8] == [tile, 0, 53576]
    assert tk._stopped_fwd_grid(packed, torch.device("cpu")) == grid
    assert tk._stopped_fwd_block_ints(packed, grid) == [threads, rows * 328,
                                                        stages, grid]
    # F + H + d_in + d = 371 + 270 + 101 + 100 rows a path
    # and wL's 371 floats (372)
    assert tk._stopped_fwd_smem_bytes(packed) == 4 * (
        -(-2 * tile // 4) * 4 + 372 + -(-842 * tile // 4) * 4
        + stages * rows * 328)
    assert tk._stopped_fwd_smem_bytes(packed) <= tk._SMEM_LIMIT
    # the lanes kernel where it is forced: as the parent chose it
    lanes = _allen_cahn_call(K, fwd_kernel="lanes").pack(backward=False)
    assert isinstance(lanes.layout, tk._FwdLayout) and lanes.iargs[6] == 0


@pytest.mark.parametrize("shape", list(fwd_layout_tests.ROW4))
def test_staged_cells_keep_the_lanes_kernel(shape):
    """Every cell of PERF.md row 4 (nets that a block stages) keeps the
    lanes kernel at the layout it had; forced, the block kernel takes the
    same call."""
    (kind, K, arch, d), want = fwd_layout_tests.ROW4[shape]
    call = fwd_layout_tests._cell(kind, K, arch, d)
    packed = call.pack(backward=False)
    assert isinstance(packed.layout, tk._FwdLayout)
    lay = tk._FwdLayout(*packed.layout)
    assert (lay.tile, lay.tpp, lay.refill, bool(packed.iargs[6])) == want[:4]
    block = call._replace(fwd_kernel="block").pack(backward=False)
    assert tk._stopped_fwd_block_of(block) is not None
    assert block.iargs[6] == 0


def test_forced_layouts_and_the_raises():
    """A forced block layout is taken as given; one the kernel does not
    take (a tile off the list, threads off 32..256 or not a multiple of 32,
    stages other than 2 or 3, no rows, a block past one block's shared
    memory) raises; so do a forced kernel of another name and the block
    kernel outside its families (the two spheres, a dense sigma, the
    committor's reference, the Schroedinger family), naming ROADMAP.md."""
    call = _allen_cahn_call(200)
    for lay in ((2, 64, 4, 2), (32, 256, 16, 3), (1, 32, 1, 2)):
        packed = call._replace(fwd_block=lay).pack(backward=False)
        assert tuple(tk._stopped_fwd_block_of(packed)) == lay
        assert packed.iargs[5] == lay[0]
    for bad in ((64, 256, 8, 3), (3, 64, 8, 3), (4, 48, 8, 3),
                (4, 512, 8, 3), (4, 128, 8, 4), (4, 128, 0, 3),
                (32, 256, 64, 3)):
        with pytest.raises(ValueError, match="block forward layout"):
            call._replace(fwd_block=bad).pack(backward=False)
    with pytest.raises(ValueError, match="fwd_kernel"):
        call._replace(fwd_kernel="lane").pack(backward=False)
    com = tp.Committor(d=10, device="cpu")
    cnet = DenseNet(1, (30, 30), d_in=10, device="cpu")
    ccall = tk._StoppedCall(
        com, cnet, torch.zeros((64, 10)), torch.zeros(64), 5, 1e-3, 0,
        tk._check_stopped_family(com, cnet, "erfinv"),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None)
    assert isinstance(ccall.pack(backward=False).layout, tk._FwdLayout)
    for forced in (dict(fwd_kernel="block"), dict(fwd_block=(4, 64, 8, 3))):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            ccall._replace(**forced).pack(backward=False)
    sch = tp.SchrodingerEigen(d=4, device="cpu")
    from pspde_torch.ansatz import DenseNetTanh
    snet = DenseNetTanh(1, (8, 8), d_in=4, output_relu=True, device="cpu")
    lam = torch.full((1,), -2.0)
    scall = tk._StoppedCall(
        sch, snet, torch.zeros((64, 4)), torch.zeros(64), 5, 1e-3, 0,
        tk._check_stopped_family(sch, snet, "erfinv", lam=lam),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None,
        lam, fwd_kernel="block")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        scall.pack(backward=False)


def test_block_bytes_against_the_cu():
    """The wrapper's shared bytes follow the .cu's block_smem_floats (the
    flags, wL, the tile's rows, the ring; each part rounded up to 4
    floats),
    its constants and the launch limits of unpack_block_layout; at every
    layout the chooser may take for the notebook's net the block fits."""
    src = CU.read_text()
    assert _cu_int(src, "kBlockThreads") == tk._STOPPED_BLOCK_THREADS
    assert _cu_int(src, "kBlockMaxTile") == max(tk._STOPPED_BLOCK_TILES)
    body = _cu_function(src, "size_t block_smem_floats(")
    assert "const size_t rows = a.F + (a.F - d_in) + d_in + a.d;" in body
    assert ("return (2 * T + 3) / 4 * 4 + (a.F + 3) / 4 * 4 + "
            "(rows * T + 3) / 4 * 4 +\n"
            "         static_cast<size_t>(lay.stages) * lay.cap;" in body)
    unpack = _cu_function(src, "bool unpack_block_layout(")
    for cond in ("t > kBlockMaxTile", "nt > kBlockThreads", "nt % 32 != 0",
                 "a.stage != 0", "lay->stages != 2 && lay->stages != 3",
                 "lay->cap % 4 != 0", "*grid != (a.K + t - 1) / t"):
        assert cond in unpack
    # the notebook's net: F 371, H 270, d_in 101, d 100, widest row 328
    assert tk._stopped_block_cols(list(NOTEBOOK), 101) == 328
    for tile in tk._STOPPED_BLOCK_TILES:
        lay = tk._FwdBlockLayout(tile, 256, 8, 3)
        floats = (-(-2 * tile // 4) * 4 + 372
                  + -(-842 * tile // 4) * 4 + 3 * 8 * 328)
        assert tk._stopped_fwd_block_bytes(list(NOTEBOOK), 101, 100, lay,
                                           328) == 4 * floats
        assert 4 * floats <= tk._SMEM_LIMIT
    assert 4 * (2 * 32 + 372 + 842 * 32 + 3 * 8 * 328) == 141_008


# -- the split, transcribed ------------------------------------------------------


def _fma(a, b, c):
    """fmaf of float32s: the exact product and sum in float64, rounded."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


class _Block:
    """NT threads of one block over named float32 arrays in shared memory
    and a ring of `stages` buffers of `cap` floats.  Each thread runs a
    generator that yields where the block meets (__syncthreads); between
    two meetings a thread reads the arrays as they were at the last
    meeting, or as it wrote them itself, and may not read nor write an
    element that another thread wrote since.  A ring element is written by
    a thread's copy (cp.async) and lands when that thread waits for the
    copy's group; another thread may read it only after a meeting that
    follows the landing, and no copy may write an element that a thread
    read since the last meeting.  The transcription fails where the kernel
    would race, and where the threads meet unevenly."""

    def __init__(self, nt, mem, cap, stages):
        self.nt, self.mem = nt, mem
        self.ring = np.zeros(stages * cap, np.float32)
        self.cap, self.stages = cap, stages
        self.epoch = 0
        self.landed = {}     # ring element -> (writer, epoch it landed)
        self.pending = [[] for _ in range(nt)]   # groups of (element, value)
        self.open = [[] for _ in range(nt)]
        self.ring_reads = {}    # ring element -> readers this epoch
        self.meetings = 0

    def thread(self, tid, writes):
        blk = self

        class Th:
            def read(self, name, i):
                key = (name, i)
                if key in writes[tid]:
                    return writes[tid][key]
                for o in range(blk.nt):
                    assert o == tid or key not in writes[o], (
                        f"thread {tid} reads {key}, which thread {o} wrote "
                        "before the block met")
                return blk.mem[name][i]

            def write(self, name, i, v):
                for o in range(blk.nt):
                    assert o == tid or (name, i) not in writes[o], (
                        f"threads {tid} and {o} both write {(name, i)}")
                writes[tid][(name, i)] = np.float32(v)

            def copy(self, e, v):   # cp.async of one ring element
                readers = blk.ring_reads.get(e, set())
                assert not readers - {tid}, (
                    f"thread {tid} copies into ring element {e}, which "
                    f"{readers} read before the block met")
                blk.landed.pop(e, None)
                blk.open[tid].append((e, np.float32(v)))

            def commit(self):
                blk.pending[tid].append(blk.open[tid])
                blk.open[tid] = []

            def wait(self, n):   # cp.async.wait_group n
                groups = blk.pending[tid]
                done = groups[:max(len(groups) - n, 0)]
                blk.pending[tid] = groups[len(done):]
                for g in done:
                    for e, v in g:
                        blk.ring[e] = v
                        blk.landed[e] = (tid, blk.epoch)

            def ring_read(self, e):
                assert e in blk.landed, (
                    f"thread {tid} reads ring element {e}, whose copy has "
                    "not landed")
                writer, at = blk.landed[e]
                assert writer == tid or at < blk.epoch, (
                    f"thread {tid} reads ring element {e}, which thread "
                    f"{writer}'s copy landed since the block met")
                blk.ring_reads.setdefault(e, set()).add(tid)
                return blk.ring[e]
        return Th()

    def run(self, body, *args):
        writes = [{} for _ in range(self.nt)]
        gens = [body(tid, self.nt, self.thread(tid, writes), *args)
                for tid in range(self.nt)]
        live = [True] * self.nt
        outs = [None] * self.nt
        while any(live):
            for q, g in enumerate(gens):
                try:
                    next(g)
                except StopIteration as e:
                    live[q] = False
                    outs[q] = e.value
            assert all(live) or not any(live), "the block met unevenly"
            for w in writes:
                for (name, i), v in w.items():
                    self.mem[name][i] = v
                w.clear()
            self.epoch += 1
            self.ring_reads = {}
            self.meetings += 1
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


def _wt(Ws, widths):
    """The wrapper's W_l^T (w x padded(n_in)), as _stopped_wt packs it."""
    out = []
    for W, w in zip(Ws, widths):
        n_in = W.shape[0]
        WT = np.zeros((w, -(-n_in // CHUNK) * CHUNK), np.float32)
        WT[:, :n_in] = W[:, :w].T
        out.append(WT)
    return out


# one-thread sweeps: value_forward and value_grad, in their order

def _value_forward(net, widths, d_in, f, r):
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
                    rv = max(np.float32(acc[c] + bs[l][j]), np.float32(0))
                    r[n_in - d_in + j] = rv
                    f[n_in + j] = np.float32(rv * rv)
        n_in += w
    v = np.float32(0)
    for i in range(len(f)):
        v = _fma(f[i], wL[i], v)
    return np.float32(v + bL)


def _value_grad(net, widths, d_in, r, g):
    Ws, _, wL, _ = net
    F = len(g)
    g[:] = wL
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for j in range(w):
            g[o + j] = np.float32(np.float32(2 * r[o - d_in + j]) * g[o + j])
        for i in range(o):
            s = np.float32(0)
            for j in range(w):
                s = _fma(Ws[l][i, j], g[o + j], s)
            g[i] = np.float32(g[i] + s)


# the block's sweeps, as the kernel runs them (block_product and the
# kernel's loops): generators that yield at each __syncthreads()

def _product_pass(tid, nt, th, M, R, C, in_name, in_row0, T, cap, stages,
                  km, base, epi):
    p, slots = tid & (T - 1), nt // T
    c0, n_chunks, S = base + tid // T, C // CHUNK, cap // C
    n_slices = -(-R // S)
    flat = M.reshape(-1)

    def fill(s, r0, r1):
        for x in range(tid, (r1 - r0) * C // 4, nt):
            for e in range(4):
                th.copy(s * cap + 4 * x + e, flat[r0 * C + 4 * x + e])

    acc = [[np.float32(0)] * CHUNK for _ in range(km)]
    for s in range(stages - 1):
        if s < n_slices:
            fill(s, s * S, min(R, (s + 1) * S))
        th.commit()
    for k in range(n_slices):
        th.wait(stages - 2)
        yield
        nx = k + stages - 1
        if nx < n_slices:
            fill(nx % stages, nx * S, min(R, (nx + 1) * S))
        th.commit()
        buf = (k % stages) * cap
        i0 = k * S
        for r in range(min(S, R - i0)):
            a = th.read(in_name, (in_row0 + i0 + r) * T + p)
            for m in range(km):
                c = c0 + m * slots
                if c < n_chunks:
                    for cc in range(CHUNK):
                        wv = th.ring_read(buf + r * C + c * CHUNK + cc)
                        acc[m][cc] = _fma(a, wv, acc[m][cc])
    yield
    for m in range(km):
        c = c0 + m * slots
        if c < n_chunks:
            epi(p, c * CHUNK, acc[m])


def _block_product(tid, nt, th, M, R, C, in_name, in_row0, T, cap, stages,
                   tiles, epi):
    slots, n_chunks = nt // T, C // CHUNK
    for base in range(0, n_chunks, tiles * slots):
        m = -(-(n_chunks - base) // slots)
        km = next((k for k in _DISPATCH[:-1] if m <= k), tiles)
        yield from _product_pass(tid, nt, th, M, R, C, in_name, in_row0, T,
                                 cap, stages, km, base, epi)
    yield


def _block_sweeps(tid, nt, th, net, WTs, widths, d_in, F, T, cap, stages,
                  tiles):
    """The value sweep, V in thread p < T, grad V: as the kernel's step."""
    Ws, bs, wL, bL = net
    n_in = d_in
    for l, w in enumerate(widths):
        wp = Ws[l].shape[1]

        def epi(q, j0, acc, l=l, w=w, n_in=n_in):
            for c in range(CHUNK):
                j = j0 + c
                if j < w:
                    rv = max(np.float32(acc[c] + bs[l][j]), np.float32(0))
                    th.write("r", (n_in - d_in + j) * T + q, rv)
                    th.write("f", (n_in + j) * T + q, np.float32(rv * rv))
        yield from _block_product(tid, nt, th, Ws[l], n_in, wp, "f", 0, T,
                                  cap, stages, tiles, epi)
        n_in += w
    v = None
    if tid < T:
        v = np.float32(0)
        for i in range(F):
            v = _fma(th.read("f", i * T + tid), wL[i], v)
        v = np.float32(v + bL)
    yield   # __syncthreads_or(adv && on) before grad V

    def grow(i):
        return ("gin", i * T) if i < d_in else ("f", i * T)

    for x in range(tid, F * T, nt):
        i = x // T
        name, base = grow(i)
        th.write(name, base + x - i * T, wL[i])
    yield
    o = F
    for l in range(len(widths) - 1, -1, -1):
        w = widths[l]
        o -= w
        for x in range(tid, w * T, nt):
            rv = th.read("r", (o - d_in) * T + x)
            gv = th.read("f", o * T + x)
            th.write("f", o * T + x, np.float32(np.float32(2 * rv) * gv))
        yield

        def epi(q, i0, acc, o=o):
            for c in range(CHUNK):
                i = i0 + c
                if i < o:
                    name, base = grow(i)
                    th.write(name, base + q, np.float32(
                        th.read(name, base + q) + acc[c]))
        yield from _block_product(tid, nt, th, WTs[l], w, WTs[l].shape[1],
                                  "f", o, T, cap, stages, tiles, epi)
    return v


def _tiles():
    return _cu_int(CU.read_text(), "kBlockTiles")


# the tile counts a pass of block_product dispatches to, the last
# kBlockTiles (parsed from the .cu)
_DISPATCH = [int(v) if v.isdigit() else v for v in re.findall(
    r"product_pass<(\w+)>\(", CU.read_text())]


SPLIT_NETS = [((12, 10), 5), ((9, 17, 6), 7), ((30, 26), 25)]
# (tile, threads, slice rows of the widest matrix, ring buffers)
SPLIT_LAYOUTS = [(1, 2, 1, 2), (2, 4, 2, 3), (4, 4, 1, 3), (2, 8, 5, 2),
                 (4, 16, 3, 3)]


@pytest.mark.parametrize("layout", SPLIT_LAYOUTS)
@pytest.mark.parametrize("widths,d_in", SPLIT_NETS)
def test_block_sweeps_are_the_one_thread_sweeps(widths, d_in, layout):
    """For each tile, thread count, slice depth and ring the block's value
    sweep, V and grad V, run thread by thread between the block's meetings
    (a read of a row another thread wrote since the last meeting, of a ring
    element whose copy has not landed or landed since, a copy over an
    element read since, or an uneven meeting fails), give each path's
    one-thread sweeps bitwise: the features and relu rows, V, and grad V's
    rows (the input rows in their own rows, the hidden rows in the
    features' rows).  Where the threads equal the tile (one chunk slot)
    the (30, 26) net needs two passes of kBlockTiles chunks over W_1^T's
    7."""
    T, nt, rows, stages = layout
    tiles = _tiles()
    net = _net(widths, d_in, seed=len(widths) + d_in)
    WTs = _wt(net[0], widths)
    F, H = d_in + sum(widths), sum(widths)
    cols = max([W.shape[1] for W in net[0]] + [W.shape[1] for W in WTs])
    cap = rows * cols
    rng = np.random.default_rng(T * 100 + nt)
    X = rng.uniform(-1.0, 1.0, (T, d_in)).astype(np.float32)
    mem = {"f": np.zeros(F * T, np.float32), "r": np.zeros(H * T, np.float32),
           "gin": np.zeros(d_in * T, np.float32)}
    for q in range(T):
        mem["f"][q:d_in * T:T] = X[q]
    blk = _Block(nt, mem, cap, stages)
    outs = blk.run(_block_sweeps, net, WTs, widths, d_in, F, T, cap, stages,
                   tiles)

    def bits(a):
        return np.asarray(a, np.float32).view(np.int32)

    for q in range(T):
        f1, r1 = np.zeros(F, np.float32), np.zeros(H, np.float32)
        f1[:d_in] = X[q]
        v1 = _value_forward(net, widths, d_in, f1, r1)
        g1 = np.zeros(F, np.float32)
        _value_grad(net, widths, d_in, r1, g1)
        assert bits(outs[q]) == bits(v1)
        np.testing.assert_array_equal(bits(mem["r"][q::T]), bits(r1))
        np.testing.assert_array_equal(bits(mem["gin"][q::T]),
                                      bits(g1[:d_in]))
        # the features' rows: X, then grad V's hidden rows over them
        np.testing.assert_array_equal(bits(mem["f"][q::T][:d_in]),
                                      bits(X[q]))
        np.testing.assert_array_equal(bits(mem["f"][q::T][d_in:]),
                                      bits(g1[d_in:]))
    assert blk.meetings > 2 * len(widths)


def test_pass_dispatch_of_the_cu():
    """block_product runs each pass at the fewest tiles of 1, 2 and
    kBlockTiles that cover the pass's chunks (the model above takes the
    same list from the .cu)."""
    assert _DISPATCH == [1, 2, "kBlockTiles"]
    assert _tiles() > 2


def test_block_model_catches_a_missing_meeting():
    """The transcription's memory model is not vacuous: the product without
    the meeting after its copies land reads ring elements whose copies
    other threads made, and one whose pass loop ends at each thread's own
    chunks meets unevenly."""
    widths, d_in = (12, 10), 5
    net = _net(widths, d_in, seed=1)
    F, H, T, nt = d_in + sum(widths), sum(widths), 2, 8
    cap, stages = 16, 2

    def racy(tid, nt_, th, *a):
        gen = _block_product(tid, nt_, th, net[0][0], d_in, 16, "f", 0, T,
                             cap, stages, _tiles(), lambda *x: None)
        next(gen)            # the first slice's meeting
        for _ in gen:        # every later meeting dropped
            pass
        yield

    mem = {"f": np.ones(F * T, np.float32), "r": np.zeros(H * T, np.float32),
           "gin": np.zeros(d_in * T, np.float32)}
    with pytest.raises(AssertionError, match="ring element"):
        _Block(nt, mem, cap, stages).run(racy)

    def own_passes(tid, nt_, th):
        # the pass loop bounded by the thread's own chunks (c0 < n_chunks)
        slot, slots = tid // T, nt_ // T
        for _ in range(slot, 5, 1 * slots):
            yield

    with pytest.raises(AssertionError, match="unevenly"):
        _Block(nt, mem, cap, stages).run(own_passes)


# -- the launch ----------------------------------------------------------------


def test_launch_through_a_fake_library(monkeypatch):
    """The block kernel's launch: the ints [threads, cap, stages, grid]
    after StoppedArgs' and StoppedExt's, one block per tile, the transposed
    net (each W_l^T padded to 8 columns) after the packed net, a zeroed
    queue of 1 + grid x tile ints whose tail comes back as each path's
    trips; the launch counted once, on the block kernel; the lanes kernel
    forced on the same call goes through its own entry with [tpp, grid]."""
    launched = []

    def fake_launch(fn, who, packed, tensors, seed, dev):
        launched.append((fn, packed.iargs[N_INTS:], tensors))
        X, acc, queue = tensors[-3:]
        assert queue.dtype == torch.int32 and int(queue.abs().sum()) == 0
        X.fill_(1.0)
        acc.fill_(2.0)
        queue[1:] = torch.arange(1, queue.numel(), dtype=torch.int32)

    monkeypatch.setattr(tk, "_launch", fake_launch)
    monkeypatch.setattr(tk, "_STOPPED_FWD_OCC", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    K = 100
    call = _allen_cahn_call(K, arch=(12, 10), d=6)
    before = dict(tk.fused_stopped_train_rollout.launches_by_kernel)
    n0 = tk.fused_stopped_train_rollout.launches
    c = call._replace(fwd_block=(4, 64, 2, 3))
    out, trips = tk._stopped_forward_launch(c)
    fn, ints, tensors = launched[0]
    cols = tk._stopped_block_cols([12, 10], 7)
    assert fn == "pspde_stopped_rollout_fwd_block"
    assert cols == 24 and ints == [64, 2 * 24, 3, 25]
    assert len(tensors) == 8 and tensors[2] is None
    WT = tensors[1]
    net = call.v_net
    W0, W1 = net.layers[0].weight.detach(), net.layers[1].weight.detach()
    want = torch.cat([torch.nn.functional.pad(W0, (0, 1)).reshape(-1),
                      torch.nn.functional.pad(W1, (0, 5)).reshape(-1)])
    assert torch.equal(WT, want)
    assert tensors[-1].numel() == 1 + 25 * 4
    assert out.X.shape == (K, 6) and float(out.Y.sum()) == 2.0 * K
    assert tuple(trips.shape) == (25, 4) and int(trips[-1, -1]) == 100
    after = tk.fused_stopped_train_rollout.launches_by_kernel
    assert tk.fused_stopped_train_rollout.launches == n0 + 1
    assert after["block"] == before["block"] + 1
    assert after["lanes"] == before["lanes"]
    tk._stopped_forward_launch(call._replace(fwd_kernel="lanes"))
    fn, ints, tensors = launched[1]
    lay = tk._FwdLayout(*call._replace(fwd_kernel="lanes").pack(False).layout)
    assert fn == "pspde_stopped_rollout_fwd" and len(tensors) == 7
    assert ints == [lay.tpp, -(-K // lay.tile)]
    assert (tk.fused_stopped_train_rollout.launches_by_kernel["lanes"]
            == before["lanes"] + 1)


def test_block_kernel_counts_its_launches(monkeypatch):
    """The block kernel's launch gets the pointer of its own count word,
    ('fused_stopped_train_rollout', 'launches', 'block'), which
    kernel_launch_counts reads back under the forward's total and its
    '_by_kernel' key; the lanes kernel's goes to its own word."""
    monkeypatch.setattr(tk, "_COUNT_WORDS", {})
    dev = torch.device("cpu")
    packed = _allen_cahn_call(8).pack(backward=False)
    for fn, n in (("pspde_stopped_rollout_fwd_block", 2),
                  ("pspde_stopped_rollout_fwd", 1)):
        for _ in range(n):
            ptr = tk._count_word(fn, packed, dev)
            words = tk._COUNT_WORDS[dev]
            words[(ptr - words.data_ptr()) // 8] += 1
    got = tk.kernel_launch_counts()
    assert got[("fused_stopped_train_rollout", "launches")] == 3
    assert got[("fused_stopped_train_rollout", "launches_by_kernel",
                "block")] == 2
    assert got[("fused_stopped_train_rollout", "launches_by_kernel",
                "lanes")] == 1
    tk.reset_launch_counts()
    assert not any(tk.kernel_launch_counts().values())
