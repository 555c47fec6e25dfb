"""The HJB training forward's net products on the tensor cores (CPU).

The forward kernel (pspde_torch/csrc/train_rollout.cu) and the backward's
replay compute each step's TanhMLP layers as block-cooperative TF32
tensor-core products (train_step.cuh:net_tile_product): for layer l over a
block's paths, M = the paths, N = the layer's padded output columns, K = its
padded input rows, each operand split into big = rna(x) and small =
rna(x - big) (3xTF32), three float32 accumulators per output (big big from
the initial value init = fmaf(t, W_0 row 0, b_0) for layer 0 and b_l after
it, big small and small big), k blocks of 8 rows added in order, summed
as (sb + bs) + bb, then tanh for the hidden layers.

Here that arithmetic is emulated in numpy: rna by integer bit arithmetic,
each block of 8 products exact and summed in float64, then added to its
float32 accumulator (the shim the kernels were rehearsed on does the
same).  At the bench net [101 -> 30 -> 30 -> 100] (the exported control)
and at config 5's layer 0 (t and 1000 state rows into 32 columns) the
3xTF32 product stays within 1e-6 of each layer's largest float64 entry on
the same float32 operands, and one TF32 product per pair does not; the
emulated net's Z agrees with pspde's TanhMLP (Flax, float32 on the CPU).
The index arithmetic of the staged fragments (train_stage_net, NetFragB)
and of the row-major reader (NetRowB) is transcribed and held to give the
same B fragments, and the wrapper's launch shapes to fit the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
import pspde_torch.problems as tp
from pspde_torch.ansatz import TanhMLP
from pspde_torch.rollout import kernels as tk
from pspde_torch.utils.convert import tanh_mlp_from_flax

ASSET = os.path.join(os.path.dirname(__file__), "..", "pspde_torch",
                     "assets", "llgc_d100_tanhmlp.npz")
TOL = 1e-6   # of each layer's largest float64 entry
PATHS = 256  # four blocks of the forward's 64 paths


def rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 x (train_step.cuh / common.cuh:
    tf32_rna)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    big = rna(x)
    return big, rna((x - big).astype(np.float32))


def kernel_product(A, B, init, mode="3x"):
    """init + A @ B as net_tile_product sums it: A (paths, K), B (K, cols),
    K a multiple of 8; mode '3x' (the kernel) or '1x' (one TF32 product
    per pair)."""
    a_big, a_small = split(A)
    b_big, b_small = split(B)
    bb = np.broadcast_to(init.astype(np.float32), (A.shape[0], B.shape[1]))
    bb = bb.copy()
    bs = np.zeros_like(bb)
    sb = np.zeros_like(bb)
    for k0 in range(0, A.shape[1], 8):
        blk = slice(k0, k0 + 8)

        def add(acc, a, b):
            s = a[:, blk].astype(np.float64) @ b[blk].astype(np.float64)
            return (acc.astype(np.float64) + s).astype(np.float32)

        bb = add(bb, a_big, b_big)
        if mode == "3x":
            bs = add(bs, a_big, b_small)
            sb = add(sb, a_small, b_big)
    return ((sb + bs) + bb).astype(np.float32)


def _layers(net: TanhMLP, d: int):
    """Each layer's (B, t row, bias) as the kernel multiplies them: B the
    weights (in, out) padded to multiples of 8 (layer 0 without its t row,
    its k rows X's dp), the t row (layer 0) and the bias padded alike."""
    dp = -(-d // 8) * 8
    out = []
    for l, lin in enumerate(net.layers):
        W = lin.weight.detach().numpy().T.astype(np.float32)
        b = lin.bias.detach().numpy().astype(np.float32)
        cols = -(-W.shape[1] // 8) * 8
        t_row = None
        if l == 0:
            t_row, W = W[0], W[1:]
        k_rows = dp if l == 0 else -(-W.shape[0] // 8) * 8
        B = np.zeros((k_rows, cols), np.float32)
        B[:W.shape[0], :W.shape[1]] = W
        bp = np.zeros(cols, np.float32)
        bp[:b.shape[0]] = b
        tp_ = None
        if t_row is not None:
            tp_ = np.zeros(cols, np.float32)
            tp_[:t_row.shape[0]] = t_row
        out.append((B, tp_, bp))
    return out


def emulated_net(net: TanhMLP, t: float, X: np.ndarray, mode="3x"):
    """Z of the kernel's train_net on X (paths, d): each layer's product,
    its float64 reference on the same float32 operands, and Z."""
    d = X.shape[1]
    layers = _layers(net, d)
    A = np.zeros((X.shape[0], layers[0][0].shape[0]), np.float32)
    A[:, :d] = X
    errs = []
    for l, (B, t_row, bias) in enumerate(layers):
        init = (bias if t_row is None else
                (np.float32(t) * t_row + bias).astype(np.float32))
        pre = kernel_product(A, B, init, mode)
        ref = (init.astype(np.float64)
               + A.astype(np.float64) @ B.astype(np.float64))
        errs.append(float(np.abs(pre - ref).max() / np.abs(ref).max()))
        A = np.tanh(pre).astype(np.float32) if l + 1 < len(layers) else pre
    return A[:, :d], errs


def _bench_net():
    z = np.load(ASSET)
    tree = {"params": {f"Dense_{i}": {
        "kernel": z[f"z/params/Dense_{i}/kernel"],
        "bias": z[f"z/params/Dense_{i}/bias"]} for i in range(3)}}
    return tree, tanh_mlp_from_flax(tree, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_net_keeps_float32_accuracy_at_the_bench_net(seed):
    """Per layer of [101 -> 30 -> 30 -> 100] (the exported control), over
    256 paths of LLGC-sized states at a step's t: the 3xTF32 product within
    1e-6 of the layer's largest entry, one TF32 product not within 1e-5;
    the emulated Z within 1e-5 of pspde's TanhMLP on the same inputs."""
    tree, net = _bench_net()
    rng = np.random.default_rng(seed)
    X = (0.7 * rng.standard_normal((PATHS, 100))).astype(np.float32)
    t = float(np.float32(rng.integers(32) / 32))
    Z3, e3 = emulated_net(net, t, X, "3x")
    _, e1 = emulated_net(net, t, X, "1x")
    assert max(e3) <= TOL, e3
    assert min(e1) > 10 * TOL, e1
    tX = np.concatenate([np.full((PATHS, 1), t, np.float32), X], axis=1)
    zj = np.asarray(ja.TanhMLP(d_out=100).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tX)))
    assert np.abs(Z3 - zj).max() <= 1e-5 * (1.0 + np.abs(zj).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_at_config5_layer0(seed):
    """Config 5's first layer (TanhMLP [1001 -> 30 ...], init_scale 0.1):
    t into the accumulators' initial value and 1000 state rows in 125 k
    blocks: the 3xTF32 product within 1e-6 of the largest entry, one TF32
    product not within 1e-5."""
    rng = np.random.default_rng(10 + seed)
    W = (0.1 * rng.standard_normal((1001, 30))).astype(np.float32)
    b = (0.1 * rng.standard_normal(30)).astype(np.float32)
    X = rng.standard_normal((PATHS, 1000)).astype(np.float32)
    t = np.float32(0.37)
    B = np.zeros((1000, 32), np.float32)
    B[:, :30] = W[1:]
    init = np.zeros(32, np.float32)
    init[:30] = (t * W[0] + b).astype(np.float32)
    ref = init.astype(np.float64) + X.astype(np.float64) @ B.astype(
        np.float64)
    scale = np.abs(ref).max()
    e3 = np.abs(kernel_product(X, B, init, "3x") - ref).max() / scale
    e1 = np.abs(kernel_product(X, B, init, "1x") - ref).max() / scale
    assert e3 <= TOL, e3
    assert e1 > 10 * TOL, e1


def _staged_fragments(W, r0, rows, k_rows, cols):
    """train_stage_net's fragment section of one layer, transcribed: entry
    e = ((kb * cols / 8 + nt) * 32 + lane) * 2 + h holds W[8 kb + c + 4 h +
    r0][8 nt + g] (lane = 4 g + c), 0 past the layer's rows."""
    nt_count = cols // 8
    out = np.zeros(k_rows * cols, np.float32)
    flat = W.reshape(-1)
    for e in range(k_rows * cols):
        h, lane, blk = e & 1, (e >> 1) & 31, e >> 6
        kb, nt = divmod(blk, nt_count)
        row = 8 * kb + (lane & 3) + 4 * h + r0
        out[e] = flat[row * cols + 8 * nt + (lane >> 2)] if row < rows else 0
    return out


@pytest.mark.parametrize("d", [6, 100])
def test_both_b_readers_give_the_mma_fragments(d):
    """Lane 4g + c of the fragment (kb, nt) must hold (B[8kb + c][8nt + g],
    B[8kb + c + 4][8nt + g]): from the staged fragments (NetFragB, the
    forward's shared plan) and from the row-major net (NetRowB, the
    backward and the device plan; rows past the layer's k_valid read 0)
    alike, for every layer of the packed buffer."""
    pt = tp.LLGC(d=d, T=1.0, device="cpu")
    net = TanhMLP(d + 1, d, hidden=(30, 37),
                  generator=torch.Generator().manual_seed(0), device="cpu")
    fam = tk._check_train_family(pt, net, 4, 1.0, None, "binom")
    packed = tk._pack_train(
        pt, net, *fam, 256, 4, 0.25, None, backward=False, host_noise=None,
        noise_sign=1.0, adaptive_forward=True, accumulate_kl=False,
        kl_ito_term=False, u_tab=None, rng="binom")
    ia, buf = packed.iargs, packed.params.numpy()
    L, M = ia[4], tk._MAX_LAYERS
    rows, cols = ia[22:22 + L], ia[22 + M:22 + M + L]
    w_off = ia[22 + 2 * M:22 + 2 * M + L]
    dp = ia[3]
    layers = _layers(net, d)
    for l in range(L):
        W = buf[w_off[l]:w_off[l] + rows[l] * cols[l]].reshape(rows[l],
                                                               cols[l])
        r0 = 1 if l == 0 else 0
        k_rows = dp if l == 0 else rows[l]
        k_valid = d if l == 0 else k_rows
        frag = _staged_fragments(W, r0, rows[l], k_rows, cols[l]).reshape(
            k_rows // 8, cols[l] // 8, 8, 4, 2)          # kb, nt, g, c, h
        B = layers[l][0]
        for kb in range(k_rows // 8):
            for nt in range(cols[l] // 8):
                for g in range(8):
                    for c in range(4):
                        want = (B[8 * kb + c, 8 * nt + g],
                                B[8 * kb + c + 4, 8 * nt + g])
                        # NetRowB: row r0 + k while k < k_valid, else 0
                        k = 8 * kb + c
                        row_b = tuple(
                            W[r0 + kk, 8 * nt + g] if kk < k_valid else 0.0
                            for kk in (k, k + 4))
                        assert tuple(frag[kb, nt, g, c]) == want == row_b


def _pack(pt, net, K, N, backward, plan=None, tile=None, u_tab=None):
    fam = tk._check_train_family(pt, net, N, 1.0, u_tab, "binom")
    return tk._pack_train(
        pt, net, *fam, K, N, 1.0 / N, tile, backward=backward,
        host_noise=None, noise_sign=1.0, adaptive_forward=True,
        accumulate_kl=False, kl_ito_term=False, u_tab=u_tab, rng="binom",
        plan=plan)


SM_SMEM = 233_472   # bytes of shared memory of one SM (228 KB)


@pytest.mark.parametrize("case", ["bench", "config5", "bench_device",
                                  "lqgc_dense"])
def test_forward_launch_fits_both_plans(case):
    """The forward's tile, threads per path and shared memory: at d=100
    tile 64 with 4 threads a path (256 threads, 8 warps), 108,576 bytes
    (the staged net in fragment order, 7,880 floats; the per-path arrays at
    stride 68; the exchange of the sums' 4 classes), so two blocks (16
    warps) fit an SM;
    in the device plan 2 threads a path (the fastest there);
    the dense LQGC net (50, 37) at tile 64 in one block (its backward at
    tile 32); at d=1000, and
    forced at d=100, the device plan with the same block and only the
    exchange of sums in shared memory.  The backward keeps one thread a
    path."""
    d = 1000 if case == "config5" else 100
    pt = (tp.LQGC(d=d, T=1.0, off_diag=0.05, device="cpu")
          if case == "lqgc_dense" else tp.LLGC(d=d, T=1.0, device="cpu"))
    hidden = (50, 37) if case == "lqgc_dense" else (30, 30)
    net = TanhMLP(d + 1, d, hidden=hidden,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    K = 98304 if case == "config5" else 131072
    plan = "device" if case == "bench_device" else None
    fwd = _pack(pt, net, K, 32, False, plan)
    bwd = _pack(pt, net, K, 32, True, plan)
    tile, tpp = fwd.iargs[5], fwd.iargs[-3]
    device = case in ("config5", "bench_device")
    assert fwd.iargs[-4:-2] == [0, 2 if device else 4]
    assert bwd.iargs[-4:-2] == [1, 1]
    dense = case == "lqgc_dense"
    assert tile == 64 and bwd.iargs[5] == (32 if dense else 64)
    assert tk._FWD_THREADS == 256
    assert tile * tpp == (128 if device else 256)
    dp = -(-d // 8) * 8
    cols = [-(-w // 8) * 8 for w in hidden] + [dp]
    k_rows = [dp] + cols[:-1]
    net_floats = cols[0] + sum(c + k * c for k, c in zip(k_rows, cols))
    sums = 3 * 4 * tile   # three sums of each of 4 classes a path
    per_path = dp * (3 if dense else 2) + sum(cols[:-1])
    if device:
        assert tk._plan_of(fwd) == tk._plan_of(bwd) == "device"
        assert fwd.ws_floats == per_path * (-(-K // tile) * tile)
        assert 4 * sums == 3072   # the device plan's shared memory
        return
    assert tk._plan_of(fwd) == "shared"
    smem = tk._train_smem_bytes(net_floats + sums, per_path, tile)
    assert smem == 4 * (net_floats + sums + per_path * (tile + 4))
    assert smem <= tk._SMEM_LIMIT
    if case == "bench":
        assert net_floats == 7880 and smem == 108576
        assert 2 * (smem + 1024) <= SM_SMEM   # two blocks: 16 warps an SM


@pytest.mark.parametrize("plan,want", [("shared", [4, 4, 2, 2]),
                                       ("device", [2, 2, 2, 2])])
def test_forward_threads_per_path_at_each_tile(plan, want):
    """tile x threads per path never passes the kernel's 256 threads."""
    tiles = (32, 64, 96, 128)
    assert [tk._train_fwd_tpp(t, plan) for t in tiles] == want
    for t in tiles:
        assert t * tk._train_fwd_tpp(t, plan) <= tk._FWD_THREADS
