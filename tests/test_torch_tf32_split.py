"""The arithmetic of the backward kernels' weight-gradient products (CPU).

The HJB replay-backward kernel (pspde_torch/csrc/train_rollout.cu,
train_step.cuh:train_weight_grads) sums each step's weight-gradient
products [in; 1]^T Delta over a block's paths with TF32 tensor-core mma,
and the stopped one (stopped_rollout.cu:pair_tile_product) the pair
[f; f']^T [hbar; hbar'] of depth 2 tile.
TF32 keeps 10 of float32's 23 mantissa bits, so each operand x is split
into big = rna(x) and small = rna(x - big), both TF32, where rna is
cvt.rna: round to nearest, ties away from zero, on the 13 dropped bits.
The kernel accumulates big big, big small and small big in float32 (the
small small term is below float32's rounding) - the "3xTF32" product.

Here the same arithmetic is emulated in plain PyTorch: rna by integer bit
arithmetic on the float32 pattern, the TF32 products exact in float32 (11
by 11 significant bits), the sums in float32.  On operands shaped as the
bench's first layer - 102 gradient rows (t, 100 state rows, the bias) by
64 paths by 32 columns, each step's product added to a block's float32
row over 32 steps, 64 blocks summed - the 3xTF32 sum stays within 1e-6
of the largest entry against a float64 reference, and one TF32 product
per pair does not: that is why the kernel splits.  The kernel's own
products cannot run here; chip_smoke.py holds them on the card.
"""

import numpy as np
import pytest
import torch

STEPS, BLOCKS, TILE, ROWS, COLS = 32, 64, 64, 102, 32
TOL = 1e-6   # of the largest entry of the summed gradient


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half of the dropped 13 bits' range to the
    magnitude, then clear them (the sign bit is apart, so ties go away
    from zero; a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = rna(x)
    return big, rna(x - big)


def bench_operands(seed: int):
    """Per step and block: A (ROWS, TILE) = [t; tanh activations; 1] and
    Delta (TILE, COLS) cotangents of both signs, float32 from numpy."""
    rng = np.random.default_rng(seed)
    A = np.tanh(rng.standard_normal((STEPS, BLOCKS, ROWS, TILE)))
    A[:, :, 0, :] = (np.arange(STEPS) / STEPS)[:, None, None]   # the t row
    A[:, :, -1, :] = 1.0                                        # the bias
    D = 0.5 * rng.standard_normal((STEPS, BLOCKS, TILE, COLS))
    return A.astype(np.float32), D.astype(np.float32)


def stopped_operands(seed: int):
    """The stopped backward's pair (pspde_torch/csrc/stopped_rollout.cu:
    pair_tile_product) at d=50, DenseNet (30, 30): per step and block, A
    (111, 2 TILE) = [f; f'] (features relu(h)^2 with the bias row of ones
    over the paths; tangents with a bias row of zeros) and Delta (2 TILE,
    30) = [hbar; hbar'] (cotangents of h and h' of both signs), float32 from
    numpy.  Three lanes in four carry no gradient this step: their f',
    hbar and hbar' columns are zero, their features are not."""
    rng = np.random.default_rng(seed)
    shape = (STEPS, BLOCKS, 111, TILE)
    live = rng.random((STEPS, BLOCKS, 1, TILE)) < 0.25
    f = rng.random(shape) ** 2
    f[:, :, -1, :] = 1.0
    fd = 1e-2 * rng.standard_normal(shape) * live
    fd[:, :, -1, :] = 0.0
    lanes = np.swapaxes(live, 2, 3)
    hb = 1e-3 * rng.standard_normal((STEPS, BLOCKS, TILE, 30)) * lanes
    hdb = rng.standard_normal((STEPS, BLOCKS, TILE, 30)) * lanes
    A = np.concatenate([f, fd], axis=3)
    D = np.concatenate([hb, hdb], axis=2)
    return A.astype(np.float32), D.astype(np.float32)


def summed_errors(seed: int, operands=bench_operands) -> dict:
    """max |G - G_64| / max |G_64| of the 3xTF32, one-TF32 and float32
    sums, G_64 the float64 sum of the same float32 operands."""
    A, D = operands(seed)
    ref = np.einsum("sbrp,sbpc->rc", A.astype(np.float64),
                    D.astype(np.float64))
    At, Dt = torch.from_numpy(A), torch.from_numpy(D)
    a_big, a_small = split(At)
    d_big, d_small = split(Dt)
    rows = {k: torch.zeros((A.shape[1], A.shape[2], D.shape[3]))
            for k in ("3x", "1x", "32")}
    for s in range(A.shape[0]):
        # the kernel's three accumulators and their sum, then the block row
        bb, bs, sb = (a_big[s] @ d_big[s], a_big[s] @ d_small[s],
                      a_small[s] @ d_big[s])
        rows["3x"] += (sb + bs) + bb
        rows["1x"] += bb
        rows["32"] += At[s] @ Dt[s]
    scale = np.abs(ref).max()
    return {k: float(np.abs(G.sum(0).double().numpy() - ref).max() / scale)
            for k, G in rows.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_keeps_float32_accuracy_where_one_tf32_product_does_not(seed):
    """The precision argument for the split, on emulated arithmetic: the
    kernel's own products are held to it on the card (chip_smoke.py)."""
    err = summed_errors(seed)
    assert err["3x"] <= TOL, err
    # and sits with the float32 loop it replaces
    assert err["3x"] <= 2.0 * err["32"] + 1e-7, err
    assert err["1x"] > 10 * TOL, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_at_the_stopped_pair_shape(seed):
    """The same argument for the stopped backward's products: depth 2 tile
    (paths, then tangents), 111 gradient rows by 30 columns, most lanes
    without a gradient (their columns zero)."""
    err = summed_errors(seed, stopped_operands)
    assert err["3x"] <= TOL, err
    assert err["3x"] <= 2.0 * err["32"] + 1e-7, err
    assert err["1x"] > 10 * TOL, err
