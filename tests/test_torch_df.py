"""The double-float outer step: the port's plain PyTorch version
(``openmg_tpu_torch.ops.kernels``, CPU tensors) against the JAX package's
Pallas kernel in interpret mode and against float64.

``x_hi'``, ``x_lo'`` and ``r_hi`` must be equal bit for bit: both sides run
the same sequence of float32 adds and exact power-of-two scalings, which
neither framework reassociates.  The partial sums have their own layout on
each side; their totals agree to 1e-6 relative (float32 sums of n terms in
another order).
"""

import numpy as np
import pytest
import torch

from openmg_tpu.models.poisson import poisson_offsets
from openmg_tpu.ops import kernels as jkernels
from openmg_tpu_torch.ops import doublefloat as tdf
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.core.solver import _residual_norm_df_exact

from _torch_parity import to_j, to_n
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (4, 8, 128)
OFFSETS = poisson_offsets(3)
VALUES = [6.0] + [-1.0] * 6
TERMS = tuple(tdf.pow2_terms(v) for v in VALUES)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    b64 = rng.standard_normal(SHAPE)
    x64 = rng.standard_normal(SHAPE)
    e = rng.standard_normal(SHAPE).astype(np.float32) * np.float32(1e-3)
    return b64, x64, e


@pytest.fixture(scope="module")
def outputs(data):
    b64, x64, e = data
    bh, bl = tdf.df_split(b64)
    xh, xl = tdf.df_split(x64)
    ref = jkernels.df_update_residual_const_3d(
        OFFSETS, TERMS, to_j(to_n(xh)), to_j(to_n(xl)), to_j(e),
        to_j(to_n(bh)), to_j(to_n(bl)), emit_norm=True,
    )
    got = tkernels.df_update_residual_const_3d(
        OFFSETS, TERMS, xh, xl, torch.from_numpy(e), bh, bl, emit_norm=True
    )
    return got, ref


def test_terms_are_dyadic():
    assert TERMS == ((4.0, 2.0),) + ((-1.0,),) * 6


@pytest.mark.parametrize("i,name", [(0, "x_hi"), (1, "x_lo"), (2, "r_hi")])
def test_bit_equal_to_reference_kernel(outputs, i, name):
    got, ref = outputs
    assert got[i].dtype == torch.float32
    np.testing.assert_array_equal(to_n(got[i]), np.asarray(ref[i]), err_msg=name)


def test_partials_sum_to_the_reference_norm(outputs):
    got, ref = outputs
    assert got[3].ndim == 1
    want = float(np.sum(np.asarray(ref[3])[:, 0, 0], dtype=np.float64))
    have = float(torch.sum(got[3]))
    assert abs(have - want) <= 1e-6 * want, (have, want)
    exact = float(np.sum(to_n(got[2]).astype(np.float64) ** 2))
    assert abs(have - exact) <= 1e-6 * exact


def test_without_norm_returns_the_same_three(data, outputs):
    b64, x64, e = data
    bh, bl = tdf.df_split(b64)
    xh, xl = tdf.df_split(x64)
    three = tkernels.df_update_residual_const_3d(
        OFFSETS, TERMS, xh, xl, torch.from_numpy(e), bh, bl
    )
    assert len(three) == 3
    for a, b in zip(three, outputs[0]):
        assert torch.equal(a, b)


def test_against_float64(data, outputs):
    """The updated pair is x + e to double-float accuracy, and r_hi is the
    float64 residual of it rounded to float32 (one ulp of slack for the
    final rounding of the pair's hi part)."""
    b64, x64, e = data
    got = outputs[0]
    xn = tdf.df_merge((got[0], got[1]))
    np.testing.assert_allclose(xn, x64 + e.astype(np.float64), rtol=0, atol=1e-13)
    p = np.pad(xn, 1)
    ax = 6.0 * xn
    for off in OFFSETS[1:]:
        sl = tuple(slice(1 + o, 1 + o + n) for o, n in zip(off, SHAPE))
        ax = ax - p[sl]
    r64 = b64 - ax
    err = np.abs(to_n(got[2]).astype(np.float64) - r64)
    assert np.max(err) <= 2.0 ** -23 * np.max(np.abs(r64))


def test_matches_unfused_port_functions(data, outputs):
    """The separate double-float functions (df_add_f32, then the exact-terms
    residual the solver uses for a caller's x0) give the same bits."""
    b64, x64, e = data
    bh, bl = tdf.df_split(b64)
    x2 = tdf.df_add_f32(tdf.df_split(x64), torch.from_numpy(e))
    assert torch.equal(x2[0], outputs[0][0]) and torch.equal(x2[1], outputs[0][1])
    acc, rn = _residual_norm_df_exact(OFFSETS, TERMS, (bh, bl), x2)
    assert torch.equal(acc[0], outputs[0][2])
    assert abs(float(rn) ** 2 - float(torch.sum(outputs[0][3]))) <= 1e-5 * float(rn) ** 2


def test_cpu_calls_do_not_count_as_launches(data):
    b64, x64, e = data
    bh, bl = tdf.df_split(b64)
    xh, xl = tdf.df_split(x64)
    before = tkernels.LAUNCHES
    tkernels.df_update_residual_const_3d(
        OFFSETS, TERMS, xh, xl, torch.from_numpy(e), bh, bl
    )
    assert tkernels.LAUNCHES == before


@pytest.mark.parametrize("shape,want", [
    ((256, 256, 256), 8 * 16 * 8),     # 128 tiles of 16 x 32, 8 chunks of 32 planes
    ((1, 4096, 4096), 128 * 256),      # the 2D lift: one plane, a block a tile
    ((20, 36, 72), 3 * 3 * 20),        # few tiles: a block a plane
    ((4, 8, 128), 4 * 1 * 4),
    ((7, 17, 33), 2 * 2 * 7),
])
def test_partial_count_follows_the_tiling(shape, want):
    assert tkernels.df_num_partials(*shape) == want


def test_kernel_wrapper_refuses_before_launching(data):
    """The K2 wrapper's checks run before the kernel is built or launched."""
    b64, x64, e = data
    bh, bl = tdf.df_split(b64)
    xh, xl = tdf.df_split(x64)
    et = torch.from_numpy(e)
    call = tkernels._df_update_residual_cuda
    with pytest.raises(ValueError, match="3D"):
        call(OFFSETS, TERMS, xh[0], xl[0], et[0], bh[0], bl[0], False)
    with pytest.raises(ValueError, match="float32"):
        call(OFFSETS, TERMS, xh.double(), xl, et, bh, bl, False)
    with pytest.raises(ValueError, match="shape"):
        call(OFFSETS, TERMS, xh, xl, et[:, :, :-1].contiguous(), bh, bl, False)
    with pytest.raises(ValueError, match="contiguous"):
        call(OFFSETS, TERMS, xh, xl.transpose(1, 2).contiguous().transpose(1, 2),
             et, bh, bl, False)
    with pytest.raises(ValueError, match="radius-1"):
        call(OFFSETS[:-1] + ((0, 0, 2),), TERMS, xh, xl, et, bh, bl, False)
    with pytest.raises(ValueError, match="terms"):
        call(OFFSETS, TERMS[:-1] + ((1.0, 0.5, 0.25, 0.125),), xh, xl, et, bh, bl, False)
