"""How the 2D level-visit kernel (K5) and the constant 3D pass (K3) cover
their grids, and their plain versions against the JAX package's array code
at the shapes ``chip_smoke.py`` checks the kernels on.

The plans are computed in Python (``kernels.fused2d_plan``,
``kernels.sweep_plan``) and checked again by the CUDA side, so the CPU can
show that every point of every level is owned by exactly one warp or block.
The plain versions (unchanged by the kernels' designs) are held against
the JAX package's jnp smoothers, residual and transfers (``use_pallas=False``):
no Pallas kernel is traced here.
"""

import numpy as np
import pytest

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.ops import smoothers as jsmoothers
from openmg_tpu.ops import stencil as jstencil
from openmg_tpu.ops.transfer import TRANSFERS as JTRANSFERS
from openmg_tpu.ops.transfer import prolong as jprolong
from openmg_tpu.ops.transfer import restrict as jrestrict
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.ops.transfer import TRANSFERS as TTRANSFERS

from _torch_parity import assert_close, port_op, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

OMEGA = 2.0 / 3.0
SMS = 132  # the H100's SMs, as the wrappers read them on the card

# the 4096² hierarchy's levels, BASELINE config 2's odd family, the 2D
# shape without transfers
PLANES = [(4096, 4096), (2048, 2048), (1024, 1024), (512, 512), (256, 256),
          (128, 128), (200, 328), (100, 164), (37, 91)]
# the 256³ hierarchy's levels, the odd shape and its coarse level, 2D lifts
GRIDS = [(256, 256, 256), (128, 128, 128), (64, 64, 64), (32, 32, 32),
         (20, 36, 72), (10, 18, 36), (1, 36, 72), (1, 1024, 1024),
         (1, 2048, 2048)]


# ---------------------------------------------------------------------------
# (a) the plans cover every point exactly once
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [5, 6, 7, 9])
@pytest.mark.parametrize("shape", PLANES, ids=lambda s: "x".join(map(str, s)))
def test_fused2d_plan_covers_every_point_once(shape, depth):
    """Depth 5: an up-leg (four stages and the prolongation); 6: a down-leg
    (four stages, the residual, the restriction); 7: six Jacobi stages and
    the residual; 9: the deepest launch with a prolongation.  Strip i owns
    columns [i·ow, (i+1)·ow), chunk j rows [j·rows, (j+1)·rows); the halo
    covers the depth and keeps a lane's four columns one aligned word."""
    ny, nx = shape
    hp, ow, rows, strips, chunks = tkernels.fused2d_plan(ny, nx, depth, SMS)
    assert hp >= depth and hp % 4 == 0 and ow == tkernels.K5_STRIP - 2 * hp
    assert rows % 2 == 0 and rows in tkernels.K5_ROWS
    owned = np.zeros(shape, dtype=np.int8)
    for j in range(chunks):
        for i in range(strips):
            owned[j * rows:(j + 1) * rows, i * ow:(i + 1) * ow] += 1
    assert (owned == 1).all()
    # every strip and chunk owns something; the coarse points of a
    # restriction (fine 2c) are owned once too
    assert (strips - 1) * ow < nx and (chunks - 1) * rows < ny
    if ny % 2 == 0 and nx % 2 == 0:
        coarse = np.zeros((ny // 2, nx // 2), dtype=np.int8)
        for j in range(chunks):
            for i in range(strips):
                coarse[j * rows // 2:(j + 1) * rows // 2,
                       i * ow // 2:(i + 1) * ow // 2] += 1
        assert (coarse == 1).all()


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: "x".join(map(str, s)))
def test_sweep_plan_covers_every_point_once(shape):
    """Tile (i, j) owns rows [8 i, 8 i + 8) and columns [128 j, 128 j + 128)
    of every plane of its chunk, chunk c the planes [c·zc, (c+1)·zc)."""
    nz, ny, nx = shape
    zc, ty, tx, chunks = tkernels.sweep_plan(nz, ny, nx, SMS)
    cy, cx = tkernels.K3_TILE
    assert 1 <= zc <= max(nz, 1) and ty == -(-ny // cy) and tx == -(-nx // cx)
    owned = np.zeros(shape, dtype=np.int8)
    for c in range(chunks):
        for i in range(ty):
            for j in range(tx):
                owned[c * zc:(c + 1) * zc, i * cy:(i + 1) * cy,
                      j * cx:(j + 1) * cx] += 1
    assert (owned == 1).all()
    assert (chunks - 1) * zc < nz


def test_plans_fill_the_card():
    """The rules on the main paths' levels: K5's chunks are the longest that
    still give 8 warps an SM (32 rows at 4096² and 2048², 8 at 1024², the
    shortest below); K3's chunks the longest that still give a block an SM
    (64 planes at 256³, 8 at 128³), one plane on a 2D lift."""
    rows = {n: tkernels.fused2d_plan(n, n, 6, SMS)[2]
            for n in (4096, 2048, 1024, 512, 128)}
    assert rows == {4096: 32, 2048: 32, 1024: 8, 512: 2, 128: 2}
    for n, r in rows.items():
        hp, ow, r_, strips, chunks = tkernels.fused2d_plan(n, n, 6, SMS)
        assert r == min(tkernels.K5_ROWS) or strips * chunks >= (
            tkernels.K5_WARPS_PER_SM * SMS)
    zc = {s: tkernels.sweep_plan(*s, SMS)[0] for s in GRIDS[:4] + [(1, 1024, 1024)]}
    assert zc[(256, 256, 256)] == 64 and zc[(128, 128, 128)] == 8
    assert zc[(1, 1024, 1024)] == 1
    for s, z in zc.items():
        _, ty, tx, chunks = tkernels.sweep_plan(*s, SMS)
        assert z == 1 or ty * tx * chunks >= tkernels.K3_BLOCKS_PER_SM * SMS


# ---------------------------------------------------------------------------
# (b) the plain versions against the JAX package's array code
# ---------------------------------------------------------------------------

CFG = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat")


@pytest.fixture(scope="module")
def levels():
    """JAX operators (and their ports) of the chip's small shapes: (200, 328)
    constant 5-point and (100, 164) cornered 9-point (BASELINE config 2's
    odd family), (20, 36, 72) constant 7-point and (10, 18, 36) cornered
    27-point, (36, 72) constant and (18, 36) cornered lifted to
    (1, ny, nx)."""
    out = {}
    for shape, kw in (((200, 328), dict(gridlevels=4, max_dense_coarse=4096)),
                      ((20, 36, 72), dict(gridlevels=3, max_dense_coarse=1024)),
                      ((36, 72), dict(gridlevels=3, max_dense_coarse=1024))):
        h = jmg.setup(shape, jmg.SolverConfig(**CFG, **kw)).hierarchy
        for L in h.levels[:2]:
            out[tuple(int(s) for s in L.A.grid_shape)] = (L.A, L.inv_diag)
    return out


def _jax_sweeps(name, A, inv_diag, b, x, iterations):
    return jsmoothers.smooth(name, A, inv_diag, b, x, iterations, OMEGA,
                             use_pallas=False)


K5_CASES = [((200, 328), "down"), ((200, 328), "up"), ((100, 164), "down"),
            ((100, 164), "up"), ((100, 164), "jacobi residual"),
            ((37, 91), "rb on x"), ((37, 91), "jacobi residual")]


@pytest.mark.parametrize("shape,case", K5_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_fused_stages_2d_plain_matches_reference_array_code(levels, shape, case):
    """1e-5·max|ref| (a residual: 1e-5·max|b|), as for the Pallas kernel:
    the reference sums a cornered operator's taps as the constant part and
    region deltas, the port one tap row a point."""
    if shape == (37, 91):   # no transfers: the 5-point operator of any plane
        A = jstencil.StencilOperator(
            None, ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
            to_j(np.asarray([4.0, -1, -1, -1, -1])), shape)
        inv_diag = to_j(np.asarray(0.25))
    else:
        A, inv_diag = levels[shape]
    op = port_op(A)
    cshape = tuple(s // 2 for s in shape)
    b, x, ec = rand(shape, 50), rand(shape, 51), rand(cshape, 52)
    jt, tt = JTRANSFERS["linear"], TTRANSFERS["linear"]
    kw = dict(corner=tfused._corner_info(op))
    rb4 = (("rb", 0), ("rb", 1)) * 2
    jb = to_j(b)
    if case == "down":
        xr = _jax_sweeps("rbgs", A, inv_diag, jb, to_j(np.zeros(shape)), 2)
        ref = (xr, jrestrict(jb - jstencil.apply(A, xr), jt))
        got = tkernels.fused_stages_2d_plain(
            op.values, op.offsets, to_t(b), None, rb4, emit_residual=True,
            restrict_transfer=tt, **kw)
    elif case == "up":
        x0 = to_j(x) + jprolong(to_j(ec), shape, jt)
        ref = (_jax_sweeps("rbgs", A, inv_diag, jb, x0, 2),)
        got = (tkernels.fused_stages_2d_plain(
            op.values, op.offsets, to_t(b), to_t(x), rb4, ec=to_t(ec),
            prolong_transfer=tt, **kw),)
    elif case == "rb on x":
        ref = (_jax_sweeps("rbgs", A, inv_diag, jb, to_j(x), 2),)
        got = (tkernels.fused_stages_2d_plain(
            op.values, op.offsets, to_t(b), to_t(x), rb4, **kw),)
    else:
        xr = _jax_sweeps("jacobi", A, inv_diag, jb, to_j(x), 6)
        ref = (xr, jb - jstencil.apply(A, xr))
        got = tkernels.fused_stages_2d_plain(
            op.values, op.offsets, to_t(b), to_t(x), (("jacobi", OMEGA),) * 6,
            emit_residual=True, **kw)
    assert len(got) == len(ref)
    assert_close(got[0], ref[0], factor=1e-5, what=f"{case} {shape}: x")
    if len(ref) > 1:
        assert tuple(got[1].shape) == tuple(to_n(ref[1]).shape)
        assert_close(got[1], ref[1], factor=1e-5, scale=b, what=f"{case} {shape}: r")


@pytest.mark.parametrize("mode", ["jacobi", "rbgs", "residual"])
@pytest.mark.parametrize("shape", [(20, 36, 72), (10, 18, 36), (36, 72), (18, 36)],
                         ids=lambda s: "x".join(map(str, s)))
def test_half_sweep_plain_matches_reference_array_code(levels, shape, mode):
    """One pass of ``half_sweep_plain`` (a red/black sweep: colour 0 then
    colour 1) against the JAX package's jnp smoothers and residual; 2D
    operands lifted to (1, ny, nx) as the card takes them.  2e-6·max|ref|
    on constant operators, 1e-5 on cornered ones (the reference's region
    deltas), a residual scaled by max|b|."""
    A, inv_diag = levels[shape]
    op = port_op(A)
    b, x = rand(shape, 60), rand(shape, 61)
    lift = len(shape) == 2
    offs = tkernels._lift2d(op.offsets) if lift else op.offsets
    corner = tfused._corner_info(op)
    corner = tkernels._lift_corner(corner) if lift else corner
    tb, tx = (to_t(b)[None], to_t(x)[None]) if lift else (to_t(b), to_t(x))

    def plain(y, mode, color=0):
        return tkernels.half_sweep_plain(op.values, offs, tb, y, mode, OMEGA,
                                         color, corner)

    jb, jx = to_j(b), to_j(x)
    if mode == "residual":
        got, ref = plain(tx, "residual"), jb - jstencil.apply(A, jx)
    elif mode == "jacobi":
        got, ref = plain(tx, "jacobi"), _jax_sweeps("jacobi", A, inv_diag, jb, jx, 1)
    else:
        got = plain(plain(tx, "rbgs", 0), "rbgs", 1)
        ref = _jax_sweeps("rbgs", A, inv_diag, jb, jx, 1)
    got = got[0] if lift else got
    factor = 1e-5 if corner else 2e-6
    assert_close(got, ref, factor=factor, what=f"{mode} {shape}",
                 scale=b if mode == "residual" else None)
