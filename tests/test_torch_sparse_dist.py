"""The port's distributed general-sparse engine
(``openmg_tpu_torch/parallel/sparse_dist.py``) and K6's halo form.

In process: K6h's plain version against the whole-vector plain version of
K6, the partition plan against the JAX package's on the same matrices, the
constructor's errors, the exports.

On gloo ranks (the two spawns of ``tests/_torch_dist_cases.py``, shared
with the stencil engine's tests): the dry run's banded-sparse case
(``__graft_entry__.py``, 2D Poisson ELL at (16, 16)) on two ranks and on a
(2, 2) mesh, the pentadiagonal matrix under Jacobi, multicolour GS and
Chebyshev with V, W and F cycles, the irregular matrix on the gathered-x
tier, MG-PCG(2) on the (2, 2) mesh and one ``solve_many``, each held
against the port's single-device ``AlgebraicSolver`` (which
``tests/test_torch_algebraic.py`` holds against the JAX package's) with the
tolerances of ``tests/test_torch_dist.py``: equal cycles, histories within
rtol 1e-3, ‖Δx‖₂ ≤ 2e-10/λ_min.  The dry run's two-rank case is also held
against the JAX package's ``DistributedAlgebraicSolver`` on two of the
virtual CPU devices (the one reference distributed build of this file).
"""

import numpy as np
import pytest
import torch

from _torch_dist_cases import (
    SPARSE_CASES,
    SPARSE_MANY,
    assert_many_equals_scalars,
    assert_solves_agree,
    irregular_spd,
    lam_min,
    matrix_of,
    pentadiag,
    results,
    sparse_case,
    sparse_rhs,
)
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

# -- K6h ------------------------------------------------------------------

NY, NX = 6, 8  # a 2D grid of 48 rows, flat indexing


def _banded(H, seed):
    """A random banded ELL operand reaching ``H`` rows: offsets 0, ±1, ±H
    (row-major 2D Poisson's shape when H = NX), the slots' out-of-range
    entries zero as the builders store them."""
    n = NY * NX
    offs = tuple(sorted({0, -1, 1, -H, H}))
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offs), n)).astype(np.float32)
    rows = np.arange(n)
    for j, d in enumerate(offs):
        data[j, (rows + d < 0) | (rows + d >= n)] = 0.0
    x = rng.standard_normal(n).astype(np.float32)
    return offs, torch.from_numpy(data), torch.from_numpy(x)


@pytest.mark.parametrize("H", range(1, NX + 2))
def test_k6h_plain_equals_whole_vector_rows(H):
    """Every slab of every cut (a rank at each domain edge and inside), its
    halos the neighbours' rows, against K6's plain version of the whole
    vector: bit for bit.  Halos deeper than the band too."""
    from openmg_tpu_torch.ops import ell

    offs, data, x = _banded(H, H)
    n = x.shape[0]
    whole = ell.spmv_banded_plain(data, offs, x)
    for P in (p for p in (1, 2, 3, 4, 6) if n // p >= H):
        m = n // P
        for depth in (H, H + 1):
            depth = min(depth, m)
            for i in range(P):
                lo = x[i * m - depth:i * m] if i else torch.zeros(depth)
                hi = x[(i + 1) * m:(i + 1) * m + depth] if i < P - 1 else torch.zeros(depth)
                y = ell.spmv_banded_halo(data[:, i * m:(i + 1) * m].contiguous(), offs,
                                         x[i * m:(i + 1) * m].contiguous(),
                                         lo.contiguous(), hi.contiguous())
                assert torch.equal(y, whole[i * m:(i + 1) * m]), (P, i, depth)


def test_k6h_checks_its_operands():
    from openmg_tpu_torch.ops import ell

    offs, data, x = _banded(NX, 0)
    m = 24
    args = (data[:, :m].contiguous(), offs, x[:m].contiguous())
    with pytest.raises(ValueError, match="reach"):
        ell.spmv_banded_halo(*args, torch.zeros(NX - 1), torch.zeros(NX - 1))
    with pytest.raises(ValueError, match="one type"):
        ell.spmv_banded_halo(*args, torch.zeros(NX, dtype=torch.float64),
                             torch.zeros(NX, dtype=torch.float64))
    with pytest.raises(ValueError, match="H rows"):
        ell.spmv_banded_halo(*args, torch.zeros(NX), torch.zeros(NX + 1))
    with pytest.raises(ValueError, match="slot offsets"):
        ell.spmv_banded_halo(data[:, :m + 1].contiguous(), offs, x[:m].contiguous(),
                             torch.zeros(NX), torch.zeros(NX))


# -- the plan, the constructor, the exports ------------------------------


PLAN_MATRICES = {
    "pentadiag 4096": (lambda: pentadiag(4096), (4096,), 512),
    "pentadiag 1004": (lambda: pentadiag(1004), (1004,), 512),
    "irregular 1024": (lambda: irregular_spd(1024), (1024,), 512),
    "poisson 16^3": (lambda: matrix_of({"matrix": "poisson", "shape": [16, 16, 16]}),
                     (16, 16, 16), 512),
    "poisson 16^2": (lambda: matrix_of({"matrix": "poisson", "shape": [16, 16]}),
                     (16, 16), 16),
}


@pytest.mark.parametrize("name", PLAN_MATRICES)
def test_partition_plan_matches_reference(name):
    """``sparse_partition_plan`` on the port's hierarchy equals the JAX
    package's on its own, for meshes of 1 to 16 ranks, two row minima and
    ``force``."""
    import openmg_tpu.core.algebraic as jalg
    from openmg_tpu.parallel.sparse_dist import sparse_partition_plan as jplan

    from openmg_tpu_torch.core.algebraic import build_sparse_hierarchy
    from openmg_tpu_torch.parallel.sparse_dist import sparse_partition_plan

    make, shape, mdc = PLAN_MATRICES[name]
    A = make()
    kw = dict(fmt="ell", residual_dtype="doublefloat", max_dense_coarse=mdc)
    hp = build_sparse_hierarchy(A, shape, device="cpu", **kw)
    hj = jalg.build_sparse_hierarchy(A, shape, **kw)
    assert hp.num_levels == hj.num_levels
    for n_dev in (1, 2, 4, 8, 16):
        for mr in (2, 64):
            for force in (False, True):
                assert sparse_partition_plan(hp, n_dev, mr, force) == \
                    jplan(hj, n_dev, mr, force), (n_dev, mr, force)


@pytest.mark.parametrize("what", ["csr", "float32 residual", "smoother", "cycle_type",
                                  "krylov"])
def test_constructor_raises_as_the_reference(what):
    """The reference's errors, raised before any process group is needed
    (``tests/test_parallel_sparse.py`` checks the format's; the two-rank
    spawn checks a fine level that does not split)."""
    from openmg_tpu_torch import SolverConfig
    from openmg_tpu_torch.core.algebraic import build_sparse_hierarchy
    from openmg_tpu_torch.parallel.sparse_dist import DistributedAlgebraicSolver

    A = pentadiag(256)
    cfg = SolverConfig(format="ell", residual_dtype="doublefloat")
    fmt, rd, match = "ell", "doublefloat", None
    if what == "csr":
        fmt, match = "csr", "ell"
    elif what == "float32 residual":
        rd, match = "float32", "doublefloat"
    else:
        object.__setattr__(cfg, what, "bogus")
        match = f"unknown {what}"
    h = build_sparse_hierarchy(A, (256,), fmt=fmt, residual_dtype=rd,
                               max_dense_coarse=64, device="cpu")
    with pytest.raises(ValueError, match=match):
        DistributedAlgebraicSolver(h, cfg)


def test_exports_contain_the_reference_all():
    import openmg_tpu
    import openmg_tpu_torch

    assert set(openmg_tpu.__all__) <= set(openmg_tpu_torch.__all__)
    assert "DistributedAlgebraicSolver" in openmg_tpu_torch.__all__
    assert "setup_sparse_distributed" in openmg_tpu_torch.__all__


def test_setup_never_picks_the_cpu():
    from openmg_tpu_torch import setup_sparse_distributed

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_sparse_distributed(pentadiag(64), (64,))


# -- on gloo ranks --------------------------------------------------------


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return results(tmp_path_factory)


@pytest.fixture(scope="module")
def single():
    """The port's single-device solve of every sparse case on the CPU."""
    from openmg_tpu_torch import SolverConfig, setup_sparse

    out = {}
    for name in SPARSE_CASES:
        case = sparse_case(name)
        A = matrix_of(case)
        shape = tuple(case["shape"])
        solver = setup_sparse(A, shape, SolverConfig(**case["config"]), device="cpu")
        x, info = solver.solve(sparse_rhs(A.shape[0]))
        assert info["converged"]
        out[name] = (x, info, A)
    return out


def _lam(name, A):
    case = sparse_case(name)
    if case["matrix"] == "poisson":
        return lam_min(tuple(case["shape"]))
    return float(np.linalg.eigvalsh(A.toarray())[0])


@pytest.mark.parametrize("name", SPARSE_CASES)
def test_sparse_matches_single_device(port, single, name):
    x, info, A = single[name]
    assert int(port[f"{name}/cycles"]) == info["cycles"]
    assert bool(port[f"{name}/plan"][0])
    assert_solves_agree(port[f"{name}/hist"], port[f"{name}/x"],
                        info["residual_norms"], x, _lam(name, A))


def test_sparse_tiers(port):
    """Banded levels exchange halo rows; the irregular matrix moves nothing
    point to point (the gathered-x tier) but gathers a vector an ``Ax``."""
    assert int(port["sp_jacobi/bytes_sent"]) > 0
    assert int(port["sp_irregular/bytes_sent"]) == 0
    assert int(port["sp_irregular/gathered_bytes"]) > int(port["sp_jacobi/gathered_bytes"])
    assert tuple(port["sp_jacobi/plan"]) == (True, True, True, False)
    assert list(port["jax_modules"]) == []


@pytest.mark.parametrize("name,native_x0",
                         [(n, False) for n in SPARSE_MANY] + [("sp_rbgs", True)])
def test_sparse_solve_many_member_equals_scalar_solve(port, name, native_x0):
    """``solve_many`` as one stack (K6hb on banded levels, the gathered
    tier member by member): every member bit-equal to its scalar solve on
    the same ranks, one host read a step, the scalar exchanges, the
    members' bytes; with ``native_x0`` a float32 tensor batch from host
    initial guesses (the reference's card batch with host ``x0s``)."""
    many = assert_many_equals_scalars(port, name, native_x0)
    assert port[f"{many}/x"].shape == (3, 512)
    assert bool(port[f"{many}/plan"][0])
    if not native_x0:
        np.testing.assert_array_equal(port[f"{many}/x"][0], port[f"{name}/x"])


def test_fine_level_that_does_not_split_raises(port):
    assert "single-device" in str(port["sp_indivisible/error"])


def test_dry_run_case_matches_reference(port):
    """The dry run's banded-sparse case on two ranks against the JAX
    package's ``DistributedAlgebraicSolver`` on two virtual devices."""
    from openmg_tpu import MeshConfig, SolverConfig
    from openmg_tpu.parallel.sparse_dist import setup_sparse_distributed

    case = sparse_case("sp_dry")
    shape = tuple(case["shape"])
    solver = setup_sparse_distributed(matrix_of(case), shape,
                                      SolverConfig(**case["config"]),
                                      MeshConfig(n_devices=2))
    x, info = solver.solve(sparse_rhs(int(np.prod(shape))))
    assert info["converged"]
    assert tuple(port["sp_dry/plan"]) == tuple(info["partition_plan"]) == (True, True, False)
    assert_solves_agree(port["sp_dry/hist"], port["sp_dry/x"], info["residual_norms"],
                        np.asarray(x), lam_min(shape))


def test_local_levels_hold_only_the_rows_of_the_rank(monkeypatch):
    """A rank's share: the row block of every partitioned level (and of the
    outer residual's operator), the whole of the replicated ones (the
    second rank of two, its mesh made by hand: no process group here)."""
    from openmg_tpu_torch import MeshConfig, SolverConfig
    from openmg_tpu_torch.core.algebraic import build_sparse_hierarchy
    from openmg_tpu_torch.parallel import sparse_dist
    from openmg_tpu_torch.parallel.mesh import Mesh

    h = build_sparse_hierarchy(pentadiag(512), (512,), fmt="ell",
                               residual_dtype="doublefloat", max_dense_coarse=64,
                               device="cpu")
    monkeypatch.setattr(sparse_dist, "make_mesh", lambda n, axis: Mesh(
        group=None, ranks=(0, 1), index=1, shape=(2,), axis_names=(axis,)))
    solver = sparse_dist.DistributedAlgebraicSolver(
        h, SolverConfig(format="ell"), MeshConfig(n_devices=2), device="cpu")
    assert solver.plan == (True, True, True, False)
    for i, lv in enumerate(solver.levels[:-1]):
        n = h.levels[i].n
        assert solver.rows[i] == (n // 2, n)
        assert lv.whole is None
        assert torch.equal(lv.data, h.levels[i].A.data[:, n // 2:])
        assert torch.equal(lv.inv_diag, h.levels[i].inv_diag[n // 2:])
    assert solver.levels[-1].whole is not None and solver.levels[-1].data is None
    assert torch.equal(solver.fine_hi, h.fine_hi.data[:, 256:])
