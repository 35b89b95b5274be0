"""The sparse format layer of the port on the CPU against the JAX package:
the host-built containers, the device-side Poisson ELL, the plain versions
of the slot-offset ELL SpMV (K6) and the blocked-band BSR SpMV (K7) against
the Pallas kernels in interpret mode, the other SpMV paths, the
double-float SpMV and the diagonal, and the vector-PDE generators.

Inputs come from numpy seeds and go to both packages.  The six Pallas calls
in (c) are the only traced kernels of this file.
"""

import dataclasses

import jax.numpy as jnp
import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from openmg_tpu.models import elasticity as jelas
from openmg_tpu.models import poisson as jpoisson
from openmg_tpu.ops import bsr as jbsr
from openmg_tpu.ops import ell as jell
from openmg_tpu.ops import sparse as jsparse
from openmg_tpu.utils.oracle import weighted_restriction
from openmg_tpu_torch.models import elasticity as telas
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import bsr as tbsr
from openmg_tpu_torch.ops import ell as tell
from openmg_tpu_torch.ops import sparse as tsparse
from openmg_tpu_torch.ops.transfer import LINEAR

from _torch_parity import non_stencil_spd, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)


MATRICES = {
    "poisson3d": lambda: jpoisson.poisson((8, 8, 16)),
    "poisson2d": lambda: jpoisson.poisson((16, 8)),
    "elasticity2d": lambda: jelas.elasticity((8, 8)),
    "elasticity3d": lambda: jelas.elasticity((4, 4, 4)),
    "coupled": lambda: jelas.coupled_diffusion((4, 4, 4), 4),
    "nonstencil": lambda: non_stencil_spd((8, 8)),
    "restriction": lambda: weighted_restriction((8, 8), LINEAR.r_taps),
}

# (matrix, format, converter keywords)
CONTAINER_CASES = [
    ("poisson3d", "ell", {}), ("poisson2d", "ell", {}),
    ("elasticity2d", "ell", {}), ("coupled", "ell", {}),
    ("nonstencil", "ell", {}), ("restriction", "ell", {}),
    ("poisson2d", "ell", {"k": 8}),
    ("poisson2d", "csr", {}), ("nonstencil", "csr", {}),
    ("restriction", "csr", {}),
    ("poisson3d", "bsr", {"blocksize": (4, 4)}),
    ("elasticity2d", "bsr", {"blocksize": (2, 2)}),
    ("elasticity3d", "bsr", {"blocksize": (3, 3)}),
    ("coupled", "bsr", {"blocksize": (4, 4)}),
    ("nonstencil", "bsr", {"blocksize": (2, 2)}),
    ("poisson2d", "dense", {}),
]


def _case_id(c):
    return f"{c[0]}-{c[1]}" + "".join(f"-{k}{v}" for k, v in c[2].items())


def _pair(name, fmt, kw, dtype=np.float32):
    A = MATRICES[name]()
    return A, (
        jsparse.from_scipy(A, fmt, dtype=dtype, **kw),
        tsparse.from_scipy(A, fmt, dtype=dtype, device="cpu", **kw),
    )


def _fields(M):
    return {f: getattr(M, f) for f in M.__dataclass_fields__}


# (a) containers ------------------------------------------------------------


@pytest.mark.parametrize("case", CONTAINER_CASES, ids=_case_id)
def test_containers_bit_equal(case):
    _, (jM, tM) = _pair(*case)
    jf, tf = _fields(jM), _fields(tM)
    assert jf.keys() == tf.keys()
    for key, jv in jf.items():
        tv = tf[key]
        if isinstance(tv, torch.Tensor):
            a, b = np.asarray(jv), to_n(tv)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key
        else:
            assert jv == tv, key


@pytest.mark.parametrize("case", CONTAINER_CASES, ids=_case_id)
def test_to_scipy_round_trip(case):
    A, (_, tM) = _pair(*case)
    back = tsparse.to_scipy(tM)
    diff = (back - sp.csr_matrix(A).astype(np.float32)).tocoo()
    assert back.shape == A.shape
    assert diff.nnz == 0 or np.abs(diff.data).max() == 0.0


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8), (32,)])
def test_poisson_ell_device_equals_host_build(shape):
    dev = tpoisson.poisson_ell_device(shape, device="cpu")
    host = tsparse.ell_from_scipy(tpoisson.poisson(shape), device="cpu")
    jdev = jpoisson.poisson_ell_device(shape)
    for M in (host, jdev):
        assert M.slot_offsets == dev.slot_offsets
        assert (M.nnz, M.bandwidth, M.shape) == (dev.nnz, dev.bandwidth, dev.shape)
        assert np.array_equal(to_n(M.data), to_n(dev.data))
    # columns agree wherever an entry exists; pads sit at column 0 on the
    # device build (the host build keeps the band's column there)
    live = to_n(dev.data) != 0
    assert np.array_equal(to_n(host.cols)[live], to_n(dev.cols)[live])
    assert np.array_equal(np.asarray(jdev.cols), to_n(dev.cols))
    x = to_t(rand(dev.shape[0], 31))
    assert torch.equal(tsparse.spmv(dev, x), tsparse.spmv(host, x))


def test_poisson_ell_device_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpoisson.poisson_ell_device((8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsparse.ell_from_scipy(tpoisson.poisson((8, 8)))


@pytest.mark.parametrize("which", ["elasticity2d", "elasticity3d", "coupled"])
def test_generators_bit_equal(which):
    args = {"elasticity2d": ("elasticity", (6, 5)),
            "elasticity3d": ("elasticity", (3, 4, 3)),
            "coupled": ("coupled_diffusion", (5, 4))}[which]
    a = getattr(jelas, args[0])(args[1])
    b = getattr(telas, args[0])(args[1])
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# (b) SpMV helpers ----------------------------------------------------------


def _term_scale(A, x):
    """max_i Σ_j |A_ij x_j|: the size of the terms of a row's sum, which
    sets what float32 summation in another order may move."""
    return float(np.max(abs(sp.csr_matrix(A)) @ np.abs(x.astype(np.float64))))


def _close(got, ref, A, x, factor=1e-6, what=""):
    tol = factor * _term_scale(A, x)
    err = float(np.max(np.abs(to_n(got).astype(np.float64) - to_n(ref))))
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


# (c) K6 / K7 plain versions against the Pallas kernels (interpret mode) ----


@pytest.mark.parametrize("shape", [(8, 8, 16), (4, 16, 64)])
def test_k6_plain_matches_pallas(shape):
    A = jpoisson.poisson(shape)
    jM = jsparse.ell_from_scipy(A)
    tM = tsparse.ell_from_scipy(A, device="cpu")
    assert jell.supports(jM) and tell.supports(tM)
    x = rand(A.shape[0], 3)
    ref = jell.spmv_ell(jM, to_j(x))
    before = tell.LAUNCHES_K6
    got = tell.spmv_ell(tM, to_t(x))
    assert tell.LAUNCHES_K6 == before  # the CPU runs the plain version
    _close(got, ref, A, x, what=f"K6 {shape}")
    # and it is the port's dispatch for a banded ELL, bit for bit
    assert torch.equal(tsparse.spmv(tM, to_t(x)), got)


K7_CASES = [
    ("poisson16", 2), ("poisson16", 4), ("poisson16", 8), ("coupled8", 4),
    ("elasticity3d", 3), ("stencil27", 3),
]


def _stencil27(shape=(8, 8, 12)):
    """A 27-point operator with varying taps: kb 27 at B = 3, whose 81
    terms a row are not a multiple of the lane group (4 at this size)."""
    offsets = [(0, 0, 0)] + [o for o in itertools.product((-1, 0, 1), repeat=3)
                             if any(o)]
    coeffs = -0.5 - np.random.default_rng(7).random((27,) + shape)
    coeffs[0] = 30.0
    return jpoisson.stencil_to_csr(offsets, coeffs)


@pytest.mark.parametrize("case", K7_CASES, ids=lambda c: f"{c[0]}-B{c[1]}")
def test_k7_plain_matches_pallas(case):
    name, B = case
    A = {"poisson16": lambda: jpoisson.poisson((16, 16, 16)),
         "coupled8": lambda: jelas.coupled_diffusion((8, 8, 8), 4),
         "elasticity3d": lambda: jelas.elasticity((6, 6, 6)),
         "stencil27": _stencil27}[name]()
    jM = jsparse.bsr_from_scipy(A, blocksize=(B, B))
    tM = tsparse.bsr_from_scipy(A, blocksize=(B, B), device="cpu")
    assert tM.slot_offsets is not None and tbsr.supports(tM)
    if name == "stencil27":
        G = tbsr.lane_group(A.shape[0], tM.kb, B)
        assert tM.kb == 27 and G > 1 and (tM.kb * B) % G != 0
    x = rand(A.shape[0], 5)
    if B == 3:
        # 128 % 3 != 0: the Pallas kernel does not take it, and the JAX
        # package's banded array code is its reference
        assert not jbsr.supports(jM)
        ref = jbsr.spmv_banded_jnp(jM, to_j(x))
    else:
        assert jbsr.supports(jM)
        ref = jbsr.spmv_bsr(jM, to_j(x))
    before = tbsr.LAUNCHES_K7
    got = tbsr.spmv_bsr(tM, to_t(x))
    assert tbsr.LAUNCHES_K7 == before
    _close(got, ref, A, x, what=f"K7 {name} B={B}")
    assert torch.equal(tsparse.spmv(tM, to_t(x)), got)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_banded_plain_versions_in_float64(fmt):
    if fmt == "ell":
        M = tsparse.ell_from_scipy(
            tpoisson.poisson((6, 5, 4)), dtype=np.float64, device="cpu"
        )
    else:
        M = tsparse.bsr_from_scipy(
            telas.coupled_diffusion((4, 4, 4), 4), blocksize=(4, 4),
            dtype=np.float64, device="cpu",
        )
    assert M.slot_offsets is not None
    x = np.random.default_rng(2).standard_normal(M.shape[0])
    got = tsparse.spmv(M, torch.from_numpy(x))
    assert got.dtype == torch.float64
    ref = tsparse.to_scipy(M) @ x
    assert np.max(np.abs(to_n(got) - ref)) <= 1e-14 * _term_scale(tsparse.to_scipy(M), x)


def test_wrappers_refuse_what_their_kernel_does_not_take():
    irregular = tsparse.ell_from_scipy(MATRICES["nonstencil"](), device="cpu")
    assert irregular.slot_offsets is None and not tell.supports(irregular)
    with pytest.raises(ValueError, match="slot_offsets"):
        tell.spmv_ell(irregular, torch.zeros(irregular.shape[0]))
    general = tsparse.bsr_from_scipy(MATRICES["nonstencil"](), blocksize=(2, 2),
                                     device="cpu")
    assert general.slot_offsets is None
    with pytest.raises(ValueError, match="blocked-band"):
        tbsr.spmv_bsr(general, torch.zeros(general.shape[0]))
    data = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="one type"):
        tell.check_operands("k", data, torch.zeros(8, dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tell.check_operands("k", data.t().contiguous().t(), torch.zeros(8), 8)
    with pytest.raises(ValueError, match="expected"):
        tell.check_operands("k", data, torch.zeros(9), 8)


@pytest.mark.parametrize("shape,k,B,n", [
    ((3, 8), 2, 1, 8),     # fewer offsets than slots
    ((3, 8), 3, 2, 8),     # an ELL layout given a block size
    ((3, 2, 9), 3, 2, 9),  # rows not a whole number of blocks
    ((3, 2, 8), 3, 4, 8),  # data of another block size
])
def test_banded_launch_refuses_mismatched_layouts(shape, k, B, n):
    # K6 and K7 share one launch; it checks the layout before the kernel
    with pytest.raises(ValueError, match="slot offsets"):
        tell.spmv_banded_cuda("k", torch.zeros(shape), tuple(range(k)), B,
                              torch.zeros(n))


# (d) every SpMV path, spmv_df, diagonal ------------------------------------


SPMV_CASES = [
    ("poisson2d", "ell", {}), ("nonstencil", "ell", {}),
    ("restriction", "ell", {}), ("poisson2d", "csr", {}),
    ("restriction", "csr", {}), ("elasticity2d", "bsr", {"blocksize": (2, 2)}),
    ("nonstencil", "bsr", {"blocksize": (2, 2)}), ("poisson2d", "dense", {}),
]


@pytest.mark.parametrize("case", SPMV_CASES, ids=_case_id)
def test_spmv_matches_reference(case):
    A, (jM, tM) = _pair(*case)
    x = rand(A.shape[1], 7)
    _close(tsparse.spmv(tM, to_t(x)), jsparse.spmv(jM, to_j(x)), A, x,
           what=_case_id(case))


@pytest.mark.parametrize("name", ["poisson2d", "nonstencil"])
def test_spmv_df_bit_equal(name):
    A = sp.csr_matrix(MATRICES[name]()).astype(np.float64) * (1.0 + 1e-9)
    j64 = jsparse.ell_from_scipy(A, dtype=np.float64)
    d64 = np.asarray(j64.data)
    hi = d64.astype(np.float32)
    lo = (d64 - hi.astype(np.float64)).astype(np.float32)
    assert np.any(lo != 0)
    jhi = dataclasses.replace(j64, data=jnp.asarray(hi))
    jlo = dataclasses.replace(j64, data=jnp.asarray(lo))
    t64 = tsparse.ell_from_scipy(A, dtype=np.float64, device="cpu")
    thi = dataclasses.replace(t64, data=to_t(hi))
    tlo = dataclasses.replace(t64, data=to_t(lo))
    xh, xl = rand(A.shape[0], 1), rand(A.shape[0], 2) * np.float32(1e-8)
    ref = jsparse.spmv_df(jhi, jlo, to_j(xh), to_j(xl))
    got = tsparse.spmv_df(thi, tlo, to_t(xh), to_t(xl))
    for g, r in zip(got, ref):
        assert np.array_equal(to_n(g), np.asarray(r))


@pytest.mark.parametrize(
    "case", [c for c in CONTAINER_CASES if c[0] != "restriction"], ids=_case_id
)
def test_diagonal_bit_equal(case):
    A, (jM, tM) = _pair(*case)
    assert np.array_equal(to_n(tsparse.diagonal(tM)), np.asarray(jsparse.diagonal(jM)))
