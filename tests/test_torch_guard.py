"""The port stands on its own: no module of ``openmg_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "openmg_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist_worker.py",
    ROOT / "tests" / "_torch_dist_cases.py",
    ROOT / "scripts" / "dryrun_multichip_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "openmg_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def test_port_has_all_its_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in (
        "openmg_tpu_torch/__init__.py", "openmg_tpu_torch/_build.py",
        "openmg_tpu_torch/core/config.py", "openmg_tpu_torch/core/cycle.py",
        "openmg_tpu_torch/core/hierarchy.py", "openmg_tpu_torch/core/solver.py",
        "openmg_tpu_torch/core/structured.py", "openmg_tpu_torch/models/poisson.py",
        "openmg_tpu_torch/ops/doublefloat.py", "openmg_tpu_torch/ops/fused.py",
        "openmg_tpu_torch/ops/galerkin.py", "openmg_tpu_torch/ops/kernels.py",
        "openmg_tpu_torch/ops/smoothers.py", "openmg_tpu_torch/ops/stencil.py",
        "openmg_tpu_torch/ops/transfer.py", "openmg_tpu_torch/utils/convert.py",
        "openmg_tpu_torch/core/algebraic.py", "openmg_tpu_torch/ops/sparse.py",
        "openmg_tpu_torch/ops/ell.py", "openmg_tpu_torch/ops/bsr.py",
        "openmg_tpu_torch/models/elasticity.py", "openmg_tpu_torch/models/spd.py",
        "openmg_tpu_torch/utils/oracle.py",
        "openmg_tpu_torch/utils/checkpoint.py", "openmg_tpu_torch/utils/observe.py",
        "openmg_tpu_torch/cli.py", "openmg_tpu_torch/__main__.py",
        "openmg_tpu_torch/parallel/mesh.py", "openmg_tpu_torch/parallel/halo.py",
        "openmg_tpu_torch/parallel/fast.py", "openmg_tpu_torch/parallel/dist.py",
        "openmg_tpu_torch/parallel/sparse_dist.py", "openmg_tpu_torch/parallel/model.py",
        "scripts/dryrun_multichip_torch.py", "chip_smoke.py",
    ):
        assert want in names, want
    assert (ROOT / "openmg_tpu_torch/csrc/fused_stages.cu").exists()
    assert (ROOT / "openmg_tpu_torch/csrc/df_update.cu").exists()
    assert (ROOT / "openmg_tpu_torch/csrc/half_sweep.cu").exists()
    assert (ROOT / "openmg_tpu_torch/csrc/fused_stages_2d.cu").exists()
    assert (ROOT / "openmg_tpu_torch/csrc/spmv_banded.cu").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    code = (
        "import sys, openmg_tpu_torch, openmg_tpu_torch.utils.convert, "
        "openmg_tpu_torch.ops.fused, openmg_tpu_torch.ops.kernels, "
        "openmg_tpu_torch.ops.ell, openmg_tpu_torch.ops.bsr, "
        "openmg_tpu_torch.core.algebraic, openmg_tpu_torch.utils.oracle, "
        "openmg_tpu_torch.utils.checkpoint, openmg_tpu_torch.utils.observe, "
        "openmg_tpu_torch.cli, openmg_tpu_torch.parallel.mesh, "
        "openmg_tpu_torch.parallel.halo, openmg_tpu_torch.parallel.fast, "
        "openmg_tpu_torch.parallel.dist, openmg_tpu_torch.parallel.sparse_dist, "
        "openmg_tpu_torch.parallel.model, openmg_tpu_torch._build; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'openmg_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_kernel_sources_call_no_library():
    for src in (ROOT / "openmg_tpu_torch/csrc").glob("*.cu"):
        text = src.read_text()
        for lib in ("cublas", "cusparse", "cudnn", "cutlass", "cub/", "thrust"):
            assert lib not in text.lower(), (src.name, lib)
        assert "#include <cuda_runtime.h>" in text
