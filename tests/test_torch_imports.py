"""The port, chip_smoke.py, tools/ and the port's examples
(``examples/*_torch.py``) import neither JAX nor the JAX package.

A static scan of the sources' import statements: the test process has JAX
imported already (the JAX tests run in it), so a ``sys.modules`` check
could not tell.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "cuembed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "cuembed_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imported_modules(path) if _forbidden(mod)]
    assert not bad, bad


def test_scan_sees_the_port():
    """The scan covers every module of the slice, and flags what it must."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("__init__.py", "types.py", "ops/transforms.py",
                   "ops/lookup_torch.py", "ops/_build.py", "ops/cuda_forward.py",
                   "ops/cuda_backward.py", "ops/dispatch.py", "ops/api.py",
                   "train.py", "models/embedding_bag.py",
                   "utils/datagen.py", "utils/benchmarking.py",
                   "native/__init__.py", "utils/frequency.py", "utils/calibration.py",
                   "utils/pipeline.py", "table.py", "collection.py", "fused.py",
                   "models/qr_embedding.py", "models/dlrm.py", "utils/chip.py",
                   "utils/calibrate_chip.py"):
        assert f"cuembed_tpu_torch/{module}" in names
    assert "chip_smoke.py" in names and "tools/k3_sweep.py" in names
    assert "examples/train_dlrm_torch.py" in names
    assert "examples/train_dlrm.py" not in names  # the JAX trainer
    assert _forbidden("jax.numpy") and _forbidden("cuembed_tpu.ops")
    assert not _forbidden("cuembed_tpu_torch.ops")


def test_scan_sees_the_parallel_layer():
    """The host-offloaded table, the parallel layer and the sharded trainer
    are scanned, and the JAX sharded trainer is not."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("offload.py", "parallel/__init__.py", "parallel/sharding.py",
                   "parallel/collectives.py", "parallel/sharded_lookup.py",
                   "parallel/alltoall_lookup.py", "parallel/train.py",
                   "parallel/multihost.py", "parallel/dryrun.py"):
        assert f"cuembed_tpu_torch/{module}" in names
    assert "examples/train_dlrm_sharded_torch.py" in names
    assert "examples/train_dlrm_sharded.py" not in names


def test_scan_sees_the_planner_and_the_rest():
    """The planner, the golden models, the allocation and the planner's
    example are scanned, and the JAX example is not."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("parallel/planner.py", "ref/__init__.py", "ref/forward.py",
                   "ref/backward.py", "ref/transforms.py", "utils/allocation.py"):
        assert f"cuembed_tpu_torch/{module}" in names
    assert "examples/plan_and_train_torch.py" in names
    assert "examples/plan_and_train.py" not in names


def _imported_names(path: Path):
    """Every module an import statement of ``path`` names, at any depth of
    the file, with each name a ``from`` import takes (it may be a module)."""
    for _, module in _imported_modules(path):
        yield module
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def test_imports_run_down_the_layers():
    """The lookup's route runs one way, collection -> api -> dispatch ->
    the kernel wrappers -> ``_build``: ``collection.py`` imports no kernel
    wrapper (``ops.cuda_*``), and no kernel wrapper imports ``ops.api``,
    ``ops.dispatch`` or ``collection``."""
    pkg = ROOT / "cuembed_tpu_torch"
    wrappers = sorted((pkg / "ops").glob("cuda_*.py"))
    assert {p.name for p in wrappers} == {"cuda_forward.py", "cuda_backward.py",
                                          "cuda_adagrad.py", "cuda_transforms.py"}
    up = [m for m in _imported_names(pkg / "collection.py")
          if m.startswith("cuembed_tpu_torch.ops.cuda_")]
    assert not up, up
    above = ("cuembed_tpu_torch.ops.api", "cuembed_tpu_torch.ops.dispatch",
             "cuembed_tpu_torch.collection")
    for path in wrappers:
        up = [m for m in _imported_names(path)
              if any(m == a or m.startswith(a + ".") for a in above)]
        assert not up, (path.name, up)
