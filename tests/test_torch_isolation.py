"""The port stands alone and never falls back behind the caller's back:
no JAX or reference import in src/repro_torch/ or chip_smoke.py, constructors
that refuse a missing card instead of landing on the CPU, and kernel
wrappers that choose by device alone, with no exception handling that could
turn a failed launch into a plain-version result."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import apply as A  # noqa: E402
from repro_torch.core import make_accum_sketch  # noqa: E402
from repro_torch.kernels.accum_apply import kernel as KT  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as LK  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path} imports {mod}"
        assert not top.startswith("repro") or top == "repro_torch", \
            f"{path} imports {mod}"


def test_constructor_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.sketched_attention import init_sketch_cache
    from repro_torch.models.model import init_params

    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_accum_sketch(g, 100, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, reduced(ARCHS["minitron-8b"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_sketch_cache(1, 2, 16, 8)


def test_routing_by_device_alone():
    assert A.default_use_kernel(torch.device("cuda")) is True
    assert A.default_use_kernel(torch.device("cuda", 1)) is True
    assert A.default_use_kernel(torch.device("cpu")) is False


def test_kernel_launchers_refuse_cpu_tensors():
    x = torch.zeros(8, 3)
    coef = torch.ones(2, 4)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.matfree_apply(x, torch.zeros(8, 3), coef, kernel="gaussian")
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_apply_left(x, idx, coef)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_sketch_both(torch.zeros(8, 8), idx, coef)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_apply(torch.zeros(8, 8), idx, coef)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_step_slab(torch.zeros(8, 8), idx[:1], coef[:1], torch.zeros(8, 4), 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_grow_slabs(torch.zeros(8, 8), idx, coef, torch.zeros(8, 4), 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KT.accum_apply_scalar(torch.zeros(8, 8), idx, coef)
    assert [f.launches for f in KT.KERNELS] == [0] * 7
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        LK.landmark_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        LK.landmark_stats(q, q, q, q)
    assert [f.launches for f in LK.KERNELS] == [0] * 2


def _assert_no_swallowed_exceptions(family: str) -> None:
    ops = PORT / "kernels" / family / "ops.py"
    assert not [n for n in ast.walk(ast.parse(ops.read_text()))
                if isinstance(n, ast.Try)], "ops.py must not catch exceptions"
    kernel = PORT / "kernels" / family / "kernel.py"
    for node in ast.walk(ast.parse(kernel.read_text())):
        if isinstance(node, ast.Try):
            for handler in node.handlers:
                assert isinstance(handler.body[-1], ast.Raise), \
                    f"kernel.py:{handler.lineno} handles an exception without re-raising"


def test_no_exception_handling_around_launches():
    _assert_no_swallowed_exceptions("accum_apply")


def test_no_exception_handling_around_landmark_launches():
    _assert_no_swallowed_exceptions("landmark_attention")
    for mod in ("core/sketched_attention.py", "models/attention.py", "models/model.py"):
        assert not [n for n in ast.walk(ast.parse((PORT / mod).read_text()))
                    if isinstance(n, ast.Try)], f"{mod} must not catch exceptions"


def test_build_dir_is_ignored():
    assert KT.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert KT.library_path(LK.SOURCE).parent == KT.BUILD_DIR
    assert KT.library_path(LK.SOURCE).name.startswith("liblandmark_attention-")
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "build/repro_torch/" in ignored


def _init_imports(path: Path) -> set[str]:
    """The names a package's ``__init__`` imports (``as`` names included)."""
    return {a.asname or a.name for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) for a in node.names}


# the reference's exports the port lacks on purpose, each with its reason
EXPORT_EXCEPTIONS = {
    # not ported: a CUDA tensor never degrades to another route (ROADMAP
    # queue 1)
    ("resilience", "ladder_call"),
    # the port's default profile is the H100 it runs on (H100_SXM), not a TPU
    ("analysis", "TPU_V5E"),
}


@pytest.mark.parametrize("package", ["core", "models", "analysis", "resilience"])
def test_port_exports_every_name_the_reference_exports(package):
    ref = _init_imports(ROOT / "src" / "repro" / package / "__init__.py")
    port = _init_imports(PORT / package / "__init__.py")
    missing = {n for n in ref - port if (package, n) not in EXPORT_EXCEPTIONS}
    assert not missing, f"repro_torch.{package} lacks {sorted(missing)}"
    assert all(n in ref for p, n in EXPORT_EXCEPTIONS if p == package)


def _module_defs(path: Path) -> list[str]:
    """The functions and classes a module defines at its top level."""
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))]


@pytest.mark.parametrize("module,name", [
    *(("sharding", n) for n in _module_defs(ROOT / "src" / "repro" / "sharding.py")),
    *(("launch.mesh", n) for n in _module_defs(ROOT / "src" / "repro" / "launch" / "mesh.py"))],
    ids=lambda v: v)
def test_port_defines_every_name_the_reference_sharding_defines(module, name):
    import importlib

    port = importlib.import_module(f"repro_torch.{module}")
    assert callable(getattr(port, name, None)), f"repro_torch.{module} lacks {name}"


# the dry run's modules: each reference name the port does not define, with
# its reason; the private names the port keeps
DRY_RUN_MODULES = ("analysis/hlo.py", "launch/analysis.py", "launch/specs.py",
                   "launch/dryrun.py")
DEF_EXCEPTIONS = {
    # TPU v5e's per-link ICI rate: the port's collective term divides by the
    # H100's NVLink rate (NVLINK_BW)
    ("launch/analysis.py", "ICI_BW"),
    # lowered-text donation attributes: the port checks donation on the
    # buffers themselves (repro_torch.analysis.trace.verify_donation)
    ("analysis/hlo.py", "DONATION_ATTRS"),
    ("analysis/hlo.py", "donation_attrs_present"),
}
PRIVATE_KEPT = {("launch/dryrun.py", "_active_params"), ("launch/dryrun.py", "_moe_active")}


def _top_level_names(path: Path) -> list[str]:
    """The functions, classes and module-level assignments of a module."""
    out = []
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.append(n.name)
        elif isinstance(n, ast.Assign):
            out += [t.id for t in n.targets if isinstance(t, ast.Name)]
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.append(n.target.id)
    return out


@pytest.mark.parametrize("module,name", [
    (m, n) for m in DRY_RUN_MODULES for n in _top_level_names(ROOT / "src" / "repro" / m)
    if (not n.startswith("_") or (m, n) in PRIVATE_KEPT) and (m, n) not in DEF_EXCEPTIONS],
    ids=lambda v: v)
def test_dry_run_modules_define_every_name_the_reference_defines(module, name):
    import importlib

    port = importlib.import_module("repro_torch." + module[:-3].replace("/", "."))
    assert hasattr(port, name), f"repro_torch/{module} lacks {name}"


@pytest.mark.parametrize("module", DRY_RUN_MODULES)
def test_dry_run_modules_import_no_jax_or_reference(module):
    path = PORT / module
    assert path in PORT_FILES
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib") and (not top.startswith("repro")
                                                 or top == "repro_torch"), mod
    assert all(n in _top_level_names(ROOT / "src" / "repro" / m) for m, n in DEF_EXCEPTIONS)
