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
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_accum_sketch(g, 100, 8, 2)


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
    assert [f.launches for f in KT.KERNELS] == [0] * 6


def test_no_exception_handling_around_launches():
    ops = PORT / "kernels" / "accum_apply" / "ops.py"
    assert not [n for n in ast.walk(ast.parse(ops.read_text()))
                if isinstance(n, ast.Try)], "ops.py must not catch exceptions"
    kernel = PORT / "kernels" / "accum_apply" / "kernel.py"
    for node in ast.walk(ast.parse(kernel.read_text())):
        if isinstance(node, ast.Try):
            for handler in node.handlers:
                assert isinstance(handler.body[-1], ast.Raise), \
                    f"kernel.py:{handler.lineno} handles an exception without re-raising"


def test_build_dir_is_ignored():
    assert KT.BUILD_DIR == ROOT / "build" / "repro_torch"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "build/repro_torch/" in ignored
