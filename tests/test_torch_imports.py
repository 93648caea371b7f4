"""The port stands alone: no module of titan_tpu_torch, and neither
chip_smoke.py nor the port's scripts (scripts/torch_*.py), imports jax or
anything of the JAX package titan_tpu."""

import ast
import pathlib

import pytest
import torch

from titan_tpu_torch.device import next_pow2, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "titan_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "titan_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_scripts_are_scanned():
    names = {p.name for p in FILES}
    assert {"torch_bfs_breakdown.py", "torch_engine_breakdown.py",
            "seg_scan.py", "engine.py", "overlay.py"} <= names
    assert ROOT / "titan_tpu_torch" / "olap" / "live" / "__init__.py" \
        in FILES


def test_guard_sees_the_prefix_correctly():
    assert _forbidden("titan_tpu.native") and _forbidden("jax.numpy")
    assert not _forbidden("titan_tpu_torch.ops.frontier")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_titan_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_next_pow2_matches_the_jax_package_rule():
    assert [next_pow2(x) for x in (0, 1, 2, 3, 4, 5, 1023, 1024)] == \
        [2, 2, 2, 4, 4, 8, 1024, 1024]
