"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax``, the
JAX package ``titan_tpu`` or ``bench.py``, compared by whole top-level
module name (``titan_tpu_torch`` is the system under test and passes):
by the import statements of every file under ``gbench/``, and by
``sys.modules`` after a run of the harness in a fresh process."""

import ast
import os
import subprocess
import sys

from gbench import harness, registry

BANNED = {"jax", "jaxlib", "flax", "titan_tpu", "bench"}


def _imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    here = os.path.join(registry.ROOT, "gbench")
    seen = 0
    for dirpath, _, files in os.walk(here):
        for name in files:
            if name.endswith(".py"):
                bad = _imported(os.path.join(dirpath, name)) & BANNED
                assert not bad, f"{name} imports {bad}"
                seen += 1
    assert seen > 10


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import titan_tpu_torch.olap\nfrom titan_tpu import x\n")
    assert _imported(str(p)) == {"titan_tpu_torch", "titan_tpu"}


RUN = """
import json, sys, time
from gbench import harness, registry
bench = registry.benchmark()
for name in ("g500-s25.bfs-k16", "g500-s22.pagerank-engine"):
    cell = registry.cell(bench, name)
    cfg = dict(registry.config(bench, cell["config"]), scale=9)
    mix = dict(registry.traffic(cell["traffic"]), warmup_jobs=2,
               clients=2)
    harness.run(name, cfg, mix, registry.cell_metrics(bench, name, True),
                5, 0.5, True, "cpu", time.time())
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_none_of_them():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", RUN], cwd=registry.ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "titan_tpu_torch_x", sys)
    assert "titan_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
