"""The port's config reference generator (titan_tpu_torch.config.docgen)
against the JAX package's: the same page once the package is named
``titan_tpu_torch``, except the one option the port's tree changes,
``computer.backend`` (``gpu`` is the port's default computer).
``docs/config-reference.md`` stays the JAX package's page
(tests/test_config_docs.py)."""

import re
import subprocess
import sys

from titan_tpu.config.docgen import render as jax_render
from titan_tpu_torch.config import defaults as PDef
from titan_tpu_torch.config.docgen import _fmt_default, render


def _named_port(text: str) -> str:
    """The JAX page with its package names (a module path or attribute,
    ``titan_tpu/...`` or ``titan_tpu.``) made the port's; values such as
    the metric prefix ``'titan_tpu'`` stay."""
    return re.sub(r"titan_tpu(?=[./])", "titan_tpu_torch", text)


def test_render_equals_jax_with_the_package_renamed():
    want = _named_port(jax_render()).splitlines()
    got = render().splitlines()
    assert len(got) == len(want)
    diff = [(w, g) for w, g in zip(want, got) if w != g]
    opt = PDef.COMPUTER_BACKEND
    row = (f"| `computer.backend` | {opt.datatype.__name__} | "
           f"{_fmt_default(opt)} | {opt.mutability.name} | "
           f"{opt.description} |")
    assert [g for _, g in diff] == [row]
    assert [w.split("|")[1] for w, _ in diff] == [" `computer.backend` "]
    assert "`titan_tpu_torch/config/defaults.py`" in got[2]
    assert "`python -m titan_tpu_torch.config.docgen`" in got[2]
    assert "| `metrics.prefix` | str | `'titan_tpu'` |" in render()


def test_reference_covers_all_namespaces():
    md = render()
    for ns in ("storage.cluster", "storage.lock", "ids", "graph",
               "metrics.csv", "index"):
        assert f"`{ns}`" in md or f"`{ns}." in md


def test_module_prints_the_page():
    out = subprocess.run([sys.executable, "-m",
                          "titan_tpu_torch.config.docgen"],
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout == render()
    assert "import jax" not in out.stderr
