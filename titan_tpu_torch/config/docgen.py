"""Config reference generator: the typed option tree -> markdown.

The reference ships a static config surface with its distribution
(titan-dist/src/assembly/static/conf/ + the ~200 options declared in
GraphDatabaseConfiguration.java); here the single source of truth is the
option tree itself (config/defaults.py), and the docs page is GENERATED
from it so it can never drift — tests/test_config_docs.py regenerates and
compares the JAX package's page.

The port's copy of ``titan_tpu/config/docgen.py``, over the port's option
tree: ``python -m titan_tpu_torch.config.docgen`` prints the page (or
call :func:`render`). Its text is the JAX package's with the package
named ``titan_tpu_torch``; the option tree differs in
``computer.backend`` (``gpu`` is the port's default computer).
``docs/config-reference.md`` stays the JAX package's page.
"""

from __future__ import annotations

from titan_tpu_torch.config.options import ConfigNamespace, ConfigOption


def _walk(ns: ConfigNamespace, path: str = ""):
    opts, subs = [], []
    for child in sorted(ns.children(), key=lambda c: c.name):
        if isinstance(child, ConfigNamespace):
            subs.append(child)
        else:
            opts.append(child)
    yield path, ns, opts
    for sub in subs:
        sub_path = f"{path}.{sub.name}" if path else sub.name
        yield from _walk(sub, sub_path)


def _cell(text: str) -> str:
    """Escape table-breaking characters in a markdown cell."""
    return str(text).replace("|", "\\|")


def _fmt_default(opt: ConfigOption) -> str:
    d = opt.default
    if d is None:
        return "(none)"
    if isinstance(d, str):
        return _cell(f"`{d!r}`")
    return _cell(f"`{d}`")


def render() -> str:
    from titan_tpu_torch.config import defaults as d

    lines = [
        "# Configuration reference",
        "",
        "GENERATED from the typed option tree (`titan_tpu_torch/config/"
        "defaults.py`) by `python -m titan_tpu_torch.config.docgen` — do "
        "not "
        "edit by hand; `tests/test_config_docs.py` enforces sync.",
        "",
        "Options are set via `titan_tpu_torch.open({...})` dicts, "
        "properties "
        "files, or the management system (GLOBAL options live in the "
        "storage backend itself and merge at open — reference: "
        "KCVSConfiguration over the system_properties store, "
        "Backend.java:273-298).",
        "",
        "Mutability levels (reference: ConfigOption.java): **LOCAL** = "
        "per-instance, from local config only; **MASKABLE** = local "
        "value overrides the global one; **GLOBAL** = cluster-wide, "
        "changed online via the management system; **GLOBAL_OFFLINE** = "
        "cluster-wide, all instances must be down to change; **FIXED** = "
        "set at cluster creation, immutable.",
        "",
    ]
    for path, ns, opts in _walk(d.ROOT):
        if not opts:
            continue
        title = path or "(root)"
        lines.append(f"## `{title}` — {ns.description}")
        lines.append("")
        lines.append("| option | type | default | mutability | "
                     "description |")
        lines.append("|---|---|---|---|---|")
        for opt in opts:
            full = f"{path}.{opt.name}" if path else opt.name
            lines.append(
                f"| `{full}` | {opt.datatype.__name__} | "
                f"{_fmt_default(opt)} | {opt.mutability.name} | "
                f"{_cell(opt.description)} |")
        lines.append("")
    return "\n".join(lines) + "\n"


def main() -> None:
    print(render(), end="")


if __name__ == "__main__":
    main()
