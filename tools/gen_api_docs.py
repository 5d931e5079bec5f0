#!/usr/bin/env python3
"""Generate markdown API documentation from the package's docstrings.

The reference ships a Doxygen target (/root/reference/docs/doxygen,
CMakeLists.txt `doc`); this is the equivalent for this package:
one markdown page per module under docs/api/, built purely from the
installed sources (no third-party doc tooling - the image has none).

Usage: python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import os
import pathlib
import pkgutil
import sys

_REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))

# keep heavy backends off the import path cost; CPU is fine for doc gen
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SKIP_MEMBERS = {"annotations"}


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def document_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]

    classes, functions = [], []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_") or name in SKIP_MEMBERS:
            continue
        if getattr(obj, "__module__", None) != modname:
            continue  # re-exports are documented at their home module
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            functions.append((name, obj))

    for name, cls in classes:
        lines += [f"## class `{name}{_sig(cls)}`", ""]
        if cls.__doc__:
            lines += [inspect.cleandoc(cls.__doc__), ""]
        for mname, m in sorted(vars(cls).items()):
            if mname.startswith("_") or not inspect.isfunction(m):
                continue
            lines += [f"### `{name}.{mname}{_sig(m)}`", ""]
            if m.__doc__:
                lines += [inspect.cleandoc(m.__doc__), ""]

    for name, fn in functions:
        lines += [f"## `{name}{_sig(fn)}`", ""]
        if fn.__doc__:
            lines += [inspect.cleandoc(fn.__doc__), ""]

    return "\n".join(lines) + "\n"


def main() -> int:
    import fun_ofdm_tpu

    outdir = _REPO / "docs" / "api"
    outdir.mkdir(parents=True, exist_ok=True)
    modules = ["fun_ofdm_tpu"]
    pkgdir = str(pathlib.Path(fun_ofdm_tpu.__file__).parent)
    for info in pkgutil.walk_packages([pkgdir], prefix="fun_ofdm_tpu."):
        if ".csrc" in info.name:
            continue
        modules.append(info.name)

    index = ["# fun_ofdm_tpu API reference", "",
             "Generated from docstrings by `tools/gen_api_docs.py`", ""]
    for modname in sorted(set(modules)):
        try:
            text = document_module(modname)
        except Exception as e:  # pragma: no cover - doc build diagnostics
            print(f"skip {modname}: {e}", file=sys.stderr)
            continue
        fname = modname.replace(".", "_") + ".md"
        (outdir / fname).write_text(text)
        index.append(f"- [{modname}]({fname})")
    (outdir / "README.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(modules)} pages -> docs/api/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
