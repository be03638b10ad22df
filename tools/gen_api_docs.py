#!/usr/bin/env python
"""Generate docs/api.md — the public API reference.

The reference ships a Doxygen -> GitHub Pages pipeline
(/root/reference/.github/workflows/action.yaml); this is the
dependency-free analog: introspect the package and emit one markdown
file with every public module, class, and function signature plus its
docstring. CI regenerates it and fails if the checked-in copy is stale.

    python tools/gen_api_docs.py [--check]
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

MODULES = [
    "graphite_tpu",
    "graphite_tpu.precision",
    "graphite_tpu.vertices",
    "graphite_tpu.factors",
    "graphite_tpu.graph",
    "graphite_tpu.linearize",
    "graphite_tpu.loss",
    "graphite_tpu.hessian",
    "graphite_tpu.schur",
    "graphite_tpu.schur_reference",
    "graphite_tpu.covariance",
    "graphite_tpu.solvers",
    "graphite_tpu.solvers.pcg",
    "graphite_tpu.solvers.pcg_schur",
    "graphite_tpu.solvers.dense_cholesky",
    "graphite_tpu.solvers.dense_cholesky_schur",
    "graphite_tpu.solvers.sparse_direct",
    "graphite_tpu.solvers.sparse_direct_schur",
    "graphite_tpu.preconditioners",
    "graphite_tpu.optimizers",
    "graphite_tpu.optimizers.lm",
    "graphite_tpu.optimizers.gradient_descent",
    "graphite_tpu.optimizers.adam",
    "graphite_tpu.models.lie",
    "graphite_tpu.models.bal",
    "graphite_tpu.models.pose_graph",
    "graphite_tpu.parallel.sharding",
    "graphite_tpu.io.bal",
    "graphite_tpu.io.g2o",
    "graphite_tpu.io.synthetic",
    "graphite_tpu.io.checkpoint",
    "graphite_tpu.ops.blocked_cholesky",
    "graphite_tpu.ops.streamreduce",
    "graphite_tpu.ops.blockfmt",
    "graphite_tpu.ops.segment",
    "graphite_tpu.ops.batched_linalg",
    "graphite_tpu.perf",
    "graphite_tpu.runtime",
    "graphite_tpu.hostops",
]


def _doc(obj, indent: str = "") -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + line for line in d.splitlines())


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # only document objects defined in this module (skip re-exports,
        # except in package __init__s which exist to re-export)
        owner = getattr(obj, "__module__", mod.__name__)
        is_pkg = mod.__file__.endswith("__init__.py")
        if not is_pkg and owner != mod.__name__:
            continue
        out.append((n, obj))
    return out


def generate() -> str:
    lines = [
        "# graphite_tpu API reference",
        "",
        "Auto-generated by `tools/gen_api_docs.py` — do not edit by hand.",
        "See `docs/guide.md` for the narrative guide (vertex/factor trait",
        "authoring, solver and optimizer selection).",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        lines.append(f"## `{modname}`")
        lines.append("")
        md = _doc(mod)
        if md:
            lines.append(md.split("\n\n")[0])
            lines.append("")
        seen_funcs = []
        for name, obj in _public_members(mod):
            if inspect.isclass(obj):
                lines.append(f"### class `{modname}.{name}`")
                lines.append("")
                d = _doc(obj)
                if d:
                    lines.append(d)
                    lines.append("")
                methods = [
                    (mn, m) for mn, m in inspect.getmembers(obj)
                    if not mn.startswith("_")
                    and (inspect.isfunction(m) or isinstance(
                        m, property))
                ]
                for mn, m in methods:
                    if isinstance(m, property):
                        lines.append(f"- `{mn}` (property)"
                                     + (f" — {inspect.getdoc(m).splitlines()[0]}"
                                        if inspect.getdoc(m) else ""))
                    else:
                        first = (inspect.getdoc(m) or "").split("\n")[0]
                        lines.append(f"- `{mn}{_sig(m)}`"
                                     + (f" — {first}" if first else ""))
                if methods:
                    lines.append("")
                if inspect.isclass(obj) and hasattr(obj,
                                                    "__dataclass_fields__"):
                    flds = ", ".join(obj.__dataclass_fields__)
                    lines.append(f"Fields: `{flds}`")
                    lines.append("")
            elif inspect.isfunction(obj):
                seen_funcs.append((name, obj))
            else:
                # module-level constants / precision policies
                rep = repr(obj)
                if len(rep) > 80:
                    rep = rep[:77] + "..."
                lines.append(f"- constant `{name}` = `{rep}`")
        for name, obj in seen_funcs:
            lines.append(f"### `{modname}.{name}{_sig(obj)}`")
            lines.append("")
            d = _doc(obj)
            if d:
                lines.append(d)
                lines.append("")
        lines.append("")
    return "\n".join(lines) + "\n"


def main() -> int:
    out_path = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                            "api.md")
    out_path = os.path.abspath(out_path)
    text = generate()
    if "--check" in sys.argv:
        with open(out_path) as f:
            if f.read() != text:
                print("docs/api.md is stale: run python tools/gen_api_docs.py")
                return 1
        print("docs/api.md is up to date")
        return 0
    with open(out_path, "w") as f:
        f.write(text)
    print(f"wrote {out_path} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
