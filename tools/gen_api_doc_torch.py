"""Generate docs/API_torch.md, the API reference of euispice_coreg_tpu_torch,
from the port's signatures and docstrings.

Usage:  python tools/gen_api_doc_torch.py > docs/API_torch.md
        python tools/gen_api_doc_torch.py --check
  --check: exit 1 if docs/API_torch.md differs from what would be written.

Imports only the port (never jax nor the JAX package), so it runs on a
machine with PyTorch alone.  The sections mirror tools/gen_api_doc.py's; the
closing sections print the tables of euispice_coreg_tpu_torch/surface.py:
the parameters the port adds and what it did not carry over.
"""
import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from euispice_coreg_tpu_torch import surface  # noqa: E402

DOC = os.path.join(ROOT, "docs", "API_torch.md")
PKG = "euispice_coreg_tpu_torch"

# (title, module, names or None for every public callable of the module);
# a dotted name is a path under the package.
SECTIONS = [
    (f"Header-shift alignment — `{PKG}.hdrshift`",
     f"{PKG}.hdrshift",
     ["Alignment", "AlignmentSpice", "AlignementSpiceIterativeContextRaster",
      "AlignmentResults"]),
    ("Selector-driven SPICE alignment",
     f"{PKG}.hdrshift.alignment_spice_selector", None),
    (f"Synthetic rasters — `{PKG}.synras`",
     f"{PKG}.synras",
     ["MapBuilder", "ComposedMapBuilder", "SPICEComposedMapBuilder"]),
    (f"Pixel-space alignment — `{PKG}.pxlshift`",
     f"{PKG}.pxlshift",
     ["AlignmentPixels", "AlignmentSpicePixel"]),
    (f"Jitter correction — `{PKG}.jitter_correction`",
     f"{PKG}.jitter_correction",
     ["jitter_correction_imagers", "align_movie_to_reference"]),
    (f"Data selector — `{PKG}.selector`",
     f"{PKG}.selector",
     ["Selector", "SelectorEui", "SelectorSpice"]),
    (f"Plotting — `{PKG}.plot.plot`",
     f"{PKG}.plot.plot", None),
    (f"FITS I/O — `{PKG}.io.fits`",
     f"{PKG}.io.fits", None),
    (f"Engine (advanced) — `{PKG}.engine.lag_search`",
     f"{PKG}.engine.lag_search",
     ["evaluate_lag_grid", "utils.mesh.resolve_mesh",
      "utils.mesh.default_mesh", "utils.mesh.split", "utils.mesh.replicate",
      "utils.mesh.round_robin", "utils.mesh.gather"]),
]


class _Named:
    """A default shown by name: a module's repr holds its install path."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


def sig_of(obj):
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return "(...)"
    params = [p.replace(default=_Named(p.default.__name__))
              if inspect.ismodule(p.default) else p
              for p in sig.parameters.values()]
    return str(sig.replace(parameters=params))


def own_doc(obj):
    """First paragraph of the object's OWN docstring (no MRO inheritance
    for classes; function objects never inherit docstrings)."""
    raw = vars(obj).get("__doc__") if inspect.isclass(obj) else obj.__doc__
    if not raw:
        return ""
    out = []
    for line in inspect.cleandoc(raw).splitlines():
        line = line.strip()
        if not line:
            if out:
                break
            continue
        out.append(line)
    return " ".join(out)


def resolve(mod, name):
    """``(shown name, object)`` for a name of ``mod`` or a dotted path
    under the package."""
    if "." not in name:
        return name, getattr(mod, name, None)
    modpath, attr = name.rsplit(".", 1)
    owner = importlib.import_module(f"{PKG}.{modpath}")
    return attr, getattr(owner, attr, None)


def render():
    out = []
    emit = out.append
    emit("# Public API reference — the PyTorch port\n")
    emit("Generated from docstrings (`python tools/gen_api_doc_torch.py > "
         "docs/API_torch.md`).")
    emit(f"`{PKG}` has the public surface of `euispice_coreg_tpu` "
         "(docs/API.md) at the same import paths;")
    emit("`tests/test_torch_api_surface.py` holds the two to each other. "
         "Entry points take `device=`")
    emit("(a card unless the caller asks for `\"cpu\"`) and, where work "
         "splits, `mesh=` (a sequence of devices).\n")
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        if names is None:
            names = [n for n, o in vars(mod).items()
                     if not n.startswith("_") and callable(o)
                     and getattr(o, "__module__", "").startswith(modname)]
        emit(f"## {title}\n")
        for name in names:
            shown, obj = resolve(mod, name)
            if obj is None:
                continue
            where = (f" — `{name.rsplit('.', 1)[0]}`" if "." in name else "")
            if inspect.isclass(obj):
                emit(f"### `{shown}`{where}\n")
                if own_doc(obj):
                    emit(own_doc(obj) + "\n")
                emit(f"```python\n{shown}{sig_of(obj)}\n```\n")
                for mn, mo in inspect.getmembers(
                        obj, predicate=inspect.isfunction):
                    if mn.startswith("_"):
                        continue
                    tag = " *(inherited)*" if mn not in vars(obj) else ""
                    emit(f"- **`{mn}{sig_of(mo)}`**{tag} — {own_doc(mo)}")
                emit("")
            else:
                emit(f"### `{shown}{sig_of(obj)}`{where}\n")
                emit(own_doc(obj) + "\n")
    emit("## Parameters the port adds\n")
    emit("Allowed on any counterpart of a JAX package function:\n")
    for name, reason in surface.EXTRA_PARAMETERS.items():
        emit(f"- `{name}` — {reason}")
    emit("\nAdded to one function:\n")
    for path, reason in surface.PARAMETER_DIFFERENCES.items():
        emit(f"- `{path}` — {reason}")
    emit("\n## Not carried over\n")
    emit("Layers of `euispice_coreg_tpu` that only the TPU needed "
         "(`euispice_coreg_tpu_torch/surface.py`).\n")
    emit("| JAX package path | Why | In the port |")
    emit("|---|---|---|")
    for path, (reason, replacement) in surface.NOT_CARRIED_OVER.items():
        emit(f"| `{path}` | {reason} | {replacement or '—'} |")
    return "\n".join(out) + "\n"


def main(argv):
    text = render()
    if "--check" in argv:
        try:
            with open(DOC) as f:
                current = f.read()
        except FileNotFoundError:
            current = None
        if current != text:
            print(f"{DOC} is stale: run python tools/gen_api_doc_torch.py > "
                  "docs/API_torch.md", file=sys.stderr)
            return 1
        print(f"{DOC} is fresh")
        return 0
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
