"""The port's public surface holds the JAX package's.

Every module of ``euispice_coreg_tpu`` is walked.  Each public function,
class and method (defined in the module, listed in its ``__all__``, or
re-exported by a package) has a counterpart at the same path in
``euispice_coreg_tpu_torch``, or stands in the one table of things not
carried over (``euispice_coreg_tpu_torch/surface.py``).  Each counterpart
takes the JAX package's parameters in the same order, of the same kind and
with equal defaults; a positional call binds the same arguments in both.
It may add only the parameters of ``surface.EXTRA_PARAMETERS``, or one that
``surface.PARAMETER_DIFFERENCES`` names for that function.  Defaults that
name a dtype compare by name (``jnp.float32`` equals ``"float32"``), and
the array namespace ``jax.numpy`` equals ``torch``.

The API reference of the port, ``docs/API_torch.md``, is generated from the
same surface by ``tools/gen_api_doc_torch.py``, and must be fresh.
"""
import ast
import importlib
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from euispice_coreg_tpu_torch import surface

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "euispice_coreg_tpu", "euispice_coreg_tpu_torch"
_EMPTY = inspect.Parameter.empty
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _jax_modules():
    """(path relative to the package, is a package) of every ``.py`` file
    of the JAX package, found on disk so that collection imports nothing."""
    root = os.path.join(REPO, JAX)
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        rel = os.path.relpath(dirpath, root).replace(os.sep, ".")
        rel = "" if rel == "." else rel
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            if name == "__init__.py":
                out.append((rel, True))
            else:
                stem = name[:-3]
                out.append((f"{rel}.{stem}" if rel else stem, False))
    return sorted(out)


MODULES = _jax_modules()


def _full(rel, pkg):
    return f"{pkg}.{rel}" if rel else pkg


def _dropped(path):
    """The table entry that covers ``path`` (itself or a module above it)."""
    parts = path.split(".")
    for k in range(len(parts), 0, -1):
        key = ".".join(parts[:k])
        if key in surface.NOT_CARRIED_OVER:
            return key
    return None


def public_names(mod, rel, is_pkg):
    """Public functions and classes of a JAX module: defined there, listed
    in its ``__all__``, or (for a package) re-exported from the package."""
    listed = set(getattr(mod, "__all__", ()))
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        owner = getattr(obj, "__module__", "") or ""
        if (owner == mod.__name__ or name in listed
                or (is_pkg and owner.startswith(JAX + "."))):
            out[name] = obj
    return out


def public_members(cls):
    """Public methods and properties of a class, inherited ones included."""
    return {name: obj for name, obj in inspect.getmembers(cls)
            if not name.startswith("_")
            and (inspect.isroutine(obj) or isinstance(
                inspect.getattr_static(cls, name, None), property))}


def norm_default(value):
    """A default as compared across the packages: dtypes by name, the
    array namespace (``jax.numpy`` or ``torch``) as one token."""
    if value is _EMPTY:
        return value
    if inspect.ismodule(value):
        if value.__name__ in ("jax.numpy", "torch"):
            return "<array namespace>"
        return value.__name__
    if isinstance(value, torch.dtype):
        return str(value).rsplit(".", 1)[-1]
    if isinstance(value, np.dtype):
        return value.name
    if isinstance(value, type) and hasattr(value, "dtype"):
        return np.dtype(value).name          # jnp.float32 and kin
    return value


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True                           # nan
    try:
        return bool(a == b)
    except Exception:
        return repr(a) == repr(b)


def signature_problems(path, jax_obj, port_obj):
    """What keeps ``port_obj``'s signature from holding ``jax_obj``'s; an
    empty list when it does."""
    try:
        js = inspect.signature(jax_obj)
    except (TypeError, ValueError):
        return []
    try:
        ts = inspect.signature(port_obj)
    except (TypeError, ValueError):
        return [f"{path}: no signature in the port"]
    jp = [p for p in js.parameters.values()
          if f"{path}({p.name})" not in surface.NOT_CARRIED_OVER]
    tp = ts.parameters
    jnames = [p.name for p in jp]
    problems = []
    missing = [n for n in jnames if n not in tp]
    if missing:
        problems.append(f"{path}: the port lacks {missing}")
    common = [n for n in tp if n in jnames]
    if common != [n for n in jnames if n in tp]:
        problems.append(f"{path}: order {common} != {jnames}")
    jpos = [p.name for p in jp if p.kind in _POSITIONAL]
    tpos = [n for n, p in tp.items() if p.kind in _POSITIONAL]
    if tpos[:len(jpos)] != jpos:
        problems.append(f"{path}: positional {tpos} do not start with {jpos}")
    for p in jp:
        q = tp.get(p.name)
        if q is None:
            continue
        if q.kind != p.kind:
            problems.append(f"{path}({p.name}): kind {q.kind} != {p.kind}")
        if not _same(norm_default(p.default), norm_default(q.default)):
            problems.append(f"{path}({p.name}): default {q.default!r} != "
                            f"{p.default!r}")
    for name in tp:
        if name in jnames or name in surface.EXTRA_PARAMETERS:
            continue
        if f"{path}({name})" not in surface.PARAMETER_DIFFERENCES:
            problems.append(f"{path}: extra parameter {name!r}")
    return problems


def module_problems(rel, is_pkg):
    """Every gap between the JAX module ``rel`` and its port."""
    mod = importlib.import_module(_full(rel, JAX))
    if _dropped(rel) is not None:
        return []
    try:
        tmod = importlib.import_module(_full(rel, PORT))
    except ImportError as exc:
        return [f"{rel or PORT}: module missing ({exc})"]
    problems = []
    for name, obj in public_names(mod, rel, is_pkg).items():
        path = f"{rel}.{name}" if rel else name
        if _dropped(path) is not None:
            continue
        tobj = getattr(tmod, name, None)
        if tobj is None:
            problems.append(f"{path}: missing")
            continue
        if inspect.isclass(obj) != inspect.isclass(tobj):
            problems.append(f"{path}: class in one package only")
            continue
        problems += signature_problems(path, obj, tobj)
        if not inspect.isclass(obj):
            continue
        for mname, mobj in public_members(obj).items():
            mpath = f"{path}.{mname}"
            if _dropped(mpath) is not None:
                continue
            if not hasattr(tobj, mname):
                problems.append(f"{mpath}: missing")
            elif inspect.isroutine(mobj):
                problems += signature_problems(mpath, mobj,
                                               getattr(tobj, mname))
    return problems


@pytest.mark.parametrize("rel,is_pkg", MODULES,
                         ids=[rel or JAX for rel, _ in MODULES])
def test_module_surface_holds_the_jax_package(rel, is_pkg):
    assert module_problems(rel, is_pkg) == []


def _exists_in(pkg, path):
    """Whether the dotted ``path`` (module, then attributes) resolves
    under ``pkg``."""
    parts = path.split(".")
    for k in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(_full(".".join(parts[:k]), pkg))
        except ImportError:
            continue
        for attr in parts[k:]:
            if not hasattr(obj, attr):
                return False
            obj = getattr(obj, attr)
        return True
    return False


def _split_param(path):
    head, _, name = path.partition("(")
    return head, name.rstrip(")")


def test_tables_name_only_real_gaps():
    """Each entry names what the JAX package has and the port lacks, with a
    reason and a replacement that exists; each parameter difference names
    a parameter the port has and the JAX package lacks."""
    for path, (reason, replacement) in surface.NOT_CARRIED_OVER.items():
        assert reason, path
        if "(" in path:
            head, name = _split_param(path)
            jobj = importlib.import_module(f"{JAX}.{head.rsplit('.', 1)[0]}")
            jobj = getattr(jobj, head.rsplit(".", 1)[1])
            tobj = getattr(importlib.import_module(
                f"{PORT}.{head.rsplit('.', 1)[0]}"), head.rsplit(".", 1)[1])
            assert name in inspect.signature(jobj).parameters, path
            assert name not in inspect.signature(tobj).parameters, path
        else:
            assert _exists_in(JAX, path), path
            assert not _exists_in(PORT, path), path
        for target in re.findall(r"\b(?:core|engine|utils)\.[\w.]*\w",
                                 replacement or ""):
            assert _exists_in(PORT, target), (path, target)
        for target in re.findall(r"\bcsrc/[\w.]+", replacement or ""):
            assert os.path.isfile(os.path.join(REPO, PORT, target)), target
    for path, reason in surface.PARAMETER_DIFFERENCES.items():
        assert reason, path
        head, name = _split_param(path)
        mod, fn = head.rsplit(".", 1)
        tparams = inspect.signature(
            getattr(importlib.import_module(f"{PORT}.{mod}"), fn)).parameters
        jparams = inspect.signature(
            getattr(importlib.import_module(f"{JAX}.{mod}"), fn)).parameters
        assert name in tparams and name not in jparams, path
    assert set(surface.EXTRA_PARAMETERS) == {"device", "mesh", "as_numpy"}


def _jax_f(a, b=1, *, c="float32", d=None):
    """Stand-in for a JAX package function."""


def _port_ok(a, b=1, *, device, c="float32", d=None, mesh=None):
    """A counterpart that holds it."""


def _port_missing(a, b=1, *, c="float32"):
    """Lacks ``d``."""


def _port_reordered(a, b=1, *, d=None, c="float32"):
    """Keyword-only parameters out of order."""


def _port_default(a, b=1, *, c="float64", d=None):
    """Another default."""


def _port_extra(a, b=1, *, c="float32", d=None, tile_batch=None):
    """A parameter of no table."""


def _port_shifted(a, device=None, b=1, *, c="float32", d=None):
    """An extra positional parameter that moves ``b``."""


def _port_kind(a, *, b=1, c="float32", d=None):
    """``b`` keyword-only."""


@pytest.mark.parametrize("port,bad", [
    (_port_ok, False), (_port_missing, True), (_port_reordered, True),
    (_port_default, True), (_port_extra, True), (_port_shifted, True),
    (_port_kind, True)])
def test_signature_check_catches_drift(port, bad):
    """The rule itself: each kind of drift is reported, and a counterpart
    that only adds allowed parameters is not."""
    assert bool(signature_problems("x.f", _jax_f, port)) == bad


def test_defaults_compare_dtypes_by_name():
    import jax.numpy as jnp

    assert norm_default(jnp.float32) == norm_default("float32") \
        == norm_default(torch.float32) == norm_default(np.dtype("float32"))
    assert norm_default(jnp.float64) != norm_default("float32")
    assert norm_default(jnp) == norm_default(torch)
    assert norm_default(np) != norm_default(torch)


def test_api_doc_fresh():
    """``docs/API_torch.md`` is what ``tools/gen_api_doc_torch.py`` writes
    now: regenerate it with ``python tools/gen_api_doc_torch.py >
    docs/API_torch.md``."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "gen_api_doc_torch.py"),
         "--check"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_api_doc_covers_every_section_and_the_table():
    """Each section of the JAX package's reference has a section in the
    port's, with the port's module paths, and the doc ends with every
    entry of the table."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        gen = importlib.import_module("gen_api_doc_torch")
    finally:
        sys.path.pop(0)
    with open(os.path.join(REPO, "tools", "gen_api_doc.py")) as f:
        tree = ast.parse(f.read())
    jax_sections = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", None) == "SECTIONS")
    assert [m.replace(JAX, PORT, 1) for _, m, _ in jax_sections] == \
        [modname for _, modname, _ in gen.SECTIONS]
    for (_, _, jnames), (_, _, tnames) in zip(jax_sections, gen.SECTIONS):
        kept = [n for n in jnames or () if n not in ("default_mesh",
                                                     "mesh_put")]
        assert (jnames is None) == (tnames is None)
        assert kept == [n for n in tnames or () if "." not in n]
    with open(os.path.join(REPO, "docs", "API_torch.md")) as f:
        doc = f.read()
    tail = doc[doc.index("## Not carried over"):]
    for path in surface.NOT_CARRIED_OVER:
        assert f"`{path}`" in tail, path
    for name in ("evaluate_lag_grid", "default_mesh", "replicate", "split"):
        assert f"`{name}(" in doc, name
    assert "device" in doc and "mesh=None" in doc
