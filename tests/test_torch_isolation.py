"""The port stands alone: it and its examples import no JAX (nor
matplotlib until a figure is drawn), it builds its codecs from its own
sources into its own build directory, and a CUDA request without a card
raises instead of running on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import euispice_coreg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k == "euispice_coreg_tpu" or k.startswith("euispice_coreg_tpu.")
             or k == "matplotlib" or k.startswith("matplotlib."))
print(len(names), names, bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(" ", 1)
    names, bad = rest.rsplit("] [", 1)
    assert int(n) >= 15
    for mod in ("io.native", "io.tile_compression", "plot.plot",
                "utils.util_compat", "engine.tile_fft", "core.transforms",
                "utils.matrix_transform", "utils.mesh"):
        assert f"'euispice_coreg_tpu_torch.{mod}'" in names, mod
    assert bad.strip() == "]"


def test_chip_smoke_imports_no_jax_nor_matplotlib():
    """chip_smoke.py, and every module of the port it reaches, import
    neither JAX, the JAX package nor matplotlib (the card's machine has
    none of them)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    top = {name.split(".")[0] for name in imported}
    assert not top & {"jax", "jaxlib", "euispice_coreg_tpu", "matplotlib"}
    env = dict(os.environ, PYTHONPATH=REPO)
    code = ("import sys, chip_smoke; " + "; ".join(
        f"import {m}" for m in sorted(imported)
        if m.startswith("euispice_coreg_tpu_torch")) + "; print(sorted("
        "k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'euispice_coreg_tpu', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


EXAMPLES = os.path.join(REPO, "examples")
PORT_EXAMPLES = ("_synthetic_torch", "demo_synthetic_torch",
                 "align_hri_fsi_torch", "align_spice_synras_torch",
                 "jitter_movie_torch")
_FORBIDDEN = ("jax", "jaxlib", "euispice_coreg_tpu", "matplotlib")

_RUN_EXAMPLES = """
import os, sys
sys.path.insert(0, {examples!r})
for name in {names!r}:
    module = __import__(name)
    if name != "_synthetic_torch":
        module.main(["--device", "cpu", os.path.join({tmp!r}, name)])
print(sorted(k for k in sys.modules if k.split(".")[0] in {forbidden!r}))
"""


def test_examples_import_no_jax_nor_matplotlib(tmp_path):
    """The port's examples (``examples/*_torch.py``) and their generators
    import neither JAX, the JAX package nor matplotlib, at import nor in a
    whole run of each without ``--figures`` (on the CPU)."""
    import ast

    for name in PORT_EXAMPLES:
        with open(os.path.join(EXAMPLES, name + ".py")) as f:
            tree = ast.parse(f.read())
        top = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                top.add(node.module.split(".")[0])
        assert not top & set(_FORBIDDEN), (name, top & set(_FORBIDDEN))
    code = _RUN_EXAMPLES.format(examples=EXAMPLES, names=PORT_EXAMPLES,
                                tmp=str(tmp_path), forbidden=_FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_FIGURES = """
import sys
if {block}:
    sys.modules["matplotlib"] = None   # as if matplotlib were not installed
sys.path.insert(0, {examples!r})
import align_hri_fsi_torch
try:
    out = align_hri_fsi_torch.main(["--device", "cpu", "--figures", {tmp!r}])
except ImportError as exc:
    print("ImportError", exc)
else:
    print(out["paths"]["correlation"], "matplotlib" in sys.modules)
"""


@pytest.mark.parametrize("block", [False, True])
def test_examples_figures_only_when_asked(tmp_path, block):
    """``--figures`` draws the correlation figure with matplotlib; without
    matplotlib it raises ``ImportError`` rather than skipping the
    figure."""
    code = _FIGURES.format(block=block, examples=EXAMPLES, tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    if block:
        assert last.startswith("ImportError")
        assert not os.path.exists(tmp_path / "correlation.png")
    else:
        assert last == f"{tmp_path / 'correlation.png'} True"
        assert os.path.getsize(tmp_path / "correlation.png") > 0


def _tree_state(root):
    state = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            state[path] = os.stat(path).st_mtime_ns
    return state


def test_codec_build_stays_in_the_port(tmp_path):
    """The port's codecs build from ``euispice_coreg_tpu_torch/io/native/``
    with g++ into the build directory (here redirected to a temporary
    one), under a name keyed by the sources and flags, and write nothing
    under ``euispice_coreg_tpu/``."""
    jax_pkg = os.path.join(REPO, "euispice_coreg_tpu")
    before = _tree_state(jax_pkg)
    code = f"""
import numpy as np
from euispice_coreg_tpu_torch.io import native
native.BUILD_DIR = {str(tmp_path)!r}
a = np.arange(-50, 50, dtype=np.int32)
assert (native.rice_decode(native.rice_encode(a), a.size) == a).all()
print(native.library_path())
print(" ".join(native._SRCS))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib, srcs = out.stdout.strip().splitlines()
    assert os.path.dirname(lib) == str(tmp_path) and os.path.isfile(lib)
    assert os.listdir(tmp_path) == [os.path.basename(lib)]  # no temp left
    native_dir = os.path.join(REPO, "euispice_coreg_tpu_torch", "io",
                              "native")
    assert [os.path.dirname(s) for s in srcs.split()] == [native_dir] * 3
    assert _tree_state(jax_pkg) == before


def test_codec_build_key_follows_sources(monkeypatch):
    """The library name changes with a source or a flag, and the default
    build directory is the port's git-ignored ``build/``."""
    from euispice_coreg_tpu_torch.io import native

    assert native.BUILD_DIR == os.path.join(REPO, "euispice_coreg_tpu_torch",
                                            "build")
    key = native.build_key()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.build_key() != key


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")


def test_cuda_alignment_without_card_raises(tmp_path):
    from euispice_coreg_tpu_torch import Alignment

    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        Alignment(str(tmp_path / "a.fits"), str(tmp_path / "b.fits"),
                  device="cuda")


def test_cuda_spice_entry_points_without_card_raise(tmp_path):
    """The SPICE entry points with device='cuda' raise before any file is
    read (the paths do not exist)."""
    from euispice_coreg_tpu_torch.hdrshift import (
        AlignementSpiceIterativeContextRaster, AlignmentSpice)
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice_selector import \
        AlignmentSpiceSelector
    from euispice_coreg_tpu_torch.pxlshift import AlignmentSpicePixel
    from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder

    _no_card()
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "solo_L2_b.fits")
    calls = [
        lambda: AlignmentSpice(a, b, device="cuda"),
        lambda: AlignementSpiceIterativeContextRaster([a], b, 60.0,
                                                      device="cuda"),
        lambda: SPICEComposedMapBuilder(b, [a], 60.0, device="cuda"),
        lambda: AlignmentSpicePixel(a, 0, b, 0, device="cuda"),
        lambda: AlignmentSpiceSelector(b, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_cuda_kernel_call_without_card_raises():
    """No CPU fallback: the K1 entry point with device='cuda' raises, and a
    tensor on neither the CPU nor a card reaches no plain version."""
    from euispice_coreg_tpu_torch.engine import lag_search, warp_score

    _no_card()
    img = np.ones((16, 16))
    base = {"crval1": 0.0, "crval2": 0.0, "crpix1": 8.0, "crpix2": 8.0,
            "cdelt1": 1e-3, "cdelt2": 1e-3, "pc11": 1.0, "pc12": 0.0,
            "pc21": 0.0, "pc22": 1.0, "crota": 0.0}
    lags = ([0.0], [0.0], [0.0], [0.0], [0.0])
    with pytest.raises(RuntimeError, match="cuda"):
        warp_score.evaluate_lag_grid_warp(img, img, img, img, base, *lags,
                                          device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        lag_search.evaluate_lag_grid(img, img, img, img, base, *lags,
                                     device="cuda", allow_fast="pallas")
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no kernel"):
        warp_score.warp_score_sums(
            torch.empty(20, 20, **meta), torch.empty(16, 16, **meta),
            torch.empty(16, 16, **meta), torch.empty(16, 16, **meta),
            torch.empty(1, 10, **meta), pad=2, order=2, kind="tan")


def test_not_ported_parts_raise(tmp_path):
    """Nothing is left unported: tile-compressed FITS, figures, the
    Carrington tile-FFT evaluator and meshes of several devices run.  A
    mesh of two devices (frame- and tile-axis sharding) gives the
    unsharded result, and the port holds no refusal of a mesh."""
    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.hdrshift import results
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.utils import torchcfg

    assert not hasattr(fits, "_TILE_COMPRESSED")
    assert not hasattr(results, "PLOT_NOT_PORTED")
    fits.write(str(tmp_path / "c.fits"),
               [fits.CompImageHDU(data=np.zeros((4, 4), np.float32))])
    assert isinstance(fits.open(str(tmp_path / "c.fits"))[1],
                      fits.CompImageHDU)
    Alignment("a", "b", path_save_figure=str(tmp_path), device="cpu")
    from euispice_coreg_tpu_torch.engine import carrington

    hdr = {"CRVAL1": 0.0, "CRVAL2": 0.0, "CDELT1": 2.0, "CDELT2": 2.0,
           "CRPIX1": 8.0, "CRPIX2": 8.0, "CROTA": 0.0, "DSUN_OBS": 7.5e10,
           "CRLN_OBS": 120.0, "CRLT_OBS": 0.0}
    img = np.ones((16, 16))
    assert not hasattr(carrington, "TILE_FFT_NOT_PORTED")
    out = carrington.evaluate_lag_grid_carrington(
        img, img, hdr, (119.0, 121.0), (-1.0, 1.0), (16, 16), [0.0],
        [0.0], [0.0], [0.0], [0.0], device="cpu", lag_mode="tile_fft")
    assert out.shape == (1, 1, 1, 1, 1)
    # a mesh of two devices: the unsharded result
    from euispice_coreg_tpu_torch.engine import fast_corr, tile_fft

    assert not hasattr(torchcfg, "MESH_NOT_PORTED")
    assert not hasattr(torchcfg, "check_single_device_mesh")
    two = [torch.device("cpu")] * 2
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(3, 16, 16)) + 10.0
    cs = rng.uniform(-1.0, 1.0, size=(3, 4, 2))
    kw = dict(device="cpu", compute_dtype="float64")
    np.testing.assert_allclose(
        fast_corr.evaluate_movie_from_displacements(frames, frames[::-1], cs,
                                                    mesh=two, **kw),
        fast_corr.evaluate_movie_from_displacements(frames, frames[::-1], cs,
                                                    **kw), rtol=0, atol=1e-12)
    coeffs = np.zeros((3, 6, 2))
    coeffs[:, 2, 0] = [-1.0, 0.0, 1.0]
    kw = dict(order=2, h=16, w=16, device="cpu", compute_dtype="float64",
              tile_size=8)
    np.testing.assert_allclose(
        tile_fft.evaluate_select_tile_fft(coeffs, frames[0], frames[1],
                                          mesh=two, **kw),
        tile_fft.evaluate_select_tile_fft(coeffs, frames[0], frames[1], **kw),
        rtol=0, atol=1e-12)
