"""The port stands alone: it imports no JAX, and a CUDA request without a
card raises instead of running on the CPU."""
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
             or k == "euispice_coreg_tpu" or k.startswith("euispice_coreg_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15
    assert bad.strip() == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")


def test_cuda_alignment_without_card_raises(tmp_path):
    from euispice_coreg_tpu_torch import Alignment

    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        Alignment(str(tmp_path / "a.fits"), str(tmp_path / "b.fits"),
                  device="cuda")


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
    """Tile-compressed FITS HDUs, figures, the Carrington-grid entry point
    and multi-device meshes raise NotImplementedError naming the ROADMAP."""
    from euispice_coreg_tpu_torch import Alignment, AlignmentResults
    from euispice_coreg_tpu_torch.io import fits

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fits.write(str(tmp_path / "c.fits"),
                   [fits.CompImageHDU(data=np.zeros((4, 4), np.float32))])
    # a ZIMAGE binary-table extension, as a tile-compressed file has
    cards = [fits._make_card(k, v) for k, v in (
        ("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
        ("NAXIS1", 8), ("NAXIS2", 1), ("PCOUNT", 0), ("GCOUNT", 1),
        ("ZIMAGE", True))]
    blob = fits._hdu_bytes(fits.PrimaryHDU(), primary=True) \
        + fits._serialize_header(cards) + b"\0" * 2880
    with pytest.raises(NotImplementedError, match="tile-compressed"):
        fits.open(blob)
    res = AlignmentResults(np.random.default_rng(0).normal(size=(5, 5, 1, 1,
                                                                 1)),
                           np.arange(5.0), np.arange(5.0), None, None, None,
                           "arcsec")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        res.plot_correlation()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Alignment("a", "b", path_save_figure=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Alignment("a", "b", device="cpu").align_using_carrington()
