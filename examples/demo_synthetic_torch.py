"""Self-contained, self-verifying demo of the PyTorch port: no archive data.

Synthesizes a reference/mispointed image pair with an exactly known
pointing error, writes them as FITS, runs the helioprojective and
Carrington alignments through the public API of
``euispice_coreg_tpu_torch``, and checks the recovered shift.  Runs on a
CUDA card by default; ``--device cpu`` runs it on the CPU.

    python3 examples/demo_synthetic_torch.py [output_dir] [--device cpu]
        [--figures]

Without ``output_dir`` the files go to a new temporary directory.
``--figures`` also saves the correlation figure (needs matplotlib).  Exits
0 when the injected shift is recovered within 1 arcsec (prints ``OK``),
else 1 (``MISMATCH``).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

# run from a checkout: the package sits beside examples/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from euispice_coreg_tpu_torch.hdrshift import Alignment  # noqa: E402
from euispice_coreg_tpu_torch.io import fits  # noqa: E402
from euispice_coreg_tpu_torch.utils import coords  # noqa: E402
from euispice_coreg_tpu_torch.utils.torchcfg import resolve_device  # noqa: E402

import _synthetic_torch as synth  # noqa: E402

TRUE_SHIFT = (8.0, -4.0)  # arcsec: the pointing error injected into hdr
LAG_CRVAL1 = np.arange(2.0, 15.0, 1.0)
LAG_CRVAL2 = np.arange(-10.0, 3.0, 1.0)
CARRINGTON_GRID = dict(lonlims=(117.0, 123.0), latlims=(-1.0, 7.0),
                       shape=(128, 128))
# observer geometry (used by the Carrington engine)
OBSERVER = {"DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0}


def scene(lon_deg, lat_deg, seed=0):
    """Smooth analytic 'sun': a fixed field of Gaussian blobs, so the same
    world-coordinate scene renders consistently through ANY header."""
    rng = np.random.default_rng(seed)
    out = np.full(lon_deg.shape, 100.0)
    for _ in range(30):
        cx, cy = rng.uniform(-0.08, 0.12), rng.uniform(-0.06, 0.10)
        w = rng.uniform(0.004, 0.02)
        a = rng.uniform(0.5, 3.0)
        out += a * np.exp(-(((lon_deg - cx) ** 2) + ((lat_deg - cy) ** 2))
                          / (2 * w * w))
    return out


def render(hdr):
    lon, lat = coords.header_world_grid(hdr)
    return scene(lon, lat)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("output_dir", nargs="?",
                   help="where the FITS files go (default: a new temporary "
                        "directory)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    p.add_argument("--figures", action="store_true",
                   help="also save the correlation figure (matplotlib)")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the demo; returns {"helioprojective", "carrington": the
    AlignmentResults, "ok": the shift check, "paths": the files written}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = args.output_dir or tempfile.mkdtemp(prefix="demo_synthetic_")
    os.makedirs(out_dir, exist_ok=True)

    # the large reference image, correctly pointed at the origin
    hdr_large = synth.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0,
                                  extra=OBSERVER)
    # the small image: rendered through its TRUE pointing, but handed to the
    # engine with a header mispointed by -TRUE_SHIFT — the search must
    # recover +TRUE_SHIFT
    hdr_true = synth.make_header((96, 96), (5.0, 5.0), (120.0, 80.0), 0.75,
                                 extra=OBSERVER)
    hdr_small = synth.make_header(
        (96, 96), (5.0, 5.0),
        (120.0 - TRUE_SHIFT[0], 80.0 - TRUE_SHIFT[1]), 0.75, extra=OBSERVER)

    paths = {"large": os.path.join(out_dir, "large.fits"),
             "small": os.path.join(out_dir, "small.fits"),
             "aligned": os.path.join(out_dir, "aligned.fits")}
    fits.writeto(paths["large"], render(hdr_large), hdr_large)
    fits.writeto(paths["small"], render(hdr_true), hdr_small)

    A = Alignment(
        large_fov_known_pointing=paths["large"],
        small_fov_to_correct=paths["small"],
        lag_crval1=LAG_CRVAL1, lag_crval2=LAG_CRVAL2,
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0,
        display_progress_bar=False, device=device,
    )
    res = A.align_using_helioprojective(method="correlation")
    print(f"helioprojective: recovered shift = "
          f"({res.shift_arcsec[0]:+.2f}, {res.shift_arcsec[1]:+.2f}) arcsec "
          f"(injected {TRUE_SHIFT[0]:+.1f}, {TRUE_SHIFT[1]:+.1f})")
    if args.figures:
        paths["correlation"] = os.path.join(out_dir, "correlation.pdf")
        res.plot_correlation(paths["correlation"])
    res.write_corrected_fits(window_list_to_apply_shift=[0],
                             path_to_l3_output=paths["aligned"])

    B = Alignment(
        large_fov_known_pointing=paths["large"],
        small_fov_to_correct=paths["small"],
        lag_crval1=LAG_CRVAL1, lag_crval2=LAG_CRVAL2,
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0, device=device,
    )
    res_c = B.align_using_carrington(**CARRINGTON_GRID)
    print(f"carrington:      recovered shift = "
          f"({res_c.shift_arcsec[0]:+.2f}, {res_c.shift_arcsec[1]:+.2f}) "
          f"arcsec")

    ok = (abs(res.shift_arcsec[0] - TRUE_SHIFT[0]) < 1.0
          and abs(res.shift_arcsec[1] - TRUE_SHIFT[1]) < 1.0)
    print(f"outputs in {out_dir}")
    print("OK" if ok else "MISMATCH")
    return {"helioprojective": res, "carrington": res_c, "ok": ok,
            "paths": paths}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
