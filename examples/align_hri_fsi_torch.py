"""Align an HRIEUV image against an FSI 174 reference (helioprojective) with
the PyTorch port.

Runs on a CUDA card by default (``--device cpu`` runs on the CPU).  With
real data, plain or tile-compressed (RICE_1, ...) EUI files, the last HDU
of each:

    python3 examples/align_hri_fsi_torch.py <fsi.fits> <hri.fits> [output_dir]

Without the two paths it aligns a synthetic pair (the small image
mispointed by (-24", -6")), written into the output directory first:

    python3 examples/align_hri_fsi_torch.py [output_dir] [--device cpu]

The corrected HRI file goes to ``output_dir/aligned.fits`` (default: a new
temporary directory); ``--figures`` also saves ``correlation.png`` (needs
matplotlib).
"""
import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

# run from a checkout: the package sits beside examples/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from euispice_coreg_tpu_torch.hdrshift import Alignment  # noqa: E402
from euispice_coreg_tpu_torch.utils.torchcfg import resolve_device  # noqa: E402

SYNTHETIC_SHIFT = (24.0, 6.0)  # arcsec, the synthetic pair's pointing error
LAG_CRVAL1 = np.arange(15, 35, 1.0)
LAG_CRVAL2 = np.arange(-4, 17, 1.0)


def synthetic_pair(out_dir):
    import _synthetic_torch as synth

    dl, hl, ds, hs = synth.make_helioprojective_pair(
        true_shift_arcsec=SYNTHETIC_SHIFT)
    return synth.write_pair_fits(pathlib.Path(out_dir), dl, hl, ds, hs)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("paths", nargs="*", metavar="path",
                   help="[<fsi.fits> <hri.fits>] [output_dir]")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    p.add_argument("--figures", action="store_true",
                   help="also save the correlation figure (matplotlib)")
    args = p.parse_intermixed_args(argv)
    if len(args.paths) > 3:
        p.error("expected [<fsi.fits> <hri.fits>] [output_dir]")
    return args


def main(argv=None):
    """Runs the alignment; returns {"results": the AlignmentResults,
    "window": the HDU aligned, "paths": the inputs and the files written}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    real = len(args.paths) >= 2
    out_dir = (args.paths[2 if real else 0] if len(args.paths) in (1, 3)
               else tempfile.mkdtemp(prefix="align_hri_fsi_"))
    os.makedirs(out_dir, exist_ok=True)
    if real:
        path_fsi, path_hri = args.paths[:2]
        window = -1
    else:
        path_fsi, path_hri = synthetic_pair(out_dir)
        window = 0
    paths = {"fsi": path_fsi, "hri": path_hri,
             "aligned": os.path.join(out_dir, "aligned.fits")}

    A = Alignment(
        large_fov_known_pointing=path_fsi,
        small_fov_to_correct=path_hri,
        lag_crval1=LAG_CRVAL1,
        lag_crval2=LAG_CRVAL2,
        lag_cdelt1=None,
        lag_cdelt2=None,
        lag_crota=None,
        large_fov_window=window,
        small_fov_window=window,
        device=device,
    )
    results = A.align_using_helioprojective(method="correlation")
    print(results)
    if args.figures:
        paths["correlation"] = os.path.join(out_dir, "correlation.png")
        results.plot_correlation(path_save_figure=paths["correlation"])
    results.write_corrected_fits(
        window_list_to_apply_shift=[window],
        path_to_l3_output=paths["aligned"],
    )
    print("wrote " + " and ".join(
        paths[k] for k in ("aligned", "correlation") if k in paths))
    return {"results": results, "window": window, "paths": paths}


if __name__ == "__main__":
    main()
