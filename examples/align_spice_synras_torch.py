"""Align a SPICE L2 raster against a synthetic raster built from an imager
sequence (the SPICE workflow) with the PyTorch port, fully offline.

    python3 examples/align_spice_synras_torch.py [output_dir] [--device cpu]

Runs on a CUDA card by default (``--device cpu`` runs on the CPU).  The
imager frames, the SPICE cube (mispointed by (-8", +4")) and the synthetic
raster go to ``output_dir`` (default: a new temporary directory).
"""
import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

# run from a checkout: the package sits beside examples/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _synthetic_torch as synth  # noqa: E402

from euispice_coreg_tpu_torch.hdrshift import AlignmentSpice  # noqa: E402
from euispice_coreg_tpu_torch.io import fits  # noqa: E402
from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder  # noqa: E402
from euispice_coreg_tpu_torch.utils import timeutils  # noqa: E402
from euispice_coreg_tpu_torch.utils.torchcfg import resolve_device  # noqa: E402

TRUE_SHIFT = (8.0, -4.0)  # arcsec, the lag that corrects the given CRVAL
LAG_CRVAL1 = np.arange(0.0, 17.0, 1.0)
LAG_CRVAL2 = np.arange(-12.0, 5.0, 1.0)
THRESHOLD_TIME = 600.0  # seconds


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("output_dir", nargs="?",
                   help="where the FITS files go (default: a new temporary "
                        "directory)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Builds the synthetic raster and aligns the cube on it; returns
    {"results": the AlignmentResults, "dates_selected": the imager date
    (seconds) each raster column took, "paths": the files written}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    tmp = pathlib.Path(args.output_dir
                       or tempfile.mkdtemp(prefix="align_spice_synras_"))
    os.makedirs(tmp, exist_ok=True)

    # imager sequence spanning the raster duration
    t0 = timeutils.parse_fits_time("2022-03-17T09:45:00")
    imager_paths = []
    for k in range(3):
        hdr = synth.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + 120.0 * k)
        data = synth.render_helioprojective(hdr)
        p = str(tmp / f"imager_{k}.fits")
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32),
                                       header=hdr)])
        imager_paths.append(p)

    # SPICE L2 cube, mispointed by (8, -4) arcsec
    cube = synth.render_spice_l2_cube(
        synth.make_spice_l2_header(crval_arcsec=(120.0, 80.0)))
    hdr_given = synth.make_spice_l2_header(
        crval_arcsec=(120.0 - TRUE_SHIFT[0], 80.0 - TRUE_SHIFT[1]))
    p_spice = str(tmp / "solo_L2_spice.fits")
    fits.write(p_spice, [fits.PrimaryHDU(data=cube.astype(np.float32),
                                         header=hdr_given)])

    # 1. build the synthetic raster matched to the slit exposure times
    builder = SPICEComposedMapBuilder(
        path_to_spectro=p_spice, list_imager_paths=imager_paths,
        threshold_time=THRESHOLD_TIME, window_imager=0, window_spectro=0,
        device=device)
    synras = builder.process(folder_path_output=str(tmp), level=2,
                             print_filename=False, return_synras_name=True)
    print("synthetic raster:", synras)

    # 2. align the SPICE cube against it
    A = AlignmentSpice(
        large_fov_known_pointing=synras,
        small_fov_to_correct=p_spice,
        lag_crval1=LAG_CRVAL1,
        lag_crval2=LAG_CRVAL2,
        large_fov_window=0, small_fov_window=0,
        device=device,
    )
    results = A.align_using_helioprojective()
    print(results)
    return {"results": results, "dates_selected": builder.dates_selected,
            "paths": {"imagers": imager_paths, "spice": p_spice,
                      "synras": synras}}


if __name__ == "__main__":
    main()
