"""Correct the jitter of an imager movie with the PyTorch port (offline
synthetic demo).

    python3 examples/jitter_movie_torch.py [output_dir] [--device cpu]

Runs on a CUDA card by default (``--device cpu`` runs on the CPU).  Six
frames, each but the first mispointed by up to 4" on each axis, go to
``output_dir`` (default: a new temporary directory) and the corrected
frames to ``output_dir/corrected``.
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

from euispice_coreg_tpu_torch.io import fits  # noqa: E402
from euispice_coreg_tpu_torch.jitter_correction import jitter_correction_imagers  # noqa: E402
from euispice_coreg_tpu_torch.utils import timeutils  # noqa: E402
from euispice_coreg_tpu_torch.utils.torchcfg import resolve_device  # noqa: E402

LAGS = np.arange(-6.0, 6.5, 0.5)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("output_dir", nargs="?",
                   help="where the FITS files go (default: a new temporary "
                        "directory)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Writes the movie and corrects it; returns {"results": the
    AlignmentResults of each corrected frame, "jitter": the pointing error
    injected into each frame (arcsec), "paths": the files written}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    tmp = pathlib.Path(args.output_dir
                       or tempfile.mkdtemp(prefix="jitter_movie_"))
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(0)
    t0 = timeutils.parse_fits_time("2022-03-17T09:00:00")
    paths, jitters = [], []
    for k in range(6):
        jitter = rng.uniform(-4, 4, size=2) if k else (0.0, 0.0)
        hdr_true = synth.make_header((128, 128), (8.0, 8.0), (0.0, 0.0), 0.0)
        hdr_true["DATE-AVG"] = timeutils.format_fits_time(t0 + 60.0 * k)
        data = synth.render_helioprojective(hdr_true)
        hdr = hdr_true.copy()
        hdr["CRVAL1"] -= jitter[0]
        hdr["CRVAL2"] -= jitter[1]
        p = str(tmp / f"movie_{k:02d}.fits")
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32),
                                       header=hdr)])
        paths.append(p)
        jitters.append(tuple(float(j) for j in jitter))

    outdir = tmp / "corrected"
    os.makedirs(outdir, exist_ok=True)
    results = jitter_correction_imagers(
        list_files_input=paths,
        path_files_output=str(outdir),
        lag_crval1=LAGS,
        lag_crval2=LAGS,
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        window_files_input=0,
        alignement_method="helioprojective",
        device=device,
    )
    print("corrected movie written to", outdir)
    return {"results": results, "jitter": jitters,
            "paths": {"frames": paths, "corrected": str(outdir)}}


if __name__ == "__main__":
    main()
