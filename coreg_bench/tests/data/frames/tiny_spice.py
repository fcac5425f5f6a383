"""Test frame: a SPICE L2 raster aligned against an imager image with
``AlignmentSpice``.

The raster is a 4-D (t, lambda, y, x) cube of ``nx`` slit positions,
``ny`` rows and ``nlam`` spectral pixels at CDELT1 != CDELT2, under a
SPICE-like L2 header: HPLN/HPLT-TAN, WAVE and UTC axes, the raster's
time-x coupling in PC4_1, the roll in PCi_j and no CROTA card, and "L2" in
the file name (which the program reads the level from).  HDU 0 holds the
spectral window that is aligned; HDU 1 holds a second window, another
line with its own structures, which the program must not read.  The imager
image is a file of its own.

The reference is the helioprojective one (``HelioReference``) on the
spectral sum of HDU 0's cube under its spatial header, with the rows
outside the slit's usable part (the dumbbells, upstream
``AlignSpiceUtil.vertical_edges_limits``) left out as the program's L2
preparation leaves them out.  Not reproduced, because this frame does not
ask for them: the solar-rotation stretch of CDELT1
(``extend_pixel_size``), a wavelength interval other than "all",
``sub_fov_window`` and ``cut_from_center``.
"""
import math
import os

import numpy as np
import torch

from coreg_bench import inputs
from coreg_bench.frames import helioprojective as _helio
from coreg_bench.reference import geometry as g
from coreg_bench.reference import judge
from coreg_bench.reference.hypercube import HelioReference

WINDOW = 0  # the raster's HDU that is aligned

ROUTES = _helio.ROUTES
align = _helio.align


def l2_header(sm, crval):
    """The raster's 4-D L2 header pointed at ``crval`` (arcsec)."""
    c1, c2 = sm["cdelt_arcsec"]
    pc11, pc12, pc21, pc22 = g.pc_matrix(sm["crota_deg"], c1, c2)
    nx, ny, nlam = sm["nx"], sm["ny"], sm["nlam"]
    hdr = {"CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CTYPE3": "WAVE",
           "CTYPE4": "UTC", "CUNIT1": "arcsec", "CUNIT2": "arcsec",
           "CUNIT3": "nm", "CUNIT4": "s",
           "CRVAL1": float(crval[0]), "CRVAL2": float(crval[1]),
           "CRVAL3": sm["lambda_nm"], "CRVAL4": 0.0,
           "CRPIX1": (nx + 1) / 2, "CRPIX2": (ny + 1) / 2,
           "CRPIX3": (nlam + 1) / 2, "CRPIX4": 1.0,
           "CDELT1": float(c1), "CDELT2": float(c2),
           "CDELT3": sm["dlambda_nm"], "CDELT4": 1.0,
           "PC1_1": pc11, "PC1_2": pc12, "PC2_1": pc21, "PC2_2": pc22,
           "PC3_3": 1.0, "PC4_4": 1.0, "PC4_1": sm["step_s"]}
    hdr.update(sm["header"])
    return hdr


def spatial(hdr):
    """The raster's 2-D spatial header, the roll read from its PC."""
    keys = ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2", "CDELT1", "CDELT2",
            "PC1_1", "PC1_2", "PC2_1", "PC2_2")
    return dict({k: hdr[k] for k in keys}, CROTA=judge.roll_deg(hdr))


def usable_rows(hdr):
    """[first, end) rows of the slit less 20 unbinned rows at each end
    (upstream AlignSpiceUtil.slit_pxl and vertical_edges_limits)."""
    ybin = hdr["NBIN2"]
    h_detector = 1024 / ybin
    h_slit = {"SW": 600, "LW": 626}[hdr["DETECTOR"]] / ybin
    beg = (h_detector - h_slit) / 2
    end = h_detector - beg
    beg = beg - hdr["PXBEG2"] / ybin + 1
    end = end - hdr["PXBEG2"] / ybin + 1
    return (int(math.ceil(beg)) + int(20 / ybin),
            int(math.floor(end)) - int(20 / ybin))


def _raster(config, blobs, hdr, profile, device):
    sm = config["small"]
    y, x = torch.meshgrid(
        torch.arange(sm["ny"], dtype=torch.float64, device=device),
        torch.arange(sm["nx"], dtype=torch.float64, device=device),
        indexing="ij")
    img = inputs.render_scene(blobs, config["scene"]["background"],
                              *g.tan_pixel_to_world(
                                  g.tan_params(spatial(hdr)), x, y))
    prof = torch.tensor(profile, dtype=torch.float64, device=device)
    return (img[None, None] * (prof / prof.sum())[None, :, None, None])


def make_pair(config, workload, seed, k, device):
    """Pair ``k``: ``large`` (the imager image), ``small`` and ``other``
    (the two windows' (1, nlam, ny, nx) cubes), ``hdr_large``,
    ``hdr_small`` (the L2 header handed over) and ``error``."""
    rng = inputs.pair_rng(seed, k, "pair")
    scene = config["scene"]
    blobs = inputs._blobs(rng, scene)
    e = rng.uniform(-workload["error_arcsec"], workload["error_arcsec"], 2)
    other_blobs = inputs._blobs(rng, scene)
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs._noise_seed(seed, k))
    sm, lg = config["small"], config["large"]
    given = l2_header(sm, sm["crval_arcsec"])
    true = l2_header(sm, (sm["crval_arcsec"][0] + e[0],
                          sm["crval_arcsec"][1] + e[1]))
    hdr_large = inputs.tan_header(lg["n"], lg["cdelt_arcsec"],
                                  lg["crval_arcsec"], lg["crota_deg"],
                                  lg.get("header"))
    x, y = inputs.pixels(lg["n"], device)
    large = inputs.render_scene(blobs, scene["background"],
                                *g.tan_pixel_to_world(g.tan_params(hdr_large),
                                                      x, y))
    sigma = config["noise_sigma"]
    return {"large": inputs._noisy(large, sigma, gen),
            "small": inputs._noisy(_raster(config, blobs, true,
                                           sm["line_profile"], device),
                                   sigma, gen),
            "other": inputs._noisy(_raster(config, other_blobs, true,
                                           sm["other_line_profile"], device),
                                   sigma, gen),
            "hdr_large": hdr_large, "hdr_small": given,
            "error": (float(e[0]), float(e[1]))}


def write_pair(pair, directory, k):
    paths = (os.path.join(directory, f"pair{k}_imager.fits"),
             os.path.join(directory, f"solo_L2_spice-n-ras_pair{k}.fits"))
    inputs.write_hdus(paths[0], [(pair["large"], pair["hdr_large"])])
    inputs.write_hdus(paths[1], [(pair["small"], pair["hdr_small"]),
                                 (pair["other"], pair["hdr_small"])])
    return paths


def program(paths, kw):
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice import (
        AlignmentSpice)

    return AlignmentSpice(large_fov_known_pointing=paths[0],
                          small_fov_to_correct=paths[1],
                          small_fov_window=WINDOW, large_fov_window=0,
                          wavelength_interval_to_sum="all", **kw), WINDOW


def reference(config, pair, lags_deg, device, dtype):
    cube = pair["small"][0].astype(np.float64)
    lo, hi = usable_rows(pair["hdr_small"])
    cube[:, :lo, :] = np.nan
    cube[:, hi:, :] = np.nan
    img = np.nansum(cube, axis=0)
    img[:lo] = np.nan
    img[hi:] = np.nan
    return HelioReference(pair["large"], img, pair["hdr_large"],
                          spatial(pair["hdr_small"]), lags_deg, dtype=dtype,
                          device=device)
