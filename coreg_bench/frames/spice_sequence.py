"""The SPICE sequence frame: a SPICE L2 raster against the imager frames
taken while it was scanned, in the helioprojective frame.

A pair is one raster file and the sequence's frame files.  The raster is a
4-D (t, lambda, y, x) L2 cube under a SPICE-like header (HPLN/HPLT-TAN,
WAVE and UTC axes, the time-x coupling in PC4_1, the roll in PCi_j and no
CROTA card, "L2" in the file name), one HDU a spectral window of the
configuration's ``windows``: HDU 0 is the window that is aligned, the
others further lines with their own structures, which the program must
not read.  Each imager frame is a file of its own, with its DATE-AVG.
The scene is a set of Gaussian blobs whose amplitudes are drawn again for
each frame, and each raster column sees them as the frame nearest in time
does, so that a column composed from another frame changes the raster.

The workload's ``program`` names the call of a file:

* ``"synras"``: ``SPICEComposedMapBuilder.process`` writes the synthetic
  raster as an L3 file beside the pair's files, then ``AlignmentSpice``
  aligns the raster on it (reference:
  :class:`coreg_bench.reference.spice.RasterReference`);
* ``"iterative"``: ``AlignementSpiceIterativeContextRaster`` composes the
  raster again for every lag (reference:
  :class:`coreg_bench.reference.spice.IterativeReference`).
"""
import os
from typing import NamedTuple

import numpy as np
import torch

from coreg_bench import inputs
from coreg_bench.frames import helioprojective as _helio
from coreg_bench.reference import geometry as g
from coreg_bench.reference.spice import (IterativeReference, RasterReference,
                                         Sequence, masked_sum, nearest_frames,
                                         spatial)

ROUTES = _helio.ROUTES + (("engine path: iterative context raster",
                           "iterative"),)


class Files(NamedTuple):
    """A pair's files as the program is given them, and the sequence's
    ``threshold_time`` (seconds)."""
    raster: str
    frames: tuple
    composed: str | None  # the synthetic raster's L3 file, "synras" only
    threshold_s: float


def _date(date_beg, seconds):
    """A FITS timestamp ``seconds`` after ``date_beg``, to the ms."""
    t = np.datetime64(date_beg) + np.timedelta64(int(round(seconds * 1e3)),
                                                 "ms")
    return str(t.astype("datetime64[ms]"))


def l2_header(config, crval):
    """The raster's 4-D L2 header pointed at ``crval`` (arcsec): column c
    is exposed ``step_s * (c + 0.5)`` seconds after DATE-BEG."""
    sm = config["small"]
    c1, c2 = sm["cdelt_arcsec"]
    pc11, pc12, pc21, pc22 = g.pc_matrix(sm["crota_deg"], c1, c2)
    nx, ny, nlam = sm["nx"], sm["ny"], sm["nlam"]
    hdr = {"CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CTYPE3": "WAVE",
           "CTYPE4": "UTC", "CUNIT1": "arcsec", "CUNIT2": "arcsec",
           "CUNIT3": "nm", "CUNIT4": "s",
           "CRVAL1": float(crval[0]), "CRVAL2": float(crval[1]),
           "CRVAL3": sm["lambda_nm"], "CRVAL4": sm["step_s"] * nx / 2,
           "CRPIX1": (nx + 1) / 2, "CRPIX2": (ny + 1) / 2,
           "CRPIX3": (nlam + 1) / 2, "CRPIX4": 1.0,
           "CDELT1": float(c1), "CDELT2": float(c2),
           "CDELT3": sm["dlambda_nm"], "CDELT4": 1.0,
           "PC1_1": pc11, "PC1_2": pc12, "PC2_1": pc21, "PC2_2": pc22,
           "PC3_3": 1.0, "PC4_4": 1.0, "PC4_1": sm["step_s"]}
    hdr.update(sm["header"])
    return hdr


def frame_headers(config):
    """The imager frames' TAN headers, DATE-AVG ``cadence_s`` apart from
    ``first_s`` after the raster's DATE-BEG."""
    lg = config["large"]
    beg = config["small"]["header"]["DATE-BEG"]
    out = []
    for f in range(lg["frames"]):
        date = _date(beg, lg["first_s"] + lg["cadence_s"] * f)
        out.append(inputs.tan_header(
            lg["n"], lg["cdelt_arcsec"], lg["crval_arcsec"], lg["crota_deg"],
            dict(lg.get("header", {}), **{"DATE-AVG": date,
                                          "DATE-OBS": date})))
    return out


def _line(nlam, line, device):
    k = torch.arange(nlam, dtype=torch.float64, device=device)
    prof = torch.exp(-0.5 * ((k - line["center_px"]) / line["sigma_px"]) ** 2)
    return prof / prof.sum()


def _cube(img, line, nlam):
    return img[None, None] * _line(nlam, line, img.device)[None, :, None,
                                                            None]


def make_pair(config, workload, seed, k, device):
    """Pair ``k``: ``frames`` (float32 images) under ``hdr_frames``,
    ``small`` and ``others`` (the windows' (1, nlam, ny, nx) cubes, the
    aligned one and the rest), ``hdr_small`` (the L2 header handed over),
    ``error``, the workload's ``program`` and the sequence's
    ``threshold_s``."""
    rng = inputs.pair_rng(seed, k, "pair")
    scene = config["scene"]
    blobs = inputs._blobs(rng, scene)
    e = rng.uniform(-workload["error_arcsec"], workload["error_arcsec"], 2)
    sm, lg = config["small"], config["large"]
    lines = config["windows"]
    other_blobs = [inputs._blobs(rng, scene) for _ in lines[1:]]
    gain = 1.0 + scene["amplitude_jitter"] * rng.uniform(
        -1.0, 1.0, (lg["frames"], scene["blobs"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs._noise_seed(seed, k))
    sigma, bg = config["noise_sigma"], scene["background"]

    hdrs = frame_headers(config)
    # the frames share their pointing: one world grid for all
    lon, lat = g.tan_pixel_to_world(g.tan_params(hdrs[0]),
                                    *inputs.pixels(lg["n"], device))
    frames = [inputs._noisy(inputs.render_scene(
        (*blobs[:3], blobs[3] * gain[f]), bg, lon, lat), sigma, gen)
        for f in range(lg["frames"])]
    del lon, lat

    given = l2_header(config, sm["crval_arcsec"])
    true = l2_header(config, (sm["crval_arcsec"][0] + e[0],
                              sm["crval_arcsec"][1] + e[1]))
    y, x = torch.meshgrid(
        torch.arange(sm["ny"], dtype=torch.float64, device=device),
        torch.arange(sm["nx"], dtype=torch.float64, device=device),
        indexing="ij")
    lon, lat = g.tan_pixel_to_world(g.tan_params(spatial(true)), x, y)
    # each column as the frame nearest in time sees the scene
    column_frame = nearest_frames(true, sm["nx"], hdrs)
    img = torch.empty_like(lon)
    for f in np.unique(column_frame):
        cols = torch.as_tensor(np.nonzero(column_frame == f)[0],
                               device=device)
        img[:, cols] = inputs.render_scene(
            (*blobs[:3], blobs[3] * gain[f]), bg, lon[:, cols], lat[:, cols])
    small = inputs._noisy(_cube(img, lines[0], sm["nlam"]), sigma, gen)
    others = [inputs._noisy(_cube(inputs.render_scene(b, bg, lon, lat),
                                  line, sm["nlam"]), sigma, gen)
              for b, line in zip(other_blobs, lines[1:])]
    return {"frames": frames, "hdr_frames": hdrs, "small": small,
            "others": others, "hdr_small": given,
            "error": (float(e[0]), float(e[1])),
            "program": workload["program"],
            "threshold_s": config["threshold_time_s"]}


def write_pair(pair, directory, k):
    """The raster (every window), then the frames; the synthetic raster's
    L3 file has a fixed name beside them, written by the program."""
    raster = os.path.join(directory, f"solo_L2_spice-n-ras_pair{k}.fits")
    inputs.write_hdus(raster, [(cube, pair["hdr_small"]) for cube in
                               [pair["small"], *pair["others"]]])
    frames = []
    for f, (img, hdr) in enumerate(zip(pair["frames"], pair["hdr_frames"])):
        frames.append(os.path.join(
            directory, f"solo_L2_eui-hrieuv174-image_pair{k}_{f:02d}.fits"))
        inputs.write_hdus(frames[-1], [(img, hdr)])
    composed = (os.path.join(directory, f"solo_L3_synras_pair{k}.fits")
                if pair["program"] == "synras" else None)
    return Files(raster, tuple(frames), composed, pair["threshold_s"])


def program(files, kw):
    """The file's call: the iterative context raster on the sequence, or
    the synthetic raster composed and written, then ``AlignmentSpice``
    on it.  Window 0 of the raster is aligned and corrected."""
    if files.composed is None:
        from euispice_coreg_tpu_torch.hdrshift.alignment_spice import \
            AlignementSpiceIterativeContextRaster

        return AlignementSpiceIterativeContextRaster(
            list(files.frames), files.raster,
            threshold_time=files.threshold_s, small_fov_window=0,
            large_fov_window=0, **kw), 0
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice import \
        AlignmentSpice
    from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder

    builder = SPICEComposedMapBuilder(
        files.raster, list(files.frames), threshold_time=files.threshold_s,
        window_imager=0, window_spectro=0, device=kw["device"])
    builder.process(os.path.dirname(files.composed),
                    basename_output=os.path.basename(files.composed),
                    print_filename=False)
    return AlignmentSpice(files.composed, files.raster,
                          wavelength_interval_to_sum="all",
                          small_fov_window=0, large_fov_window=0, **kw), 0


def align(alignment, config):
    """The search as a user calls it: the iterative context raster scores
    its lags in the API's chunks of 64."""
    return alignment.align_using_helioprojective()


def reference(config, pair, lags_deg, device, dtype):
    if pair["program"] == "iterative":
        return IterativeReference(pair["frames"], pair["hdr_frames"],
                                  pair["small"], pair["hdr_small"], lags_deg,
                                  dtype=dtype, device=device)
    img = masked_sum(pair["small"], pair["hdr_small"])
    hdr = spatial(pair["hdr_small"])
    seq = Sequence(pair["frames"], pair["hdr_frames"], pair["hdr_small"],
                   img.shape, dtype, torch.device(device))
    return RasterReference(seq.compose(g.tan_params(hdr)), img, hdr,
                           lags_deg, dtype=dtype, device=device)

