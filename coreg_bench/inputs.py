"""The benchmark's inputs: image pairs rendered from the seed, written as FITS.

Rewritten from ``bench_torch.synthesize_pair``, ``_carr_scene``,
``_carr_render`` and ``_carr_reference`` and from ``chip_smoke.write_pair``
at commit 6bb729c, on the benchmark's own geometry
(:mod:`coreg_bench.reference.geometry`) and FITS writer, importing nothing
of the program.  What changed against those: the scene's blobs, the
injected pointing error and the noise come from ``--seed`` and the pair's
index instead of fixed seeds, and the given (mispointed) header is the same
for every seed, so that the program's geometry and routes are too.

A pair is two images: the reference (``large``), correct under the header it
carries, and the image to correct (``small``), rendered through its true
pointing and handed over with a header whose CRVAL1/2 lies ``error`` arcsec
from it.  The search should find ``error``.  Images are rendered on the
device in float64, noise is drawn there with a ``torch.Generator`` seeded
from the seed, and both are written as float32.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import discover
from .reference import geometry as g


STREAMS = {"pair": 428, "sample": 642}  # fixed: the inputs of a seed never change


def pair_rng(seed, k, stream):
    """Numpy generator of pair ``k`` of ``seed`` for one use of
    :data:`STREAMS`: the pair itself, or the lags its judgement samples."""
    return np.random.default_rng([int(seed) % 2 ** 64, int(k),
                                  STREAMS[stream]])


def _noise_seed(seed, k):
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, int(k)])
               .generate_state(1, dtype=np.uint64)[0] >> 1)


def _blobs(rng, scene):
    n = scene["blobs"]
    lo, hi = scene["lon_deg"], scene["lat_deg"]
    return (rng.uniform(*lo, n), rng.uniform(*hi, n),
            rng.uniform(*scene["width_deg"], n),
            rng.uniform(*scene["amplitude"], n))


def render_scene(blobs, background, lon, lat):
    """Gaussian blobs over (lon, lat) in degrees, on their tensors."""
    out = torch.full_like(lon, background)
    for cx, cy, w, a in zip(*blobs):
        out += float(a) * torch.exp(-((lon - float(cx)) ** 2
                                      + (lat - float(cy)) ** 2)
                                    / (2.0 * float(w) * float(w)))
    return out


def tan_header(n, cdelt, crval, crota, extra=None):
    pc = g.pc_matrix(crota, cdelt, cdelt)
    hdr = {"NAXIS1": n, "NAXIS2": n, "CRVAL1": float(crval[0]),
           "CRVAL2": float(crval[1]), "CRPIX1": (n + 1) / 2,
           "CRPIX2": (n + 1) / 2, "CDELT1": float(cdelt),
           "CDELT2": float(cdelt), "CUNIT1": "arcsec", "CUNIT2": "arcsec",
           "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CROTA": float(crota),
           "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3]}
    hdr.update(extra or {})
    return hdr


def pixels(n, device):
    y, x = torch.meshgrid(torch.arange(n, dtype=torch.float64, device=device),
                          torch.arange(n, dtype=torch.float64, device=device),
                          indexing="ij")
    return x, y


def _noisy(img, sigma, gen):
    if sigma:
        img = img + sigma * torch.randn(img.shape, generator=gen,
                                        dtype=img.dtype, device=img.device)
    return img.to(torch.float32).cpu().numpy()


def make_pair(config, workload, seed, k, device):
    """Pair ``k`` of ``seed``: ``{"large", "small"}`` float32 arrays,
    ``{"hdr_large", "hdr_small"}`` dicts and ``error`` (arcsec, the shift
    the search should find)."""
    rng = pair_rng(seed, k, "pair")
    blobs = _blobs(rng, config["scene"])
    e = rng.uniform(-workload["error_arcsec"], workload["error_arcsec"], 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(_noise_seed(seed, k))
    sm, lg = config["small"], config["large"]
    given = tan_header(sm["n"], sm["cdelt_arcsec"], sm["crval_arcsec"],
                       sm["crota_deg"], sm.get("header"))
    true = dict(given, CRVAL1=given["CRVAL1"] + e[0],
                CRVAL2=given["CRVAL2"] + e[1])
    hdr_large = tan_header(lg["n"], lg["cdelt_arcsec"], lg["crval_arcsec"],
                           lg["crota_deg"], lg.get("header"))
    large, small = discover.frame(config["frame"]).render(
        config, blobs, hdr_large, true, device)
    sigma = config["noise_sigma"]
    return {"large": _noisy(large, sigma, gen),
            "small": _noisy(small, sigma, gen),
            "hdr_large": hdr_large, "hdr_small": given,
            "error": (float(e[0]), float(e[1]))}


# --------------------------------------------------------------------------
# FITS
# --------------------------------------------------------------------------

BLOCK = 2880


def _card(key, value):
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, (int, np.integer)):
        v = str(int(value))
    elif isinstance(value, (float, np.floating)):
        v = repr(float(value)).upper()
        if "." not in v and "E" not in v:
            v += ".0"
    else:
        v = "'" + str(value).replace("'", "''").ljust(8) + "'"
        return f"{key:<8}= {v:<20}".ljust(80)
    return f"{key:<8}= {v:>20}".ljust(80)


def write_fits(path, data, header):
    """One primary HDU of big-endian float32 ``data`` under ``header``
    (the structural keywords are written here, first)."""
    data = np.asarray(data, dtype=">f4")
    cards = [_card("SIMPLE", True), _card("BITPIX", -32), _card("NAXIS", 2),
             _card("NAXIS1", data.shape[1]), _card("NAXIS2", data.shape[0])]
    cards += [_card(k, v) for k, v in header.items()
              if k not in ("SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2")]
    cards.append("END".ljust(80))
    text = "".join(cards)
    text += " " * (-len(text) % BLOCK)
    raw = data.tobytes()
    with open(path, "wb") as f:
        f.write(text.encode("ascii"))
        f.write(raw)
        f.write(b"\0" * (-len(raw) % BLOCK))


def write_pair(pair, directory, k):
    """Write pair ``k`` into ``directory``; returns (large path, small
    path)."""
    paths = (os.path.join(directory, f"pair{k}_large.fits"),
             os.path.join(directory, f"pair{k}_small.fits"))
    write_fits(paths[0], pair["large"], pair["hdr_large"])
    write_fits(paths[1], pair["small"], pair["hdr_small"])
    return paths
