"""The comparison that decides ``correct``.

An answer is what one ``Alignment`` call produced for one file: its
correlation hypercube (read only at the lags the reference scores), its
argmax, and the corrected header's CRVAL1/2, CDELT1/2 and CROTA.  The
reference (:mod:`.hypercube`) scores a sample of lags drawn from the seed,
plus every lag the judgement below needs (the zero lag and the 5 x 5
around each answer's argmax), and works out the header the
answer should carry with the upstream ``AlignmentResults`` procedure: a 2-D
Gaussian fitted over the 5 x 5 CRVAL neighbourhood of the answer's argmax,
on its CDELT/CROTA plane, with the upstream initial guess and bounds.

Three numbers, each held to its limit (the cell's workload file):

* ``r_gap``: the largest |r(answer) - r(reference)| over the scored lags;
* ``argmax_gap``: how far, in r of the reference, the answer's argmax lies
  below the best lag the reference scored (0 where it is the best);
* ``header_gap``: the largest difference between the answer's corrected
  header and the reference's, in arcsec (CROTA's degrees as arcsec of
  angle).
"""
from __future__ import annotations

import math
import warnings

import numpy as np
from scipy.optimize import curve_fit

NUMBERS = ("r_gap", "argmax_gap", "header_gap")
HEADER_KEYS = ("CRVAL1", "CRVAL2", "CDELT1", "CDELT2", "CROTA")


def gaussian2d(xy, amplitude, xo, yo, sigma_x, sigma_y, offset):
    x, y = xy
    return np.ravel(offset + amplitude * np.exp(
        -((x - xo) ** 2 / (2 * sigma_x ** 2) + (y - yo) ** 2
          / (2 * sigma_y ** 2))))


def sample_lags(shape, truth, zero, n_random, rng):
    """Lag indices the reference scores for every pair: a 3 x 3 CRVAL window
    around the truth on every CDELT/CROTA plane, 7 x 7 on the truth's plane,
    the zero lag ``zero`` (where a grid maps onto itself and its edge pixels
    are decided by rounding), and ``n_random`` lags drawn from the whole
    grid."""
    n1, n2, n3, n4, n5 = shape
    t1, t2, t3, t4, t5 = truth
    out = {tuple(int(v) for v in zero)}
    for i3 in range(n3):
        for i4 in range(n4):
            for i5 in range(n5):
                half = 3 if (i3, i4, i5) == (t3, t4, t5) else 1
                for a in range(t1 - half, t1 + half + 1):
                    for b in range(t2 - half, t2 + half + 1):
                        if 0 <= a < n1 and 0 <= b < n2:
                            out.add((a, b, i3, i4, i5))
    flat = rng.choice(int(np.prod(shape)), size=min(n_random,
                                                    int(np.prod(shape))),
                      replace=False)
    out.update(tuple(int(v) for v in np.unravel_index(k, shape))
               for k in flat)
    return np.array(sorted(out), dtype=np.int64)


def _window(center, plane, shape, half):
    a0, b0 = center
    return np.array([(a, b, *plane)
                     for a in range(a0 - half, a0 + half + 1)
                     for b in range(b0 - half, b0 + half + 1)
                     if 0 <= a < shape[0] and 0 <= b < shape[1]],
                    dtype=np.int64)


def fitted_header(scores, argmax, lags_arcsec, crota_lags, given):
    """The corrected header of an argmax under ``scores`` (a callable giving
    r at (K, 5) indices): a Gaussian over the argmax's 5 x 5 CRVAL
    neighbourhood on its plane (the raw lag where the fit fails, as
    upstream), the plane's CDELT and CROTA lags.  The fit is centred where
    the answer put its argmax, so that a near tie between two lags, which
    ``argmax_gap`` judges, does not move the window."""
    shape = tuple(len(v) for v in lags_arcsec[:2])
    plane = tuple(int(v) for v in argmax[2:])
    best = tuple(int(v) for v in argmax[:2])
    nb = _window(best, plane, shape, 2)
    r_nb = scores(nb)
    lag1, lag2 = lags_arcsec[0], lags_arcsec[1]
    shift = (float(lag1[best[0]]), float(lag2[best[1]]))
    if len(nb) >= 4:
        p0 = (float(scores(np.array([[*best, *plane]]))[0]), float(best[0]),
              float(best[1]), 1.0, 1.0, 0.9)
        bounds = ([0.0, best[0] - 5.0, best[1] - 5.0, 0.0, 0.0, -10.0],
                  [10.0, best[0] + 5.0, best[1] + 5.0, 1000.0, 1000.0, 10.0])
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                popt, _ = curve_fit(gaussian2d, (nb[:, 0].astype(np.float64),
                                                 nb[:, 1].astype(np.float64)),
                                    np.asarray(r_nb, dtype=np.float64),
                                    p0=p0, bounds=bounds)
            shift = (float(np.interp(popt[1], np.arange(len(lag1)), lag1)),
                     float(np.interp(popt[2], np.arange(len(lag2)), lag2)))
        except (ValueError, RuntimeError):
            pass
    return {"CRVAL1": given["CRVAL1"] + shift[0],
            "CRVAL2": given["CRVAL2"] + shift[1],
            "CDELT1": given["CDELT1"] + float(lags_arcsec[2][plane[0]]),
            "CDELT2": given["CDELT2"] + float(lags_arcsec[3][plane[1]]),
            "CROTA": given["CROTA"] + float(crota_lags[plane[2]])}


def header_gap(got, want):
    """Largest header difference in arcsec (CROTA: degrees x 3600)."""
    gaps = [abs(float(got[k]) - float(want[k])) * (3600.0 if k == "CROTA"
                                                    else 1.0)
            for k in HEADER_KEYS]
    return max(gaps) if all(math.isfinite(v) for v in gaps) else math.inf


def r_gap(got, want):
    """Largest |got - want|; a lag scored by one side only is an inf gap."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if np.any(np.isnan(got) != np.isnan(want)):
        return math.inf
    d = np.abs(got - want)
    d = d[np.isfinite(d)]
    return float(d.max()) if d.size else 0.0


def judge(reference, answer_scores, answer_argmax, answer_header, sample,
          lags_arcsec, crota_lags, given):
    """The three numbers for one answer.  ``answer_scores`` gives the
    answer's r at (K, 5) indices, ``sample`` the pair's sampled lags."""
    a = tuple(int(v) for v in answer_argmax[:5])
    want = fitted_header(reference.r, a, lags_arcsec, crota_lags, given)
    scored = np.array(sorted(reference.scores), dtype=np.int64)
    scored = np.unique(np.concatenate([scored, sample]), axis=0)
    r_ref = reference.r(scored)
    best = float(np.nanmax(r_ref))
    at_answer = float(reference.r(np.array([a]))[0])
    return {"r_gap": r_gap(answer_scores(scored), r_ref),
            "argmax_gap": (max(0.0, best - at_answer)
                           if math.isfinite(at_answer) else math.inf),
            "header_gap": header_gap(answer_header, want)}


class ControlAnswer:
    """The reference put in the program's place (the control): its scores,
    its argmax over the lags it scored, and the header of its own fit."""

    def __init__(self, control, sample, lags_arcsec, crota_lags, given):
        r = control.r(sample)
        self.argmax = tuple(int(v) for v in sample[int(np.nanargmax(r))])
        self.header = fitted_header(control.r, self.argmax, lags_arcsec,
                                    crota_lags, given)
        self.scores = control.r
