"""Composable 2-D coordinate transforms and the grid rectifier (torch).

Counterpart of ``euispice_coreg_tpu/core/transforms.py``, the reference's
transform framework (``euispice_coreg/utils/rectify.py:126-888``): the
linear, euclidean, homographic and polar transforms, the differential
rotation, the spherical (Carrington) projection and the optical-distortion
polynomials, as functions over torch tensors (``xp=torch``, the default;
they run on the tensors' device in their dtype) or numpy (``xp=np``, host
float64).

Transforms compose with ``+`` (left applied first), mirroring
``BaseTransform.__add__``/``CompositeTransform`` (rectify.py:126-155).
:class:`Rectifier` computes the grid's coordinates on the host in float64
and samples on ``device`` through ``core.resample``; the distortion
machinery samples its chief-ray grids there too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import timeutils
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import resample
from .resample import interpol2d  # parity: utils/rectify.py:22-56 re-export


class BaseTransform:
    def __add__(self, other):
        return CompositeTransform(self, other)

    def __call__(self, x=None, y=None, xp=torch):
        raise NotImplementedError


class CompositeTransform(BaseTransform):
    """Apply ``transform_1`` then ``transform_2`` (rectify.py:135-155)."""

    def __init__(self, transform_1, transform_2):
        self.transform_1 = transform_1
        self.transform_2 = transform_2

    def __call__(self, x=None, y=None, xp=torch):
        x, y = self.transform_1(x=x, y=y, xp=xp)
        return self.transform_2(x=x, y=y, xp=xp)


class Transform(BaseTransform):
    def __init__(self, direction: str = "forward"):
        if direction not in ("forward", "inverse"):
            raise ValueError("Transform direction must be forward or inverse")
        self.direction = direction

    def forward(self, x=None, y=None, xp=torch):
        raise NotImplementedError

    def inverse(self, x=None, y=None, xp=torch):
        raise NotImplementedError

    def __call__(self, x=None, y=None, xp=torch):
        if self.direction == "forward":
            return self.forward(x=x, y=y, xp=xp)
        return self.inverse(x=x, y=y, xp=xp)


class LinearTransform(Transform):
    """y = A x in homogeneous coordinates (rectify.py:183-200)."""

    _fmatrix: np.ndarray
    _imatrix: np.ndarray

    def _apply(self, matrix, x, y, xp):
        nx = matrix[0, 0] * x + matrix[0, 1] * y + matrix[0, 2]
        ny = matrix[1, 0] * x + matrix[1, 1] * y + matrix[1, 2]
        return nx, ny

    def transform(self, matrix, x=None, y=None):
        """Reference-named matrix application (rectify.py:190-194)."""
        return self._apply(np.asarray(matrix), x, y, np)

    def forward(self, x=None, y=None, xp=torch):
        return self._apply(self._fmatrix, x, y, xp)

    def inverse(self, x=None, y=None, xp=torch):
        return self._apply(self._imatrix, x, y, xp)


class EuclidianTransform(LinearTransform):
    """Rotation + uniform scale + translation (rectify.py:252-268)."""

    def __init__(self, dx, dy, theta, scale, degrees=True, direction="forward"):
        super().__init__(direction=direction)
        t = np.radians(theta) if degrees else theta
        self._fmatrix = np.array([
            [np.cos(t) * scale, -np.sin(t) * scale, dx],
            [np.sin(t) * scale, np.cos(t) * scale, dy],
            [0.0, 0.0, 1.0],
        ])
        self._imatrix = np.linalg.inv(self._fmatrix)


class HomographicTransform(LinearTransform):
    """Arbitrary 3x3 homogeneous matrix (rectify.py:271-279)."""

    def __init__(self, matrix, direction="forward"):
        super().__init__(direction=direction)
        self._fmatrix = np.asarray(matrix, dtype=np.float64)
        self._imatrix = np.linalg.inv(self._fmatrix)


class PolarTransform(Transform):
    """(theta, r) -> cartesian, with optional ellipticity and tilt
    (rectify.py:203-249)."""

    def __init__(self, xc, yc, e=1.0, psi=0.0, degrees=True, direction="forward"):
        super().__init__(direction=direction)
        self.xc, self.yc = xc, yc
        self.e = e
        self.psi = np.radians(psi) if degrees else psi
        self.degrees = degrees

    def forward(self, x=None, y=None, xp=torch):
        theta = (xp.deg2rad(x) if self.degrees else x) - self.psi
        r = 1.0 if y is None else y
        nx = r * xp.cos(theta)
        ny = r * xp.sin(theta) * self.e
        if self.psi != 0:
            c, s = np.cos(self.psi), np.sin(self.psi)
            nx, ny = nx * c - ny * s, nx * s + ny * c
        return nx + self.xc, ny + self.yc


class DifferentialRotationTransform(Transform):
    """Rotate Carrington longitudes by the accumulated differential rotation
    (rectify.py:282-311); Hortin (2003) coefficients per EUV band."""

    def __init__(self, delta_t_days, rate_wave=None, degrees=True,
                 direction="forward"):
        super().__init__(direction=direction)
        from ..engine.carrington import CARRINGTON_RATE, DIFF_ROT_COEFFS

        self.delta_t = delta_t_days
        self.carrington_rate = CARRINGTON_RATE
        self.coeffs = DIFF_ROT_COEFFS.get(
            str(rate_wave), (CARRINGTON_RATE, 0.0, 0.0))
        self.degrees = degrees

    def _dx(self, y, xp):
        lat = xp.deg2rad(y) if self.degrees else y
        siny2 = xp.sin(lat) ** 2
        return self.delta_t * (
            self.coeffs[0] + siny2 * (self.coeffs[1] + self.coeffs[2] * siny2)
            - self.carrington_rate
        )

    def forward(self, x=None, y=None, xp=torch):
        return x - self._dx(y, xp), y

    def inverse(self, x=None, y=None, xp=torch):
        return x + self._dx(y, xp), y


class SphericalTransform(Transform):
    """Carrington (lon, lat) on a sphere -> observer-frame detector pixels,
    with roll, observer lon/lat, far-side z-clip and optional centre-to-limb
    darkening factor (rectify.py:314-374)."""

    def __init__(self, x0, y0, dist, obs_lon, obs_lat, roll, cdelt1,
                 cdelt2=None, direction="forward", zclip=0.0, degrees=True,
                 c2limb=False):
        super().__init__(direction=direction)
        conv = np.radians if degrees else (lambda v: v)
        self.x0, self.y0 = x0, y0
        self.dist = dist
        self.obs_lon = conv(obs_lon)
        self.obs_lat = conv(obs_lat)
        self.roll = conv(roll)
        self.cdelt1 = cdelt1
        self.cdelt2 = cdelt1 if cdelt2 is None else cdelt2
        self.zclip = zclip
        self.degrees = degrees
        self.c2limb = c2limb

    def forward(self, x=None, y=None, xp=torch):
        conv = xp.deg2rad if self.degrees else (lambda v: v)
        lon = conv(x) - self.obs_lon
        lat = conv(y)
        x3 = xp.cos(lat) * xp.sin(lon)
        y3 = xp.sin(lat)
        z3 = xp.cos(lat) * xp.cos(lon)
        zz = z3 * np.cos(self.obs_lat) + y3 * np.sin(self.obs_lat)
        yy = y3 * np.cos(self.obs_lat) - z3 * np.sin(self.obs_lat)
        good = zz >= self.zclip

        c, s = np.cos(self.roll), np.sin(self.roll)
        py = yy * c - x3 * s
        px = x3 * c + yy * s
        z = self.dist - zz
        nx = self.x0 + xp.rad2deg(xp.arctan(px / z)) * 3600.0 / self.cdelt1
        ny = self.y0 + xp.rad2deg(xp.arctan(py / z)) * 3600.0 / self.cdelt2
        nx = xp.where(good, nx, np.nan)
        ny = xp.where(good, ny, np.nan)
        if self.c2limb:
            a = 0.1
            r = xp.sqrt(px ** 2 + py ** 2)
            r = xp.where(r > 1.0, 1.0, r)
            theta = xp.arcsin(r)
            mu = -xp.cos(theta) / a + xp.sqrt(1 + 2 / a + (xp.cos(theta) / a) ** 2)
            mu = xp.where(good, mu, 1.0)
            return nx, ny, mu
        return nx, ny


class CarringtonTransform(CompositeTransform):
    """Differential rotation followed by the spherical projection, built from
    FITS header scalars (rectify.py:377-423)."""

    def __init__(self, hdr, radius_correction=1.0, direction="forward",
                 reference_date=None, rate_wave=None, zclip=0.0, c2limb=False):
        from ..engine.carrington import R_SUN_M
        from ..utils import units
        from .header import get_crota

        roll = get_crota(hdr)
        cunit1 = hdr.get("CUNIT1", "arcsec")
        cunit2 = hdr.get("CUNIT2", "arcsec")
        crval1 = units.convert(hdr["CRVAL1"], cunit1, "arcsec")
        crval2 = units.convert(hdr["CRVAL2"], cunit2, "arcsec")
        cdelt1 = units.convert(hdr["CDELT1"], cunit1, "arcsec")
        cdelt2 = units.convert(hdr["CDELT2"], cunit2, "arcsec")

        c, s = np.cos(np.radians(roll)), np.sin(np.radians(roll))
        dx = c * crval1 + s * crval2
        dy = -s * crval1 + c * crval2
        spherical = SphericalTransform(
            (hdr["CRPIX1"] - 1) - dx / cdelt1,
            (hdr["CRPIX2"] - 1) - dy / cdelt2,
            hdr["DSUN_OBS"] / (radius_correction * R_SUN_M),
            hdr["CRLN_OBS"],
            hdr["CRLT_OBS"],
            roll,
            cdelt1,
            cdelt2,
            direction=direction,
            zclip=zclip,
            c2limb=c2limb,
        )
        if reference_date is None:
            reference_date = hdr["DATE-OBS"]
        delta_t = timeutils.time_diff_days(str(hdr["DATE-OBS"]), str(reference_date))
        diffrot = DifferentialRotationTransform(delta_t, rate_wave)
        super().__init__(diffrot, spherical)
        self.reference_date = reference_date


class Rectifier:
    """Resample an image on a regular grid through a transform
    (rectify.py:842-888): the grid and its transform on the host in
    float64, the spline sampling on ``device`` in ``dtype``."""

    def __init__(self, transform):
        self.transform = transform
        self._cache_key = None
        self._coords = None

    def coordinates(self, shape, xlims, ylims):
        """Pixel coordinates (nx, ny[, mu]) of the grid in the image (host
        float64), the regular grid cached across calls."""
        key = (tuple(shape), tuple(xlims), tuple(ylims))
        if key != self._cache_key:
            self._coords = np.meshgrid(
                np.linspace(xlims[0], xlims[1], shape[0], dtype=np.float64),
                np.linspace(ylims[0], ylims[1], shape[1], dtype=np.float64),
            )
            self._cache_key = key
        x, y = self._coords
        return self.transform(x=x, y=y, xp=np)

    def __call__(self, image, shape, xlims, ylims, order=1, fill=np.nan,
                 dst=None, dtype=np.float32, *, device="cuda"):
        out = self.coordinates(shape, xlims, ylims)
        if len(out) == 3:
            nx, ny, mu = out
        else:
            nx, ny = out
            mu = 1.0
        dev, dt = resolve_device(device), resolve_dtype(dtype)
        sampled = resample.sample_image(
            to_tensor(np.asarray(image, dtype=np.float64), device=dev,
                      dtype=dt),
            to_tensor(nx, device=dev, dtype=dt),
            to_tensor(ny, device=dev, dtype=dt),
            order=order).to(torch.float64).cpu().numpy()
        if not np.isnan(fill):
            sampled = np.where(np.isnan(sampled), fill, sampled)
        result = sampled / mu
        if dst is not None:
            dst[...] = result
            return None
        return result


# ---------------------------------------------------------------------------
# optical distortion (rectify.py:426-839: DistortionMatrix / ZemaxData)
# ---------------------------------------------------------------------------

def polyfit2d(x, y, f, deg, maxdegree=False):
    """Least-squares 2-D polynomial fit (rectify.py:59-82 capability)."""
    from numpy.polynomial import polynomial

    vander = polynomial.polyvander2d(np.ravel(x), np.ravel(y), [deg, deg])
    vander = vander.reshape((-1, vander.shape[-1]))
    if maxdegree:
        dy, dx = np.indices((deg + 1, deg + 1))
        vander[:, (dx.reshape(-1) + dy.reshape(-1)) > deg] = 0
    c, *_ = np.linalg.lstsq(vander, np.ravel(f), rcond=-1)
    return c.reshape((deg + 1, deg + 1))


class PolynomialDistortion(Transform):
    """Pixel-space distortion as a pair of 2-D polynomial displacement
    fields: (x, y) -> (x + Px(x, y), y + Py(x, y)).

    Plays the role of the reference's Zemax-derived ``DistortionMatrix``
    polynomials (rectify.py:426-839) without the .ini parsing: coefficients
    are given directly as (deg+1, deg+1) arrays, e.g. from
    :func:`polyfit2d` on measured displacement data.
    """

    def __init__(self, coeffs_x, coeffs_y, direction="forward"):
        super().__init__(direction=direction)
        self.coeffs_x = np.asarray(coeffs_x, dtype=np.float64)
        self.coeffs_y = np.asarray(coeffs_y, dtype=np.float64)

    def _evaluate(self, coeffs, x, y, xp):
        out = 0.0
        for i in range(coeffs.shape[0]):
            for j in range(coeffs.shape[1]):
                if coeffs[i, j] != 0.0:
                    out = out + coeffs[i, j] * (x ** i) * (y ** j)
        return out

    def forward(self, x=None, y=None, xp=torch):
        return (x + self._evaluate(self.coeffs_x, x, y, xp),
                y + self._evaluate(self.coeffs_y, x, y, xp))

    def inverse(self, x=None, y=None, xp=torch):
        # one Newton step (distortions are small): x0 - P(x0 - P(x0))
        dx = self._evaluate(self.coeffs_x, x, y, xp)
        dy = self._evaluate(self.coeffs_y, x, y, xp)
        dx2 = self._evaluate(self.coeffs_x, x - dx, y - dy, xp)
        dy2 = self._evaluate(self.coeffs_y, x - dx, y - dy, xp)
        return x - dx2, y - dy2


def load_distortion_ini(path, section="distortion", deg_key="degree"):
    """Load polynomial-distortion coefficients from an .ini file, the storage
    format of the reference's Zemax-derived FSI distortion data
    (rectify.py:522-527, 679-695: configparser over coefficient sections).

    Expected layout::

        [distortion]
        degree = 2
        cx_0_0 = 0.0
        cx_1_0 = 1.2e-4
        cy_0_1 = -3e-5
        ...

    Returns a :class:`PolynomialDistortion`.
    """
    import configparser

    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)
    sec = cp[section]
    deg = int(sec.get(deg_key, 3))
    cx = np.zeros((deg + 1, deg + 1))
    cy = np.zeros((deg + 1, deg + 1))
    for key, value in sec.items():
        if key == deg_key:
            continue
        which, i, j = key.split("_")
        if which == "cx":
            cx[int(i), int(j)] = float(value)
        elif which == "cy":
            cy[int(i), int(j)] = float(value)
    return PolynomialDistortion(cx, cy)


def gridpattern(nx=3072, ny=3072, s=16, t=3):
    """Binary test grid (rectify.py:110-123)."""
    image = np.zeros((nx, ny))
    for i in range(t):
        image[i::s, :] = 1
        image[:, i::s] = 1
    return image


def rotationmatrix(angle, axis):
    """3-D rotation matrix about z/y/x (rectify.py:85-107)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 0:
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == 2:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    raise ValueError("axis must be 0 (z), 1 (y) or 2 (x)")


def polyval(x, y, coefficients):
    """Bivariate polynomial sum c[i, j] x^i y^j, Horner over both axes
    (behavioural port of the nested ``polyval`` in
    rectify.py:483-499)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    degree = coefficients.shape[0] - 1
    poly = np.zeros_like(x)
    for j in range(degree, -1, -1):
        dum = np.full_like(x, coefficients[degree, j])
        for i in range(degree - 1, -1, -1):
            dum *= x
            dum += coefficients[i, j]
        poly *= y
        poly += dum
    return poly


def reform_poly(items, axis, scale):
    """Decode one axis' polynomial from a distortion .ini section: the
    stored coefficients encode only the distortion, the mean plate scale is
    added back into the linear term (rectify.py:505-519)."""
    degree = int(float(items[axis + "degree"]))
    d = np.asarray(items["d" + axis + "k"].split(),
                   dtype=np.float32).reshape((degree + 1, degree + 1))
    if axis == "x":
        d[1, 0] += scale
    elif axis == "y":
        d[0, 1] += scale
    else:
        raise ValueError("Invalid axis")
    return d


class DistortionMatrix(Transform):
    """FSI optical-distortion transform, behavioural port of the reference's
    Zemax machinery (rectify.py:426-839) with the astropy/Zemax IO replaced
    by this framework's FITS reader and plain-text parsing.

    ``file`` is either a distortion-polynomials .ini (sections ``gen`` /
    ``field2pos`` / ``pos2field``) or, with ``rebuild=True`` or a ``.fits``
    extension, a Zemax chief-ray grid to fit/interpolate directly.  The
    chief-ray grids are sampled on ``device``.

    The reference's ``DistortionPolynomial.write`` and
    ``ZemaxData.write_polynomials`` crash (configparser misuse,
    rectify.py:535-537, 660-695); here both are implemented working with the
    same on-disk format.
    """

    class DistortionPolynomial:
        """Bivariate distortion polynomials, one per output axis
        (rectify.py:438-537)."""

        def __init__(self, file=None, direction=None, coefficients=None):
            if file is not None and coefficients is not None:
                raise ValueError("file and coefficients are exclusive")
            if file is not None:
                if direction is None:
                    raise ValueError("direction required with file")
                import os

                if not os.path.isfile(file):
                    raise FileNotFoundError(file)
                self.file = file
                self.scale = None
                self.coefficients = None
                self.read(direction)
            elif coefficients is not None:
                self.scale = coefficients[0]
                self.coefficients = coefficients[1]

        def __call__(self, x, y):
            return (polyval(x, y, self.coefficients[0]),
                    polyval(x, y, self.coefficients[1]))

        def read(self, direction):
            import configparser

            config = configparser.ConfigParser()
            config.read(self.file)
            items = dict(config.items(direction))
            self.scale = np.float32(items["scale"])
            self.coefficients = (reform_poly(items, "x", self.scale),
                                 reform_poly(items, "y", self.scale))

        def write(self, direction, file=None, config=None):
            """Serialize into ``[direction]`` (inverse of :meth:`read`:
            the scale is removed from the linear term before storing)."""
            import configparser

            own = config is None
            if own:
                config = configparser.ConfigParser()
            cx = np.array(self.coefficients[0], dtype=np.float64)
            cy = np.array(self.coefficients[1], dtype=np.float64)
            cx[1, 0] -= self.scale
            cy[0, 1] -= self.scale
            config[direction] = {
                "scale": repr(float(self.scale)),
                "xdegree": str(cx.shape[0] - 1),
                "dxk": " ".join(repr(float(v)) for v in cx.ravel()),
                "ydegree": str(cy.shape[0] - 1),
                "dyk": " ".join(repr(float(v)) for v in cy.ravel()),
            }
            if own:
                with open(file or self.file, "w") as fh:
                    config.write(fh)
            return config

    class ZemaxData:
        """Zemax chief-ray distortion grids (rectify.py:539-712): field
        angles (deg) vs chief-ray detector positions (mm), sampled on
        ``device``."""

        def __init__(self, file, *, device="cuda"):
            import os

            if not os.path.isfile(file):
                raise FileNotFoundError(file)
            self.file = file
            self.device = device
            self.xchief = self.ychief = None
            self.xfield = self.yfield = None
            self.maxfield = self.nsamples = self.step = None
            if file.endswith(".txt"):
                self.read_txt()
            elif file.endswith(".fits"):
                self.read_fits()
            else:
                raise ValueError("Invalid file extension")

        def read_fits(self):
            from ..io import fits as _fits

            hdul = _fits.open(self.file)
            self.maxfield = float(hdul[0].header["MAXFIELD"])
            self.step = float(hdul[0].header["STEPSIZE"])
            self.nsamples = int(hdul[1].header["NAXIS1"])
            self.xchief = np.asarray(hdul[1].data, dtype=np.float64)
            self.ychief = np.asarray(hdul[2].data, dtype=np.float64)
            grid = np.linspace(-self.maxfield + self.step / 2,
                               self.maxfield - self.step / 2, self.nsamples)
            self.xfield, self.yfield = np.meshgrid(grid, grid)

        def read_txt(self):
            """Zemax macro ASCII output: ';'-comment lines (the last of
            which carry maxfield and nsamples), then whitespace-separated
            columns xchief ychief hx hy (rectify.py:581-614)."""
            comments, rows = [], []
            with open(self.file) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    if line.startswith(";"):
                        comments.append(line.lstrip("; ").rstrip())
                    else:
                        rows.append([float(v) for v in line.split()])
            if not rows:
                raise IOError(f"no data rows in {self.file}")
            data = np.asarray(rows, dtype=np.float64)
            self.maxfield = float(comments[-5].split()[-1])
            self.nsamples = int(float(comments[-4].split()[-1]))
            self.step = 2 * self.maxfield / self.nsamples
            shape = (self.nsamples, self.nsamples)
            self.xchief = data[:, 0].reshape(shape)
            self.ychief = data[:, 1].reshape(shape)
            self.xfield = data[:, 2].reshape(shape) * self.maxfield
            self.yfield = data[:, 3].reshape(shape) * self.maxfield

        def write_fits(self, outfile=None):
            """Working version of the reference's stub (rectify.py:617-637),
            laid out so :meth:`read_fits` round-trips."""
            from ..io import fits as _fits

            outfile = outfile or self.file.replace(".txt", ".fits")
            primary = _fits.PrimaryHDU()
            primary.header["MAXFIELD"] = self.maxfield
            primary.header["STEPSIZE"] = 2 * self.maxfield / self.nsamples
            primary.header["UNITS"] = "degrees"
            _fits.write(outfile, [
                primary,
                _fits.ImageHDU(data=np.asarray(self.xchief, dtype=np.float64)),
                _fits.ImageHDU(data=np.asarray(self.ychief, dtype=np.float64)),
            ])
            return outfile

        def fit(self, direction):
            """Polynomial fit of the grids: x-axis degree 5 with combined-
            degree cap, y-axis degree 3 (rectify.py:639-665)."""
            if direction == "pos2field":
                x, y = self.xchief, self.ychief
                f1, f2 = self.xfield, self.yfield
            elif direction == "field2pos":
                x, y = self.xfield, self.yfield
                f1, f2 = self.xchief, self.ychief
            else:
                raise ValueError(direction)
            c1 = polyfit2d(x, y, f1, 5, maxdegree=True)
            c2 = polyfit2d(x, y, f2, 3, maxdegree=False)
            return (c1, c2)

        def write_polynomials(self, outfile, phys_pix_size=0.01,
                              ref_x_pix=1536, ref_y_pix=1536):
            """Working version of rectify.py:660-695: fit both directions
            and store them with the instrument constants."""
            import configparser

            config = configparser.ConfigParser()
            config["gen"] = {"phys_pix_size": repr(phys_pix_size),
                             "ref_x_pix": repr(ref_x_pix),
                             "ref_y_pix": repr(ref_y_pix)}
            for direction in ("field2pos", "pos2field"):
                poly = DistortionMatrix.DistortionPolynomial(
                    coefficients=(np.float32(0.0), self.fit(direction)))
                poly.write(direction, config=config)
            with open(outfile, "w") as fh:
                config.write(fh)
            return outfile

        def _sample(self, grid, nx, ny):
            return interpol2d(grid, nx, ny, device=self.device).cpu().numpy()

        def field2pos(self, x, y):
            # the reference omits the -0.5 (rectify.py:697-699), putting its
            # exact-mode lookup half a grid cell off its own pixel-center
            # grid convention (read_fits:577-578) -- fixed here
            nx = self.nsamples * (np.asarray(x) / self.maxfield + 1) / 2 - 0.5
            ny = self.nsamples * (np.asarray(y) / self.maxfield + 1) / 2 - 0.5
            return (self._sample(self.xchief, nx, ny),
                    self._sample(self.ychief, nx, ny))

        def pos2field(self, x, y):
            import scipy.interpolate

            xidx, yidx = np.indices(self.xchief.shape)
            points = np.stack((self.xchief.ravel(), self.ychief.ravel()),
                              axis=1)
            nx = scipy.interpolate.griddata(points, xidx.ravel(), (x, y),
                                            method="nearest")
            ny = scipy.interpolate.griddata(points, yidx.ravel(), (x, y),
                                            method="nearest")
            return (self._sample(self.xfield, nx, ny),
                    self._sample(self.yfield, nx, ny))

    def __init__(self, file, rebuild=False, flip=False, direction="forward",
                 *, device="cuda"):
        import configparser
        import os

        super().__init__(direction=direction)
        self.exact = file.endswith(".fits")
        if not rebuild:
            if not os.path.isfile(file):
                raise FileNotFoundError(file)
            self.file = file
            if self.exact:
                self.phys_pix_size = 0.01
                self.ref_x_pix = 1535.5
                self.ref_y_pix = 1535.5
                data = self.ZemaxData(file, device=device)
                self.pos2field = data.pos2field
                self.field2pos = data.field2pos
            else:
                config = configparser.ConfigParser()
                config.read(self.file)
                items = dict(config.items("gen"))
                self.phys_pix_size = np.float32(items["phys_pix_size"])
                self.ref_x_pix = np.float32(items["ref_x_pix"])
                self.ref_y_pix = np.float32(items["ref_y_pix"])
                self.pos2field = self.DistortionPolynomial(file, "pos2field")
                self.field2pos = self.DistortionPolynomial(file, "field2pos")
        else:
            self.phys_pix_size = np.float32(0.01)
            self.ref_x_pix = np.float32(1535.5)
            self.ref_y_pix = np.float32(1535.5)
            self.zemax_data = self.ZemaxData(file, device=device)
            self.pos2field = self.DistortionPolynomial(
                coefficients=(0, self.zemax_data.fit("pos2field")))
            self.field2pos = self.DistortionPolynomial(
                coefficients=(0, self.zemax_data.fit("field2pos")))
        self.flipped_images = flip

    def forward(self, x=None, y=None, xp=np):
        """Field angles (deg) -> detector pixels (rectify.py:760-775)."""
        if self.flipped_images:
            y, x = self.field2pos(-np.asarray(y), np.asarray(x))
            y = -y
        else:
            x, y = self.field2pos(x, y)
        x = x / self.phys_pix_size + self.ref_x_pix
        y = y / self.phys_pix_size + self.ref_y_pix
        return x, y

    def inverse(self, x=None, y=None, xp=np):
        """Detector pixels -> field angles (rectify.py:777-792)."""
        x = (np.asarray(x, dtype=np.float64) - self.ref_x_pix) * self.phys_pix_size
        y = (np.asarray(y, dtype=np.float64) - self.ref_y_pix) * self.phys_pix_size
        if self.flipped_images:
            y, x = self.pos2field(-y, x)
            y = -y
        else:
            x, y = self.pos2field(x, y)
        return x, y

    def plot(self, s=10):
        """Distortion quiver figure (rectify.py:794-839): blue = undistorted
        grid, red = distorted, vectors magnified by ``s``."""
        from matplotlib import collections as mcol
        from matplotlib import pyplot as plt

        scale = self.pos2field.scale
        x = np.linspace(-3072 / 2 + 1, 3072 / 2, 48) * self.phys_pix_size
        y = np.linspace(-3072 / 2 + 1, 3072 / 2, 48) * self.phys_pix_size
        ox, oy = np.meshgrid(x, y)
        nx, ny = self.field2pos(ox * scale, oy * scale)
        dx = nx - ox
        dy = ny - oy

        fig, ax = plt.subplots()
        ax.quiver(x, y, s * dx, s * dy, angles="xy", scale_units="xy",
                  scale=1, linewidth=0.25)
        for gx, gy, color in ((ox, oy, (0, 0, 1, 1)),
                              (ox + s * dx, oy + s * dy, (1, 0, 0, 1))):
            for a, b in ((gx, gy), (gx.T, gy.T)):
                ax.add_collection(mcol.LineCollection(
                    np.stack((a, b), axis=2), colors=color, linewidth=0.25))
        ax.set_xlabel("Position on detector (mm)")
        ax.set_ylabel("Position on detector (mm)")
        ax.set_aspect("equal")
        return fig


# explicit 2-D name for the bivariate evaluator
polyval2d = polyval
