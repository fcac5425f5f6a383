"""The port's transform framework (core/transforms.py) and matrix
transforms (utils/matrix_transform.py) against the JAX package: one case
for each transform case of tests/test_transforms_util.py and each test of
tests/test_distortion.py, on the same inputs.  The port runs in torch
(``xp=torch``, float64 tensors) and in numpy (``xp=np``); the JAX package in
numpy."""
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.core import transforms as jtr
from euispice_coreg_tpu.utils.matrix_transform import \
    MatrixTransform as JMatrixTransform
from euispice_coreg_tpu_torch.core import transforms as tr
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.engine import carrington as carr
from euispice_coreg_tpu_torch.utils.matrix_transform import MatrixTransform

XPS = pytest.mark.parametrize("xp", [np, torch], ids=["numpy", "torch"])


def call(fn, *arrays, xp, **kw):
    """``fn`` on float64 numpy arrays, or on float64 tensors made from them
    with ``xp=torch``; the results as numpy."""
    if xp is torch:
        out = fn(*(torch.as_tensor(a, dtype=torch.float64) for a in arrays),
                 xp=torch, **kw)
        return [o.numpy() for o in out]
    return [np.asarray(o) for o in fn(*arrays, xp=np, **kw)]


@XPS
def test_euclidian_roundtrip(xp):
    """forward equal to the JAX package's within 1e-12, and the round trip
    within 1e-12."""
    t = tr.EuclidianTransform(dx=3.0, dy=-2.0, theta=30.0, scale=1.5)
    jt = jtr.EuclidianTransform(dx=3.0, dy=-2.0, theta=30.0, scale=1.5)
    x = np.linspace(0, 10, 7)
    y = np.linspace(-5, 5, 7)
    fwd = call(t.forward, x, y, xp=xp)
    for a, b in zip(fwd, jt.forward(x, y, xp=np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    bx, by = call(t.inverse, *fwd, xp=xp)
    np.testing.assert_allclose(bx, x, atol=1e-12)
    np.testing.assert_allclose(by, y, atol=1e-12)


@XPS
def test_composite_transform_order(xp):
    """shift then scale: x = 1 -> 4, as in the JAX package."""
    def comp(mod):
        shift = mod.EuclidianTransform(dx=1.0, dy=0.0, theta=0.0, scale=1.0)
        scale = mod.EuclidianTransform(dx=0.0, dy=0.0, theta=0.0, scale=2.0)
        return shift + scale

    got = call(comp(tr), np.array([1.0]), np.array([0.0]), xp=xp)
    want = comp(jtr)(np.array([1.0]), np.array([0.0]), xp=np)
    assert float(got[0][0]) == pytest.approx(4.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@XPS
def test_differential_rotation_inverse(xp):
    """The 171 band's rotation within 1e-12 deg of the JAX package's, the
    equator ahead of the Carrington rate, the inverse exact to 1e-12."""
    t = tr.DifferentialRotationTransform(delta_t_days=2.0, rate_wave="171")
    jt = jtr.DifferentialRotationTransform(delta_t_days=2.0, rate_wave="171")
    lon = np.array([120.0, 130.0])
    lat = np.array([0.0, 30.0])
    fwd = call(t.forward, lon, lat, xp=xp)
    for a, b in zip(fwd, jt.forward(lon, lat, xp=np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert fwd[0][0] < lon[0]
    bx, _ = call(t.inverse, *fwd, xp=xp)
    np.testing.assert_allclose(bx, lon, atol=1e-12)


@XPS
def test_carrington_transform_matches_engine(xp):
    """CarringtonTransform against the JAX package's and against the port's
    engine math (observer geometry + spherical projection), float64: pixel
    coordinates within 1e-9, NaN where either has NaN."""
    hdr = fx.make_header((80, 80), (8.0, 8.0), (150.0, 100.0), 0.3,
                         extra=fx.CARR_EXTRA)
    phdr = Header(dict(hdr.items()))
    kw = dict(radius_correction=1.004, reference_date=hdr["DATE-OBS"],
              rate_wave="171")
    t = tr.CarringtonTransform(phdr, **kw)
    jt = jtr.CarringtonTransform(hdr, **kw)
    lon, lat = carr.carrington_grid((115, 125), (-2, 8), (32, 32))
    got = call(t, lon, lat, xp=xp)
    want = jt(lon, lat, xp=np)
    sc = carr.header_spherical_scalars(phdr, 1.004)
    x3, yy, zz = carr.observer_geometry(lon, lat, sc["obs_lon"], sc["obs_lat"])
    x0, y0 = carr._pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                                sc["crpix1"], sc["crpix2"], sc["roll"],
                                sc["cdelt1_arcsec"], sc["cdelt2_arcsec"], xp=np)
    engine = carr.spherical_project(x3, yy, zz, sc["dist"], sc["roll"], x0,
                                    y0, sc["cdelt1_arcsec"],
                                    sc["cdelt2_arcsec"], xp=np)
    for a, b, c in zip(got, want, engine):
        np.testing.assert_allclose(a, b, atol=1e-9, equal_nan=True)
        np.testing.assert_allclose(a, c, atol=1e-9, equal_nan=True)


@pytest.mark.parametrize("order", [1, 2])
def test_rectifier_samples_image(order):
    """The identity rectifier samples the image at the grid (order 1: x = 2
    -> img[0, 2]); a rotated, scaled one at ``order`` gives the JAX
    package's image within 1e-12 (float64 sampling on the CPU), NaN pattern
    equal."""
    img = np.arange(100, dtype=np.float64).reshape(10, 10)
    ident = tr.Rectifier(tr.EuclidianTransform(dx=0.0, dy=0.0, theta=0.0,
                                               scale=1.0))
    out = ident(img, shape=(5, 5), xlims=(0, 8), ylims=(0, 8), order=1,
                device="cpu")
    assert out.shape == (5, 5)
    assert out[0, 0] == pytest.approx(0.0)
    assert out[0, 1] == pytest.approx(2.0)

    rng = np.random.default_rng(4)
    img = rng.normal(size=(40, 48)) + 10.0
    kw = dict(dx=1.5, dy=-2.0, theta=12.0, scale=1.1)
    args = (img, (30, 24), (-3.0, 50.0), (-2.0, 41.0))
    got = tr.Rectifier(tr.EuclidianTransform(**kw))(
        *args, order=order, dtype=np.float64, device="cpu")
    want = jtr.Rectifier(jtr.EuclidianTransform(**kw))(
        *args, order=order, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-12, equal_nan=True)


@XPS
def test_polynomial_distortion_roundtrip(xp):
    """dx = 1e-3 x, dy = -5e-4 y: forward equal to the JAX package's within
    1e-12, the one-step inverse within 1e-3."""
    cx = np.zeros((3, 3))
    cx[1, 0] = 1e-3
    cy = np.zeros((3, 3))
    cy[0, 1] = -5e-4
    t = tr.PolynomialDistortion(cx, cy)
    x = np.linspace(0, 2000, 11)
    y = np.linspace(0, 2000, 11)
    fwd = call(t.forward, x, y, xp=xp)
    for a, b in zip(fwd, jtr.PolynomialDistortion(cx, cy).forward(x, y,
                                                                  xp=np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert fwd[0][10] == pytest.approx(2002.0)
    bx, by = call(t.inverse, *fwd, xp=xp)
    np.testing.assert_allclose(bx, x, atol=1e-3)
    np.testing.assert_allclose(by, y, atol=1e-3)


def test_polyfit2d_recovers_coeffs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 200)
    y = rng.uniform(0, 10, 200)
    f = 2.0 + 0.5 * x - 0.25 * y + 0.1 * x * y
    c = tr.polyfit2d(x, y, f, deg=1)
    np.testing.assert_array_equal(c, jtr.polyfit2d(x, y, f, deg=1))
    assert c[0, 0] == pytest.approx(2.0, abs=1e-8)
    assert c[1, 0] == pytest.approx(0.5, abs=1e-8)
    assert c[1, 1] == pytest.approx(0.1, abs=1e-8)
    for deg, cap in ((3, False), (5, True)):
        np.testing.assert_array_equal(
            tr.polyfit2d(x, y, np.sin(x) * y, deg, maxdegree=cap),
            jtr.polyfit2d(x, y, np.sin(x) * y, deg, maxdegree=cap))


@XPS
def test_matrix_transform_polar_rotation(xp):
    """A 90 degree rotation about the centre (round(11/2) = 6): the centre
    fixed, +x to +y, every point within 1e-12 of the JAX package's; the
    linear transform of a rotation matrix equal too."""
    xx, yy = np.meshgrid(np.arange(11, dtype=float),
                         np.arange(11, dtype=float))
    nx, ny = call(MatrixTransform.polar_transform, xx, yy, xp=xp, theta=90,
                  units="degree")
    jnx, jny = JMatrixTransform.polar_transform(xx, yy, theta=90,
                                                units="degree", xp=np)
    np.testing.assert_allclose(nx, jnx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ny, jny, rtol=0, atol=1e-12)
    assert nx[6, 6] == pytest.approx(6.0)
    assert ny[6, 6] == pytest.approx(6.0)
    assert nx[6, 7] == pytest.approx(6.0, abs=1e-9)
    assert ny[6, 7] == pytest.approx(7.0, abs=1e-9)
    m = MatrixTransform.rotation_matrix(theta=30, units="degree") @ \
        MatrixTransform.displacement_matrix(dx=2.0, dy=-1.0)
    np.testing.assert_array_equal(
        m, JMatrixTransform.rotation_matrix(theta=30, units="degree")
        @ JMatrixTransform.displacement_matrix(dx=2.0, dy=-1.0))
    got = call(lambda a, b, xp: MatrixTransform.linear_transform(
        a, b, matrix=m, xp=xp), xx, yy, xp=xp)
    for a, b in zip(got, JMatrixTransform.linear_transform(xx, yy, matrix=m,
                                                           xp=np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_load_distortion_ini(tmp_path):
    ini = tmp_path / "dist.ini"
    ini.write_text(
        "[distortion]\ndegree = 2\ncx_1_0 = 1e-3\ncy_0_1 = -5e-4\n"
        "cx_2_1 = 2e-9\n")
    t = tr.load_distortion_ini(str(ini))
    jt = jtr.load_distortion_ini(str(ini))
    np.testing.assert_array_equal(t.coeffs_x, jt.coeffs_x)
    np.testing.assert_array_equal(t.coeffs_y, jt.coeffs_y)
    fx_, fy_ = call(t.forward, np.array([1000.0]), np.array([1000.0]),
                    xp=torch)
    assert fx_[0] == pytest.approx(1001.0 + 2.0)
    assert fy_[0] == pytest.approx(999.5)


# ---------------------------------------------------------------------------
# tests/test_distortion.py
# ---------------------------------------------------------------------------

def synth_distortion(xf, yf):
    """Field angles (deg) -> detector position (mm): 10 mm/deg plus cubic
    barrel terms."""
    r2 = xf * xf + yf * yf
    return 10.0 * xf * (1 + 0.004 * r2), 10.0 * yf * (1 + 0.004 * r2)


def make_zemax_txt(path, n=24, maxfield=2.0):
    step = 2 * maxfield / n
    grid = np.linspace(-maxfield + step / 2, maxfield - step / 2, n)
    xf, yf = np.meshgrid(grid, grid)
    xc, yc = synth_distortion(xf, yf)
    lines = ["; Zemax distortion macro output", "; xchief ychief hx hy",
             f"; maxfield {maxfield}", f"; nsamples {n}",
             "; units deg / mm", "; synthetic fixture", "; ---"]
    for a, b, hx, hy in zip(xc.ravel(), yc.ravel(),
                            (xf / maxfield).ravel(), (yf / maxfield).ravel()):
        lines.append(f"{float(a)!r} {float(b)!r} {float(hx)!r} {float(hy)!r}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_zemax_txt_fit_and_roundtrip(tmp_path):
    """The Zemax text grid read and fitted as in the JAX package (grids and
    coefficients equal), the fit within 5e-3 mm of the distortion, and the
    FITS round trip exact to 1e-12."""
    f = make_zemax_txt(tmp_path / "zemax.txt")
    z = tr.DistortionMatrix.ZemaxData(f, device="cpu")
    jz = jtr.DistortionMatrix.ZemaxData(f)
    assert (z.nsamples, z.maxfield) == (jz.nsamples, jz.maxfield) == (24, 2.0)
    c1, c2 = z.fit("field2pos")
    for a, b in zip((c1, c2), jz.fit("field2pos")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.polyval2d(z.xfield, z.yfield, c1),
                               z.xchief, atol=5e-3)
    np.testing.assert_allclose(tr.polyval2d(z.xfield, z.yfield, c2),
                               z.ychief, atol=5e-3)
    out = z.write_fits(str(tmp_path / "zemax.fits"))
    z2 = tr.DistortionMatrix.ZemaxData(out, device="cpu")
    np.testing.assert_allclose(z2.xchief, z.xchief, rtol=1e-12)
    np.testing.assert_allclose(z2.xfield, z.xfield, rtol=1e-12)


def test_distortion_matrix_rebuild_forward_inverse(tmp_path):
    """Rebuilt from the Zemax grid: forward and inverse equal to the JAX
    package's within 1e-9 px / 1e-12 deg, forward within 1 px of the
    analytic truth, the round trip within 5e-3 deg."""
    f = make_zemax_txt(tmp_path / "zemax.txt")
    dm = tr.DistortionMatrix(f, rebuild=True, device="cpu")
    jdm = jtr.DistortionMatrix(f, rebuild=True)
    xf = np.array([0.0, 0.5, -1.0, 1.2])
    yf = np.array([0.0, -0.3, 0.8, -1.1])
    px, py = dm.forward(xf, yf)
    jpx, jpy = jdm.forward(xf, yf)
    np.testing.assert_allclose(px, jpx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(py, jpy, rtol=0, atol=1e-9)
    mmx, mmy = synth_distortion(xf, yf)
    np.testing.assert_allclose(px, mmx / 0.01 + 1535.5, atol=1.0)
    np.testing.assert_allclose(py, mmy / 0.01 + 1535.5, atol=1.0)
    xb, yb = dm.inverse(np.asarray(px), np.asarray(py))
    jxb, jyb = jdm.inverse(np.asarray(px), np.asarray(py))
    np.testing.assert_allclose(xb, jxb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(yb, jyb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(xb, xf, atol=5e-3)
    np.testing.assert_allclose(yb, yf, atol=5e-3)


def test_write_polynomials_ini_roundtrip(tmp_path):
    """The .ini written by the port reads back in both packages with the
    same constants and forward values (within 1e-9 px)."""
    f = make_zemax_txt(tmp_path / "zemax.txt")
    z = tr.DistortionMatrix.ZemaxData(f, device="cpu")
    ini = str(tmp_path / "distortion.ini")
    z.write_polynomials(ini)
    jini = str(tmp_path / "distortion_jax.ini")
    jtr.DistortionMatrix.ZemaxData(f).write_polynomials(jini)
    with open(ini) as a, open(jini) as b:
        assert a.read() == b.read()
    dm = tr.DistortionMatrix(ini, device="cpu")
    jdm = jtr.DistortionMatrix(ini)
    assert float(dm.phys_pix_size) == pytest.approx(0.01)
    assert float(dm.ref_x_pix) == pytest.approx(1536)
    xf = np.array([0.4, -0.9])
    yf = np.array([-0.2, 1.0])
    px, py = dm.forward(xf, yf)
    for a, b in zip((px, py), jdm.forward(xf, yf)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    mmx, mmy = synth_distortion(xf, yf)
    np.testing.assert_allclose(px, mmx / 0.01 + 1536, atol=1.0)
    np.testing.assert_allclose(py, mmy / 0.01 + 1536, atol=1.0)


def test_exact_fits_mode_and_plot(tmp_path):
    """Exact (FITS) mode samples the chief-ray grids on the device: within
    1e-9 px of the JAX package's and 2 px of the truth.  The quiver
    figure's numbers (``field2pos`` on its 48 x 48 grid) equal the JAX
    package's within 1e-9; no figure is drawn."""
    f = make_zemax_txt(tmp_path / "zemax.txt", n=32)
    fits_path = tr.DistortionMatrix.ZemaxData(f, device="cpu").write_fits(
        str(tmp_path / "zemax.fits"))
    dm = tr.DistortionMatrix(fits_path, device="cpu")
    jdm = jtr.DistortionMatrix(fits_path)
    assert dm.exact and jdm.exact
    xf = np.array([0.25, -0.75])
    yf = np.array([0.5, -0.25])
    px, py = dm.forward(xf, yf)
    for a, b in zip((px, py), jdm.forward(xf, yf)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    mmx, mmy = synth_distortion(xf, yf)
    np.testing.assert_allclose(px, mmx / 0.01 + 1535.5, atol=2.0)
    np.testing.assert_allclose(py, mmy / 0.01 + 1535.5, atol=2.0)

    ini = str(tmp_path / "d.ini")
    tr.DistortionMatrix.ZemaxData(f, device="cpu").write_polynomials(ini)
    dm_ini, jdm_ini = tr.DistortionMatrix(ini, device="cpu"), \
        jtr.DistortionMatrix(ini)
    scale = dm_ini.pos2field.scale
    assert scale == jdm_ini.pos2field.scale
    g = np.linspace(-3072 / 2 + 1, 3072 / 2, 48) * dm_ini.phys_pix_size
    ox, oy = np.meshgrid(g, g)
    for a, b in zip(dm_ini.field2pos(ox * scale, oy * scale),
                    jdm_ini.field2pos(ox * scale, oy * scale)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
