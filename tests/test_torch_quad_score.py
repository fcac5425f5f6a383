"""K2's plain version (the CPU side of engine/quad_score.py) against the JAX
package's Pallas quadratic-displacement kernel in interpret mode and against
the exact gather sampler, on the cases of tests/test_pallas_quad.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pallas_quad as tpq
from euispice_coreg_tpu.core import resample as jresample
from euispice_coreg_tpu.core import score as jscore
from euispice_coreg_tpu.engine import pallas_common as jpc
from euispice_coreg_tpu.engine import pallas_quad as jquad
from euispice_coreg_tpu_torch.engine import quad_score


def quad_coeffs():
    """test_pallas_quad's four lags: large shifts of both signs, an affine +
    quadratic field and a pure cross term."""
    coeffs = np.zeros((4, 6, 2))
    coeffs[0, 2] = (37.0 + 0.3, -141.0 + 0.6)
    coeffs[1, 2] = (-129.4, 8.2)
    coeffs[2, 2] = (5.3, -2.1)
    coeffs[2, 0, 0] = 4e-3
    coeffs[2, 1, 1] = -6e-3
    coeffs[2, 3, 0] = 3e-6
    coeffs[2, 4, 1] = -4e-6
    coeffs[3, 5] = (2e-6, -1.5e-6)
    return coeffs


def nan_coeffs():
    coeffs = np.zeros((2, 6, 2))
    coeffs[0, 2] = (17.3, -4.6)
    coeffs[1, 2] = (-3.1, 9.9)
    coeffs[1, 0, 0] = -3e-3
    coeffs[1, 4, 1] = 5e-6
    return coeffs


def residus_case():
    warped, ref = tpq.make_scene(with_nans=True)
    coeffs = np.zeros((3, 6, 2))
    coeffs[0, 2] = (7.3, -24.6)
    coeffs[1, 2] = (-3.1, 9.9)
    coeffs[1, 0, 0] = -3e-3
    coeffs[2, 2] = (140.8, 33.2)
    return coeffs, np.abs(warped) + 50.0, np.abs(ref) + 50.0


def exact_gather64(coeffs, warped, ref, order, method):
    """JAX's exact gather sampler + score on the quadratic field, float64."""
    h, w = warped.shape
    fn = jscore.SCORE_FUNCTIONS[method]
    vals = []
    for cf in coeffs:
        x, y = tpq.quad_field(cf, h, w)
        sampled = jresample.sample_image(jnp.asarray(warped), jnp.asarray(x),
                                         jnp.asarray(y), order=order)
        vals.append(float(fn(jnp.asarray(ref), sampled)))
    return np.array(vals)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_plain_k2_matches_jax_pallas_interpret(order):
    """float32: atol 3e-4 (test_pallas_quad's own) against
    ``evaluate_select_carr_pallas(interpret=True)``, argmax equal."""
    warped, ref = tpq.make_scene()
    h, w = warped.shape
    coeffs = quad_coeffs()
    want = jquad.evaluate_select_carr_pallas(coeffs, warped, ref, order=order,
                                             h=h, w=w, interpret=True)
    got = quad_score.evaluate_select_quad(coeffs, warped, ref, order=order,
                                          device="cpu")
    assert want is not None
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert np.nanargmax(got) == np.nanargmax(want)


@pytest.mark.parametrize("case", ["nans", "residus_masked"])
def test_plain_k2_nans_and_residus_match_jax_pallas(case):
    """NaN holes (correlation) and the residue score: atol 3e-4 against the
    JAX kernel in interpret mode."""
    if case == "nans":
        warped, ref = tpq.make_scene(with_nans=True)
        coeffs, method = nan_coeffs(), "correlation"
    else:
        (coeffs, warped, ref), method = residus_case(), "residus_masked"
    h, w = warped.shape
    want = jquad.evaluate_select_carr_pallas(
        coeffs, warped, ref, order=2, h=h, w=w, method=method, interpret=True)
    got = quad_score.evaluate_select_quad(coeffs, warped, ref, order=2,
                                          method=method, device="cpu")
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_plain_k2_float64_matches_exact_gather(method):
    """float64, orders 0/1/2 (correlation) and 2 (residue): atol 1e-6
    against JAX's exact gather sampler and score on the same quadratic
    fields (the single-interpolation truth)."""
    if method == "correlation":
        warped, ref = tpq.make_scene(with_nans=True)
        coeffs = np.concatenate([quad_coeffs(), nan_coeffs()])
        orders = (0, 1, 2)
    else:
        coeffs, warped, ref = residus_case()
        orders = (2,)
    for order in orders:
        want = exact_gather64(coeffs, warped, ref, order, method)
        got = quad_score.evaluate_select_quad(coeffs, warped, ref,
                                              order=order, method=method,
                                              device="cpu",
                                              compute_dtype="float64")
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_k2_scores_what_the_tpu_kernel_declines():
    """A 64-px spread inside one 128-px tile: the TPU kernel declines (None,
    the JAX package then gathers); K2 has no residual bound and matches the
    exact gather, float64 atol 1e-6."""
    warped, ref = tpq.make_scene(h=128, w=128)
    coeffs = np.zeros((2, 6, 2))
    coeffs[0, 0, 0] = 0.5
    coeffs[1, 2] = (3.0, -2.0)
    coeffs[1, 1, 1] = -0.3
    assert jquad.evaluate_select_carr_pallas(
        coeffs, warped, ref, order=2, h=128, w=128, interpret=True) is None
    got = quad_score.evaluate_select_quad(coeffs, warped, ref, order=2,
                                          device="cpu",
                                          compute_dtype="float64")
    want = exact_gather64(coeffs, warped, ref, 2, "correlation")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_k2_declines_like_jax():
    """Only what K2 does not compute: raw ``residus`` and order 3."""
    warped, ref = tpq.make_scene(h=64, w=64)
    coeffs = np.zeros((1, 6, 2))
    for kw in ({"method": "residus"}, {"order": 3}):
        args = {"order": 2, "method": "correlation", **kw}
        assert quad_score.evaluate_select_quad(coeffs, warped, ref,
                                               device="cpu", **args) is None
    assert quad_score.evaluate_select_quad(coeffs, warped, ref[:-1], order=2,
                                           device="cpu") is None


def test_finishers_match_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(5, 300))
    sums = np.stack([np.full(5, 300.0), d.sum(1), (d * d).sum(1)], axis=-1)
    np.testing.assert_allclose(quad_score.residus_from_sums(sums),
                               jpc.residus_from_sums(sums), rtol=1e-14)
    np.testing.assert_allclose(quad_score.residus_from_sums(sums),
                               d.std(axis=1), rtol=1e-10)


def test_coeff_table_matches_jax_layout():
    """(L, 12) rows in the JAX kernel's SMEM order: dx coefficients, then
    dy coefficients."""
    coeffs = quad_coeffs()
    cf = coeffs.astype(np.float32)
    want = np.concatenate([cf[:, :, 0], cf[:, :, 1]], axis=1)
    np.testing.assert_array_equal(
        quad_score.coeff_table(coeffs).astype(np.float32), want)


def test_lag_chunks_join_seamlessly(monkeypatch):
    """Lags split over several launches give the one-launch result."""
    warped, ref = tpq.make_scene(h=64, w=80)
    coeffs = np.zeros((7, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-5.0, 5.0, 7)
    coeffs[:, 0, 1] = 1e-3
    kw = dict(order=2, device="cpu", compute_dtype="float64")
    whole = quad_score.evaluate_select_quad(coeffs, warped, ref, **kw)
    monkeypatch.setattr(quad_score, "MAX_LAGS", 3)
    chunked = quad_score.evaluate_select_quad(coeffs, warped, ref, **kw)
    np.testing.assert_array_equal(chunked, whole)


def test_wrapper_checks_operands():
    warped, ref = tpq.make_scene(h=32, w=40)
    canvas, ref_c = quad_score.quad_canvases(
        torch.as_tensor(warped, dtype=torch.float32),
        torch.as_tensor(ref, dtype=torch.float32), method="correlation")
    table = torch.zeros((3, 12), dtype=torch.float32)
    kw = dict(pad=quad_score.PAD, order=2)
    assert quad_score.quad_score_sums(canvas, ref_c, table,
                                      method="correlation", **kw).shape == (3, 6)
    assert quad_score.quad_score_sums(canvas, ref_c, table,
                                      method="residus_masked",
                                      **kw).shape == (3, 3)
    with pytest.raises(TypeError):
        quad_score.quad_score_sums(canvas, ref_c.double(), table,
                                   method="correlation", **kw)
    with pytest.raises(ValueError):
        quad_score.quad_score_sums(canvas[:-1], ref_c, table,
                                   method="correlation", **kw)
    with pytest.raises(ValueError):
        quad_score.quad_score_sums(canvas, ref_c, table[:, :11].contiguous(),
                                   method="correlation", **kw)
    with pytest.raises(ValueError):
        quad_score.quad_score_sums(canvas, ref_c, table, method="residus",
                                   **kw)
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no kernel"):
        quad_score.quad_score_sums(
            torch.empty(36, 44, **meta), torch.empty(32, 40, **meta),
            torch.empty(1, 12, **meta), method="correlation", **kw)


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """The library name's hash changes with the kernel source, with any
    shared header under csrc/ and with the flags, and only with them."""
    import shutil

    from euispice_coreg_tpu_torch.engine import _build

    for f in ("quad_score.cu", "warp_score.cu", "sampling.cuh"):
        shutil.copy(f"{_build.CSRC_DIR}/{f}", tmp_path / f)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    k0 = _build.build_key("quad_score")
    assert k0 == _build.build_key("quad_score")
    assert k0 != _build.build_key("warp_score")
    (tmp_path / "warp_score.cu").write_text("// another kernel\n")
    assert _build.build_key("quad_score") == k0
    (tmp_path / "sampling.cuh").write_text(
        (tmp_path / "sampling.cuh").read_text() + "\n// edited\n")
    k1 = _build.build_key("quad_score")
    assert k1 != k0
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    k2 = _build.build_key("quad_score")
    assert k2 != k1
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.build_key("quad_score") != k2
