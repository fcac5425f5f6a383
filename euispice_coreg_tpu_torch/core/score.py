"""Scoring reductions: masked Pearson correlation and residue metrics.

Counterpart of ``euispice_coreg_tpu/core/score.py``.  Each score reduces the
trailing two (image) axes, so a batch of sampled images ``b`` of shape
(B, h, w) against one reference ``a`` of shape (h, w) gives B scores; 2-D
inputs give a 0-d tensor, as the JAX functions do.
"""
from __future__ import annotations

import torch


def _flat(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return a.flatten(-2), b.flatten(-2)


def masked_pearson(a, b):
    """Pearson r over elements finite in both a and b.

    Mean-centering two-pass formula (reference ``c_correlate.py:39-72`` with
    lags=[0]).  NaN when no valid element or zero variance.
    """
    a, b = _flat(a, b)
    mask = torch.isfinite(a) & torch.isfinite(b)
    nf = mask.sum(-1, keepdim=True).to(a.dtype)
    am = torch.where(mask, a, 0.0)
    bm = torch.where(mask, b, 0.0)
    mean_a = am.sum(-1, keepdim=True) / nf
    mean_b = bm.sum(-1, keepdim=True) / nf
    da = torch.where(mask, a - mean_a, 0.0)
    db = torch.where(mask, b - mean_b, 0.0)
    num = (da * db).sum(-1)
    den = torch.sqrt((da * da).sum(-1) * (db * db).sum(-1))
    return num / den


def c_correlate3d(s_1, s_2, lags):
    """IDL ``c_correlate.pro`` over the trailing axis at integer lags.

    Inputs of shape (..., N) (tensors, or arrays made tensors); returns
    (..., len(lags)) on their device.  Each signal is mean-centred once and
    the sliding dot product is normalised by ``sqrt(sum(s1c^2) *
    sum(s2c^2))`` (reference ``c_correlate.py:9-72``).
    """
    s_1 = torch.as_tensor(s_1)
    s_2 = torch.as_tensor(s_2)
    n_s = s_1.shape[-1]
    c1 = s_1 - s_1.mean(-1, keepdim=True)
    c2 = s_2 - s_2.mean(-1, keepdim=True)
    den = torch.sqrt((c1 * c1).sum(-1) * (c2 * c2).sum(-1))
    out = []
    for lag in list(lags):
        lag = int(lag)
        if lag >= 0:
            v = (c1[..., :n_s - lag] * c2[..., lag:]).sum(-1)
        else:
            v = (c1[..., -lag:] * c2[..., :n_s + lag]).sum(-1)
        out.append(v / den)
    return torch.stack(out, dim=-1)


def c_correlate(s_1, s_2, lags):
    """:func:`c_correlate3d` for 1-D signals: returns (len(lags),).  The
    header engine's lags=[0] reduces to Pearson r."""
    s_1 = torch.as_tensor(s_1)
    if s_1.ndim != 1:
        raise ValueError(f"c_correlate takes 1-D signals, got shape "
                         f"{tuple(s_1.shape)}; use c_correlate3d")
    return c_correlate3d(s_1, s_2, lags)


# reference spelling (hdrshift/c_correlate.py:9: ``c_correlate3D``)
c_correlate3D = c_correlate3d


def residus(a, b):
    """std((a - b)/sqrt(a)) over all elements, NaNs propagating (reference
    'residus', ``alignment.py:544-548``; population std like ``jnp.std``)."""
    a, b = _flat(a, b)
    diff = (a - b) / torch.sqrt(a)
    return torch.std(diff, dim=-1, correction=0)


def residus_masked(a, b):
    """NaN-aware variant of :func:`residus`."""
    a, b = _flat(a, b)
    diff = (a - b) / torch.sqrt(a)
    mask = torch.isfinite(diff)
    n = mask.sum(-1, keepdim=True).to(a.dtype)
    dm = torch.where(mask, diff, 0.0)
    mean = dm.sum(-1, keepdim=True) / n
    var = torch.where(mask, (diff - mean) ** 2, 0.0).sum(-1) / n[..., 0]
    return torch.sqrt(var)


SCORE_FUNCTIONS = {
    "correlation": masked_pearson,
    "residus": residus,
    "residus_masked": residus_masked,
}
