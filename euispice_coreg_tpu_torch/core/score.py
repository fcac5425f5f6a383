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
