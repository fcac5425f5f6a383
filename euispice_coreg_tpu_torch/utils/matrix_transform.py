"""2-D homogeneous pixel transforms (torch).

Counterpart of ``euispice_coreg_tpu/utils/matrix_transform.py``, the port of
the reference's ``euispice_coreg/utils/matrix_transform.py:4-106``:
``xp=torch`` (the default) works on tensors on their device, ``xp=np`` on
host float64 arrays.
"""
from __future__ import annotations

import numpy as np
import torch


class MatrixTransform:
    @staticmethod
    def displacement_matrix(ndim=2, dx=0, dy=0):
        if ndim != 2:
            raise NotImplementedError
        return np.array([[1.0, 0.0, dx], [0.0, 1.0, dy], [0.0, 0.0, 1.0]])

    @staticmethod
    def rotation_matrix(ndim=2, theta=0, units="radian"):
        if ndim != 2:
            raise NotImplementedError
        if units == "degree":
            theta = np.radians(theta)
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    @staticmethod
    def linear_transform(xx, yy, *, matrix, xp=torch):
        nx = matrix[0, 0] * xx + matrix[0, 1] * yy + matrix[0, 2]
        ny = matrix[1, 0] * xx + matrix[1, 1] * yy + matrix[1, 2]
        return nx, ny

    @staticmethod
    def to_polar_coordinates(xx, yy, xc=None, yc=None, direction="forward",
                             xp=torch):
        if direction == "forward":
            if xc is None:
                xc = xx[round(xx.shape[0] / 2), round(xx.shape[1] / 2)]
                yc = yy[round(xx.shape[0] / 2), round(xx.shape[1] / 2)]
            nr = xp.sqrt((xx - xc) ** 2 + (yy - yc) ** 2)
            ntheta = xp.arctan2(yy - yc, xx - xc)
            ntheta = xp.where(xp.isnan(ntheta), 0.0, ntheta)
            return nr, ntheta
        # backward: xx = r, yy = theta
        if xc is None:
            xc, yc = 0.0, 0.0
        return xx * xp.cos(yy) + xc, xx * xp.sin(yy) + yc

    @staticmethod
    def polar_transform(xx, yy, xc=None, yc=None, theta=0, units="radian",
                        xp=torch):
        """Rotate coordinates about the image centre (or (xc, yc))."""
        if units == "degree":
            theta = np.radians(theta)
        if xc is None:
            xc = xx[round(xx.shape[0] / 2), round(xx.shape[1] / 2)]
            yc = yy[round(xx.shape[0] / 2), round(xx.shape[1] / 2)]
        nr, ntheta = MatrixTransform.to_polar_coordinates(
            xx, yy, xc, yc, direction="forward", xp=xp)
        ntheta = ntheta + theta
        return MatrixTransform.to_polar_coordinates(
            nr, ntheta, xc, yc, direction="backward", xp=xp)
