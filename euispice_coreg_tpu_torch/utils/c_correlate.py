"""Import-path twin of the reference's ``utils/c_correlate.py``: the one
implementation lives in ``core/score`` and is re-exported here."""
from ..core.score import c_correlate, c_correlate3D, c_correlate3d

__all__ = ["c_correlate", "c_correlate3D", "c_correlate3d"]
