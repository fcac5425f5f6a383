from .alignment import Alignment
from .alignment_spice import AlignementSpiceIterativeContextRaster, AlignmentSpice
from .results import AlignmentResults

__all__ = ["Alignment", "AlignementSpiceIterativeContextRaster",
           "AlignmentResults", "AlignmentSpice"]
