from .alignment import Alignment
from .results import AlignmentResults

__all__ = ["Alignment", "AlignmentResults"]
