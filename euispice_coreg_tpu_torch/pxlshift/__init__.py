from .alignment_pixels import AlignmentPixels
from .alignment_spice_pixel import AlignmentSpicePixel

__all__ = ["AlignmentPixels", "AlignmentSpicePixel"]
