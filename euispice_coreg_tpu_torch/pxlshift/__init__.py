from .alignment_pixels import AlignmentPixels

__all__ = ["AlignmentPixels"]
