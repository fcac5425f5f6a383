from .jitter_correction import (align_movie_to_reference,
                                jitter_correction_imagers)

__all__ = ["align_movie_to_reference", "jitter_correction_imagers"]
