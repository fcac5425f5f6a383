"""Test frame: the tiny helioprojective pair in the layout of an EUI L2
file, an empty primary HDU with the image in HDU 1 (a plain IMAGE
extension; the L2 files' RICE_1 compression is left to their own frame).
The program opens both files at window 1 and the corrected header is read
from HDU 1; rendering, the search and its reference are the
helioprojective frame's."""
import os

from coreg_bench import inputs
from coreg_bench.frames import helioprojective as _helio

WINDOW = 1  # the HDU of the image in an L2 file

ROUTES = _helio.ROUTES
render = _helio.render
align = _helio.align
reference = _helio.reference


def write_pair(pair, directory, k):
    paths = (os.path.join(directory, f"pair{k}_large_l2.fits"),
             os.path.join(directory, f"pair{k}_small_l2.fits"))
    for path, key in zip(paths, ("large", "small")):
        inputs.write_hdus(path, [(None, {}), (pair[key], pair["hdr_" + key])])
    return paths


def program(paths, kw):
    from euispice_coreg_tpu_torch import Alignment

    return Alignment(large_fov_known_pointing=paths[0],
                     small_fov_to_correct=paths[1], small_fov_window=WINDOW,
                     large_fov_window=WINDOW, **kw), WINDOW
