"""The helioprojective frame: both images on TAN detectors,
``Alignment.align_using_helioprojective`` and the reference's per-lag TAN
search (:class:`coreg_bench.reference.hypercube.HelioReference`)."""
from coreg_bench import inputs
from coreg_bench.reference import geometry as g
from coreg_bench.reference.hypercube import HelioReference

# the program's route lines of this frame's cells -> their route names
ROUTES = (("engine path: K1", "K1"), ("engine path: per-lag exact (K1", "K1"),
          ("engine path: FFT block fast", "block"),
          ("engine path: per-lag gather", "gather"))


def render(config, blobs, hdr_large, hdr_true, device):
    """The scene through each detector's own TAN header: (large, small)."""
    bg = config["scene"]["background"]
    return tuple(
        inputs.render_scene(blobs, bg, *g.tan_pixel_to_world(
            g.tan_params(hdr), *inputs.pixels(int(hdr["NAXIS1"]), device)))
        for hdr in (hdr_large, hdr_true))


def align(alignment, config):
    return alignment.align_using_helioprojective()


def reference(config, pair, lags_deg, device, dtype):
    return HelioReference(pair["large"], pair["small"], pair["hdr_large"],
                          pair["hdr_small"], lags_deg, dtype=dtype,
                          device=device)
