"""The Carrington frame: both images of the scene on the sphere,
``Alignment.align_using_carrington`` on the configuration's lon/lat grid
and the reference of the select path
(:class:`coreg_bench.reference.hypercube.CarrReference`); CRVAL lags
only."""
import torch

from coreg_bench import inputs
from coreg_bench.reference import geometry as g
from coreg_bench.reference.hypercube import CarrReference

# the program's route lines of this frame's cells -> their route names
ROUTES = (("carrington select: K2", "K2"),
          ("engine path: carrington linearized select", "select"))


def _render_sphere(blobs, bg, hdr, d_solar_r, device):
    """The scene on the Carrington sphere seen through a detector header;
    NaN where the line of sight misses the sphere."""
    x, y = inputs.pixels(int(hdr["NAXIS1"]), device)
    lon, lat = g.detector_to_sphere(g.sphere_scalars(hdr, d_solar_r), x, y)
    ok = torch.isfinite(lon)
    img = inputs.render_scene(blobs, bg, torch.where(ok, lon, 0.0),
                              torch.where(ok, lat, 0.0))
    return torch.where(ok, img, torch.nan)


def render(config, blobs, hdr_large, hdr_true, device):
    """The scene on the sphere through each detector: (large, small)."""
    bg = config["scene"]["background"]
    d = config["align"]["d_solar_r"]
    return tuple(_render_sphere(blobs, bg, hdr, d, device)
                 for hdr in (hdr_large, hdr_true))


def align(alignment, config):
    al = config["align"]
    return alignment.align_using_carrington(
        lonlims=al["lonlims"], latlims=al["latlims"], shape=al["shape"],
        reference_date=config["small"]["header"]["DATE-OBS"])


def reference(config, pair, lags_deg, device, dtype):
    al = config["align"]
    return CarrReference(
        pair["large"], pair["small"], pair["hdr_large"], pair["hdr_small"],
        lags_deg, lonlims=al["lonlims"], latlims=al["latlims"],
        shape=al["shape"], d_solar_r=al["d_solar_r"],
        reference_date=config["small"]["header"]["DATE-OBS"], dtype=dtype,
        device=device)
