"""Selector-driven SPICE alignment glue.

Counterpart of ``euispice_coreg_tpu/hdrshift/alignment_spice_selector.py``
(reference ``hdrshift/alignment_spice_selector.py:11-76``): query the SIDC
archive for FSI 304 frames spanning the SPICE raster, build a synthetic
raster from them on ``device``, then align the SPICE cube against it.
"""
from __future__ import annotations

from ..selector.selector_eui import SelectorEui
from ..synras.map_builder import SPICEComposedMapBuilder
from ..utils import timeutils
from ..utils.torchcfg import resolve_device
from .alignment_spice import AlignmentSpice


class AlignmentSpiceSelector(AlignmentSpice):
    """:class:`AlignmentSpice` whose imager context is fetched through a
    :class:`~euispice_coreg_tpu_torch.selector.Selector` (injectable for
    offline use) and composed into a synthetic raster automatically
    (``alignment_spice_selector.py:16-118``)."""

    def __init__(
        self,
        small_fov_to_correct: str | None = None,
        lag_crval1=None,
        lag_crval2=None,
        lag_cdelt1=None,
        lag_cdelt2=None,
        lag_crota=None,
        lag_solar_r=None,
        small_fov_window=-1,
        threshold_time: float = 30.0,
        release: float = 6.0,
        imager_file_name_str: str = "fsi304",
        time_margin: float = 300.0,
        folder_path_synras: str = ".",
        selector=None,
        path_to_spice_fits: str | None = None,
        window_spice=None,
        device="cuda",
        **kwargs,
    ):
        """``threshold_time``/``time_margin`` in seconds.  ``selector`` can be
        injected (e.g. a stub) for offline use; defaults to SelectorEui.
        ``device`` serves both the synthetic raster and the search
        (``"cuda"`` without a card raises before any file is read).

        ``path_to_spice_fits``/``window_spice`` are accepted as aliases of
        ``small_fov_to_correct``/``small_fov_window`` for drop-in parity with
        the reference's constructor
        (``alignment_spice_selector.py:12-17``)."""
        from ..io import fits

        resolve_device(device)
        if path_to_spice_fits is not None:
            small_fov_to_correct = path_to_spice_fits
        if small_fov_to_correct is None:
            raise ValueError("small_fov_to_correct (or path_to_spice_fits) "
                             "is required")
        if window_spice is not None:
            small_fov_window = window_spice

        hdul = fits.open(small_fov_to_correct)
        hdr = hdul[small_fov_window].header
        t_beg = timeutils.parse_fits_time(str(hdr["DATE-BEG"]))
        t_end_key = hdr.get("DATE-END", hdr.get("DATE-AVG", hdr["DATE-BEG"]))
        t_end = timeutils.parse_fits_time(str(t_end_key))

        if selector is None:
            selector = SelectorEui(release=release, level=2)
        urls, _ = selector.get_url_from_time_interval(
            t_beg - time_margin, t_end + time_margin,
            file_name_str=imager_file_name_str,
        )
        if len(urls) == 0:
            raise ValueError("no imager files found spanning the SPICE raster")

        builder = SPICEComposedMapBuilder(
            path_to_spectro=small_fov_to_correct,
            list_imager_paths=list(urls),
            threshold_time=threshold_time,
            window_imager=-1,
            window_spectro=small_fov_window,
            device=device,
        )
        synras_path = builder.process(
            folder_path_output=folder_path_synras,
            print_filename=False,
            return_synras_name=True,
        )

        super().__init__(
            large_fov_known_pointing=synras_path,
            small_fov_to_correct=small_fov_to_correct,
            lag_crval1=lag_crval1,
            lag_crval2=lag_crval2,
            lag_cdelt1=lag_cdelt1,
            lag_cdelt2=lag_cdelt2,
            lag_crota=lag_crota,
            lag_solar_r=lag_solar_r,
            large_fov_window=0,
            small_fov_window=small_fov_window,
            device=device,
            **kwargs,
        )
        self.synras_path = synras_path
