"""SPICE archive selector (host copy of
``euispice_coreg_tpu/selector/selector_spice.py``).

The reference ships a broken stub here (bad import, no base URL;
``selector_spice.py:1-6``, SURVEY.md 2.3).  This is a working selector over
the Paris-Saclay SPICE release tree, which shares the year/month/day index
layout of the EUI archive.
"""
from __future__ import annotations

from .selector import Selector


class SelectorSpice(Selector):
    default_base_url = "https://spice.osups.universite-paris-saclay.fr/spice-data"

    release_dict = {
        "2.0": "release-2.0",
        "3.0": "release-3.0",
        "4.0": "release-4.0",
    }
    level_dict = {"1": "level1", "2": "level2", "3": "level3"}

    def __init__(self, release=4.0, level=2, base_url: str | None = None):
        if base_url is None:
            base_url = SelectorSpice.default_base_url
        url = (base_url + "/" + SelectorSpice.release_dict[str(release)]
               + "/" + SelectorSpice.level_dict[str(level)])
        super().__init__(release_url_basis=url)
