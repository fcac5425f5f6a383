"""Remote FITS discovery over HTTP (SIDC EUI release archive).

Host copy of ``euispice_coreg_tpu/selector/selector.py`` (reference
``selector/selector.py:12-78``): walk the per-day index pages of a release
and collect FITS URLs inside a time interval.  Timestamps are parsed from
the ``...image_YYYYMMDDThhmmss...`` file-name convention.  Network access is
isolated behind ``_fetch_index`` (``requests`` and ``bs4`` are imported only
there and in the page parser), so tests run hermetically.
"""
from __future__ import annotations

import numpy as np

from ..utils import timeutils


class Selector:
    def __init__(self, release_url_basis: str):
        self._release_url_basis = release_url_basis

    @property
    def release_url_basis(self):
        return self._release_url_basis

    @release_url_basis.setter
    def release_url_basis(self, value):
        self._release_url_basis = value

    # ------------------------------------------------------------------
    @staticmethod
    def _find_time_from_file(fits_file_name: str) -> float:
        """Epoch seconds from the filename timestamp (selector.py:16-19)."""
        a = fits_file_name[fits_file_name.find("image") + 6 : 21 + fits_file_name.find("image")]
        iso = f"{a[:4]}-{a[4:6]}-{a[6:8]}T{a[9:11]}:{a[11:13]}:{a[13:15]}"
        return timeutils.parse_fits_time(iso)

    def _find_url_from_time(self, t_seconds: float) -> str:
        date = timeutils.format_fits_time(t_seconds)
        return (f"{self.release_url_basis}/{date[0:4]}/{date[5:7]}/{date[8:10]}")

    def _fetch_index(self, url: str) -> str:
        """GET an index page (overridable for tests)."""
        import requests

        resp = requests.get(url=url, timeout=60)
        resp.raise_for_status()
        return resp.text

    def _get_url_list_from_time(self, t_seconds: float, return_time_list=False,
                                file_name_str: str | None = None):
        from bs4 import BeautifulSoup

        if file_name_str is None:
            file_name_str = ""
        url = self._find_url_from_time(t_seconds)
        soup = BeautifulSoup(self._fetch_index(url), "html.parser")
        hrefs = [l.get("href") for l in soup.find_all("a")
                 if l.get("href") and ".fits" in l.get("href")
                 and file_name_str in l.get("href")]
        url_list = [url + "/" + h for h in hrefs]
        if return_time_list:
            return url_list, [self._find_time_from_file(h) for h in hrefs]
        return url_list

    def get_url_from_time_interval(self, time1, time2, file_name_str=None):
        """All FITS URLs between two ISO timestamps (inclusive).

        ``time1``/``time2``: ISO strings or epoch seconds."""
        t1 = timeutils.parse_fits_time(time1) if isinstance(time1, str) else float(time1)
        t2 = timeutils.parse_fits_time(time2) if isinstance(time2, str) else float(time2)
        if t1 > t2:
            raise ValueError(f"time2={time2!r} must be greater than time1={time1!r}")

        urls, times = self._get_url_list_from_time(
            t1, return_time_list=True, file_name_str=file_name_str)
        # walk day by day (selector.py:61-71)
        day0 = timeutils.parse_fits_time(timeutils.format_fits_time(t1)[:10])
        tref = day0
        while tref < t2:
            tref += 86400.0
            if tref < t2:
                u, tt = self._get_url_list_from_time(
                    tref, return_time_list=True, file_name_str=file_name_str)
                urls += u
                times += tt
        times = np.asarray(times)
        urls = np.asarray(urls, dtype=str)
        select = (times >= t1) & (times <= t2)
        return urls[select], times[select]
