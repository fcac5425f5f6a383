"""The seeded generator and the FITS writer."""
import numpy as np
import pytest
import torch

from _tiny import DATA  # noqa: F401  (puts the repo root on sys.path)
from coreg_bench import discover, inputs

SEEDS = (0, 2 ** 31 + 12345, 3 * 2 ** 32 + 7)


def _pair(cell, seed, k=0):
    wl = discover.workload(cell, DATA)
    cfg = discover.config(wl["config"], DATA)
    return inputs.make_pair(cfg, wl, seed, k, torch.device("cpu"))


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes(cell, seed):
    a, b = _pair(cell, seed), _pair(cell, seed)
    for key in ("large", "small"):
        assert a[key].dtype == np.float32
        assert a[key].tobytes() == b[key].tobytes()
    assert a["error"] == b["error"] and a["hdr_small"] == b["hdr_small"]


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_another_seed_or_pair_differs_and_headers_stay(cell):
    a, b, c = _pair(cell, SEEDS[1]), _pair(cell, SEEDS[2]), \
        _pair(cell, SEEDS[1], 1)
    for other in (b, c):
        assert a["small"].tobytes() != other["small"].tobytes()
        assert a["large"].tobytes() != other["large"].tobytes()
        assert a["error"] != other["error"]
        assert a["hdr_small"] == other["hdr_small"]
    wl = discover.workload(cell, DATA)
    assert max(abs(v) for v in a["error"]) <= wl["error_arcsec"]


def _read_fits(path):
    raw = open(path, "rb").read()
    cards, i = {}, 0
    while True:
        card = raw[i:i + 80].decode("ascii")
        i += 80
        if card.startswith("END"):
            break
        key, val = card[:8].strip(), card[10:].strip()
        cards[key] = val.strip("'").strip() if val.startswith("'") \
            else (float(val) if "." in val or "E" in val else
                  (val == "T" if val in ("T", "F") else int(val)))
    start = -(-i // 2880) * 2880
    n1, n2 = cards["NAXIS1"], cards["NAXIS2"]
    data = np.frombuffer(raw[start:start + 4 * n1 * n2], ">f4")
    return cards, data.reshape(n2, n1)


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_fits_round_trip(cell, tmp_path):
    pair = _pair(cell, 77)
    p_large, p_small = inputs.write_pair(pair, str(tmp_path), 3)
    for path, key in ((p_large, "large"), (p_small, "small")):
        hdr, data = _read_fits(path)
        assert np.array_equal(data, pair[key], equal_nan=True)
        assert (tmp_path / path).stat().st_size % 2880 == 0
        for k, v in pair["hdr_" + key].items():
            assert hdr[k] == v, k


def test_the_program_reads_what_was_written(tmp_path):
    from euispice_coreg_tpu_torch.io import fits

    pair = _pair("tiny_carr", 5)
    _, p_small = inputs.write_pair(pair, str(tmp_path), 0)
    hdu = fits.open(p_small)[0]
    assert np.array_equal(np.asarray(hdu.data), pair["small"], equal_nan=True)
    for k, v in pair["hdr_small"].items():
        assert hdu.header[k] == v, k
