"""Repository-wide test isolation.

A test that changes matplotlib's rcParams (``plot.use_style()`` sets
``savefig.dpi`` among others) must not change the figures of later tests in
the same process: every test runs inside its own ``matplotlib.rc_context``,
which restores the rcParams when the test ends.  matplotlib is optional.

The JAX package's reference codecs (``euispice_coreg_tpu/io/native``) build
with g++ straight into their package directory, with no temporary file, and
load whatever file is there once it is newer than the sources.  Under
pytest-xdist two workers can then meet there: one loads the library while
the other is still writing it (``OSError: ... file too short`` or ``invalid
ELF header``).  Each test process therefore builds and loads its own copy in
its own temporary directory.  JAX is optional.
"""
import pytest


@pytest.fixture(autouse=True)
def _isolate_matplotlib_rcparams():
    try:
        import matplotlib
    except ImportError:
        yield
        return
    with matplotlib.rc_context():
        yield


@pytest.fixture(scope="session", autouse=True)
def _private_reference_codec_library(tmp_path_factory):
    try:
        from euispice_coreg_tpu.io import native
    except ImportError:
        yield
        return
    if native._lib is None:
        native._SO = str(tmp_path_factory.mktemp("reference_codecs")
                         / "libeuicoreg_native.so")
    yield
