"""Repository-wide test isolation.

A test that changes matplotlib's rcParams (``plot.use_style()`` sets
``savefig.dpi`` among others) must not change the figures of later tests in
the same process: every test runs inside its own ``matplotlib.rc_context``,
which restores the rcParams when the test ends.  matplotlib is optional.
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
