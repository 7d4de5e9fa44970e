"""Suite-wide setup: make `hypothesis` importable even when not installed.

Must run before test modules are collected, which conftest import order
guarantees. With the real package present this is a no-op.

Also (PR 10) the per-test isolation fixture: process-global wire counters
are zeroed before every test so assertions are deltas, not order-dependent
residue; and when the runtime sanitizer is on (``PANGEA_SANITIZE=1``) its
state is reset per test and every test asserts it finished with zero
lock-order / blocking-while-holding violations.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import pytest

from _hypothesis_compat import install

HYPOTHESIS_SHIMMED = install()

from repro.core import sanitizer as _sanitizer
from repro.runtime import rpc as _rpc


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: launches a CUDA kernel of repro_torch; skips "
        "without an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _pangea_isolation(request):
    """Counter + sanitizer isolation around every test."""
    _rpc.reset_counters()
    if _sanitizer.enabled():
        _sanitizer.reset()
    yield
    if _sanitizer.enabled():
        _sanitizer.assert_clean(request.node.nodeid)
