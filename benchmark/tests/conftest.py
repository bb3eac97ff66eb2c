import pytest

from benchmark.tests import tiny


@pytest.fixture(autouse=True, scope="session")
def _tiny_cache(tmp_path_factory):
    """The tiny scenes' photos in a directory of the session's own."""
    tiny.use_cache(tmp_path_factory.mktemp("bench_cache"))
