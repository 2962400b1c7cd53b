"""The benchmark's own tests. They run on the CPU at a tiny size; a test
that needs the card carries the `chip` marker and skips, deciding inside
the test, where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (run on the card)")


import pytest  # noqa: E402


@pytest.fixture(scope="session")
def tiny_run(tmp_path_factory):
    """One tiny CPU run of the tiny cell in a fresh interpreter, with the
    control's readings: (exit code, stdout lines, stderr)."""
    from slam_bench.tests import tiny

    tmp = tiny.make_checkout(tmp_path_factory.mktemp("checkout"))
    return tiny.run_subprocess(tmp, *tiny.args(2 ** 31 + 11, control=1))
