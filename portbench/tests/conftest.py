"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark
(``tiny.make_copy``), made once a session."""

import pytest

from portbench.tests import tiny


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("portbench")))
