"""Fixtures of the benchmark's CPU tests: a data cache of their own under
the test's temporary directory, and two torch threads."""

import pytest
import torch


@pytest.fixture(autouse=True)
def tree_cache(tmp_path_factory, monkeypatch):
    from benchmark.drivers import common

    monkeypatch.setattr(common, "CACHE_DIR",
                        tmp_path_factory.getbasetemp() / "bench_cache")


@pytest.fixture(autouse=True, scope="session")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
