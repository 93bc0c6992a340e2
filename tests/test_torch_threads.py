"""The intra-op thread cap that the port's heavier test files share.

A file takes it with ``from test_torch_threads import two_threads``: pytest
then applies the fixture to that file's tests, once per file."""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def capped_threads(n: int):
    """torch's intra-op threads set to ``n`` inside, the count before
    restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while a file runs: the suite runs several files
    at once, and torch's OpenMP pool of one thread per core then stalls the
    full-width nets' ops for minutes."""
    with capped_threads(2):
        yield


def test_the_fixture_caps_this_file_at_two_threads():
    assert torch.get_num_threads() == 2


def test_capped_threads_restores_the_count():
    saved = torch.get_num_threads()
    with capped_threads(1):
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == saved
    with pytest.raises(RuntimeError), capped_threads(1):
        raise RuntimeError("raised inside the cap")
    assert torch.get_num_threads() == saved
