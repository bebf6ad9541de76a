"""Fixtures shared by the port's CPU tests (tests/test_torch_*.py)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Run a module's PyTorch work on two threads, then put the setting back.
    The suite runs several worker processes on one host; a full ResnestUNet
    step per test on every core of every worker makes them fight for the
    cores. Import this into a test module to apply it there."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
