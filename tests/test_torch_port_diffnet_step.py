"""Port parity: one late training step of the diffnet zoo (HRNet-18 with
stages 3 and 4 cut to one module) against the JAX package's step, through
tests/test_torch_port_vit_step.py::check_late_step, whose docstring states
the setup and the bounds. A file of its own so that each of the two stays
under a minute on one worker.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 60 s, JAX compiling most of it.
"""

import pytest
import torch

from tests.test_torch_port_vit_step import check_late_step
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def test_late_step_matches_jax(monkeypatch):
    check_late_step("diffnet", monkeypatch)
