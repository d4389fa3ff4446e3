"""Thread pinning shared by the port's CPU test files.

Import the fixture into a test module (``from _torch_threads import
_one_intra_op_thread``); it is autouse, so every test of that module runs on
one intra-op thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These boxes are small: one intra-op thread runs them about as fast
    as eight, and leaves the cores to the suite's other workers (torch's
    spinning thread pools slow the whole parallel run otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
