"""One torch thread for the port's CPU tests.

The port's CPU tests run loops of small torch operations.  The suite runs
several test processes side by side, and each process's torch would start a
pool of intra-op threads as wide as the host, so the pools crowd each other
off the cores; even alone on the host, one thread runs these loops faster
than a pool.  Each ``tests/test_torch_*.py`` takes the fixture with one
import line, which pytest finds in the module's namespace::

    from torch_threads import one_torch_thread  # noqa: F401

Ranks spawned by ``torch_ranks`` import no fixture and set their own.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests run on one torch thread; the count before is
    restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
