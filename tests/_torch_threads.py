"""One PyTorch intra-op thread for the port's CPU tests.

The tier-1 run puts six pytest workers on the machine's cores, and each
worker's PyTorch keeps an intra-op pool of one OpenMP thread per core.
The port's tests run thousands of small tensor operations and batched
products; with six pools on the same cores they ran about three times
slower than with one thread each (six of the port's test files: 210 s
against 66 s of wall time on eight cores).  Every ``tests/test_torch_*.py``
imports this fixture, which holds PyTorch at one intra-op thread for the
file's tests and gives the pool back after them.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_intraop_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
