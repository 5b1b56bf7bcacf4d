"""One CPU thread budget for torch in each pytest-xdist worker.

Under ``pytest -n N`` every worker runs torch's CPU ops with an OpenMP pool
of one thread per CPU, so N workers keep N times as many threads busy as
the machine has CPUs, and OpenMP's threads spin while they wait for work.
On 8 CPUs with 6 workers the tier-1 suite took 1027-1471 s that way and
216 s with ``OMP_NUM_THREADS=1``: the time went to the oversubscription,
not to the tests.

pytest imports every test module of a run in each worker before the
first test runs, so this module sets each worker's torch pool to its
share of the CPUs (``cpu_count // N``, at least 1) when it is imported.
Without xdist it changes nothing.  The tests' values do not depend on the
pool's size: every torch result the tests compare is held to the JAX
package within a stated tolerance, or is one fixed order of operations.
"""

import os

import torch


def worker_threads():
    """The torch CPU threads of one xdist worker, or None outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers <= 1:
        return None
    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count()
    return max(1, cpus // workers)


_THREADS = worker_threads()
if _THREADS is not None:
    torch.set_num_threads(_THREADS)


def test_worker_thread_budget():
    """Under xdist, torch's pool in this worker is the worker's share of
    the CPUs; the workers' pools together fit the machine."""
    want = worker_threads()
    if want is None:
        assert torch.get_num_threads() >= 1
        return
    assert torch.get_num_threads() == want
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    assert want * workers <= max(len(os.sched_getaffinity(0)), workers)
