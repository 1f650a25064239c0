"""torch's intra-op threads for the port's tests: each pytest-xdist worker
gets its share of the host's cores.

By default every torch process starts one thread per core, so 6 workers
on 8 cores run 48 threads for 8 cores, and the port's CPU device tier,
thousands of small operations a frame, then spends its time waiting for
threads: on an 8-core host, test_torch_pvqsearch.py's 96x64 lean-tier
case took 187 s in each of 6 concurrent processes with 8 threads and
9 s with 1.  Each port test module calls share_cores() when it is
imported; every worker imports every module, so the share holds from
the first test on.  Run in one process, torch keeps a thread per core.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
