"""One torch thread per test process, for the port's tests.

Tier-1 runs the suite under pytest-xdist, six workers on a machine of a
few cores, and torch starts one intra-op thread per core in every
worker. The port's CPU tests run many tiny torch ops (trees of a few
hundred rows); with six workers each spinning eight threads on each
other's ops, a 4 s test took over 250 s. With one thread a worker the
port's tests ran in about a third of the time, with the same passes.
Every tests/test_torch_*.py calls one_torch_thread() at import: xdist
workers import every module while they collect, so the setting holds
for the whole worker, whichever test it runs.
"""

import torch


def one_torch_thread() -> None:
    torch.set_num_threads(1)
