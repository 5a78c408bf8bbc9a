r"""One torch thread for each test process of the port's CPU tests.

The tests run several processes to a machine (pytest-xdist workers, beside
JAX's own thread pools), and torch's default of one thread per core then
oversubscribes the cores: each small operation's threads wait on the other
processes' (a tiny ADM forward took 5.1 s on 8 threads under that load,
0.08 s on one). The tests import this module for its effect.
"""

import torch

torch.set_num_threads(1)
