"""Caps torch's intra-op threads in a pytest-xdist worker to its share of the cores.

Why: the suite runs as `pytest -n 6 --dist loadfile`, six worker processes on
one machine. Left alone, torch sizes its OpenMP/MKL pool in each worker to the
whole machine, so six whole-machine pools (and XLA's threads besides) spin on
the same cores and mostly wait on one another. Six copies at once of
`test_torch_port_train.py::test_twenty_train_steps_and_ema_match_jax[nerf-0]`
took ~125 s each with torch's default pool and ~33 s each with one thread on
an 8-core machine.

How: every `tests/test_torch_*.py` imports this module in its first lines, and
an xdist worker imports every test module when it collects, before its first
test. So the cap holds for the whole worker, the JAX-side tests included. The
share is `os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`, at least one: it is
worked out from what the run can see, so it is no knob. Outside a worker (a
run by hand without `-n`) this does nothing and torch keeps the whole machine.
`tests/test_torch_threads.py` fails if the cap is not in force in a worker.

What it must never do: change a tolerance, a seed or a size, or be read by
the program. Nothing under `smpl_nerf_tpu_torch/` imports it, and it adds no
environment variable or flag to the program.
"""
import os

import torch

_worker_count = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _worker_count is not None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_worker_count)))
