"""The test helper `_torch_threads` caps torch's threads in xdist workers, and only there.

The rule: inside a pytest-xdist worker torch's intra-op pool is
`max(1, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT)` threads; outside one it
is what torch chose. The rule is restated here rather than read from the
helper, so that a change to either shows.
"""
import _torch_threads  # noqa: F401

import os
import subprocess
import sys

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))

# Prints torch's thread count before and after importing the helper.
_PROBE = ("import torch; before = torch.get_num_threads(); import _torch_threads; "
          "print(before, torch.get_num_threads())")


def _rule(worker_count):
    return max(1, os.cpu_count() // int(worker_count))


def _fresh_process_threads(worker_count):
    """(before, after) importing the helper, in a new process whose environment
    says it is an xdist worker of `worker_count` workers, or none when None."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_XDIST_")}
    if worker_count is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = worker_count
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=TESTS, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    before, after = map(int, out.stdout.split())
    return before, after


@pytest.mark.parametrize("worker_count", [None, "2", "6"])
def test_helper_caps_threads_only_in_an_xdist_worker(worker_count):
    before, after = _fresh_process_threads(worker_count)
    if worker_count is None:
        assert after == before
    else:
        assert after == _rule(worker_count)


def test_cap_is_in_force_in_this_process():
    count = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if count is None:
        expected = _fresh_process_threads(None)[0]
    else:
        expected = _rule(count)
    assert torch.get_num_threads() == expected
