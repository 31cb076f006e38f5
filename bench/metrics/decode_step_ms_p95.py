"""The 95th percentile of the window's decode steps, each timed on the host
from the call until its batch's tokens are on the host."""

from bench.harness.readers import step_ms_p95


def read(run):
    return step_ms_p95(run)
