"""The share of the traced segment's prefill calls in which no device
operation ran, in %.  The segment is profiled on the host as well, so the
profiler's own host cost is in the share: small where the card paces the
calls, most of it where the host paces them."""

from bench.harness.readers import idle_share


def read(run):
    return idle_share(run, "prefill")
