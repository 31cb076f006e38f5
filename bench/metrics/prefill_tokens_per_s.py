"""Prompt tokens of the prefill calls completed in the window, over the
window's seconds (host clock)."""

from bench.harness.readers import tokens_per_s


def read(run):
    return tokens_per_s(run, "prefill")
