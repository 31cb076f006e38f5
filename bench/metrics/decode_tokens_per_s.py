"""Tokens the decode steps of the window emitted (the batch each step),
over the window's seconds (host clock)."""

from bench.harness.readers import tokens_per_s


def read(run):
    return tokens_per_s(run, "decode")
