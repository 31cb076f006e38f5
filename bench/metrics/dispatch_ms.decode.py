"""Host milliseconds from calling ``decode_step`` until it returns, before
the tokens are read back: the mean over the window's steps."""


def read(run):
    if run.kind != "decode" or not run.calls:
        return None
    return 1e3 * sum(c["dispatch"] for c in run.calls) / len(run.calls)
