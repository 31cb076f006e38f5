"""The host's kernel launches (CUDA runtime launch calls in the trace) per
decode step of the traced segment."""


def read(run):
    tl = run.timeline
    if run.kind != "decode" or tl is None or not run.traced_calls or not tl.launches:
        return None
    return tl.launches / len(run.traced_calls)
