"""The port's serving entry points with one fault planted underneath, for
showing that ``correct`` comes out false (``bench/calibrate.py --faults``
on the card, ``tests/test_bench_faults.py`` on the CPU).  The faults a
serving cell can have:

``state_unchanged``  a call that leaves the cache as it was;
``half_batch``       half of the batch left out, its answers copied from
                     the other half;
``token_altered``    from the third call on, the first sequence is served
                     its least likely token.

(No cell spans chips, so none can leave out an exchange between them.)
"""

from __future__ import annotations

import torch

from . import program

FAULTS = ("state_unchanged", "half_batch", "token_altered")


class Api:
    """``repro_torch.models.serve`` with ``fault`` planted (``"none"``: as it
    is)."""

    def __init__(self, fault: str):
        if fault not in FAULTS + ("none",):
            raise ValueError(f"fault {fault!r}")
        self.serve, self.fault = program.api(), fault
        self.init_cache = self.serve.init_cache
        self.calls = 0

    def _half(self, fn, params, cfg, tokens, cache, batched, **kw):
        h = tokens.shape[0] // 2
        view = {**cache, "k": cache["k"][:, :h], "v": cache["v"][:, :h]}
        logits, out = fn(params, cfg, batched(tokens[:h]), view, **kw)
        if kw.get("routing") is not None:  # the records cover the half that ran
            for r in kw["routing"]:
                for key in ("experts", "kept"):
                    r[key] = torch.cat([r[key], r[key]])
        return torch.cat([logits, logits]), {**cache, "length": out["length"]}

    def _run(self, fn, params, cfg, tokens, cache, batched, **kw):
        self.calls += 1
        if self.fault == "state_unchanged":
            scratch = {k: v.clone() for k, v in cache.items()}
            logits, out = fn(params, cfg, batched(tokens), scratch, **kw)
            return logits, {**cache, "length": out["length"]}
        if self.fault == "half_batch":
            return self._half(fn, params, cfg, tokens, cache, batched, **kw)
        logits, out = fn(params, cfg, batched(tokens), cache, **kw)
        if self.fault == "token_altered" and self.calls >= 3:
            logits = logits.clone()
            logits[0] = -logits[0]
        return logits, out

    def prefill(self, params, cfg, batch, cache, **kw):
        return self._run(self.serve.prefill, params, cfg, batch["tokens"], cache,
                         lambda t: {"tokens": t}, **kw)

    def decode_step(self, params, cfg, tokens, cache, **kw):
        return self._run(self.serve.decode_step, params, cfg, tokens, cache, lambda t: t, **kw)
