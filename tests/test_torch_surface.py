"""The paper's public surface on the port against the JAX package.

* Every case of ``tests/test_core_erlang.py`` and
  ``tests/test_core_allocator.py`` -- their fixed points, and seeded draws
  from the ranges their property tests sample -- run through both packages'
  ``core.erlang`` and ``core.allocator`` functions: equal bitwise in
  float64 (allocations, E[T], totals, evaluation counts, raised errors).
* ``little_wait`` bitwise the reference's; ``tick_batch(raise_errors=)``
  raises where the reference does; ``mpc_plan(topr=, alloc=)`` hooks
  equal the reference's.
* Hygiene: the four packages export the reference's ``__all__`` names,
  each name resolves, and importing them all (and the launchers, the
  dry-run included) loads no JAX.
"""

from __future__ import annotations

import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as jcore
import repro.core.allocator as jalloc
import repro.core.erlang as jerlang
import repro.forecast.mpc as jm
import repro.models as jmodels
import repro.serving as jserving
import repro.streaming as jstreaming
from repro.core.batched import gain_table as j_gain_table
from repro.core.jackson import OperatorSpec as JSpec
from repro.core.jackson import Topology as JTopology
from repro.streaming.batchsim import little_wait as j_little_wait
import repro_torch.core as tcore
import repro_torch.core.allocator as talloc
import repro_torch.core.erlang as terlang
import repro_torch.forecast.mpc as tm
import repro_torch.models as tmodels
import repro_torch.serving as tserving
import repro_torch.streaming as tstreaming
from repro_torch.convert import mpc_config_from_reference, topology_from_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]

# --------------------------------------------------------------------------- #
# core/erlang.py: the reference test's points and seeded property draws
# --------------------------------------------------------------------------- #
_rng = np.random.default_rng(20240601)
_DRAWS = [(int(k), float(lam), float(mu)) for k, lam, mu in zip(
    _rng.integers(1, 61, 24), _rng.uniform(0.1, 50.0, 24), _rng.uniform(0.1, 20.0, 24))]
_CONVEX = [(float(lam), float(mu)) for lam, mu in zip(_rng.uniform(0.1, 100.0, 12),
                                                      _rng.uniform(0.1, 20.0, 12))]
_POINTS = [(1, 3.0, 10.0), (1, 10.0, 10.0), (2, 30.0, 10.0), (3, 30.0, 10.0), (4, 30.0, 10.0),
           (3, 0.0, 4.0), (500, 10.0, 2.0), (60, 50.0, 0.9)]
ERLANG_CASES = (
    [("expected_sojourn", p) for p in _POINTS + _DRAWS + [(4096, 100000.0, 30.0)]]
    + [("expected_sojourn_factorial", p) for p in _POINTS[:-2] + _DRAWS]
    + [("expected_queue_delay", p) for p in _POINTS + _DRAWS[:6]]
    + [("cached_sojourn", p) for p in _POINTS[:5]]
    + [("marginal_benefit", (k, lam, mu)) for lam, mu in _CONVEX
       for k in range(jerlang.min_stable_k(lam, mu), jerlang.min_stable_k(lam, mu) + 10, 3)]
    + [("sojourn_curve", (22.0, 3.0, 1, 40)), ("sojourn_curve", (22.0, 3.0, 0, 12)),
       ("sojourn_curve", (0.0, 3.0, 2, 5))]
    + [("sojourn_curve", (lam, mu, jerlang.min_stable_k(lam, mu),
                          jerlang.min_stable_k(lam, mu) + 11)) for lam, mu in _CONVEX[:6]]
    + [("min_stable_k", p) for p in ((10.0, 3.0), (9.0, 3.0), (0.0, 3.0), *_CONVEX[:6])]
    + [("erlang_b", p) for p in ((1, 0.5), (2, 1.0), (5, 3.0), (10, 8.0), (0, 2.0))]
    + [("erlang_c", p) for p in ((2, 1.0), (5, 3.0), (10, 8.0), (3, 4.0))]
)


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and (got == want or (math.isnan(got) and math.isnan(want)))


@pytest.mark.parametrize("name,args", ERLANG_CASES,
                         ids=[f"{n}-{'-'.join(f'{a:g}' for a in args)}" for n, args in
                              ERLANG_CASES])
def test_erlang_function_equals_the_reference_bitwise(name, args):
    _same(getattr(terlang, name)(*args), getattr(jerlang, name)(*args))


def test_sojourn_curve_refuses_a_bad_range_as_the_reference_does():
    for args in ((3.0, 1.0, 5, 4), (3.0, 1.0, -1, 4)):
        with pytest.raises(ValueError, match="bad range"):
            terlang.sojourn_curve(*args)
        with pytest.raises(ValueError, match="bad range"):
            jerlang.sojourn_curve(*args)


# --------------------------------------------------------------------------- #
# core/allocator.py
# --------------------------------------------------------------------------- #
def vld_like(lam0=13.0, mus=(2.0, 5.0, 50.0)):
    return JTopology.chain([("extract", mus[0]), ("match", mus[1]), ("agg", mus[2])], lam0=lam0)


def group_like(lam0=8.0):
    ops = [JSpec("gang", 3.0, scaling="group", group_alpha=0.05), JSpec("rep", 6.0),
           JSpec("report", 30.0)]
    routing = np.zeros((3, 3))
    routing[0][1] = 1.0
    routing[1][2] = 0.7
    return JTopology(ops, np.array([lam0, 0.0, 0.0]), routing)


def loop_like():
    ops = [JSpec("gen", 4.0), JSpec("det", 3.0), JSpec("rep", 30.0)]
    routing = np.zeros((3, 3))
    routing[0][1] = 2.0
    routing[1][1] = 0.3
    routing[1][2] = 0.7
    return JTopology(ops, np.array([5.0, 0, 0]), routing)


def twins():
    return JTopology([JSpec("a", 4.0), JSpec("b", 4.0)], np.array([3.0, 3.0]), np.zeros((2, 2)))


def chain12():
    ops = [JSpec(f"op{i}", 2.0 + 0.3 * i) for i in range(12)]
    routing = np.zeros((12, 12))
    for i in range(11):
        routing[i][i + 1] = 1.0
    return JTopology(ops, np.array([5.0] + [0.0] * 11), routing)


_CHAINS = [(float(l0), float(m1), float(m2), int(x)) for l0, m1, m2, x in zip(
    _rng.uniform(1.0, 20.0, 8), _rng.uniform(0.5, 10.0, 8), _rng.uniform(0.5, 10.0, 8),
    _rng.integers(0, 9, 8))]

TOPS = {
    "vld": vld_like, "vld-k512": lambda: vld_like(lam0=13.0 * 512 / 22.0), "group": group_like,
    "loop": loop_like, "twins": twins, "chain12": chain12,
    **{f"chain2-{i}": (lambda c=c: JTopology.chain([("a", c[1]), ("b", c[2])], lam0=c[0]))
       for i, c in enumerate(_CHAINS)},
}


def _floor(top):
    return int(top.min_feasible_allocation().sum())


def _budget_cases():
    out = []
    for k in list(range(11, 41)) + [64, 128]:
        out += [("assign_processors_naive", "vld", k), ("assign_processors", "vld", k),
                ("assign_processors_table", "vld", k)]
    for k in (11, 13, 16, 20, 22):
        out.append(("brute_force_optimal", "vld", k))
    for k in (10, 12, 15):
        out += [("brute_force_optimal", "loop", k), ("assign_processors", "loop", k),
                ("assign_processors_naive", "loop", k)]
    for top in ("vld", "group"):
        for k in (16, 33, 64, 128, 512):
            out += [(fn, top, k) for fn in ("assign_processors_naive", "assign_processors",
                                            "assign_processors_table")]
    out += [(fn, "vld-k512", 512) for fn in ("assign_processors_naive", "assign_processors",
                                              "assign_processors_table")]
    out += [(fn, "twins", k) for k in range(2, 12)
            for fn in ("assign_processors_table", "assign_processors_naive")]
    out += [(fn, "chain12", 120) for fn in ("assign_processors_naive", "assign_processors")]
    for i, c in enumerate(_CHAINS):
        out += [("assign_processors", f"chain2-{i}", "floor+" + str(c[3])),
                ("brute_force_optimal", f"chain2-{i}", "floor+" + str(c[3]))]
    out += [("assign_processors", "vld", "floor-1"), ("assign_processors_naive", "vld", "floor-1"),
            ("brute_force_optimal", "vld", "floor-1")]
    return out


BUDGET_CASES = _budget_cases()
SLO_CASES = ([(fn, "vld", t) for fn in ("min_processors", "min_processors_table")
              for t in (2.0, 1.2, 0.9, 0.75, 0.5)]
             + [(fn, "group", 0.9) for fn in ("min_processors", "min_processors_table")]
             + [("min_processors_table", "vld", (0.73, 12))])
ALLOCATE_CASES = [dict(k_max=22), dict(t_max=1.2), dict(k_max=50, t_max=1.2),
                  dict(k_max=12, t_max=1e-9), dict(t_max=0.5), dict(k_max=10)]


def _call(mod, fn, top, *args):
    """The result, or the raised error's type name and message."""
    try:
        return getattr(mod, fn)(top, *args)
    except (jalloc.InsufficientResourcesError, talloc.InsufficientResourcesError) as e:
        return ("raises", type(e).__name__, str(e))


def _same_result(got, want):
    if isinstance(want, tuple) and isinstance(want[0], str):
        assert got == want
    elif isinstance(want, tuple):  # brute_force_optimal: (k, E[T])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got.k, want.k)
        assert got.k.dtype == want.k.dtype
        assert (got.expected_sojourn, got.total, got.evaluations) == (
            want.expected_sojourn, want.total, want.evaluations)


@pytest.mark.parametrize("fn,top_name,budget", BUDGET_CASES,
                         ids=[f"{f}-{t}-{k}" for f, t, k in BUDGET_CASES])
def test_program4_allocator_equals_the_reference_bitwise(fn, top_name, budget):
    jtop = TOPS[top_name]()
    if isinstance(budget, str):
        budget = _floor(jtop) + int(budget[len("floor"):])
    if budget < _floor(jtop) and fn not in ("assign_processors", "assign_processors_naive",
                                            "brute_force_optimal"):
        pytest.fail("case below the floor for a solver that does not raise")
    _same_result(_call(talloc, fn, topology_from_reference(jtop), budget),
                 _call(jalloc, fn, jtop, budget))


@pytest.mark.parametrize("fn,top_name,t_max", SLO_CASES,
                         ids=[f"{f}-{t}-{s}" for f, t, s in SLO_CASES])
def test_program6_allocator_equals_the_reference_bitwise(fn, top_name, t_max):
    jtop = TOPS[top_name]()
    args = t_max if isinstance(t_max, tuple) else (t_max,)
    kw_args = args[:1]
    if len(args) == 2:  # (t_max, k_cap)
        got = _call_kw(talloc, fn, topology_from_reference(jtop), args[0], k_cap=args[1])
        want = _call_kw(jalloc, fn, jtop, args[0], k_cap=args[1])
    else:
        got = _call(talloc, fn, topology_from_reference(jtop), *kw_args)
        want = _call(jalloc, fn, jtop, *kw_args)
    _same_result(got, want)


def _call_kw(mod, fn, top, *args, **kw):
    try:
        return getattr(mod, fn)(top, *args, **kw)
    except (jalloc.InsufficientResourcesError, talloc.InsufficientResourcesError) as e:
        return ("raises", type(e).__name__, str(e))


@pytest.mark.parametrize("kw", ALLOCATE_CASES, ids=[str(k) for k in ALLOCATE_CASES])
def test_allocate_dispatch_equals_the_reference_bitwise(kw):
    jtop = vld_like()
    _same_result(_call_kw(talloc, "allocate", topology_from_reference(jtop), **kw),
                 _call_kw(jalloc, "allocate", jtop, **kw))


@pytest.mark.parametrize("top_name,k_start,budget", [
    ("vld", (7, 3, 1), 8), ("vld", (7, 3, 1), 0), ("group", (1, 2, 1), 20),
    ("twins", (1, 1), 4)])
def test_greedy_increments_equals_the_reference_bitwise(top_name, k_start, budget):
    jtop = TOPS[top_name]()
    _, G = j_gain_table(jtop, 24)
    got = talloc.greedy_increments(np.asarray(G), np.array(k_start), budget)
    np.testing.assert_array_equal(got, jalloc.greedy_increments(G, np.array(k_start), budget))
    with pytest.raises(ValueError):
        talloc.greedy_increments(np.asarray(G)[:, :10], np.array(k_start) + 7, 8)


# --------------------------------------------------------------------------- #
# little_wait, tick_batch(raise_errors=), mpc_plan(topr=, alloc=)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", [0.05, 0.5])
def test_little_wait_equals_the_reference_bitwise(dt):
    import torch

    from repro_torch.streaming.batchsim import little_wait

    rng = np.random.default_rng(9)
    q = rng.uniform(0.0, 30.0, (6, 5))
    adm = np.where(rng.random((6, 5)) < 0.25, 0.0, rng.uniform(0.01, 40.0, (6, 5)))
    got = little_wait(torch.from_numpy(q), torch.from_numpy(adm), dt).numpy()
    np.testing.assert_array_equal(got, j_little_wait(q, adm, dt))
    assert (got[adm == 0] == 0).all()


def test_tick_batch_raise_errors_follows_the_reference():
    """Lanes the model cannot price (a budget below the floor, an unstable
    measured loop): ``"infeasible"`` rows with the errors by default, the
    first hard error raised with ``raise_errors`` -- in both packages, with
    the same type and message."""
    import repro.core.controller as jctl
    import repro.core.measurer as jmeas
    from repro.api.session import ScenarioRunner as JRunner
    from repro.streaming.scenarios import scenario_matrix as j_scenario_matrix
    from repro_torch.convert import (measurement_from_reference, params_from_reference,
                                     static_from_reference)
    from repro_torch.core import controller as tctl

    jr = JRunner([s.with_(negotiated=False) for s in j_scenario_matrix(3, seed=4)],
                 tick_interval=5.0, backend="numpy")
    params = jr._params()
    params = type(params)(**{**params.__dict__, "k_max": np.array([1, 40, 40])})
    b, n = jr.static.batch, jr.static.n
    rng = np.random.default_rng(3)
    meas = jmeas.MeasurementBatch(lam_hat=np.abs(rng.normal(3.0, 0.5, (b, n))) * jr.static.active,
                                  mu_hat=np.full((b, n), 2.0), lam0_hat=np.full(b, 3.0),
                                  sojourn_hat=np.full(b, 0.5), t=0.0, drop_hat=np.zeros((b, n)))
    k = np.where(jr.static.active, 10, 0).astype(np.int64)
    want = jctl.tick_batch(meas, k.copy(), jr.static, params)
    got = tctl.tick_batch(measurement_from_reference(meas), k.copy(),
                          static_from_reference(jr.static), params_from_reference(params))
    assert [(r.action, r.reason) for r in got.rows] == [(r.action, r.reason) for r in want.rows]
    assert [str(e) for e in got.errors] == [str(e) for e in want.errors]
    assert any(e is not None for e in want.errors)

    def raised(fn, *args):
        try:
            fn(*args, raise_errors=True)
        except Exception as e:  # noqa: BLE001 -- the type is compared below
            return type(e).__name__, str(e)
        return None

    want_err = raised(jctl.tick_batch, meas, k.copy(), jr.static, params)
    assert want_err is not None and want_err[0] in ("InsufficientResourcesError",
                                                    "UnstableTopologyError")
    assert raised(tctl.tick_batch, measurement_from_reference(meas), k.copy(),
                  static_from_reference(jr.static), params_from_reference(params)) == want_err


def _plan_inputs():
    rng = np.random.default_rng(17)
    b, n, hzn, k_hi = 5, 4, 3, 40
    kw = dict(
        mu=rng.uniform(2.0, 9.0, (b, n)), group=np.zeros((b, n), dtype=bool),
        alpha=np.zeros((b, n)), speed=np.ones((b, n)), active=np.ones((b, n), dtype=bool),
        src_mask=(np.arange(n)[None, :] == 0).repeat(b, axis=0),
        cap_queue=np.full((b, n), np.inf), t_max=np.where(np.arange(b) % 2 == 0, 3.0, np.inf),
        k_max=np.full(b, 48, dtype=np.int64), span=10.0, k_hi=k_hi,
    )
    return (rng.uniform(1.0, 18.0, (b, hzn, n)), rng.uniform(0.0, 8.0, (b, n)),
            rng.integers(1, 7, (b, n)).astype(np.int64), kw)


@pytest.mark.parametrize("hook", ["topr", "alloc"])
def test_mpc_plan_hooks_equal_the_reference_bitwise(hook):
    """``topr=`` (the reference's own ``gain_topr_np``) and ``alloc=`` (one
    host allocator handed to both) through both numpy planners."""
    lam_pred, q0, k_cur, kw = _plan_inputs()
    jcfg = jm.MPCConfig(horizon=3, window=12)
    cfg = mpc_config_from_reference(jcfg)
    calls = []

    def alloc(lam_m, budgets_m):
        calls.append(lam_m.shape)
        share = lam_m / lam_m.sum(axis=-1, keepdims=True)
        return np.floor(share * budgets_m[:, None]).astype(np.int64) + 1

    extra = {"topr": jm.gain_topr_np} if hook == "topr" else {"alloc": alloc}
    want = jm.mpc_plan(lam_pred, q0, k_cur, cfg=jcfg, xp=np, **kw, **extra)
    got = tm.mpc_plan(lam_pred, q0, k_cur, cfg=cfg, **kw, **extra)
    for name, a, c in zip(("k_plan", "any_ok", "et_hold", "et_plan", "need"), want, got):
        np.testing.assert_array_equal(c, np.asarray(a), err_msg=name)
    if hook == "alloc":
        assert calls == [(15, 4), (15, 4)]
    else:
        plain = tm.mpc_plan(lam_pred, q0, k_cur, cfg=cfg, **kw)
        np.testing.assert_array_equal(got[0], plain[0])


# --------------------------------------------------------------------------- #
# Hygiene: the exported names
# --------------------------------------------------------------------------- #
PACKAGES = {"core": (jcore, tcore), "streaming": (jstreaming, tstreaming),
            "models": (jmodels, tmodels), "serving": (jserving, tserving)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_package_exports_the_references_names(pkg):
    ref, mine = PACKAGES[pkg]
    assert sorted(mine.__all__) == sorted(ref.__all__)
    assert len(mine.__all__) == len(set(mine.__all__))
    for name in mine.__all__:
        assert getattr(mine, name) is not None, name


def test_every_exported_name_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for pkg in ('core', 'streaming', 'models', 'serving', 'data', 'training',\n"
        "            'distributed', 'api', 'forecast', 'checkpoint'):\n"
        "    mod = importlib.import_module('repro_torch.' + pkg)\n"
        "    for name in mod.__all__:\n"
        "        getattr(mod, name)\n"
        "import repro_torch.launch.serve, repro_torch.launch.train, repro_torch.configs.shapes\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.trace_cost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
