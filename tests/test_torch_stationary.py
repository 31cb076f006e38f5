"""``stationary_wait``'s Erlang-B table route (``k_bound``) against its
masked loop, the JAX package's wait and its float64 numpy twin, and the
fused loop that passes the bound.

The table route computes rows ``0 .. k_bound`` with one
``kernels/erlang_c`` table and gathers each lane's row; it must hold the
masked loop's value bit for bit.  The CUDA kernel computes the table's
quotient as a double quotient rounded once to float
(``csrc/common.cuh:div_rn``); ``test_double_quotient_rounds_like_float_division``
checks that premise with numpy along the recurrence.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streaming.batchsim as jbs
from repro.api.session import ScenarioRunner as JaxRunner
from repro.streaming.scenarios import scenario_matrix
from repro_torch.convert import from_reference
from repro_torch.core import controller as tctl
from repro_torch.streaming import batchsim as tbs

CAP = tbs.STATIONARY_K_CAP


def _zoo(seed=0, past_cap=False):
    """[B, N] lanes: replica and gang lanes at random loads, k = 0,
    lam = 0, lam >= k mu (at and past capacity), light loads whose
    Erlang-B values fall to subnormals and to 0 (in float32 and in
    float64) with mu >= 1 (so a subnormal B keeps the wait subnormal),
    and, with ``past_cap``, lanes of 600 and 1000 servers."""
    rng = np.random.default_rng(seed)
    lanes = []  # (k, lam, mu, group)

    def add(k, lam, mu, group=False):
        lanes.append((k, lam, mu, group))

    for _ in range(60):  # replica lanes
        k = int(rng.integers(1, 13))
        mu = rng.uniform(0.5, 5.0)
        add(k, rng.uniform(0.05, 0.98) * k * mu, mu)
    for _ in range(30):  # gang lanes (k_srv = min(k, 1))
        k = int(rng.integers(1, 9))
        mu = rng.uniform(0.5, 5.0)
        add(k, rng.uniform(0.05, 0.9) * mu * k / (1.0 + 0.05 * (k - 1)), mu, True)
    for group in (False, True):
        add(0, 3.0, 2.0, group)  # unallocated
        add(4, 0.0, 2.0, group)  # idle
        add(3, 3 * 2.0, 2.0, group)  # at capacity
        add(3, 9.5, 2.0, group)  # past capacity
    for a in (1e-15, 1e-6, 1e-3, 1e-2, 0.1, 0.5):
        for k in (12, 20, 21, 30, 48):
            mu = rng.uniform(1.0, 4.0)
            add(k, a * mu, mu)
    if past_cap:
        for k, a in ((600, 300.0), (600, 590.0), (1000, 700.0), (CAP, 400.0)):
            mu = rng.uniform(1.0, 2.0)
            add(k, a * mu, mu)
    rng.shuffle(lanes)
    n = 8
    lanes += [(0, 0.0, 1.0, False)] * ((-len(lanes)) % n)  # padding lanes
    k, lam, mu, group = (np.array(col) for col in zip(*lanes))
    shape = (-1, n)
    return dict(
        k=k.astype(np.int32).reshape(shape), lam=lam.reshape(shape), mu=mu.reshape(shape),
        group=group.astype(bool).reshape(shape),
        alpha=np.where(group, 0.05, 0.0).reshape(shape),
        speed=rng.uniform(0.8, 1.25, len(lanes)).reshape(shape),
        ca2=rng.uniform(0.5, 2.0, len(lanes)).reshape(shape),
        cs2=rng.uniform(0.5, 2.0, len(lanes)).reshape(shape),
    )


def _torch_args(z, dtype):
    f = {key: torch.from_numpy(z[key]).to(dtype) for key in ("lam", "mu", "alpha", "speed",
                                                            "ca2", "cs2")}
    return (torch.from_numpy(z["k"]), f["lam"], f["mu"], torch.from_numpy(z["group"]),
            f["alpha"], f["speed"], f["ca2"], f["cs2"])


def _tight_bound(z):
    k_srv = np.where(z["group"], np.minimum(z["k"], 1), z["k"])
    return min(int(k_srv.max()), CAP)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _flush(x):
    """Subnormals to zero: XLA's CPU backend runs flush-to-zero, PyTorch
    (like the CUDA kernel) keeps them (as ``test_torch_kernels._bitwise_ftz``)."""
    x = np.asarray(x)
    return np.where(np.abs(x) < np.finfo(x.dtype).tiny, np.zeros_like(x), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["tight", "loose", "cap"])
def test_table_route_equals_masked_loop_bitwise(dtype, case):
    z = _zoo(seed=1, past_cap=case == "cap")
    bound = {"tight": _tight_bound(z), "loose": _tight_bound(z) + 17, "cap": CAP}[case]
    args = _torch_args(z, dtype)
    want = tbs.stationary_wait(*args)
    got = tbs.stationary_wait(*args, k_bound=bound)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    w = want.numpy()
    assert (w > 0).sum() > 50 and (w == 0).sum() > 10  # stable and not-stable lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zoo_reaches_subnormal_and_zero_erlang_b(dtype):
    """The zoo's light lanes do drive B(k) to subnormals and to 0."""
    z = _zoo(seed=1)
    k, lam, mu, group, alpha, speed = _torch_args(z, dtype)[:6]
    a = (lam / (mu * speed)).reshape(-1)
    from repro_torch.kernels.erlang_c import ref

    table = ref.erlang_b_table(a, k_hi=_tight_bound(z))
    b = table.gather(0, k.reshape(1, -1).long())[0]
    busy = ~group.reshape(-1) & (lam.reshape(-1) > 0)
    assert ((b[busy] > 0) & (b[busy] < torch.finfo(dtype).tiny)).any()
    assert (b[busy] == 0).any()


@pytest.mark.parametrize("bounded", [False, True])
def test_both_routes_match_jax_wait_float32(bounded):
    z = _zoo(seed=2, past_cap=True)
    args = _torch_args(z, torch.float32)
    got = tbs.stationary_wait(*args, k_bound=CAP if bounded else None).numpy()
    j = {key: jnp.asarray(z[key].astype(np.float32)) for key in ("lam", "mu", "alpha",
                                                                  "speed", "ca2", "cs2")}
    want = np.asarray(jbs.stationary_wait(
        jnp.asarray(z["k"]), j["lam"], j["mu"], jnp.asarray(z["group"]), j["alpha"],
        j["speed"], j["ca2"], j["cs2"], xp=jnp))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(_flush(got), want)
    assert (want > 0).sum() > 50


@pytest.mark.parametrize("bounded", [False, True])
def test_both_routes_match_numpy_twin_float64(bounded):
    z = _zoo(seed=3, past_cap=True)
    args = _torch_args(z, torch.float64)
    got = tbs.stationary_wait(*args, k_bound=CAP if bounded else None).numpy()
    want = jbs.stationary_wait(z["k"], z["lam"], z["mu"], z["group"], z["alpha"], z["speed"],
                               z["ca2"], z["cs2"], xp=np)
    np.testing.assert_array_equal(_bits(got), _bits(want))  # same ops, same order


def test_double_quotient_rounds_like_float_division():
    """``div_rn``'s premise, along the Erlang-B recurrence for 512 steps
    over a seeded sweep of loads: ``float32(float64(ab) / float64(j + ab))``
    (a zero ``ab`` over a positive ``j + ab`` returned as it is) equals the
    float32 quotient ``ab / (j + ab)`` bit for bit, subnormal and zero
    results included."""
    rng = np.random.default_rng(7)
    a = np.concatenate([
        np.float32(10.0) ** rng.uniform(-12, 3, 20000).astype(np.float32),
        rng.uniform(0, 700, 2000).astype(np.float32),
        np.float32([0.0, 1e-30, 1e-38, 1.0, 512.0, 3e3]),
    ]).astype(np.float32)
    b = np.ones_like(a)
    subnormal = zero = 0
    with np.errstate(under="ignore"):
        for j in range(1, CAP + 1):
            ab = a * b
            den = np.float32(j) + ab
            want = ab / den
            q = (ab.astype(np.float64) / den.astype(np.float64)).astype(np.float32)
            got = np.where((ab == 0) & (den > 0), ab, q)
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"j={j}")
            subnormal += int(((want > 0) & (want < np.finfo(np.float32).tiny)).sum())
            zero += int((want == 0).sum())
            b = want
    assert subnormal > 1000 and zero > 1000


def test_k_bound_outside_the_cap_is_refused():
    args = _torch_args(_zoo(seed=4), torch.float32)
    for bad in (-1, CAP + 1):
        with pytest.raises(ValueError, match="k_bound"):
            tbs.stationary_wait(*args, k_bound=bad)


def _fleet(dtype, k0_top=None):
    scens = [s.with_(negotiated=False)
             for s in scenario_matrix(8, seed=31, horizon=20.0, warmup=5.0, dt=0.05)]
    runner = JaxRunner(scens, tick_interval=5.0, backend="numpy", fused=False)
    params = runner._params()
    k0 = np.array(runner.k)
    if k0_top is not None:
        k0[0, 0] = k0_top
    arrays, static, pr, state = from_reference(
        runner.arrays, runner.static, params, k0, device="cpu", dtype=dtype)
    return arrays, static, pr, state, k0, runner._steps_per_tick


def _spy(monkeypatch, masked=False):
    """Record the ``k_bound`` each tick hands ``composed_wait`` (and with
    ``masked``, run the masked loop instead)."""
    seen = []
    orig = tbs.composed_wait

    def wrapped(*args, k_bound=None, **kw):
        seen.append(k_bound)
        return orig(*args, k_bound=None if masked else k_bound, **kw)

    monkeypatch.setattr(tbs, "composed_wait", wrapped)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fused", [False, True])
def test_fused_loop_table_route_equals_masked_loop(monkeypatch, dtype, fused):
    """The loop through the table route gives the masked loop's outputs
    bit for bit, with the decide's k_hi (here the fleet's k_max) as the
    bound on every tick."""
    arrays, static, pr, _state, k0, spt = _fleet(dtype)
    outs = []
    for masked in (False, True):
        with monkeypatch.context() as m:
            seen = _spy(m, masked)
            loop, n_ticks = tctl.make_fused_loop(arrays, static, pr, steps_per_tick=spt,
                                                 fused=fused, device="cpu", dtype=dtype)
            outs.append(loop(k0))
        assert seen == [int(pr.k_max.max())] * n_ticks
    got, want = outs
    for key, v in want.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(_bits(got[key].numpy()) if v.is_floating_point()
                                          else got[key].numpy(),
                                          _bits(v.numpy()) if v.is_floating_point()
                                          else v.numpy(), err_msg=key)
        else:
            assert got[key] == v, key


@pytest.mark.parametrize("k0_top,want", [(None, None), (100, 100), (CAP + 188, CAP)])
def test_fused_loop_bound_covers_k0_and_resumed_states(monkeypatch, k0_top, want):
    """The bound is max(k_hi, k0.max()) up to the cap, kept across
    resumed runs; a state the loop did not make (``from_reference``) gets
    it from its own k."""
    arrays, static, pr, state, k0, spt = _fleet(torch.float32, k0_top)
    want = int(pr.k_max.max()) if want is None else want
    seen = _spy(monkeypatch)
    loop, n_ticks = tctl.make_fused_loop(arrays, static, pr, steps_per_tick=spt,
                                         device="cpu", dtype=torch.float32)
    st, _ = loop.run(loop.init(k0), 1)
    loop.run(st, 1)
    loop.run(state, 1)  # made by from_reference, not by the loop
    assert seen == [want] * 3
    assert n_ticks >= 2



# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", ["tight", "cap"])
def test_cuda_table_route_equals_masked_loop_bitwise(cuda_device, case):
    """Through one ``erlang_c`` kernel launch, the masked loop's bits."""
    from repro_torch.kernels import LAUNCHES

    z = _zoo(seed=5, past_cap=case == "cap")
    args = [x.to(cuda_device) for x in _torch_args(z, torch.float32)]
    bound = _tight_bound(z) if case == "tight" else CAP
    want = tbs.stationary_wait(*args)
    before = LAUNCHES["erlang_c"]
    got = tbs.stationary_wait(*args, k_bound=bound)
    assert LAUNCHES["erlang_c"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(tbs.stationary_wait(*_torch_args(z, torch.float32),
                                                            k_bound=bound).numpy()))


def test_cuda_table_route_refuses_float64(cuda_device):
    args = [x.to(cuda_device) for x in _torch_args(_zoo(seed=6), torch.float64)]
    with pytest.raises(TypeError, match="float32"):
        tbs.stationary_wait(*args, k_bound=48)
