"""Training the ssm (rwkv6) and hybrid (zamba2) families on the port,
against autograd of the plain scans and against the JAX package, on the
CPU.

* ``Rwkv6ScanFn`` / ``SsdScanFn`` on CPU tensors (their forward is then
  the plain version): the forward and every gradient -- both outputs'
  gradients used, one of them, the initial state's, the bonus ``u``
  broadcast over the batch and reduced back to ``[H, Dk]``, zamba2's B
  and C as ``expand``ed views whose gradients autograd sums over the
  heads -- bitwise equal to autograd of the plain version; only the
  gradients asked for come back.
* The smoke rwkv6 and zamba2 in float32 against the JAX package on the
  same parameters and batch: ``loss_fn`` within 1e-6; one-step gradients
  within rtol 1e-4 of each leaf's largest |gradient| (the rule of
  ``tests/test_torch_training.py``'s llama test), global norms within
  1e-5; a 10-step loss trajectory of the port's ``TrainLoop`` from the
  JAX loop's initial state within rtol 1e-3 of the JAX ``TrainLoop``'s,
  fed its stream in order.  The JAX model picks its scan chunk as the
  largest of 32 / 16 / 8 ... dividing S (rwkv6; 64 / 32 / ... for the
  SSD), the port fixes 32 / 64 with a short last chunk: the same function
  summed in another order, within these tolerances.  rwkv6 starts its
  decay LoRA's second factor at zero, which zeroes the first factor's
  gradient in both packages; the one-step test draws it (the same numpy
  values for both) so that every leaf is compared.
* The JAX chunked scans overflow float32 once a chunk's log-decay passes
  -88 (``e^{-pc}``): the comparisons run at S = 16 and 24, where the JAX
  chunks are 16 and 8 steps long and its loss is finite.  Pinned: zamba2
  smoke at S = 128 (JAX chunk 64) gives the port finite gradients and
  JAX non-finite ones.
* The port alone: the loss falls over 60 steps (the reference's case), a
  crash-and-resume ``TrainLoop`` run is bitwise its straight run, every
  parameter moves, and ``python -m repro_torch.launch.train`` runs both
  archs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro.training.train_step import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rwkv6_scan import Rwkv6ScanFn, ops as rwkv6_ops, ref as rwkv6_ref
from repro_torch.kernels.ssd_scan import SsdScanFn, ops as ssd_ops, ref as ssd_ref
from repro_torch.models.transformer import loss_fn
from repro_torch.training.loop import LoopConfig, TrainLoop
from repro_torch.training.optimizer import AdamWConfig, global_norm
from repro_torch.training.train_step import make_train_step
from repro_torch.tree import flatten_with_paths as _leaves

ARCHS = ("rwkv6-1.6b", "zamba2-7b")


# --------------------------------------------------------------------------- #
# The autograd Functions on CPU tensors
# --------------------------------------------------------------------------- #
def _rwkv_inputs(dtype, seed=0, b=2, h=3, s=40, d=8):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, d, generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    lw = -torch.rand(b, s, h, d, generator=gen).transpose(1, 2) * 3
    u = torch.rand(h, d, generator=gen) * 0.6 - 0.3
    s0 = torch.randn(b, h, d, d, generator=gen)
    grads = (torch.randn(b, h, s, d, generator=gen).to(dtype), torch.randn(b, h, d, d,
                                                                         generator=gen))
    return [r, k, v, lw, u, s0], grads


def _leaves_of(inputs, need):
    return [t.detach().requires_grad_(n) if t is not None else None
            for t, n in zip(inputs, need)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_fn_equals_autograd_of_the_plain_version(dtype):
    inputs, (go, gs) = _rwkv_inputs(dtype)
    leaves = _leaves_of(inputs, [True] * 6)
    got = Rwkv6ScanFn.apply(*leaves, 16)
    want = rwkv6_ref.rwkv6_scan(*leaves, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g_got = torch.autograd.grad(got, leaves, (go, gs))
    g_want = torch.autograd.grad(want, leaves, (go, gs))
    assert g_got[4].shape == (3, 8)  # the bonus, reduced over the batch
    for a, b in zip(g_got, g_want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("need,outputs", [
    ((True, False, False, False, False, False), "out"),
    ((False, True, True, False, False, True), "state"),
    ((False, False, False, True, True, False), "both"),
    ((True, True, True, True, True, None), "both"),  # s0 = None: zeros, no gradient
])
def test_rwkv6_scan_fn_returns_only_the_gradients_asked_for(need, outputs):
    inputs, (go, gs) = _rwkv_inputs(torch.float32, seed=1)
    if need[5] is None:
        inputs[5], need = None, need[:5] + (False,)
    leaves = _leaves_of(inputs, need)
    wanted = [t for t, n in zip(leaves, need) if n]
    pick = {"out": ([0], [go]), "state": ([1], [gs]), "both": ([0, 1], [go, gs])}[outputs]

    def grads(fn):
        outs = fn()
        return torch.autograd.grad([outs[i] for i in pick[0]], wanted, pick[1])

    got = grads(lambda: Rwkv6ScanFn.apply(*leaves, 16))
    want = grads(lambda: rwkv6_ref.rwkv6_scan(*leaves, chunk=16))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _ssd_inputs(dtype, seed=2, b=2, h=5, s=70, d=16, dst=8):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, d, generator=gen).to(dtype).transpose(1, 2)
    a = (-torch.rand(b, s, h, generator=gen) * 6).transpose(1, 2)
    bm, cm = (torch.randn(b, s, dst, generator=gen).to(dtype) for _ in range(2))
    s0 = torch.randn(b, h, dst, d, generator=gen)
    grads = (torch.randn(b, h, s, d, generator=gen).to(dtype),
             torch.randn(b, h, dst, d, generator=gen))
    return [x, a, bm, cm, s0], grads, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fn_sums_the_shared_b_and_c_gradients_over_the_heads(dtype):
    """B and C enter as ``expand``ed views of [B, S, Dst] leaves: the
    Function returns full-shaped gradients for the views and autograd sums
    them over the heads, equal to the plain version's gradients and to the
    head sum of an expanded leaf's gradient."""
    inputs, (gy, gs), h = _ssd_inputs(dtype)
    x, a, bm, cm, s0 = _leaves_of(inputs, [True] * 5)

    def call(fn, bview, cview):
        return fn(x, a, bview, cview, s0)

    def expand(t):
        return t[:, None].expand(t.shape[0], h, *t.shape[1:])

    got = call(lambda *t: SsdScanFn.apply(*t, 32), expand(bm), expand(cm))
    want = call(lambda *t: ssd_ref.ssd_scan(*t, chunk=32), expand(bm), expand(cm))
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    leaves = (x, a, bm, cm, s0)
    g_got = torch.autograd.grad(got, leaves, (gy, gs))
    g_want = torch.autograd.grad(want, leaves, (gy, gs))
    for p, q in zip(g_got, g_want):
        assert p.dtype == q.dtype and torch.equal(p, q)
    assert g_got[2].shape == bm.shape
    # the same gradient through an expanded leaf of its own, summed by hand
    b_wide = expand(bm).detach().requires_grad_()
    out = SsdScanFn.apply(x, a, b_wide, expand(cm), s0, 32)
    (g_wide,) = torch.autograd.grad(out, (b_wide,), (gy, gs))
    assert g_wide.shape == b_wide.shape
    torch.testing.assert_close(g_wide.float().sum(1), g_got[2].float(), rtol=2e-2 if
                               dtype == torch.bfloat16 else 1e-5, atol=1e-5)


@pytest.mark.parametrize("need", [(True, False, False, False, False),
                                  (False, True, False, True, False),
                                  (False, False, True, False, True)])
def test_ssd_scan_fn_returns_only_the_gradients_asked_for(need):
    inputs, (gy, _gs), _h = _ssd_inputs(torch.float32, seed=3, h=2)
    inputs[2], inputs[3] = (t[:, None].expand(t.shape[0], 2, *t.shape[1:]) for t in inputs[2:4])
    leaves = _leaves_of(inputs, need)
    wanted = [t for t, n in zip(leaves, need) if n]
    got = torch.autograd.grad(SsdScanFn.apply(*leaves, 32)[0], wanted, gy)
    want = torch.autograd.grad(ssd_ref.ssd_scan(*leaves, chunk=32)[0], wanted, gy)
    for p, q in zip(got, want):
        assert torch.equal(p, q)


def test_cpu_scan_ops_differentiate_the_plain_versions_directly():
    inputs, _grads = _rwkv_inputs(torch.float32)
    r = inputs[0].requires_grad_()
    out, _ = rwkv6_ops.rwkv6_scan(r, *inputs[1:])
    assert type(out.grad_fn).__name__ != "Rwkv6ScanFnBackward"
    inputs, _grads, _h = _ssd_inputs(torch.float32)
    x = inputs[0].requires_grad_()
    bm, cm = (t[:, None].expand(t.shape[0], 5, *t.shape[1:]) for t in inputs[2:4])
    y, _ = ssd_ops.ssd_scan(x, inputs[1], bm, cm, inputs[4])
    assert type(y.grad_fn).__name__ != "SsdScanFnBackward"


# --------------------------------------------------------------------------- #
# The smoke models against the JAX package
# --------------------------------------------------------------------------- #
def _f32_configs(arch):
    return (dataclasses.replace(jax_get_config(arch, "smoke"), dtype=jnp.float32),
            dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32))


def _smoke_f32(arch, seed=3, seq_len=24):
    """Both packages' float32 smoke model on the same parameters (JAX's
    draw; rwkv6's zero-initialised ``w_lora_b`` drawn from numpy) and one
    batch of the reference's stream."""
    jcfg, tcfg = _f32_configs(arch)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jparams = jax.tree.map(np.asarray, jparams)
    if "w_lora_b" in jparams["layers"]:
        lora_b = jparams["layers"]["w_lora_b"]
        jparams["layers"]["w_lora_b"] = (np.random.default_rng(seed).standard_normal(
            lora_b.shape) * lora_b.shape[1] ** -0.5).astype(np.float32)
    tparams = model_params_from_reference(jparams, tcfg, device="cpu")
    batch = next(JaxTokens(JaxDataConfig(vocab=jcfg.vocab, batch=2, seq_len=seq_len,
                                         seed=seed)))
    return jcfg, jax.tree.map(jnp.asarray, jparams), tcfg, tparams, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_equals_the_jax_loss_fn(arch):
    jcfg, jparams, tcfg, tparams, batch = _smoke_f32(arch)
    got_total, got = loss_fn(tparams, tcfg, _torch_batch(batch))
    want_total, want = jax_loss_fn(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    assert set(got) == set(want)
    for key in got:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6, abs=1e-7), key


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_equal_the_jax_gradients(arch):
    """Every leaf within rtol 1e-4 of its largest |gradient| (float32 sums
    in two orders, and the scans in chunks of other lengths) and the global
    norms within 1e-5; every leaf's gradient non-zero."""
    jcfg, jparams, tcfg, tparams, batch = _smoke_f32(arch)
    leaves = _leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, _torch_batch(batch))
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch))[0])(
        jparams)
    want = dict(_leaves(jgrads))
    assert set(want) == {k for k, _t in leaves}
    for (key, _t), g in zip(leaves, grads):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)
    assert float(global_norm(dict(enumerate(grads)))) == pytest.approx(
        float(jopt.global_norm(jgrads)), rel=1e-5)


def test_zamba2_trains_finite_where_the_jax_gradients_are_not():
    """Pinned (ROADMAP Queue 3): at S = 128 the JAX model scans zamba2 in
    chunks of 64, whose ``e^{-pc}`` overflows float32 once a chunk's
    log-decay passes -88: its loss is finite, its gradients are not.  The
    port's scan forms only differences of log-decays: every gradient is
    finite."""
    jcfg, jparams, tcfg, tparams, batch = _smoke_f32("zamba2-7b", seq_len=128)
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch))[0])(
        jparams)
    assert not all(bool(jnp.isfinite(g).all()) for _k, g in _leaves(jgrads))
    leaves = _leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, _torch_batch(batch))
    assert bool(torch.isfinite(total))
    for (key, _t), g in zip(leaves, torch.autograd.grad(total, [t for _k, t in leaves])):
        assert bool(torch.isfinite(g).all()), key


TRAJ_STEPS, TRAJ_CKPT = 10, 5


class _InOrderLoader:
    """The reference's stream drawn in order on the consumer's thread (the
    JAX loop's threaded loader drops batches under load, ROADMAP Queue 3)."""

    def __init__(self, source, **_kw):
        self.source = source

    def __next__(self):
        return next(self.source)

    def stop(self):
        pass


# The llama test's learning rate for rwkv6.  zamba2's smoke model is
# sharper (grad norms ~100 to 200): each package's float32 gradients lie
# ~1e-5 from the float64 gradient (each alike), and Adam carries that noise
# apart: at 3e-3 by ~1e-2 in the losses within ten steps, at 1e-3 and 5e-4
# by up to 4e-3 and 4e-2 in a grad norm; at 3e-4 the losses and grad norms
# stay within ~1e-4.
TRAJ_LR = {"rwkv6-1.6b": 3e-3, "zamba2-7b": 3e-4}


@pytest.fixture(scope="module", params=ARCHS)
def jax_run(request, tmp_path_factory):
    """The JAX ``TrainLoop`` on the float32 smoke model, 10 steps on its
    default stream (batch 2 x 16 tokens) fed in order; and its step-0 state
    saved by the JAX store into a fresh directory for the port's loop."""
    jcfg, tcfg = _f32_configs(request.param)
    opt = dict(lr=TRAJ_LR[request.param], warmup_steps=3, decay_steps=TRAJ_STEPS)
    work = tmp_path_factory.mktemp("jax_" + request.param)
    jl = jloop.TrainLoop(jcfg, jopt.AdamWConfig(**opt),
                         jloop.LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT,
                                          ckpt_keep=5),
                         ckpt_dir=work / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "PipelinedLoader", _InOrderLoader)
        jl.run()
    state0, _ = jax_init_train_state(jcfg, jopt.AdamWConfig(**opt), jax.random.PRNGKey(0))
    JaxStore(work / "port0").save(0, state0, extra={"data": {"step": 0, "seed": 0}})
    return work, jl, tcfg, AdamWConfig(**opt)


def test_loss_trajectory_equals_the_jax_train_loop(jax_run):
    work, jl, tcfg, opt = jax_run
    mine = TrainLoop(tcfg, opt, LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT),
                     ckpt_dir=work / "port0", device="cpu")
    mine.run()
    got = [m["loss"] for m in mine.metrics_history]
    want = [m["loss"] for m in jl.metrics_history]
    assert len(got) == len(want) == TRAJ_STEPS
    assert all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in mine.metrics_history],
                                   [m[key] for m in jl.metrics_history], rtol=1e-3)


# --------------------------------------------------------------------------- #
# The port alone
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(tmp_path, arch):
    """The reference's ``test_loss_decreases`` case on the smoke model."""
    loop = TrainLoop(get_config(arch, "smoke"),
                     AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=60),
                     LoopConfig(total_steps=60, ckpt_every=30, log_every=1000),
                     ckpt_dir=tmp_path, device="cpu")
    loop.run()
    losses = [m["loss"] for m in loop.metrics_history]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_crash_and_resume_is_bitwise_the_straight_run(tmp_path, arch):
    cfg = get_config(arch, "smoke")
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=12)

    def loop(d):
        return TrainLoop(cfg, opt, LoopConfig(total_steps=12, ckpt_every=6, log_every=1000),
                         ckpt_dir=tmp_path / d, device="cpu")

    straight = loop("a")
    state_a = straight.run()
    first = loop("b")
    with pytest.raises(RuntimeError, match="simulated crash"):
        first.run(crash_at=6)
    resumed = loop("b")
    state_b = resumed.run()
    losses = [m["loss"] for m in straight.metrics_history]
    assert all(np.isfinite(losses)) and len(resumed.metrics_history) == 6
    assert [m["loss"] for m in first.metrics_history + resumed.metrics_history] == losses
    for (k, x), (_k, y) in zip(_leaves(state_a.params), _leaves(state_b.params)):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_updates_every_parameter_and_launches_nothing(arch):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState

    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    before = {k: t.clone() for k, t in _leaves(params)}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    state = TrainState(params, adamw_init(params, opt), torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, opt)
    batch = next(SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=2, seq_len=40)))
    LAUNCHES.clear()
    for _ in range(2):  # rwkv6's w_lora_a moves once w_lora_b has
        state, metrics = step(state, _torch_batch(batch))
    assert not LAUNCHES
    assert int(state.step) == 2 and np.isfinite(float(metrics["loss"]))
    for k, t in _leaves(state.params):
        assert not torch.equal(t, before[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_the_family_on_the_cpu(tmp_path, capsys, arch):
    from repro_torch.launch import train as launcher

    summary = launcher.main(["--arch", arch, "--steps", "4", "--ckpt-every", "2",
                             "--ckpt", str(tmp_path), "--device", "cpu"])
    assert summary["steps"] == 4 and summary["checkpoints"] == 4
    assert np.isfinite(summary["final_loss"])
    assert "final_loss" in capsys.readouterr().out
