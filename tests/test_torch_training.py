"""The port's training path against the JAX package's, on the CPU.

* Every case of ``tests/test_training_loop.py`` on the port (loss
  decreases, the crash-and-resume run within 2e-2 of the straight one, the
  synthetic stream deterministic, AdamW, the schedule, clipping, int8 SNR,
  error feedback), on the llama3.2-1b smoke config as the reference runs
  them.
* Against the reference on the same seeded inputs: the synthetic stream
  and the loader bitwise; int8 ``compress`` bitwise; ``lr_schedule`` and
  ``global_norm`` within rtol 1e-6, ``adamw_update`` on identical gradients
  within 1e-6 of each leaf's largest magnitude; ``cross_entropy_loss`` and ``loss_fn`` within 1e-6;
  one-step gradients of the float32 smoke llama within rtol 1e-4 of the
  leaf's largest gradient; a 10-step float32 loss trajectory of the port's
  ``TrainLoop`` from the JAX loop's initial state within rtol 1e-3 of the
  JAX ``TrainLoop``'s (parameters are not compared element by element:
  Adam turns near-zero gradients into +-lr steps); the port resuming from a
  checkpoint the JAX ``TrainLoop`` wrote, its losses within rtol 1e-3 of
  the JAX straight run's.  The JAX loop that these compare against draws
  its stream in order (its threaded loader drops batches under load,
  ROADMAP Queue 3); one test runs it with that loader to show where the
  two loops' saved stream positions part.
* The autograd Functions of the two training kernels on CPU tensors (their
  forward is then the plain version): forward and every gradient equal to
  autograd of the plain version bitwise; ``ops`` on the CPU leaves them
  out.  (The ssm and hybrid families train in
  ``tests/test_torch_ssm_training.py``.)
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
from repro.data.pipeline import PipelinedLoader as JaxLoader
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.distributed import compress as jcompress
from repro.models.common import cross_entropy_loss as jax_xent
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro.training.train_step import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.convert import (model_params_from_reference, train_state_from_reference,
                                 train_state_to_arrays)
from repro_torch.data.pipeline import DataConfig, PipelinedLoader, SyntheticTokens
from repro_torch.distributed.compress import (compress, compress_tree, compress_with_feedback,
                                              decompress, decompress_tree)
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.flash_attention.grad import FlashAttentionFn
from repro_torch.kernels.swiglu import ref as swiglu_ref
from repro_torch.kernels.swiglu.grad import SwiGLUFn
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.transformer import loss_fn
from repro_torch.training.loop import ElasticController, LoopConfig, TrainLoop
from repro_torch.training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                            clip_by_global_norm, global_norm, lr_schedule)
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step
from repro_torch.tree import flatten_with_paths as _leaves

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def smoke_cfg():
    return get_config(ARCH, "smoke")


def _f32_configs():
    return (dataclasses.replace(jax_get_config(ARCH, "smoke"), dtype=jnp.float32),
            dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32))


# --------------------------------------------------------------------------- #
# The reference's cases (tests/test_training_loop.py), on the port
# --------------------------------------------------------------------------- #
def test_loss_decreases(tmp_path, smoke_cfg):
    loop = TrainLoop(
        smoke_cfg,
        AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=60),
        LoopConfig(total_steps=60, ckpt_every=30, log_every=1000),
        ckpt_dir=tmp_path / "ckpt", device="cpu",
    )
    loop.run()
    losses = [m["loss"] for m in loop.metrics_history]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1
    assert loop.loader_workers == {"generate": 1, "transform": 1}


def test_checkpoint_restart_is_exact(tmp_path, smoke_cfg):
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=40)

    def loop(d):
        return TrainLoop(smoke_cfg, opt, LoopConfig(total_steps=40, ckpt_every=10),
                         ckpt_dir=tmp_path / d, device="cpu")

    state_a = loop("a").run()
    b1 = loop("b")
    with pytest.raises(RuntimeError, match="simulated crash"):
        b1.run(crash_at=20)
    b2 = loop("b")
    state_b = b2.run()
    assert int(b2.store.latest_step()) == 40
    assert len(b2.metrics_history) == 20  # resumed at 20
    for (ka, x), (kb, y) in zip(_leaves(state_a.params), _leaves(state_b.params)):
        assert ka == kb
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=2e-2, atol=2e-2)


def test_synthetic_stream_deterministic():
    cfg = DataConfig(vocab=128, batch=2, seq_len=8, seed=7)
    s1, s2 = SyntheticTokens(cfg), SyntheticTokens(cfg, start_step=0)
    a, b = next(s1), next(s2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    s3 = SyntheticTokens(cfg)
    s3.restore({"step": 6, "seed": 7})
    for _ in range(5):
        next(s1)
    np.testing.assert_array_equal(next(s1)["tokens"], next(s3)["tokens"])


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, decay_steps=1000)
    state = adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.1


@pytest.mark.parametrize("param_dtype,moment_dtype", [(torch.float32, torch.float32),
                                                      (torch.bfloat16, torch.float32),
                                                      (torch.bfloat16, torch.bfloat16)])
def test_adamw_update_in_place_is_the_expression_bitwise(param_dtype, moment_dtype):
    """``adamw_update`` computes in place, but each leaf's result is
    bitwise the reference's expressions evaluated out of place in the
    same order (float32 moments, one cast back), over five steps."""
    gen = torch.Generator().manual_seed(0)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=10, grad_clip=0.7,
                      moment_dtype=moment_dtype)
    shapes = {"a": (37, 11), "b": (5,), "c": (64, 64)}
    params = {k: (torch.randn(s, generator=gen) * 0.5).to(param_dtype) for k, s in shapes.items()}
    want = {k: t.clone() for k, t in params.items()}
    mu = {k: torch.zeros(s, dtype=moment_dtype) for k, s in shapes.items()}
    nu = {k: torch.zeros(s, dtype=moment_dtype) for k, s in shapes.items()}
    state = adamw_init(params, cfg)
    f32 = torch.float32
    for step in range(1, 6):
        grads = {k: (torch.randn(s, generator=gen) * 3).to(param_dtype) for k, s in shapes.items()}
        clipped, _ = clip_by_global_norm(grads, cfg.grad_clip)
        params, state, _ = adamw_update(params, grads, state, cfg)
        lr = lr_schedule(torch.tensor(step, dtype=torch.int32), cfg)
        bc1 = 1.0 - torch.pow(cfg.b1, torch.tensor(step, dtype=f32))
        bc2 = 1.0 - torch.pow(cfg.b2, torch.tensor(step, dtype=f32))
        for k in shapes:
            g = clipped[k].to(f32)
            m = mu[k].to(f32) * cfg.b1 + (1 - cfg.b1) * g
            v = nu[k].to(f32) * cfg.b2 + (1 - cfg.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * want[k].to(f32)
            want[k] = (want[k].to(f32) - lr * delta).to(param_dtype)
            mu[k], nu[k] = m.to(moment_dtype), v.to(moment_dtype)
            assert torch.equal(params[k], want[k]), (step, k)
            assert torch.equal(state.mu[k], mu[k]) and torch.equal(state.nu[k], nu[k]), (step, k)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), cfg)) for s in range(0, 110, 5)]
    assert lrs[0] < 0.01
    assert max(lrs) == pytest.approx(1.0, rel=0.05)
    assert lrs[-1] == pytest.approx(0.1, rel=0.05)


def test_grad_clip_bounds_update():
    tree = {"a": torch.full((4,), 100.0), "b": torch.full((2,), -100.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    flat = torch.cat([clipped["a"], clipped["b"]])
    assert float(torch.linalg.norm(flat)) == pytest.approx(1.0, rel=1e-4)
    assert float(norm) == pytest.approx(np.sqrt(6) * 100, rel=1e-4)


def test_int8_compression_snr():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1024).astype(np.float32))
    y = decompress(compress(x))
    assert float(torch.linalg.norm(x - y) / torch.linalg.norm(x)) < 0.02


def test_error_feedback_bounds_accumulated_error():
    rng = np.random.default_rng(1)
    true_sum = torch.zeros(256)
    fb_sum = torch.zeros(256)
    plain_sum = torch.zeros(256)
    ef = None
    for _ in range(50):
        g = {"g": torch.from_numpy((rng.standard_normal(256) * 0.01 + 0.003).astype(np.float32))}
        true_sum = true_sum + g["g"]
        comp, ef = compress_with_feedback(g, ef)
        fb_sum = fb_sum + decompress(comp["g"])
        plain_sum = plain_sum + decompress(compress(g["g"]))
    fb_err = float(torch.linalg.norm(fb_sum - true_sum))
    plain_err = float(torch.linalg.norm(plain_sum - true_sum))
    assert fb_err <= plain_err * 1.05
    assert fb_err < 0.02


# --------------------------------------------------------------------------- #
# Against the JAX package on the same inputs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pack_docs", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_stream_equals_the_jax_stream(seed, pack_docs):
    kw = dict(vocab=1000, batch=3, seq_len=257, seed=seed, pack_docs=pack_docs, mean_doc_len=64)
    mine, ref = SyntheticTokens(DataConfig(**kw), start_step=5), JaxTokens(JaxDataConfig(**kw),
                                                                           start_step=5)
    for _ in range(4):
        a, b = next(mine), next(ref)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert mine.state() == ref.state()


def test_pipelined_loader_delivers_the_jax_stream_in_order():
    kw = dict(vocab=500, batch=2, seq_len=33, seed=3)
    mine = PipelinedLoader(SyntheticTokens(DataConfig(**kw)), workers={"generate": 1,
                                                                       "transform": 1})
    ref = JaxLoader(JaxTokens(JaxDataConfig(**kw)), workers={"generate": 1, "transform": 1})
    try:
        assert mine.k() == ref.k()
        for _ in range(6):
            np.testing.assert_array_equal(next(mine)["tokens"], next(ref)["tokens"])
        mine.scale_stage("transform", 3)
        assert mine.k() == {"generate": 1, "transform": 3}
    finally:
        mine.stop()
        ref.stop()


def test_int8_compress_equals_the_jax_compress():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((33, 7)).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal(100).astype(np.float32) * 1e-3}}
    mine = compress_tree({"a": torch.from_numpy(tree["a"]),
                          "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    ref = jcompress.compress_tree(jax.tree.map(jnp.asarray, tree))
    for got, want in ((mine["a"], ref["a"]), (mine["b"]["c"], ref["b"]["c"])):
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    back = decompress_tree(mine)
    np.testing.assert_array_equal(back["a"].numpy(),
                                  np.asarray(jcompress.decompress_tree(ref)["a"]))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 99, 100, 400])
def test_lr_schedule_equals_the_jax_schedule(step):
    kw = dict(lr=3e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    got = float(lr_schedule(torch.tensor(step, dtype=torch.int32), AdamWConfig(**kw)))
    want = float(jopt.lr_schedule(jnp.int32(step), jopt.AdamWConfig(**kw)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def _grad_tree(rng, scale):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32) * scale,
            "layers": {"w": rng.standard_normal((2, 8, 8)).astype(np.float32) * scale,
                       "n": rng.standard_normal((2, 8)).astype(np.float32) * scale}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


@pytest.mark.parametrize("grad_clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_equals_the_jax_update_on_identical_grads(grad_clip):
    """Five steps of AdamW on the same float32 parameters and gradients: the
    parameters and both moments within 1e-6 of each leaf's largest
    magnitude (a last-bit difference in the clip scale or the cosine moves
    an element by a few ulps), the metrics within rtol 1e-6."""
    rng = np.random.default_rng(11)
    params = _grad_tree(rng, 1.0)
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=20, weight_decay=0.1, grad_clip=grad_clip)
    mine_p, ref_p = _to_torch(params), jax.tree.map(jnp.asarray, params)
    mine_s, ref_s = adamw_init(mine_p, AdamWConfig(**kw)), jopt.adamw_init(ref_p,
                                                                          jopt.AdamWConfig(**kw))
    for _ in range(5):
        grads = _grad_tree(rng, 0.5)
        mine_p, mine_s, mine_m = adamw_update(mine_p, _to_torch(grads), mine_s, AdamWConfig(**kw))
        ref_p, ref_s, ref_m = jopt.adamw_update(ref_p, jax.tree.map(jnp.asarray, grads), ref_s,
                                                jopt.AdamWConfig(**kw))
        for key in ("lr", "grad_norm"):
            assert float(mine_m[key]) == pytest.approx(float(ref_m[key]), rel=1e-6)
    assert int(mine_s.step) == int(ref_s.step) == 5
    for mine, ref in ((mine_p, ref_p), (mine_s.mu, ref_s.mu), (mine_s.nu, ref_s.nu)):
        for (k, got), (_k, want) in zip(_leaves(mine), _leaves(ref)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)
    assert float(global_norm(mine_p)) == pytest.approx(float(jopt.global_norm(ref_p)), rel=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_equals_the_jax_loss(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    want = jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                    None if mask is None else jnp.asarray(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _smoke_f32(seed=3):
    jcfg, tcfg = _f32_configs()
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = model_params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens = JaxTokens(JaxDataConfig(vocab=jcfg.vocab, batch=2, seq_len=24, seed=seed))
    batch = next(tokens)
    return jcfg, jparams, tcfg, tparams, batch


def test_loss_fn_equals_the_jax_loss_fn():
    jcfg, jparams, tcfg, tparams, batch = _smoke_f32()
    got_total, got = loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long()
                                            for k, v in batch.items()})
    want_total, want = jax_loss_fn(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    assert set(got) == set(want)
    for key in got:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6, abs=1e-7), key


def test_one_step_gradients_equal_the_jax_gradients():
    """Gradients of the float32 smoke llama's loss at the same parameters
    and batch: every leaf within rtol 1e-4 of its largest |gradient|
    (float32 sums in two orders), and the global norms within 1e-5."""
    jcfg, jparams, tcfg, tparams, batch = _smoke_f32()
    leaves = _leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch))[0])(jparams)
    want = dict(_leaves(jgrads))
    for (key, _t), g in zip(leaves, grads):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)
    assert float(global_norm(dict(zip(range(len(grads)), grads)))) == pytest.approx(
        float(jopt.global_norm(jgrads)), rel=1e-5)


TRAJ_STEPS, TRAJ_CKPT = 10, 5


class _InOrderLoader:
    """The reference's stream, drawn in order on the consumer's thread: the
    JAX loop's threaded loader drops a batch whenever its queue stays full
    past a put timeout (ROADMAP Queue 3), so under load -- a slow jit --
    the stream it feeds its loop has gaps."""

    def __init__(self, source, **_kw):
        self.source = source

    def __next__(self):
        return next(self.source)

    def stop(self):
        pass


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``TrainLoop`` on the float32 smoke llama, 10 steps with
    checkpoints at 5 and 10, fed its stream in order (``_InOrderLoader``);
    and its tick-0 state saved by the JAX store into a fresh directory (the
    port's loop resumes from it at step 0)."""
    jcfg, tcfg = _f32_configs()
    opt = dict(lr=3e-3, warmup_steps=3, decay_steps=TRAJ_STEPS)
    work = tmp_path_factory.mktemp("jax_train")
    jl = jloop.TrainLoop(jcfg, jopt.AdamWConfig(**opt),
                         jloop.LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT, ckpt_keep=5),
                         ckpt_dir=work / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "PipelinedLoader", _InOrderLoader)
        jl.run()
    state0, _ = jax_init_train_state(jcfg, jopt.AdamWConfig(**opt), jax.random.PRNGKey(0))
    JaxStore(work / "port0").save(0, state0, extra={"data": {"step": 0, "seed": 0}})
    return work, jl, tcfg, AdamWConfig(**opt), state0


def test_loss_trajectory_equals_the_jax_train_loop(jax_run):
    work, jl, tcfg, opt, _ = jax_run
    mine = TrainLoop(tcfg, opt, LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT),
                     ckpt_dir=work / "port0", device="cpu")
    mine.run()
    got = [m["loss"] for m in mine.metrics_history]
    want = [m["loss"] for m in jl.metrics_history]
    assert len(got) == len(want) == TRAJ_STEPS
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in mine.metrics_history],
                                   [m[key] for m in jl.metrics_history], rtol=1e-3)
    assert got[-1] < got[0]


def test_port_resumes_from_a_checkpoint_the_jax_loop_wrote(jax_run, tmp_path):
    """The JAX loop's step-5 checkpoint copied alone into a new directory:
    the port's loop restores its parameters and moments bitwise and resumes
    at step 5 on the stream position the checkpoint names; its losses for
    steps 5-9 equal, within rtol 1e-3, the JAX train step's from the same
    restored state over the same batches."""
    import shutil

    from repro.training.train_step import make_train_step as jax_make_train_step

    work, jl, tcfg, opt, state0 = jax_run
    name = f"step_{TRAJ_CKPT:010d}"
    shutil.copytree(work / "jax" / name, tmp_path / name)
    jstate, extra = JaxStore(tmp_path).restore(state0, TRAJ_CKPT)
    data_step = int(extra["data"]["step"])
    assert data_step >= TRAJ_CKPT
    mine = TrainLoop(tcfg, opt, LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT),
                     ckpt_dir=tmp_path, device="cpu")
    restored, _ = mine._init_or_restore()
    back = train_state_to_arrays(restored)
    for got, want in ((back.params, jstate.params), (back.opt.mu, jstate.opt.mu)):
        for (k, g), (_k, w) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    state = mine.run()
    assert int(state.step) == TRAJ_STEPS and int(state.opt.step) == TRAJ_STEPS
    got = [m["loss"] for m in mine.metrics_history]
    step_fn = jax.jit(jax_make_train_step(jl.cfg, jopt.AdamWConfig(
        lr=opt.lr, warmup_steps=opt.warmup_steps, decay_steps=opt.decay_steps)))
    source = JaxTokens(jl.data_cfg, start_step=data_step)
    want = []
    for _ in range(TRAJ_STEPS - TRAJ_CKPT):
        jstate, metrics = step_fn(jstate, jax.tree.map(jnp.asarray, next(source)))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    _saved, extra = mine.store.restore(restored, TRAJ_STEPS)
    assert extra["data"] == {"step": data_step + TRAJ_STEPS - TRAJ_CKPT, "seed": 0}


def test_resume_replays_the_consumed_stream_bit_for_bit(tmp_path, smoke_cfg):
    """The port saves the stream position of the batches it consumed (the
    reference saves its prefetching source's, ROADMAP Queue 3), so on the
    CPU a crash at 6 and a resume to 12 equal the straight run bitwise:
    every loss and every final parameter."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=12)

    def loop(d):
        return TrainLoop(smoke_cfg, opt, LoopConfig(total_steps=12, ckpt_every=3),
                         ckpt_dir=tmp_path / d, device="cpu")

    straight = loop("a")
    state_a = straight.run()
    first = loop("b")
    with pytest.raises(RuntimeError, match="simulated crash"):
        first.run(crash_at=6)
    _s, extra = first.store.restore(state_a, 6)
    assert extra["data"] == {"step": 6, "seed": 0}
    second = loop("b")
    state_b = second.run()
    losses = [m["loss"] for m in first.metrics_history + second.metrics_history]
    assert losses == [m["loss"] for m in straight.metrics_history]
    for (k, x), (_k, y) in zip(_leaves(state_a.params), _leaves(state_b.params)):
        assert torch.equal(x, y), k


def test_loop_without_checkpoints_writes_none_and_trains_alike(tmp_path, smoke_cfg):
    """``ckpt_every=0``: no checkpoint is written, and the run's losses and
    final parameters are bitwise those of a checkpointed run (the saves
    copy, they never touch the state)."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=6)

    def loop(d, every):
        return TrainLoop(smoke_cfg, opt, LoopConfig(total_steps=6, ckpt_every=every),
                         ckpt_dir=tmp_path / d, device="cpu")

    plain, saved = loop("a", 0), loop("b", 3)
    state_a, state_b = plain.run(), saved.run()
    assert plain.store.latest_step() is None and saved.store.latest_step() == 6
    assert [m["loss"] for m in plain.metrics_history] == [
        m["loss"] for m in saved.metrics_history]
    for (k, x), (_k, y) in zip(_leaves(state_a.params), _leaves(state_b.params)):
        assert torch.equal(x, y), k


def test_pipelined_loader_keeps_a_batch_it_cannot_queue():
    """A consumer that stalls past the stages' put timeouts (queues of one
    batch, 1.2 s against 0.2 s): the loader still delivers the source's
    stream with no gap, and its source has run ahead by no more than the
    two queues and the batch in each stage's hands."""
    import time

    cfg = DataConfig(vocab=1000, batch=2, seq_len=16, seed=3)
    loader = PipelinedLoader(SyntheticTokens(cfg), capacity=1)
    try:
        time.sleep(1.2)
        got = [next(loader) for _ in range(6)]
        ahead = loader.source.step
    finally:
        loader.stop()
    want = SyntheticTokens(cfg)
    for g in got:
        w = next(want)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(g[key], w[key])
    assert ahead <= 6 + 2 + 2


def test_resume_replays_the_stream_after_a_stalled_step(tmp_path, smoke_cfg):
    """The first step stalls for 0.6 s (as a first step that builds its
    kernels does) and the run outlasts the loader's 16 queued batches: the
    crash at 20 and the resume to 24 still equal the straight run bitwise,
    because the stream the loop consumed has no gap."""
    import time

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=24)

    def loop(d):
        return TrainLoop(smoke_cfg, opt, LoopConfig(total_steps=24, ckpt_every=10,
                                                    log_every=1000),
                         ckpt_dir=tmp_path / d, device="cpu",
                         on_metrics=lambda step, m: time.sleep(0.6))

    straight = loop("a")
    state_a = straight.run()
    first = loop("b")
    with pytest.raises(RuntimeError, match="simulated crash"):
        first.run(crash_at=20)
    second = loop("b")
    state_b = second.run()
    losses = [m["loss"] for m in first.metrics_history + second.metrics_history]
    assert losses == [m["loss"] for m in straight.metrics_history]
    for (k, x), (_k, y) in zip(_leaves(state_a.params), _leaves(state_b.params)):
        assert torch.equal(x, y), k


def test_resumed_stream_parts_from_the_jax_loops_by_its_prefetch(jax_run, tmp_path):
    """Where the two loops' resumes part.  At the step-5 checkpoint the
    port saves the stream position of the batches it consumed, 5; the JAX
    loop, with its own threaded loader, saves its source's position, which
    the loader's generate thread has already moved past the batches it
    prefetched (and past those it dropped while its queue stayed full
    during the jit of the first step).  So the port's resumed run draws
    batch 5 next, as its straight run does, and the JAX loop's draws batch
    ``jax_step`` and skips the ones between (a fault of the reference's
    loop and loader, ROADMAP Queue 3)."""
    import json

    _work, jl, tcfg, opt, _ = jax_run
    name = f"step_{TRAJ_CKPT:010d}"
    theirs = jloop.TrainLoop(jl.cfg, jl.opt_cfg,
                             jloop.LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT),
                             ckpt_dir=tmp_path / "jax")
    with pytest.raises(RuntimeError, match="simulated crash"):
        theirs.run(crash_at=TRAJ_CKPT)
    jax_step = json.loads((tmp_path / "jax" / name / "manifest.json").read_text())[
        "extra"]["data"]["step"]
    mine = TrainLoop(tcfg, opt, LoopConfig(total_steps=TRAJ_STEPS, ckpt_every=TRAJ_CKPT),
                     data_cfg=DataConfig(**dataclasses.asdict(jl.data_cfg)),
                     ckpt_dir=tmp_path / "port", device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash"):
        mine.run(crash_at=TRAJ_CKPT)
    port_step = json.loads((tmp_path / "port" / name / "manifest.json").read_text())[
        "extra"]["data"]["step"]
    assert port_step == TRAJ_CKPT
    assert jax_step >= TRAJ_CKPT
    port_next = next(SyntheticTokens(mine.data_cfg, start_step=port_step))
    jax_next = next(JaxTokens(jl.data_cfg, start_step=jax_step))
    assert np.array_equal(port_next["tokens"], jax_next["tokens"]) == (jax_step == TRAJ_CKPT)


def test_train_state_crosses_both_ways(jax_run):
    """A JAX ``TrainState`` into the port and back: every leaf bitwise."""
    _work, _jl, tcfg, _opt, state0 = jax_run
    mine = train_state_from_reference(state0, tcfg, device="cpu")
    assert isinstance(mine, TrainState) and int(mine.step) == 0
    back = train_state_to_arrays(mine)
    for got, want in ((back.params, state0.params), (back.opt.mu, state0.opt.mu),
                      (back.opt.nu, state0.opt.nu)):
        for (k, g), (_k, w) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w, dtype=np.float32), err_msg=k)
    assert int(back.opt.step) == 0


def test_bf16_state_crosses_bit_for_bit():
    cfg = get_config(ARCH, "smoke")
    jstate, _ = jax_init_train_state(jax_get_config(ARCH, "smoke"), jopt.AdamWConfig(),
                                     jax.random.PRNGKey(1))
    mine = train_state_from_reference(jstate, cfg, device="cpu")
    assert mine.params["embed"].dtype == torch.bfloat16
    back = train_state_to_arrays(mine)
    np.testing.assert_array_equal(back.params["embed"],
                                  np.asarray(jstate.params["embed"].astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# The autograd Functions of the training kernels, and what refuses to train
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_flash_attention_fn_equals_autograd_of_the_plain_version(dtype, causal, window):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 11, 16, generator=gen).to(dtype).requires_grad_()
    k = torch.randn(2, 2, 11, 16, generator=gen).to(dtype).requires_grad_()
    v = torch.randn(2, 2, 11, 16, generator=gen).to(dtype).requires_grad_()
    go = torch.randn(2, 4, 11, 16, generator=gen).to(dtype)
    got = FlashAttentionFn.apply(q, k, v, causal, window, None)
    want = flash_ref.attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, want)
    g_got = torch.autograd.grad(got, (q, k, v), go)
    g_want = torch.autograd.grad(want, (q, k, v), go)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


def test_flash_attention_fn_returns_only_the_gradients_asked_for():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, 5, 8, generator=gen).requires_grad_()
    k, v = torch.randn(1, 2, 5, 8, generator=gen), torch.randn(1, 2, 5, 8, generator=gen)
    (gq,) = torch.autograd.grad(FlashAttentionFn.apply(q, k, v, True, None, None).sum(), (q,))
    (want,) = torch.autograd.grad(flash_ref.attention(q, k, v).sum(), (q,))
    assert torch.equal(gq, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_fn_equals_autograd_of_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(7, 16, generator=gen).to(dtype).requires_grad_()
    wg, wu = (torch.randn(16, 24, generator=gen).mul(0.25).to(dtype).requires_grad_()
              for _ in range(2))
    wo = torch.randn(24, 16, generator=gen).mul(0.2).to(dtype).requires_grad_()
    go = torch.randn(7, 16, generator=gen).to(dtype)
    got = SwiGLUFn.apply(x, wg, wu, wo)
    want = swiglu_ref.swiglu(x, wg, wu, wo)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, (x, wg, wu, wo), go),
                    torch.autograd.grad(want, (x, wg, wu, wo), go)):
        assert torch.equal(a, b)


def test_cpu_ops_differentiate_the_plain_versions_directly():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.swiglu import ops as swiglu_ops

    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    out = flash_ops.attention(q, q.detach(), q.detach())
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(8, 8)
    assert type(swiglu_ops.swiglu(x, w, w, w).grad_fn).__name__ != "SwiGLUFnBackward"


def test_train_step_compress_grads_updates_every_parameter():
    smoke_cfg = _f32_configs()[1]
    state = init_train_state(smoke_cfg, AdamWConfig(lr=1e-3), 0, device="cpu")
    before = {k: t.clone() for k, t in _leaves(state.params)}
    step = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           compress_grads=True)
    batch = next(SyntheticTokens(DataConfig(vocab=smoke_cfg.vocab, batch=2, seq_len=16)))
    state, metrics = step(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert int(state.step) == 1 and int(state.opt.step) == 1
    assert set(metrics) == {"loss", "aux_loss", "total", "lr", "grad_norm"}
    for k, t in _leaves(state.params):
        assert not torch.equal(t, before[k]), k


def test_for_kernels_widens_only_head_dims_the_kernels_lack():
    from repro_torch.configs import for_kernels

    for arch in ("llama3.2-1b", "zamba2-7b", "phi3-medium-14b", "yi-34b", "command-r-35b"):
        full = get_config(arch, "full")
        assert for_kernels(full) is full
    smoke = get_config(ARCH, "smoke")
    wide = for_kernels(smoke)
    assert (wide.head_dim_, wide.d_model, wide.d_ff) == (64, 256, 512)
    assert (wide.n_layers, wide.n_heads, wide.n_kv_heads, wide.vocab) == (
        smoke.n_layers, smoke.n_heads, smoke.n_kv_heads, smoke.vocab)


def test_elastic_controller_resumes_from_the_latest_checkpoint(tmp_path, smoke_cfg):
    loop = TrainLoop(smoke_cfg, AdamWConfig(lr=1e-3), LoopConfig(total_steps=6, ckpt_every=3),
                     ckpt_dir=tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash"):
        loop.run(crash_at=3)
    ctl = ElasticController(loop)
    ctl.on_lease_change(type("Change", (), {"k_max_before": 4, "k_max_after": 2})())
    state = ctl.resume(steps=6)
    assert int(state.step) == 6 and ctl.restarts == [{"before": 4, "after": 2}]
