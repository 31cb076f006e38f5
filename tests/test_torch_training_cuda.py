"""The training path on the card: the autograd Functions of the two
kernels on the training forward, and ``TrainLoop`` on the smoke llama.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_training_cuda.py

The smoke llama runs at the kernels' head dim (``configs.for_kernels``:
d_model 256, 4 heads of 64).  ``FlashAttentionFn`` / ``SwiGLUFn``: the
forward is the CUDA kernel's output bitwise and is held to the plain
version; each input's gradient is held to autograd of the plain
version on the same inputs and output gradient (the Functions' backward
recomputes the plain version), within the kernels' parity tolerances
(attention: two bf16 ulps of the row's largest value, 2e-5 (1 + |x|) in
float32; SwiGLU: 5e-2 / 2e-3 of the tensor's largest value).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import kernel as fk, ops as fops, ref as fr
from repro_torch.kernels.flash_attention.grad import FlashAttentionFn
from repro_torch.kernels.swiglu import kernel as gk, ops as gops, ref as gr
from repro_torch.kernels.swiglu.grad import SwiGLUFn
from repro_torch.tree import flatten_with_paths, tree_map

ATTN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 2e-5}
SWIGLU_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _attn_close(got, want):
    tol = ATTN_TOL[want.dtype]
    got, want = got.double(), want.double()
    limit = (tol * want.abs().amax(-1, keepdim=True) if tol > 1e-4
             else tol * (1 + want.abs()))
    assert torch.isfinite(got).all() and bool(((got - want).abs() <= limit).all()), \
        float((got - want).abs().max())


def _tensor_close(got, want, tol):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,window,causal", [(2, 200, None, True), (1, 333, 64, True),
                                                (2, 130, None, False)])
def test_cuda_flash_attention_fn(cuda_device, dtype, b, sq, window, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    # the model's layout: [B, S, H, Dh] buffers passed as heads-first views
    q = rnd(b, sq, 8, 64).transpose(1, 2).requires_grad_()
    k = rnd(b, sq, 2, 64).transpose(1, 2).requires_grad_()
    v = rnd(b, sq, 2, 64).transpose(1, 2).requires_grad_()
    go = rnd(b, 8, sq, 64)
    LAUNCHES.clear()
    out = fops.attention(q, k, v, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert LAUNCHES["flash_attention"] == 1
    with torch.no_grad():
        assert torch.equal(out, fk.attention(q, k, v, causal=causal, window=window))
    got = torch.autograd.grad(out, (q, k, v), go)
    plain = fr.attention(q, k, v, causal=causal, window=window)
    _attn_close(out.detach(), plain.detach())
    want = torch.autograd.grad(plain, (q, k, v), go)
    for g, w in zip(got, want):
        _attn_close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [5, 300])
def test_cuda_swiglu_fn(cuda_device, dtype, t):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    d, f = 256, 512

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda_device) * s).to(dtype)

    x = rnd(t, d).requires_grad_()
    wg, wu = rnd(d, f, s=d ** -0.5).requires_grad_(), rnd(d, f, s=d ** -0.5).requires_grad_()
    wo = rnd(f, d, s=f ** -0.5).requires_grad_()
    go = rnd(t, d)
    LAUNCHES.clear()
    out = gops.swiglu(x, wg, wu, wo)
    assert type(out.grad_fn).__name__ == "SwiGLUFnBackward"
    assert LAUNCHES["swiglu"] == 2  # up and down
    with torch.no_grad():
        assert torch.equal(out, gk.swiglu(x, wg, wu, wo))
    got = torch.autograd.grad(out, (x, wg, wu, wo), go)
    plain = gr.swiglu(x, wg, wu, wo)
    _tensor_close(out.detach(), plain.detach(), SWIGLU_TOL[dtype])
    want = torch.autograd.grad(plain, (x, wg, wu, wo), go)
    for g, w in zip(got, want):
        _tensor_close(g, w, SWIGLU_TOL[dtype])


def test_cuda_functions_are_bypassed_without_grad(cuda_device):
    q = torch.randn(1, 2, 16, 64, device=cuda_device)
    assert fops.attention(q, q, q).grad_fn is None
    x = torch.randn(4, 64, device=cuda_device)
    w = torch.randn(64, 64, device=cuda_device)
    assert gops.swiglu(x, w, w, w).grad_fn is None
    with torch.no_grad():
        assert FlashAttentionFn.apply(q.requires_grad_(), q, q, True, None, None).grad_fn is None
        assert SwiGLUFn.apply(x.requires_grad_(), w, w, w).grad_fn is None


def test_cuda_scans_refuse_to_run_without_a_backward(cuda_device):
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.kernels.ssd_scan import ops as sops

    r = torch.randn(1, 2, 8, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        rops.rwkv6_scan(r, r, r, -torch.rand(1, 2, 8, 16, device=cuda_device),
                        torch.zeros(1, 2, 16, device=cuda_device))
    x = torch.randn(1, 2, 8, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        sops.ssd_scan(x, -torch.rand(1, 2, 8, device=cuda_device),
                      torch.randn(1, 2, 8, 16, device=cuda_device),
                      torch.randn(1, 2, 8, 16, device=cuda_device))


def test_cuda_train_step_gives_every_parameter_a_gradient(cuda_device):
    import dataclasses

    from repro_torch.configs import for_kernels, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.transformer import init_params, loss_fn

    cfg = dataclasses.replace(for_kernels(get_config("llama3.2-1b", "smoke")),
                              dtype=torch.float32)
    params = tree_map(lambda t: t.requires_grad_(), init_params(cfg, 0, device=cuda_device))
    leaves = flatten_with_paths(params)
    batch = {k: torch.as_tensor(v, device=cuda_device).long() for k, v in
             next(SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=2, seq_len=64))).items()}
    LAUNCHES.clear()
    total, _ = loss_fn(params, cfg, batch)
    assert LAUNCHES["flash_attention"] == cfg.n_layers and LAUNCHES["swiglu"] == 2 * cfg.n_layers
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    for (key, _t), g in zip(leaves, grads):
        assert torch.isfinite(g).all() and bool((g != 0).any()), key
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    total_cpu, _ = loss_fn(cpu_params, cfg, {k: v.cpu() for k, v in batch.items()})
    assert abs(float(total) - float(total_cpu)) <= 1e-4 * abs(float(total_cpu))


def test_cuda_train_loop_learns_and_resumes(cuda_device, tmp_path, monkeypatch):
    """On the card, under ``torch.use_deterministic_algorithms``: the smoke
    llama's loss falls over 40 steps (the reference's ``test_loss_decreases``
    rates), and the reference's ``test_checkpoint_restart_is_exact`` case --
    those 40 steps straight against a crash at 20 and a resume, at lr 3e-3 --
    gives the resumed losses and final parameters bitwise the straight
    run's, as on the CPU.  (Without it a CUDA op may sum in another order
    from run to run: ``chip_smoke.py``'s ``train_card_vs_cpu`` phase reports
    the gradients that a default second backward does not repeat.)"""
    from repro_torch.configs import for_kernels, get_config
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = for_kernels(get_config("llama3.2-1b", "smoke"))
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=40)

    def loop(d):
        return TrainLoop(cfg, opt, LoopConfig(total_steps=40, ckpt_every=10, log_every=1000),
                         ckpt_dir=tmp_path / d, device=cuda_device)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        straight = loop("a")
        state_a = straight.run()
        first = loop("b")
        with pytest.raises(RuntimeError, match="simulated crash"):
            first.run(crash_at=20)
        resumed = loop("b")
        state_b = resumed.run()
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [m["loss"] for m in straight.metrics_history]
    assert all(x == x for x in losses)
    assert sum(losses[-10:]) / 10 < sum(losses[:10]) / 10 - 0.1
    assert len(resumed.metrics_history) == 20
    assert ([m["loss"] for m in first.metrics_history + resumed.metrics_history]
            == [m["loss"] for m in straight.metrics_history])
    for (k, x), (_k, y) in zip(flatten_with_paths(state_a.params),
                               flatten_with_paths(state_b.params)):
        assert torch.equal(x, y), (k, float((x.float() - y.float()).abs().max()))
