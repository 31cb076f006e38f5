"""The training path on the card: the autograd Functions of the four
kernels on the training forward, and ``TrainLoop`` on the smoke llama,
rwkv6 and zamba2.

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
float32; SwiGLU: 5e-2 / 2e-3 of the tensor's largest value; the scans: two
bf16 ulps of the row's largest value, 1e-4 of one plus it in float32).
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
SCAN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}


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


def _scan_close(got, want):
    """The scans' parity rule (``chip_smoke.SCAN_TOL``): bf16 within two
    ulps of the row's largest |value|, float32 within 1e-4 of one plus it."""
    bf16, tol = want.dtype == torch.bfloat16, SCAN_TOL[want.dtype]
    got, want = got.double(), want.double()
    row = want.abs().amax(-1, keepdim=True)
    limit = tol * row if bf16 else tol * (1 + row)
    assert torch.isfinite(got).all() and bool(((got - want).abs() <= limit).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [True, False])
def test_cuda_rwkv6_scan_fn(cuda_device, dtype, with_state):
    """``ops.rwkv6_scan`` on inputs that require grad goes through
    ``Rwkv6ScanFn``: one kernel launch, the forward bitwise the kernel's,
    and every gradient -- both outputs used, the bonus broadcast over the
    batch and reduced back to [H, Dk], the state's -- within the scans'
    tolerance of autograd of the plain version."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk, ops as rops, ref as rr

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    b, h, s, d = 2, 4, 100, 64

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    r, k, v = (rnd(b, s, h, d).transpose(1, 2) for _ in range(3))
    lw = -torch.rand(b, s, h, d, generator=gen, device=cuda_device).transpose(1, 2) * 3
    u = torch.rand(h, d, generator=gen, device=cuda_device) * 0.6 - 0.3
    s0 = rnd(b, h, d, d, dt=torch.float32) if with_state else None
    inputs = [t for t in (r, k, v, lw, u, s0) if t is not None]
    leaves = [t.detach().requires_grad_() for t in inputs]
    args = leaves + ([] if with_state else [None])
    go, gs = rnd(b, h, s, d), rnd(b, h, d, d, dt=torch.float32)
    LAUNCHES.clear()
    out, st = rops.rwkv6_scan(*args, chunk=32)
    assert type(out.grad_fn).__name__ == "Rwkv6ScanFnBackward"
    assert LAUNCHES["rwkv6_scan"] == 1
    with torch.no_grad():
        ko, ks = rk.rwkv6_scan(*args, chunk=32)
    assert torch.equal(out, ko) and torch.equal(st, ks)
    got = torch.autograd.grad((out, st), leaves, (go, gs))
    plain = rr.rwkv6_scan(*args, chunk=32)
    _scan_close(out.detach(), plain[0].detach())
    _scan_close(st.detach(), plain[1].detach())
    want = torch.autograd.grad(plain, leaves, (go, gs))
    assert got[4].shape == (h, d)
    for g, w in zip(got, want):
        _scan_close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_fn(cuda_device, dtype):
    """``ops.ssd_scan`` on inputs that require grad goes through
    ``SsdScanFn``, with B and C expanded over the heads as zamba2 passes
    them: one kernel launch, the forward bitwise the kernel's, and the
    gradients of x, a, the [B, S, Dst] B and C (summed over the heads by
    autograd through the ``expand``) and the state within the scans'
    tolerance of autograd of the plain version.  Only ``y`` is used: the
    final state's gradient stays None."""
    from repro_torch.kernels.ssd_scan import kernel as sk, ops as sops, ref as sr

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, s, d, dst = 2, 6, 130, 64, 16

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    x = rnd(b, s, h, d).transpose(1, 2).requires_grad_()
    a = (-torch.rand(b, s, h, generator=gen, device=cuda_device) * 6).transpose(1, 2)
    a.requires_grad_()
    bm, cm = rnd(b, s, dst).requires_grad_(), rnd(b, s, dst).requires_grad_()
    s0 = rnd(b, h, dst, d, dt=torch.float32).requires_grad_()
    go = rnd(b, h, s, d)

    def call(fn):
        return fn(x, a, bm[:, None].expand(b, h, s, dst), cm[:, None].expand(b, h, s, dst), s0,
                  chunk=64)

    LAUNCHES.clear()
    y, _st = call(sops.ssd_scan)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    assert LAUNCHES["ssd_scan"] == 1
    with torch.no_grad():
        assert torch.equal(y, call(sk.ssd_scan)[0])
    got = torch.autograd.grad(y, (x, a, bm, cm, s0), go)
    plain = call(sr.ssd_scan)[0]
    _scan_close(y.detach(), plain.detach())
    want = torch.autograd.grad(plain, (x, a, bm, cm, s0), go)
    assert got[2].shape == bm.shape
    for g, w in zip(got, want):
        _scan_close(g, w)


@pytest.fixture
def tf32():
    """TF32 on for float32 products, as ``torch.set_float32_matmul_precision
    ("high")`` sets it in a training script; restored afterwards."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("scan", ["rwkv6", "ssd"])
def test_cuda_scan_prefix_sums_ignore_tf32(cuda_device, tf32, scan):
    """The plain scans' prefix sums of the log-decays are float32 sums
    whatever the matmul precision: a chunk's total decay e^{tot} under TF32
    lies within 1e-5 relative (in its exponent) of the float64 one.  A
    product with triangular ones would round each decay to TF32's 10-bit
    mantissa, ~5e-4 relative, and fail."""
    from repro_torch.kernels.rwkv6_scan import ref as rr
    from repro_torch.kernels.ssd_scan import ref as sr

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    if scan == "rwkv6":
        r, k, v = (torch.randn(8, 32, 64, generator=gen, device=cuda_device) for _ in range(3))
        lw = -torch.rand(8, 32, 64, generator=gen, device=cuda_device) * 2
        u = torch.zeros(64, device=cuda_device)
        tot = rr._chunk_terms(r, k, v, lw, u)[2]
        want = lw.double().sum(-2)
    else:
        x = torch.randn(8, 64, 64, generator=gen, device=cuda_device)
        a = -torch.rand(8, 64, generator=gen, device=cuda_device) * 1.5
        b, c = (torch.randn(8, 64, 16, generator=gen, device=cuda_device) for _ in range(2))
        tot = sr._chunk_terms(x, a, b, c)[2]
        want = a.double().sum(-1)
    err = (tot.double().log() - want).abs() / want.abs()
    assert float(err.max()) <= 1e-5, float(err.max())


@pytest.mark.parametrize("scan", ["rwkv6", "ssd"])
def test_cuda_scan_fn_gradients_under_tf32(cuda_device, tf32, scan):
    """With TF32 on, the scan Functions' float32 gradients (the plain
    backward) stay within 1e-2 of the tensor's largest |value| of autograd
    of the plain scan at full float32 precision (TF32 off; the plain scans
    compute in float32 whatever their inputs), at decays that reach e^-90
    within a chunk: what is left is TF32's rounding of the products
    (~1e-3), not of the exponents."""
    from repro_torch.kernels.rwkv6_scan import ops as rops, ref as rr
    from repro_torch.kernels.ssd_scan import ops as sops, ref as sr

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    b, h, s, d = 2, 4, 100, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    if scan == "rwkv6":
        lw = -torch.rand(b, h, s, d, generator=gen, device=cuda_device) * 5.6
        inputs = [rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d), lw,
                  torch.rand(h, d, generator=gen, device=cuda_device) * 0.6 - 0.3,
                  rnd(b, h, d, d)]
        fn, plain, kw = rops.rwkv6_scan, rr.rwkv6_scan, {"chunk": 32}
    else:
        a = -torch.rand(b, h, s, generator=gen, device=cuda_device) * 2.8
        inputs = [rnd(b, h, s, d), a, rnd(b, h, s, 16), rnd(b, h, s, 16), rnd(b, h, 16, d)]
        fn, plain, kw = sops.ssd_scan, sr.ssd_scan, {"chunk": 64}
    go, gs = rnd(b, h, s, d), rnd(*inputs[-1].shape)
    leaves = [t.requires_grad_() for t in inputs]
    got = torch.autograd.grad(fn(*leaves, **kw), leaves, (go, gs))
    torch.backends.cuda.matmul.allow_tf32 = False
    want = torch.autograd.grad(plain(*leaves, **kw), leaves, (go, gs))
    for g, w in zip(got, want):
        _tensor_close(g, w, 1e-2)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b", "zamba2-7b"])
def test_cuda_train_step_gives_every_parameter_a_gradient(cuda_device, arch):
    """The smoke model's loss on the card launches each kernel of its
    forward once per layer (zamba2: per shared-block site), gives every
    parameter a finite, non-zero gradient (rwkv6's decay LoRA starts its
    second factor at zero, which zeroes the first's gradient: it is drawn
    here) and equals the CPU's loss."""
    import dataclasses

    from repro_torch.configs import for_kernels, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.transformer import init_params, loss_fn, shared_sites

    cfg = dataclasses.replace(for_kernels(get_config(arch, "smoke")), dtype=torch.float32)
    params = init_params(cfg, 0, device=cuda_device)
    if "w_lora_b" in params["layers"]:
        params["layers"]["w_lora_b"].normal_(std=0.1)
    params = tree_map(lambda t: t.requires_grad_(), params)
    leaves = flatten_with_paths(params)
    batch = {k: torch.as_tensor(v, device=cuda_device).long() for k, v in
             next(SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=2, seq_len=64))).items()}
    LAUNCHES.clear()
    total, _ = loss_fn(params, cfg, batch)
    sites = {"dense": cfg.n_layers, "ssm": 0, "hybrid": len(shared_sites(cfg))}[cfg.family]
    assert LAUNCHES["flash_attention"] == sites and LAUNCHES["swiglu"] == 2 * sites
    assert LAUNCHES["rwkv6_scan"] == (cfg.n_layers if cfg.family == "ssm" else 0)
    assert LAUNCHES["ssd_scan"] == (cfg.n_layers if cfg.family == "hybrid" else 0)
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


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_cuda_scan_train_loop_resumes_bitwise(cuda_device, tmp_path, monkeypatch, arch):
    """The smoke rwkv6 and zamba2 through ``TrainLoop`` on the card under
    ``torch.use_deterministic_algorithms`` (the plain scans' backward uses
    no op without a deterministic CUDA implementation): 12 straight steps
    against a crash at 6 and a resume, the resumed losses and final
    parameters bitwise the straight run's."""
    from repro_torch.configs import for_kernels, get_config
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = for_kernels(get_config(arch, "smoke"))
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=12)

    def loop(d):
        return TrainLoop(cfg, opt, LoopConfig(total_steps=12, ckpt_every=6, log_every=1000),
                         ckpt_dir=tmp_path / d, device=cuda_device)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        straight = loop("a")
        state_a = straight.run()
        first = loop("b")
        with pytest.raises(RuntimeError, match="simulated crash"):
            first.run(crash_at=6)
        resumed = loop("b")
        state_b = resumed.run()
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [m["loss"] for m in straight.metrics_history]
    assert all(x == x for x in losses) and len(resumed.metrics_history) == 6
    assert [m["loss"] for m in first.metrics_history + resumed.metrics_history] == losses
    for (k, x), (_k, y) in zip(flatten_with_paths(state_a.params),
                               flatten_with_paths(state_b.params)):
        assert torch.equal(x, y), k
