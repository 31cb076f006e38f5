#!/usr/bin/env python3
"""GPU drive of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

1. the device: ``torch.cuda.get_device_name()`` and ``nvidia-smi``'s
   name / power limit (the raw CSV line is printed too);
2. the kernel build (``nvcc`` for sm_90a, one process per source), timed;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and, for ``erlang_c``, at k_hi = 512 over S = 8192 lanes
   and under three load mixes at the fleet's S = 4096 x 7, k_hi = 48 (the
   loads the fleet's last fused tick hands ``stationary_wait``'s table,
   all-idle lanes with a = 0, and a in [10, 40], where B stays normal to
   row 48), each timed (``erlang_loads``); for ``decide_fused`` at k_hi =
   512, N = 32 (also at N = 40, its wide route; the fleet shape
   must run the packed route, ``decide_packed_kernel``, by profiler
   symbol; ``queue_window``: the fleet's window, B 4096 x N 7 over 100
   steps, with bounded and ``+inf`` queues, padded lanes and ``warm``
   switching inside the window, all 15 outputs, and at N = 40, its wide
   route; ``gain_topr`` at the fleet tile, with ``+inf`` gains, and at N =
   40, its grid route (``gain_topr_hist_kernel`` by profiler symbol), the
   fleet tile by profiler symbol on the warp route
   (``gain_topr_warp_kernel``); ``l2_match``: at the VLD matcher's M = N =
   1024, D = 64 and at M = 1000, N = 777, D = 50): integer outputs exact,
   float outputs bitwise; each timed with
   CUDA events (median of 25 runs of 10 calls, after warm-up) beside its
   bound (the larger of bytes over 3.35 TB/s and operations over the
   67 TFLOP/s float32 rate of an H100 SXM);
4. the main path: 4096 scenario lanes (256 distinct ``scenario_matrix``
   scenarios, seed 5, tiled x16) through the port's ``ScenarioRunner`` in
   float32, with the two-pass decide and with the fused decide, in turns
   (off, on, on, off).  Launch counters are zeroed just before each run
   and checked just after (one ``queue_window`` per tick, no ``queue_step``;
   ``erlang_c`` once per fused tick -- ``stationary_wait``'s Erlang-B
   table -- and twice per two-pass tick, with the decide's; ``gain_topr``
   once per two-pass tick, ``decide_fused`` once per fused tick); all four
   runs must make bitwise-equal decisions.  One more run of each dispatch
   under ``torch.profiler`` gives device time, launches per tick (at most
   400 fused, 500 two-pass: no 512-step Erlang-B loop) and the device's
   busy share;
5. the same loop for the first 256 lanes on the CPU with the plain
   versions, against the card's run: no (tick, lane) decision code or
   allocation may differ;
6. ``vld_card_vs_cpu``: 64 seeded frames of the VLD application at its
   full width (480 x 640 frames, 1024 keypoints, 16 logos x 64
   descriptors, D = 64) through extract -> match -> aggregate on the card
   and on the CPU: match counts and detections must be equal; then 16 of
   them once more under torch.profiler (``vld_profile``): kernel device
   time and launches per frame against the unprofiled wall time;
7. ``vld_live``: the live DRS session of ``examples/stream_vld.py`` at that
   width on the card -- ``DRSSession.bind(graph, "engine")`` under
   ``SchedulerConfig(k_max=6, min_improvement=0.01, horizon_seconds=600)``
   from the bad start {extract: 1, match: 2, aggregate: 1}: frames are
   injected for ~5 s, the session ticks (and applies its decision), ~3 s
   more frames, then it drains.  Every injected frame must complete with
   one detection row and exactly one ``match_count`` launch;
7a. ``twin_loop``: the window-at-a-time control loop on the card -- the
   256 ``scenario_matrix`` scenarios of phase 4 as generated (72 of them
   negotiated: machine leases between windows) tiled x4 to 1,024 lanes
   through ``ScenarioRunner(backend="torch")``, 6 ticks: exactly one
   ``queue_window`` launch per tick, no ``queue_step``, no decide kernel
   (the twin decides on the host in float64, as the reference's does);
   wall ms per tick, and device ms, launches and the busy share per tick
   from one more run under torch.profiler; ``expected_sojourn_batch`` on
   the card for the 256 mean topologies at their final allocations (one
   ``erlang_c`` launch per call, within 1e-5 relative of the float64
   numpy table); the first 256 lanes again on the CPU (the plain window:
   no (tick, lane) action or allocation may differ) and through the
   float64 twin (the cells that differ are printed, not checked);
7b. ``proactive_loop``: the forecast/MPC plane and the sparse decide on
   the card -- fleet-4096 with its last 256-lane tile on deterministic
   arrivals (Poisson lanes measure a new window every tick; deterministic
   constant lanes go quiet, so the sparse decide has lanes to skip) through
   ``ScenarioRunner(proactive=True)`` with the fused decide off / on and
   ``compact`` off / on, in turns (8 runs).  Checks: compact and dense
   runs bitwise equal on every output (decisions, ``mpc_used``,
   ``confident`` and every float); the two dispatches equal on codes, k
   and ``mpc_used``; 256 lanes (128 of the first tile, 128 of the quiet
   one) on the CPU against the card: no (tick, lane) cell of codes, k or
   ``mpc_used`` differs; each run's launches equal ``loop_launch_rule``
   (per tick: one ``queue_window``; ``erlang_c`` for ``stationary_wait``,
   the two-pass decide and the planner's table; ``gain_topr`` or
   ``decide_fused`` for the decide and the planner's allocator; under
   compaction the decide and the planner run only on ticks with a
   repriced / eligible lane, read from the run's own outputs); some lane
   commits ``"proactive"`` and some tick reprices fewer than all lanes.
   Reported: wall, device ms, launches by kernel and the busy share per
   tick (one profiled run per config), the repriced share and the plans
   used per tick, and ``decide_fused`` / ``gain_topr`` / ``erlang_c`` on
   the planner's own inputs (3 x 4096 candidate rows, ``k_cur = 0``;
   B (H+1) N loads), bitwise against their plain versions, timed beside
   their bounds;
7c. ``soak``: the checkpointed soak (``repro_torch.streaming.soak``) on
   the card in float32 -- the full day of ``SoakConfig()`` (720 ticks of
   240 steps, B = 1, a crash and restore every 96 ticks) reactive with the
   two-pass decide and proactive with the fused decide, the 2 h day
   (``SoakConfig.smoke()``) with ``compact`` off and on, and fleet-4096
   (6 ticks) saved and restored every 2 ticks with ``compact`` on.  Hard:
   each stitched run equals its straight run bitwise outside
   ``DIAGNOSTIC_KEYS``, the restores counted, each straight run's launches
   exactly :func:`soak_launch_rule`, the 2 h day card vs CPU 0 ticks of
   codes / k.  Reported: wall ms per tick (straight and stitched),
   launches per tick, ``save_async`` / wait / restore / rebuild / save ms,
   ``soak_report(...).summary()``, and device ms and launches per tick of
   one profiled 2 h run per mode (``soak_profile``);
7d. ``fleet_plan``: ``FleetPlanner.plan_batched`` for the 256 distinct
   fleet scenarios as tenants (mean topology, t_max; 1,298 operator rows,
   floors 3,011) at a pool of floors + 2,048: one ``gain_topr`` call on
   the grid route over [1, 1298, 2048].  Hard: takes equal to the plain
   float32 plan's, the kernel bitwise its plain version on the tile,
   totals within the pools, a pool of 3,000 overloaded as the scalar plan
   says.  Reported: operators that differ from the float64 scalar plan,
   plan ms, and the kernel call's ms, device us and bound;
7e. ``fleet_live``: a ``FleetSession(solver="batched", k_max=16)`` over
   two engine tenants on the card: VLD at ``vld_live``'s width and FPD at
   32 items, patterns up to 3, a 50,000-transaction window and threshold
   3,125, the window filled through ``apply`` first (timed); ~4.5 s of
   frames and transactions with 3 fleet ticks.  Hard: every frame
   completes with one ``match_count`` launch, every FPD event completes,
   no operator fails, FPD's incremental counts equal one
   ``support_counts`` over the final window, every plan within the pool,
   one ``gain_topr`` launch per batched plan (warp route);
7f. ``fleet_mesh``: the mesh-sharded control plane on the card --
   fleet-4096 cut to 4,090 lanes through ``ScenarioRunner(mesh=)``: (a) on
   a one-rank NCCL mesh (``fleet_mesh()``) with the fused decide off and
   on; (b) on four spawned ranks sharing the card (gloo on CUDA tensors;
   two padded lanes) off and on, ``compact`` and ``proactive``; (c) the
   256-tenant ``plan_batched(mesh=)`` on the four ranks; (d) the
   1,024-tenant fleet (5,128 operator rows, past the 4,093 the old block
   route held) planned on the one-rank mesh, its ``gain_topr`` grid-route
   call timed beside its plain version and bound; (e) the fused loop as a
   chunked resume, unsharded, on the one rank and on each of the four:
   each rank's carry and per-tick outputs hold ``B_pad / D`` lanes between
   runs, ``init`` and ``run`` make no ``all_gather``, ``gather`` gives the
   unsharded outputs, and each rank's peak device memory is set beside the
   unsharded run's.  Hard: every sharded
   run equals the unsharded card run on the decisions, allocations and
   integer aggregates, on every rank; the plans equal the unsharded plans
   and (d) the plain float32 plan, take for take.  Reported: each rank's
   device and backend, wall ms per tick sharded and unsharded;
8. the per-kernel JSON line (``launches``: the loop kernels summed over
   the four main-path runs, each of which must have launched (``erlang_c``
   1 / 2 times per fused / two-pass tick), plus ``twin_loop``'s
   ``queue_window`` and ``erlang_c`` launches, the eight
   ``proactive_loop`` runs', the ``soak`` runs' (straight and stitched),
   ``fleet_plan``'s, ``fleet_live``'s and ``fleet_mesh``'s ``gain_topr``
   (and ``fleet_mesh``'s loop kernels, in its own process), and
   ``fleet_live``'s ``match_count`` -- but
   ``queue_step``, whose steps the window kernel runs, and which is on no
   path; the two ``l2_match`` kernels from the ``vld_live`` run,
   where ``match_count`` runs once per frame and ``pairwise_sq_l2`` --
   reached by no path, only by the reference's kernel benchmark --
   never).  ``library_ms`` is
   ``torch.cdist`` on the same inputs for the two ``l2_match`` kernels (the
   unsquared distance: the nearest single PyTorch call), null for the
   others; for the three LLM kernels it is ``scaled_dot_product_attention``
   (``enable_gqa=True``) on the same inputs for the two attention kernels
   (decode: on the valid prefix), the padded ``torch.bmm`` products
   (``models/ffn.py:_experts``) for ``moe_experts``, and null for
   ``swiglu`` and the two scans (no single PyTorch call computes a chunked
   linear recurrence).
   Launches of the attention, SwiGLU, experts and scan kernels sum the serving
   paths and the ``train`` runs, each counted from zero, and are split by
   path in ``launches_by_path``; the four training kernels also carry
   ``train_fwd_bwd_ms`` / ``train_plain_fwd_bwd_ms`` from
   ``train_kernels`` (bf16); the four LLM kernels carry ``shapes``, the
   timed cases of phase 9 by group;
9. ``llm_kernels`` (with the parity phase, before the main path):
   ``flash_attention``, ``decode_attention`` and ``swiglu`` against their
   plain versions on the card at every case of one table
   (``FLASH_CASES``, ``DECODE_CASES``, ``SWIGLU_CASES``: arch, shape,
   window; heads and widths from the arch's full config), in bf16 and
   float32 within ``ATTN_TOL`` / ``SWIGLU_TOL``: llama3.2-1b's serving
   shapes (the kernel table's row) and other shapes (windowed,
   bidirectional, length 0, B 1); zamba2-7b's head dim 112 (MHA) and FFN
   width; the head-dim-128 dense archs (phi3-medium-14b's prefill, the
   (128, 4 / 7 / 8) decode pairs of phi3, yi-34b and command-r-35b, the
   three FFN widths); mixtral-8x22b's windowed 2 x 8192 prefill, kimi's
   (Dh 112, 64 / 8 heads), the (128, 6) and (112, 8) decode pairs and
   kimi's shared expert and qwen2-vl's FFN; whisper-medium's (16 heads of
   64, MHA) bidirectional encoder over 16 x 1,500 frames, cross attention
   of 224 queries over them and the (64, 1) decode over the 1,500 cross
   rows and a 448-row self cache; ``long_500k``'s decode on a full
   524,288-row cache at batch 1: zamba2's (112, 1) over every row and
   mixtral's (128, 6) over its 4,096-row window, and zamba2's SwiGLU at
   that step's T 1; decode at B 3 over 4,128 rows, where the blocks'
   ranges end mid-tile and cross from one sequence or head into the next
   (llama, kimi, zamba2).  Every decode case runs twice, its bits held
   equal.  ``moe_experts`` (``MOE_CASES``, bf16 within ``MOE_TOL`` on the
   filled slots): mixtral's layer in the mixtral prefill cell (E 8 x C
   5,120 at the cell's kept counts; the kernel table's row), kimi's 384
   full-width routed experts at a 4 x 4,096 prefill (C 426), and both at a
   B 4 step (C 1).  The timed cases (bf16, CUDA
   events and ``torch.profiler`` device time) stand beside the plain
   version, SDPA where one call computes the same function (a windowed
   case has none: SDPA takes the window only as a dense mask, off its
   flash backend; that time is kept as ``masked_sdpa_ms``; the experts'
   yardstick is the padded ``torch.bmm`` path), and the bound
   (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16; the experts'
   from their filled slots);
10. ``card_vs_cpu``: each ``CARD_VS_CPU`` arch at full width, cut to 1-2
    layers (kimi also to 32 of its 384 experts), in bf16 and float32: a
    prefill and greedy steps on the card and, with the same parameters and
    teacher-forced on the card's tokens, on the CPU (plain versions):
    logits within the stated tolerance, the share of agreeing greedy
    tokens; the moe archs' routing (experts and kept pairs of every call
    and layer) equal in float32, the smallest top-k margin reported;
    whisper at 2 + 2 layers with 1,500 stub frames per prompt;
11. ``*_serve``: each of ``SERVED_ARCHS`` at full width in bf16
    (parameters drawn on the card from seed 0; mixtral cut to 13 of its 56
    layers, kimi to 1 of its 61, ``SERVE_LAYERS``): 4 x 4096 prefilled
    (mixtral 2 x 8192, so its window bites in prefill and decode;
    qwen2-vl 256 stub patches + 3,840 tokens; whisper 16 segments of 1,500
    stub frames and a 224-token prompt in a 448-row cache), then 32 greedy
    steps, each
    kernel's launches exactly :func:`serve_launch_rule`, prefill tokens/s,
    ms per step, peak memory under 75 GB and ``torch.profiler`` breakdowns
    of a prefill and a step; the moe archs' dropped share of (token, slot)
    pairs from a second, untimed run that records the routing;
12. ``llm_decode_32k``: llama's decode step at 16 sequences x 32,000
    cached tokens (S_max 32,768, seeded K / V drawn on the card), 8 steps
    timed against the step's bound (KV prefix + weights over 3.35 TB/s);
12a. ``long_500k``: the reference's ``long_500k`` shape (one token
    against a 524,288-row cache, batch 1) through ``init_cache`` /
    ``prefill`` / ``decode_step`` for its three archs at full width in
    bf16: rwkv6-1.6b whole, its state from one prefill of
    ``LONG_PREFILL`` seeded tokens; zamba2-7b at 42 of 81 layers (7 of 14
    sites) and mixtral-8x22b at 8 of 56 layers (``LONG_LAYERS``), their
    K / V (and zamba2's SSM states) drawn on the card; from length
    524,256, 32 steps timed with CUDA events to a full cache (launches
    exactly :func:`serve_launch_rule`), then one step on the full cache
    that must rewrite only its last row, as the reference's
    ``dynamic_update_slice`` does; ms per step beside the step's bound, a
    profiled step, peaks under 75 GB, RoPE at the last 64 positions card
    against CPU within 4e-7 of (1 + the row's largest |x|); each cell
    freed before the next;
13. ``serving_plan``: for each served arch not cut in depth, DRS's prefill
    / decode chip split through the port's launcher (``launch/serve.py``:
    ``stage_rates`` of the measured rates, ``plan(4.0, chips=24)``) from
    its B = 4 cell (the 4 x 4096 prefill's prompts / s, the B = 4 decode
    step's tokens / s), then ``serving_sim``: that plan through the
    launcher's discrete-event serving simulation (horizon 600 s, warm-up
    60 s, host code), its mean and p95 latency beside the model's E[T];
14. ``ssm_kernels`` (with the parity phases, before the main path):
    ``rwkv6_scan`` and ``ssd_scan`` against their plain versions at the
    serving shapes (4 x 4096; rwkv6-1.6b's 32 heads of 64, zamba2-7b's 112
    heads of 64 with B / C shared by the heads) in bf16 and float32 with
    seeded decays spread over the models' clamp ranges and a non-zero
    initial state, at the clamp floors (w = 0.05, log a = -6) against a
    float64 step recurrence, and in the [BH] layout with a short last
    chunk; bf16 ``rwkv6_scan`` also at w = 1e-8 and at the floor with
    chunk 64 (its tensor-core kernel's exact per-pair branch), checked
    to run ``rwkv6_mma_kernel`` at the serving shape, and ``rwkv6_scan`` at
    B 1 over ``long_500k``'s prefill (``LONG_PREFILL`` tokens, both
    dtypes, the largest error of the first and last 64 tokens printed);
    each timed beside
    its plain version and its bound (the scans' bf16 rows: bytes over 3.35
    TB/s against the products over 989 TFLOP/s plus the other operations
    over 67 TFLOP/s);
14a. ``dryrun``: the port's dry-run (``repro_torch.launch.dryrun``, host
    code on meta tensors, H100 constants): the ``prefill_32k`` and
    ``decode_32k`` records of llama3.2-1b, rwkv6-1.6b, zamba2-7b,
    phi3-medium-14b, qwen2-vl-2b and whisper-medium and the ``long_500k``
    records of rwkv6-1.6b, zamba2-7b and mixtral-8x22b (full depth) on
    pod16x16 written under ``build/dryrun``, each with its dominant term
    and bound; then llama's 4 x 4096 prefill and B = 4 step, phi3's 4 x
    4096 prefill and the zamba2-42L and mixtral-8L ``long_500k`` steps
    costed on a one-device mesh at the cells the card ran: the roofline
    bound must not exceed the device ms the card took (profiled in this
    run), and the predicted peak (arguments + temporaries) must be within a
    factor 1.5 of ``max_memory_allocated`` over that call, both ratios
    printed;
15. ``launch_serve``: ``python -m repro_torch.launch.serve`` (its
    ``main(argv)``, in this process) for every planned arch on its B = 4
    rates (``--prefill-rate`` / ``--decode-rate``): the split must equal
    ``serving_plan``'s; then the six archs of ``dryrun`` with no rates:
    each must plan from ``"dry-run roofline"``;
16. ``train_kernels``: ``FlashAttentionFn`` at llama's training shape (B 2,
    Hq 32 / Hkv 8, S 4096, Dh 64), ``SwiGLUFn`` at T 8,192, D 2,048, F
    8,192, ``Rwkv6ScanFn`` at rwkv6's (B 2, H 32, S 4096, Dk = Dv = 64) and
    ``SsdScanFn`` at zamba2's (B 2, H 112, S 4096, Dh = Dst = 64, B and C
    shared by the heads), bf16 and float32: the forward within
    ``ATTN_TOL`` / ``SWIGLU_TOL`` / ``SCAN_TOL`` of the plain version and
    equal to the kernel bitwise, each input's gradient (the scans' initial
    state's and B / C's, summed over the heads, included) within the same
    tolerance of autograd of the plain version; forward + backward ms
    beside the plain version's;
17. ``train_card_vs_cpu``: llama3.2-1b, rwkv6-1.6b, zamba2-7b and
    whisper-medium at full width cut to 2 layers (zamba2: one shared-block
    site; whisper 2 + 2 with 1,500 stub frames), float32, B 2 x S 256
    (rwkv6 and zamba2: 128): every parameter's
    gradient non-zero on the card and, under deterministic algorithms,
    bitwise equal with and without the layers rematerialised, then 3
    ``make_train_step`` steps on the card and on the CPU from the same
    parameters: losses and grad norms within 1e-3 relative;
18. ``train``: each arch at full width, cut as ``TRAIN_CUTS`` says (bf16
    parameters, float32 moments), through ``TrainLoop`` on ``train_4k``'s
    sequence with the batch cut 256 -> 2 (kimi's to 1), all under
    ``torch.use_deterministic_algorithms``, launches exactly
    :func:`train_launch_rule`, peak memory under 75 GB, losses finite:
    llama3.2-1b (4 of 16 layers) and mixtral-8x22b (1 of 56 layers) 8
    steps without checkpoints, then a crash at 4 and a resume to 8 whose
    losses for steps 5-8 and final parameters are bitwise the straight
    run's; rwkv6-1.6b (whole), zamba2-7b (34 of 81
    layers: the whole model's 6.75 B parameters need ~81 GB before
    activations), kimi-k2-1t-a32b (1 layer, 32 of 384 experts),
    qwen2-vl-2b (whole; 256 stub patches from :func:`vlm_stub_inputs` +
    3,840 tokens) and whisper-medium (whole; 1,500 stub frames from
    :func:`audio_stub_inputs` + 4,096 decoder tokens) 4 straight steps;
    tokens / s, step ms, peak memory, the loader's worker counts; every
    layer body rematerialised, as the port trains;
19. ``dryrun_train``: the dry-run's peak of llama's 4-layer train step
    on one device within 1.5x of ``train``'s ``max_memory_allocated``.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before it; so does a host without a CUDA device, or a
directory without the package beside this script.
"""

from __future__ import annotations

import contextlib
import json
import os
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
MAIN_B, DISTINCT, N_OPS, K_HI = 4096, 256, 7, 48
TWIN_B = 1024  # twin_loop: the 256 distinct scenarios tiled x4
# twin_loop: expected_sojourn_batch on the card (float32 table) against
# the float64 numpy table, relative; float32 rounding gives ~2e-7.
TWIN_SOJOURN_RTOL = 1e-5
WINDOW_STEPS = 100  # fleet-4096: a 5 s tick of 0.05 s steps
# Kernels that no path of the port launches (their rows are still held to
# their plain versions and timed).
OFF_PATH = ("queue_step", "pairwise_sq_l2")
PROFILE_ATTEMPTS = 5  # profiler sessions tried before an empty trace stands
# Device-function names of the window kernel's routes, by plan route.
WINDOW_ROUTE_SYMBOLS = {"segment": "queue_window_seg_kernel", "wide": "queue_window_wide_kernel"}
# Device-function names of the control-loop kernels, by launch counter.
LOOP_SYMBOLS = {
    "queue_step": ("queue_step_kernel",),
    "queue_window": tuple(WINDOW_ROUTE_SYMBOLS.values()),
    "erlang_c": ("erlang_b_kernel",),
    "gain_topr": ("gain_topr_warp_kernel", "gain_topr_hist_kernel", "gain_topr_rows_kernel",
                  "gain_topr_take_kernel"),
    "decide_fused": ("decide_packed_kernel", "decide_fused_kernel"),
}
# The VLD application at full width: an SD frame, the paper's 16 query
# logos, the repo's 8 x 8 descriptor patch (D = 64).
VLD_WIDTH = dict(height=480, width=640, max_keypoints=1024, n_logos=16,
                 descriptors_per_logo=64)
VLD_FRAMES_CHECKED = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, *, runs=25, inner=10, warmup=3):
    """Median over ``runs`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profiled(run, expect=()):
    """``(key_averages(), result)`` of one ``run()`` under torch.profiler,
    synchronised.  The card's profiler now and then hands back a trace
    without a single device event, or without the events of a kernel that
    ran; such a session is run again, up to PROFILE_ATTEMPTS in all (three
    seconds longer apart each time), so ``run`` must be repeatable.
    ``expect``: groups of kernel names (a name or a tuple of alternatives),
    each of which the trace must show a device event of before it stands.
    Which kernels a trace shows is still for the caller to check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        keys = [e.key for e in events
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        missing = [g for g in expect
                   if not any(s in k for k in keys for s in ((g,) if isinstance(g, str) else g))]
        if keys and not missing:
            break
        free, _total = torch.cuda.mem_get_info()
        emit({"phase": "profiler", "empty_trace": attempt, "missing": missing,
              "device_events": len(keys), "free_gb": free / 1e9,
              "reserved_gb": torch.cuda.memory_reserved() / 1e9})
        # The card's profiler has recorded no device event at all for over
        # ten seconds at a time: back off 3, 6, 9, 12 s (30 s in all), and
        # hand the allocator's cached blocks back first (the profiler keeps
        # device buffers of its own).
        torch.cuda.empty_cache()
        time.sleep(3 * attempt)
    return events, out


def max_abs_err(got, want):
    """0 where the outputs are bitwise equal (NaN with NaN, inf with inf);
    otherwise the largest |difference| (inf for a mismatched inf/NaN)."""
    import torch

    got, want = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if bool(same.all()):
        return 0.0
    diff = (got - want).abs()
    diff = torch.where(torch.isnan(diff), float("inf"), diff)
    return float(diff[~same].max())


def smi(query):
    """One ``nvidia-smi --query-gpu`` CSV line for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def bound(bytes_moved, ops, peak_ops=PEAK_F32_OPS_PER_S):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Phase 3 inputs (seeded, made on the host, copied to the card)
# --------------------------------------------------------------------------- #
def queue_step_inputs(gen, m, dev):
    import torch

    q = torch.rand(m, generator=gen, dtype=torch.float64) * 40.0
    q[::7] = 0.0
    inflow = torch.poisson(torch.full((m,), 3.0, dtype=torch.float64), generator=gen)
    cap_serve = torch.rand(m, generator=gen, dtype=torch.float64) * 10.0
    cap_serve[1::11] = q[1::11]  # served exactly the backlog
    cap_queue = torch.full((m,), float("inf"), dtype=torch.float64)
    bounded = torch.rand(m, generator=gen) < 0.4
    cap_queue[bounded] = torch.randint(5, 60, (int(bounded.sum()),), generator=gen).double()
    return [x.float().to(dev) for x in (q, inflow, cap_serve, cap_queue)]


def window_inputs(gen, b, n, steps, dev):
    """One control window's inputs: scenarios of n - 3 to n real lanes
    (the rest padded with zeros), sparse routing with multiplicities up
    to 1.1, ~half the queues bounded (the rest ``+inf``), service below
    the arrivals on some lanes, Poisson arrivals, and ``warm`` switching
    from 0 to 1 a third of the way in."""
    import torch

    width = torch.randint(max(1, n - 3), n + 1, (b,), generator=gen)
    width[::5] = n
    lane = torch.arange(n)[None, :] < width[:, None]
    pair = lane[:, :, None] & lane[:, None, :]
    routing = torch.where(pair & (torch.rand(b, n, n, generator=gen) < 0.3),
                          torch.rand(b, n, n, generator=gen) + 0.1, 0.0)
    rate = torch.rand(b, n, generator=gen) * 7.5 + 0.5
    ext = torch.poisson(rate.expand(steps, b, n).contiguous(), generator=gen) * lane
    caps = torch.where(lane, (torch.rand(b, n, generator=gen) * 5.5 + 0.5)
                       * torch.randint(1, 4, (b, n), generator=gen), 0.0)
    bounded = lane & (torch.rand(b, n, generator=gen) < 0.5)
    capq = torch.where(bounded, torch.randint(2, 30, (b, n), generator=gen).float(),
                       float("inf"))
    q0 = torch.where(lane, torch.rand(b, n, generator=gen) * 20.0, 0.0)
    sp0 = torch.where(lane, torch.rand(b, n, generator=gen) * 3.0, 0.0)
    warm = (torch.arange(steps) >= steps // 3).float()
    return [x.float().contiguous().to(dev) for x in (q0, sp0, ext, warm, caps, capq, routing)]


def gain_topr_inputs(gen, b, n, j, dev):
    import torch

    # Non-increasing rows of quantized gains (many ties), zero padding.
    raw = torch.randint(0, 12, (b, n, j), generator=gen).float() * 0.25
    cand = torch.sort(raw, dim=-1, descending=True).values
    cand[:, -1, :] = 0.0  # a padded operator lane
    cand[3::11, 0, 0] = float("inf")  # +inf gains rank above every finite one
    pos = (cand > 0).sum(dim=(1, 2))
    budget = torch.randint(0, 60, (b,), generator=gen)
    budget[0::5] = 0  # budget 0
    budget[1::5] = pos[1::5] + 3  # budget >= every positive gain
    budget[2::5] = pos[2::5]
    return cand.contiguous().to(dev), budget.to(torch.int32).to(dev)


def decide_inputs(gen, b, n, k_hi, dev):
    import torch

    mu = torch.rand(b, n, generator=gen, dtype=torch.float64) * 8.0 + 1.0
    k_nom = torch.randint(1, 6, (b, n), generator=gen).double()
    rho = torch.rand(b, n, generator=gen, dtype=torch.float64) * 0.9 + 0.05
    lam = mu * k_nom * rho
    lam[::9, 0] = mu[::9, 0] * (k_hi + 5)  # infeasible lane: no finite row
    lam[1::13, :] = 0.0  # idle scenario
    group = torch.rand(b, n, generator=gen) < 0.25
    alpha = torch.where(group, torch.full_like(mu, 0.02), torch.zeros_like(mu))
    lam = torch.where(group, torch.minimum(lam, 0.2 * mu / 0.02), lam)
    active = torch.ones(b, n, dtype=torch.bool)
    active[:, n - 1] = torch.rand(b, generator=gen) < 0.5  # ragged widths
    lam = torch.where(active, lam, torch.zeros_like(lam))
    k_cur = torch.randint(0, 8, (b, n), generator=gen).to(torch.int32)
    floor = torch.where(active, torch.floor(lam / mu) + 1, torch.zeros_like(lam)).sum(-1)
    k_max = (floor + torch.randint(0, 30, (b,), generator=gen)).to(torch.int32)
    k_max[3::7] = 0  # budget 0
    f = [x.float().contiguous().to(dev) for x in (lam, mu, alpha)]
    return dict(lam=f[0], mu_eff=f[1], group=group.to(dev), alpha=f[2],
                active=active.to(dev), k_cur=k_cur.to(dev), k_max=k_max.to(dev))


def fleet_scenarios():
    """fleet-4096: ``DISTINCT`` seeded ``scenario_matrix`` scenarios tiled
    to ``MAIN_B``; returns (distinct, fleet)."""
    from repro_torch.streaming.scenarios import scenario_matrix

    distinct = [
        s.with_(negotiated=False)
        for s in scenario_matrix(DISTINCT, seed=5, horizon=30.0, warmup=5.0, dt=0.05, k_max=48)
    ]
    return distinct, distinct * (MAIN_B // DISTINCT)


def erlang_load_mixes(dev):
    """Three [MAIN_B * N_OPS] load vectors for ``erlang_c``: the loads the
    fleet's last fused tick hands ``stationary_wait``'s Erlang-B table (one
    fused run of the fleet, its launches not counted), all-idle lanes (a =
    0), and a in [10, 40] (B stays normal to row K_HI)."""
    import torch

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.kernels import _build
    from repro_torch.kernels.erlang_c import ops as eo

    seen, table = [], eo.erlang_b_table

    def record(a, *, k_hi):
        seen.append((a.clone(), k_hi))
        return table(a, k_hi=k_hi)

    eo.erlang_b_table = record
    try:
        ScenarioRunner(fleet_scenarios()[1], tick_interval=5.0, fused_decide=True,
                       device=dev).run()
    finally:
        eo.erlang_b_table = table
        _build.LAUNCHES.clear()
    m = MAIN_B * N_OPS
    check(bool(seen) and seen[-1][0].shape == (m,) and seen[-1][1] == K_HI,
          f"the fused fleet handed stationary_wait's table {[(a.shape, k) for a, k in seen]}, "
          f"expected [{m}] loads at k_hi = {K_HI}")
    gen = torch.Generator().manual_seed(77)
    normal = torch.rand(m, generator=gen, dtype=torch.float64) * 30.0 + 10.0
    return {"fleet": seen[-1][0], "zero": torch.zeros(m, device=dev),
            "normal": normal.float().to(dev)}


def kernel_phase(dev):
    """Each kernel against its plain version, timed; returns rows."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.decide_fused import kernel as dk, ref as dr
    from repro_torch.kernels.erlang_c import kernel as ek, ref as er
    from repro_torch.kernels.gain_topr import kernel as gk, ref as gr
    from repro_torch.kernels.queue_step import kernel as qk, ref as qr

    gen = torch.Generator().manual_seed(1234)
    m = MAIN_B * N_OPS
    rows = {}

    def compare(name, got, want, shape_note):
        errs = [max_abs_err(g, w) for g, w in zip(got, want)]
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{name} {shape_note}: dtype/shape {g.dtype}{tuple(g.shape)} vs "
                  f"{w.dtype}{tuple(w.shape)}")
        err = max(errs)
        emit({"phase": "parity", "kernel": name, "shape": shape_note, "max_abs_err": err,
              "bitwise": err == 0.0})
        check(err == 0.0, f"{name} {shape_note}: kernel differs from plain version "
                          f"(max abs err {err})")
        return err

    # queue_step at M = 4096 * 7 (on no path: the window kernel runs its steps)
    qs = queue_step_inputs(gen, m, dev)
    err = compare("queue_step", qk.queue_step(*qs), qr.queue_step(*qs), f"M={m}")
    rows["queue_step"] = dict(
        source="src/repro_torch/csrc/queue_step.cu",
        replaces="src/repro/kernels/queue_step/kernel.py:59",
        max_abs_err=err, ms=median_ms(lambda: qk.queue_step(*qs)),
        plain_ms=median_ms(lambda: qr.queue_step(*qs)),
        device_us=device_us_per_call(lambda: qk.queue_step(*qs), LOOP_SYMBOLS["queue_step"],
                                     calls=20),
        bound=bound(7 * 4 * m, 7 * m),
    )

    # queue_window: the fleet's window (B 4096, N 7, 100 steps), and N = 40
    # (the wide route); all 15 outputs bitwise
    wa = window_inputs(gen, MAIN_B, N_OPS, WINDOW_STEPS, dev)
    err = compare("queue_window", qk.queue_window(*wa), qr.queue_window(*wa),
                  f"B={MAIN_B},N={N_OPS},steps={WINDOW_STEPS}")
    w40 = window_inputs(gen, 256, 40, WINDOW_STEPS, dev)
    err = max(err, compare("queue_window", qk.queue_window(*w40), qr.queue_window(*w40),
                           f"B=256,N=40,steps={WINDOW_STEPS}"))
    route = WINDOW_ROUTE_SYMBOLS[qk.plan(N_OPS)[0]]
    device_us = device_us_per_launch(
        {route: lambda: qk.queue_window(*wa),
         "queue_window_wide_kernel": lambda: qk.queue_window(*w40)})
    check(device_us[route] is not None,
          f"queue_window at B={MAIN_B}, N={N_OPS} did not run {route}")
    emit({"phase": "queue_window_routes", "shape": f"B={MAIN_B},N={N_OPS}",
          "plan": qk.plan(N_OPS), "plan_N40": qk.plan(40), "device_us": device_us})
    lane_steps = WINDOW_STEPS * m
    rows["queue_window"] = dict(
        source="src/repro_torch/csrc/queue_step.cu",
        replaces="src/repro/kernels/queue_step/kernel.py:59",
        max_abs_err=err, ms=median_ms(lambda: qk.queue_window(*wa)),
        plain_ms=median_ms(lambda: qr.queue_window(*wa), runs=5, inner=2),
        device_us=device_us[route],
        # ext, warm, routing, 4 [B, N] inputs in; 11 [B, N] and 4 [B]
        # outputs.  Per lane and step: the routing product (2N - 1), the
        # inflow, ~10 ops of the queue update and admitted fraction, the
        # row-sum term and its two sums, 13 accumulator ops.
        bound=bound(4 * (lane_steps + WINDOW_STEPS + MAIN_B * N_OPS * N_OPS + 4 * m + 11 * m
                         + 4 * MAIN_B),
                    (2 * N_OPS - 1 + 1 + 10 + 3 + 13) * lane_steps),
    )

    # erlang_c at S = 4096 * 7, k_hi = 48, and at k_hi = 512 over 8192
    # lanes; timed under the three load mixes (the row: the fleet's loads)
    a = (torch.rand(m, generator=gen, dtype=torch.float64) * 12.0).float().to(dev)
    err = compare("erlang_c", [ek.erlang_b_table(a, k_hi=K_HI)],
                  [er.erlang_b_table(a, k_hi=K_HI)], f"S={m},k_hi={K_HI}")
    a512 = (torch.rand(256 * 32, generator=gen, dtype=torch.float64) * 300.0).float().to(dev)
    err = max(err, compare("erlang_c", [ek.erlang_b_table(a512, k_hi=512)],
                           [er.erlang_b_table(a512, k_hi=512)], "S=8192,k_hi=512"))
    loads = erlang_load_mixes(dev)
    timed = {}
    for mix, (al, k_hi) in {**{k: (v, K_HI) for k, v in loads.items()},
                           "wide": (a512, 512)}.items():
        table = er.erlang_b_table(al, k_hi=k_hi)
        err = max(err, compare("erlang_c", [ek.erlang_b_table(al, k_hi=k_hi)], [table],
                               f"S={al.shape[0]},k_hi={k_hi},loads={mix}"))
        tiny = torch.finfo(torch.float32).tiny
        timed[mix] = {
            "S": al.shape[0], "k_hi": k_hi,
            "ms": median_ms(lambda al=al, k_hi=k_hi: ek.erlang_b_table(al, k_hi=k_hi)),
            "device_us": device_us_per_call(
                lambda al=al, k_hi=k_hi: ek.erlang_b_table(al, k_hi=k_hi),
                LOOP_SYMBOLS["erlang_c"], calls=20),
            "subnormal_share": float(((table > 0) & (table < tiny)).double().mean()),
            "zero_share": float((table == 0).double().mean()),
        }
    emit({"phase": "erlang_loads", "loads": timed})
    fleet = loads["fleet"]
    rows["erlang_c"] = dict(
        source="src/repro_torch/csrc/erlang_c.cu",
        replaces="src/repro/kernels/erlang_c/kernel.py:56",
        max_abs_err=err, ms=timed["fleet"]["ms"],
        plain_ms=median_ms(lambda: er.erlang_b_table(fleet, k_hi=K_HI)),
        device_us=timed["fleet"]["device_us"],
        bound=bound(4 * m + 4 * m * (K_HI + 1), 4 * m * K_HI),
    )

    # gain_topr at the two-pass decide's [4096, 7, 48] candidate tile (with
    # +inf gains; the warp route), and at N = 40 (the grid route)
    cand, budget = gain_topr_inputs(gen, MAIN_B, N_OPS, K_HI, dev)
    err = compare("gain_topr", [gk.gain_topr(cand, budget)], [gr.gain_topr(cand, budget)],
                  f"B={MAIN_B},N={N_OPS},J={K_HI}")
    cand40, budget40 = gain_topr_inputs(gen, 256, 40, K_HI, dev)
    err = max(err, compare("gain_topr", [gk.gain_topr(cand40, budget40)],
                           [gr.gain_topr(cand40, budget40)], f"B=256,N=40,J={K_HI}"))
    device_us = device_us_per_launch(
        {"gain_topr_warp_kernel": lambda: gk.gain_topr(cand, budget),
         "gain_topr_hist_kernel": lambda: gk.gain_topr(cand40, budget40)})
    check(device_us["gain_topr_warp_kernel"] is not None,
          f"gain_topr at B={MAIN_B}, N={N_OPS}, J={K_HI} did not run gain_topr_warp_kernel")
    check(device_us["gain_topr_hist_kernel"] is not None,
          f"gain_topr at B=256, N=40, J={K_HI} did not run the grid route")
    emit({"phase": "gain_topr_routes", "shape": f"B={MAIN_B},N={N_OPS},J={K_HI}",
          "plan": gk.plan(N_OPS, K_HI), "plan_N40": gk.plan(40, K_HI),
          "device_us": device_us})
    rows["gain_topr"] = dict(
        source="src/repro_torch/csrc/gain_topr.cu",
        replaces="src/repro/kernels/gain_topr/kernel.py:98",
        max_abs_err=err, ms=median_ms(lambda: gk.gain_topr(cand, budget)),
        plain_ms=median_ms(lambda: gr.gain_topr(cand, budget)),
        device_us=device_us["gain_topr_warp_kernel"],
        bound=topr_bound(cand),
    )

    # decide_fused at [4096, 7], k_hi = j_cap = 48, and at k_hi = 512, N = 32
    # (the packed route), and at N = 40 (the wide route)
    d = decide_inputs(gen, MAIN_B, N_OPS, K_HI, dev)
    err = compare("decide_fused", dk.batch_decide(**d, k_hi=K_HI, j_cap=K_HI),
                  dr.batch_decide(**d, k_hi=K_HI, j_cap=K_HI),
                  f"B={MAIN_B},N={N_OPS},k_hi={K_HI}")
    d512 = decide_inputs(gen, 256, 32, 512, dev)
    err = max(err, compare("decide_fused", dk.batch_decide(**d512, k_hi=512, j_cap=128),
                           dr.batch_decide(**d512, k_hi=512, j_cap=128),
                           "B=256,N=32,k_hi=512,j_cap=128"))
    d40 = decide_inputs(gen, 256, 40, 200, dev)
    err = max(err, compare("decide_fused", dk.batch_decide(**d40, k_hi=200, j_cap=48),
                           dr.batch_decide(**d40, k_hi=200, j_cap=48),
                           "B=256,N=40,k_hi=200,j_cap=48"))
    device_us = device_us_per_launch(
        {"decide_packed_kernel": lambda: dk.batch_decide(**d, k_hi=K_HI, j_cap=K_HI),
         "decide_fused_kernel": lambda: dk.batch_decide(**d40, k_hi=200, j_cap=48)})
    check(device_us["decide_packed_kernel"] is not None,
          f"decide_fused at B={MAIN_B}, N={N_OPS} did not run decide_packed_kernel")
    emit({"phase": "decide_routes", "shape": f"B={MAIN_B},N={N_OPS},k_hi={K_HI}",
          "plan": dk.plan(N_OPS, K_HI, K_HI), "device_us": device_us})
    lanes = MAIN_B * N_OPS
    rows["decide_fused"] = dict(
        source="src/repro_torch/csrc/decide_fused.cu",
        replaces="src/repro/kernels/decide_fused/kernel.py:222",
        max_abs_err=err, ms=median_ms(lambda: dk.batch_decide(**d, k_hi=K_HI, j_cap=K_HI)),
        plain_ms=median_ms(lambda: dr.batch_decide(**d, k_hi=K_HI, j_cap=K_HI)),
        device_us=device_us["decide_packed_kernel"],
        # 6 lane inputs + k_max in, 4 lane outputs; ~25 float ops per table
        # cell and 33 window passes of ~4 ops per candidate.
        bound=bound(4 * (6 + 4) * lanes + 4 * MAIN_B,
                    25 * lanes * K_HI + 33 * 4 * lanes * K_HI),
    )
    emit({"phase": "loop_kernels", "rows": {
        k: {"ms": v["ms"], "device_us": v["device_us"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"][0], "bound_by": v["bound"][1]} for k, v in rows.items()}})
    rows.update(l2_rows(dev, compare))
    _build.LAUNCHES.clear()  # parity and timing launches are not the main path's
    return rows


def l2_inputs(gen, m, n, d, dev):
    """Unit-norm descriptors: a [m, d] frame side, b [n, d] library, with
    every fourth frame row a noisy copy of a library row (so the 0.8
    threshold fires), and a ~70 % valid mask."""
    import torch

    b = torch.randn(n, d, generator=gen)
    b = b / b.norm(dim=1, keepdim=True)
    a = torch.randn(m, d, generator=gen)
    near = torch.arange(0, m, 4)
    a[near] = b[torch.randint(0, n, (len(near),), generator=gen)] * 8.0
    a[near] += torch.randn(len(near), d, generator=gen) * 0.5
    a = a / a.norm(dim=1, keepdim=True)
    valid = torch.rand(m, generator=gen) < 0.7
    return a.contiguous().to(dev), b.contiguous().to(dev), valid.to(dev)


def device_us_per_launch(fns, calls=20):
    """Each kernel's own device time per launch (torch.profiler), over
    ``calls`` calls of every function in ``fns`` (kernel symbol -> call),
    all in one profiler session; None for a symbol the trace lacks."""
    import torch
    from torch.autograd import DeviceType

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()

    def run():
        for fn in fns.values():
            for _ in range(calls):
                fn()

    events = [e for e in profiled(run, expect=list(fns))[0] if e.device_type == DeviceType.CUDA]
    out = {}
    for symbol in fns:
        hits = [(e.self_device_time_total, e.count) for e in events if symbol in e.key]
        out[symbol] = sum(h[0] for h in hits) / sum(h[1] for h in hits) if hits else None
    return out


def l2_rows(dev, compare):
    """``pairwise_sq_l2`` and ``match_count`` against their plain versions
    at the VLD matcher's shape and at a ragged one; timed beside
    ``torch.cdist``."""
    import torch

    from repro_torch.kernels.l2_match import kernel as lk, ref as lr

    gen = torch.Generator().manual_seed(4321)
    thr = 0.8
    m = n = VLD_WIDTH["max_keypoints"]
    d = 64
    a, b, valid = l2_inputs(gen, m, n, d, dev)
    ar, br, validr = l2_inputs(gen, 1000, 777, 50, dev)
    err_d = max(compare("pairwise_sq_l2", [lk.pairwise_sq_l2(a, b)], [lr.pairwise_sq_l2(a, b)],
                        f"M={m},N={n},D={d}"),
                compare("pairwise_sq_l2", [lk.pairwise_sq_l2(ar, br)],
                        [lr.pairwise_sq_l2(ar, br)], "M=1000,N=777,D=50"))
    counts = lk.match_count(a, b, thr, valid)
    err_c = max(compare("match_count", [counts], [lr.match_count(a, b, thr, valid)],
                        f"M={m},N={n},D={d}"),
                compare("match_count", [lk.match_count(ar, br, thr, validr)],
                        [lr.match_count(ar, br, thr, validr)], "M=1000,N=777,D=50"))
    check(int(counts.sum()) > 0, "match_count: the threshold never fired on the parity inputs")
    cdist_ms = median_ms(lambda: torch.cdist(a, b))
    device_us = device_us_per_launch({
        "sq_l2_kernel": lambda: lk.pairwise_sq_l2(a, b),
        "match_count_kernel": lambda: lk.match_count(a, b, thr, valid),
    })
    # 2 M N D for the cross term, 2 (M + N) D for the norms, ~4 ops per
    # output (add, scale, subtract, clamp or compare-and-count).
    ops = 2 * m * n * d + 2 * (m + n) * d + 4 * m * n
    rows = {
        "pairwise_sq_l2": dict(
            source="src/repro_torch/csrc/l2_match.cu",
            replaces="src/repro/kernels/l2_match/kernel.py:61",
            max_abs_err=err_d, ms=median_ms(lambda: lk.pairwise_sq_l2(a, b)),
            plain_ms=median_ms(lambda: lr.pairwise_sq_l2(a, b)),
            library_ms=cdist_ms,
            device_us=device_us["sq_l2_kernel"],
            bound=bound(4 * (m * d + n * d + m * n), ops),
        ),
        "match_count": dict(
            source="src/repro_torch/csrc/l2_match.cu",
            replaces="src/repro/kernels/l2_match/kernel.py:114",
            max_abs_err=err_c, ms=median_ms(lambda: lk.match_count(a, b, thr, valid)),
            plain_ms=median_ms(lambda: lr.match_count(a, b, thr, valid)),
            library_ms=cdist_ms,
            device_us=device_us["match_count_kernel"],
            bound=bound(4 * (m * d + n * d) + m + 4 * n, ops),
        ),
    }
    emit({"phase": "l2_match", "shape": f"M={m},N={n},D={d}",
          "copy_bytes": 16 if lk.plan(d, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
          else 4,
          "hits": int(counts.sum()), **{k: {kk: v[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                                "device_us")}
                                        for k, v in rows.items()}})
    return rows


# --------------------------------------------------------------------------- #
# Phases 4-5: the main path
# --------------------------------------------------------------------------- #
def profile_phase(runner, dev):
    """One more run of the same fleet's loop under torch.profiler: the
    kernels' device time and launch count per tick, set against the
    unprofiled loop's wall time (the device's busy share)."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.core.controller import make_fused_loop
    from repro_torch.kernels.queue_step import kernel as qk

    loop, n_ticks = make_fused_loop(
        runner.arrays, runner.static, runner.params,
        steps_per_tick=runner._steps_per_tick,
        warmup_seconds=runner.scenarios[0].warmup, device=dev,
    )
    # One tick-0 state per profiler attempt, made outside the trace.
    states = [loop.init(runner.k0) for _ in range(PROFILE_ATTEMPTS)]
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        loop.run(states.pop())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    events, profiled_s = profiled(run)
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    kernels = sum(c for k, _t, c in rows if not k.startswith("Memcpy") and
                  not k.startswith("Memset"))
    loop_ms = runner.loop_seconds * 1e3
    ours = {}
    for name, symbols in LOOP_SYMBOLS.items():
        hits = [(k, t, c) for k, t, c in rows if any(s in k for s in symbols)]
        if hits:
            t, c = sum(h[1] for h in hits), sum(h[2] for h in hits)
            ours[name] = {"device_us_per_launch": t / c, "launches_per_tick": c / n_ticks,
                          "symbols": sorted({s for k, _t, _c in hits for s in symbols
                                             if s in k})}
    route = WINDOW_ROUTE_SYMBOLS[qk.plan(N_OPS)[0]]
    want_symbols = {"queue_window": [route]}
    if not runner.fused_decide:
        want_symbols["gain_topr"] = ["gain_topr_warp_kernel"]
    got_symbols = {k: ours.get(k, {}).get("symbols") for k in want_symbols}
    per_tick = ours.get("queue_window", {}).get("launches_per_tick")
    emit({"phase": "profile", "fused_decide": runner.fused_decide, "ticks": n_ticks,
          "device_ms_per_tick": device_ms / n_ticks,
          "launches_per_tick": kernels / n_ticks,
          "unprofiled_loop_ms_per_tick": loop_ms / n_ticks,
          "profiled_loop_ms_per_tick": profiled_s * 1e3 / n_ticks,
          "device_busy_share": device_ms / loop_ms, "port_kernels": ours,
          "top": [{"kernel": k[:90], "device_ms_per_tick": t / 1e3 / n_ticks,
                   "launches_per_tick": c / n_ticks} for k, t, c in rows[:8]]})
    check(got_symbols == want_symbols,
          f"profile: the fleet ran {got_symbols}, expected {want_symbols}")
    check(per_tick == 1.0 and "queue_step" not in ours,
          f"profile: {per_tick} queue_window launches per tick, queue_step "
          f"{ours.get('queue_step')}; expected one window kernel per tick and no step kernel")
    erlang = ours.get("erlang_c", {}).get("launches_per_tick")
    most = 400 if runner.fused_decide else 500
    check(erlang == (1.0 if runner.fused_decide else 2.0) and kernels / n_ticks <= most,
          f"profile: {erlang} erlang_c launches and {kernels / n_ticks} launches per tick; "
          f"expected {1 if runner.fused_decide else 2} and at most {most} (no 512-step "
          f"Erlang-B loop)")


def main_path_phase(dev):
    import numpy as np

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.core.controller import ACTIONS
    from repro_torch.kernels import KERNELS, LAUNCHES

    t0 = time.perf_counter()
    distinct, fleet = fleet_scenarios()
    emit({"phase": "fleet", "scenarios": len(fleet), "distinct": len(distinct),
          "seconds": time.perf_counter() - t0})

    # Warm-up on a small fleet: CUDA library handles (batched solve,
    # batched product) are created outside the timed runs.
    for fd in (False, True):
        ScenarioRunner(distinct[:16], tick_interval=5.0, fused_decide=fd, device=dev).run()

    # Both dispatches in turns (off, on, on, off) so neither gains from
    # running second; counters are zeroed just before each run.
    runs = {False: [], True: []}
    launches = {}
    for fd in (False, True, True, False):
        runner = ScenarioRunner(fleet, tick_interval=5.0, fused_decide=fd, device=dev)
        LAUNCHES.clear()
        runner.run()
        counts = {k: LAUNCHES[k] for k in KERNELS}
        n_ticks = runner.outputs["codes"].shape[0]
        steps = runner._steps_per_tick
        # erlang_c: stationary_wait's table every tick, the two-pass
        # decide's too.
        want = {"queue_step": 0, "queue_window": n_ticks,
                "erlang_c": n_ticks if fd else 2 * n_ticks, "gain_topr": 0 if fd else n_ticks,
                "decide_fused": n_ticks if fd else 0}
        emit({"phase": "main_path", "fused_decide": fd, "B": len(fleet), "ticks": n_ticks,
              "steps_per_tick": steps, "launches": counts, "loop_seconds": runner.loop_seconds,
              "scenario_ticks_per_s": len(fleet) * n_ticks / runner.loop_seconds,
              "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
        check(counts == want, f"fused_decide={fd}: launches {counts}, expected {want}")
        out = runner.outputs
        check(np.isfinite(out["q_final"]).all() and (out["q_final"] >= 0).all(),
              "main path: non-finite or negative backlog")
        check(out["k"].shape == (n_ticks, len(fleet), N_OPS), "main path: k shape")
        runs[fd].append(runner)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for key in ("codes", "k", "applied"):
        outs = [r.outputs[key] for r in runs[False] + runs[True]]
        same = all(np.array_equal(outs[0], o) for o in outs[1:])
        check(same, f"fused decide on/off runs disagree on {key}")
    emit({"phase": "dispatch_parity", "equal": True, "runs": 4})
    for fd in (False, True):
        profile_phase(runs[fd][0], dev)

    # Phase 5: card against CPU on the first DISTINCT lanes.
    cpu = ScenarioRunner(fleet[:DISTINCT], tick_interval=5.0, device="cpu")
    cpu.run()
    card = runs[False][0].outputs
    n_cells = card["codes"].shape[0] * DISTINCT
    codes_diff = int((cpu.outputs["codes"] != card["codes"][:, :DISTINCT]).sum())
    k_diff = int((cpu.outputs["k"] != card["k"][:, :DISTINCT]).any(axis=-1).sum())
    emit({"phase": "card_vs_cpu", "lanes": DISTINCT, "tick_lane_cells": n_cells,
          "codes_differ": codes_diff, "allocations_differ": k_diff,
          "card_actions": dict(zip(ACTIONS, np.bincount(
              card["codes"].ravel(), minlength=len(ACTIONS)).tolist()))})
    check(codes_diff == 0 and k_diff == 0,
          f"card and CPU runs differ in {codes_diff} codes / {k_diff} allocations "
          f"of {n_cells} (tick, lane) cells")
    return launches


# --------------------------------------------------------------------------- #
# Phases 6-7: the VLD application
# --------------------------------------------------------------------------- #
def vld_card_vs_cpu_phase(dev):
    """VLD_FRAMES_CHECKED seeded frames through the whole pipeline on the
    card and on the CPU (plain versions): equal counts and detections."""
    import numpy as np
    import torch

    from repro_torch.streaming.apps.vld import (
        VLDConfig, aggregate_matches, extract_features, logo_library, make_frame,
        match_features,
    )

    cfg = VLDConfig(**VLD_WIDTH)
    lib = logo_library(cfg)
    rng = np.random.default_rng(11)
    frames = [make_frame(cfg, rng, lib, rng.random() < 0.4) for _ in range(VLD_FRAMES_CHECKED)]
    out, seconds = {}, {}
    for where in (dev, torch.device("cpu")):
        libt = torch.from_numpy(lib).to(where)
        counts, dets, kps, descs = [], [], [], []
        t0 = time.perf_counter()
        for fr in frames:
            desc, valid = extract_features(torch.from_numpy(fr).to(where), cfg)
            c = match_features(desc, valid, libt, cfg.match_threshold)
            det = aggregate_matches(c, cfg.n_logos, cfg.descriptors_per_logo,
                                    cfg.detect_threshold)
            counts.append(c.cpu().numpy())
            dets.append(det.cpu().numpy())
            kps.append(int(valid.sum()))
            descs.append(desc.cpu().numpy())
        seconds[where.type] = time.perf_counter() - t0
        out[where.type] = (counts, dets, kps, descs)
    card, cpu = out["cuda"], out["cpu"]
    counts_differ = sum(not np.array_equal(x, y) for x, y in zip(card[0], cpu[0]))
    dets_differ = sum(not np.array_equal(x, y) for x, y in zip(card[1], cpu[1]))
    desc_err = max(float(np.abs(x - y).max()) for x, y in zip(card[3], cpu[3]))
    emit({"phase": "vld_card_vs_cpu", "frames": len(frames), "config": VLD_WIDTH,
          "counts_differ": counts_differ, "detections_differ": dets_differ,
          "keypoints_differ": sum(x != y for x, y in zip(card[2], cpu[2])),
          "max_descriptor_abs_err": desc_err,
          "valid_keypoints_mean": float(np.mean(card[2])),
          "frames_with_detection": int(sum(d.any() for d in card[1])),
          "card_ms_per_frame": seconds["cuda"] * 1e3 / len(frames),
          "cpu_ms_per_frame": seconds["cpu"] * 1e3 / len(frames)})
    check(counts_differ == 0 and dets_differ == 0,
          f"VLD card vs CPU: {counts_differ} count rows and {dets_differ} detection rows "
          f"differ of {len(frames)} frames")
    check(sum(d.any() for d in card[1]) > 0, "VLD: no frame had a detection")
    vld_profile(cfg, lib, frames[:16], dev)


def vld_profile(cfg, lib, frames, dev):
    """The pipeline's device time and launches per frame (torch.profiler),
    by stage, against its wall time per frame: the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from repro_torch.streaming.apps.vld import aggregate_matches, extract_features, match_features

    libt = torch.from_numpy(lib).to(dev)

    def run():
        for fr in frames:
            with record_function("vld_extract"):
                desc, valid = extract_features(torch.from_numpy(fr).to(dev), cfg)
            with record_function("vld_match"):
                c = match_features(desc, valid, libt, cfg.match_threshold)
            with record_function("vld_aggregate"):
                aggregate_matches(c, cfg.n_logos, cfg.descriptors_per_logo,
                                  cfg.detect_threshold).cpu()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    events = profiled(run)[0]
    stage_names = ("vld_extract", "vld_match", "vld_aggregate")
    # Kernels only: the stage annotations also show up as device ranges.
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in stage_names]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3 / len(frames)
    kernels = sum(c for k, _t, c in rows if not k.startswith(("Memcpy", "Memset")))
    stages = {name: {} for name in stage_names}
    for e in events:
        if e.key in stages:
            if e.device_type == DeviceType.CUDA:
                stages[e.key]["device_span_ms_per_frame"] = (
                    e.self_device_time_total / 1e3 / len(frames))
            else:
                stages[e.key]["host_ms_per_frame_profiled"] = e.cpu_time_total / 1e3 / len(frames)
    emit({"phase": "vld_profile", "frames": len(frames), "unprofiled_ms_per_frame": wall_ms,
          "device_ms_per_frame": device_ms, "launches_per_frame": kernels / len(frames),
          "device_busy_share": device_ms / wall_ms, "stages": stages,
          "top": [{"kernel": k[:90], "device_us_per_frame": t / len(frames),
                   "launches_per_frame": c / len(frames)} for k, t, c in rows[:8]]})


def vld_live_phase(dev):
    """The live DRS session on the card; returns the l2_match launches."""
    import numpy as np
    import torch

    from repro_torch.api.session import DRSSession, SchedulerConfig
    from repro_torch.kernels import LAUNCHES, VLD_KERNELS
    from repro_torch.streaming.apps.vld import (
        VLDConfig, aggregate_matches, build_vld_graph, extract_features, logo_library,
        make_frame, match_features,
    )

    cfg = VLDConfig(**VLD_WIDTH)
    lib = logo_library(cfg)
    rng = np.random.default_rng(0)
    # Warm-up outside the counted run (lazy CUDA initialisation of the
    # extractor's sort and gathers).
    libt = torch.from_numpy(lib).to(dev)
    desc, valid = extract_features(torch.from_numpy(make_frame(cfg, rng, lib, True)).to(dev), cfg)
    aggregate_matches(match_features(desc, valid, libt, cfg.match_threshold), cfg.n_logos,
                      cfg.descriptors_per_logo, cfg.detect_threshold).cpu()

    graph, detections = build_vld_graph(cfg, lib, device=dev)
    session = DRSSession.bind(
        graph, "engine",
        config=SchedulerConfig(k_max=6, min_improvement=0.01, horizon_seconds=600.0),
    )
    bad = {"extract": 1, "match": 2, "aggregate": 1}
    LAUNCHES.clear()
    session.start(bad)
    injected = 0
    t_start = time.perf_counter()
    t_end = time.time() + 5.0
    while time.time() < t_end:
        if session.inject(make_frame(cfg, rng, lib, rng.random() < 0.4)) is not None:
            injected += 1
        time.sleep(0.004)
    decision = session.tick()
    snap = session.backend.measurer.last_snapshot
    applied = session.allocation
    t_end = time.time() + 3.0
    while time.time() < t_end:
        if session.inject(make_frame(cfg, rng, lib, rng.random() < 0.4)) is not None:
            injected += 1
        time.sleep(0.02)
    drained = session.drain(timeout=60.0)
    elapsed = time.perf_counter() - t_start
    session.stop()
    launches = {k: LAUNCHES[k] for k in VLD_KERNELS}
    engine = session.backend.engine
    soj = np.asarray(session.completed_sojourns)
    completed = len(soj)
    emit({"phase": "vld_live", "config": VLD_WIDTH, "start": bad,
          "frames_injected": injected, "frames_completed": completed,
          "shed_roots": engine.shed_roots, "drops": session.drop_counts(),
          "failures": engine.failures,
          "last_failure": None if engine.last_failure is None else repr(engine.last_failure),
          "detection_rows": len(detections),
          "frames_with_detection": int(sum(d.any() for d in detections)),
          "decision": {"action": decision.action, "reason": decision.reason,
                       "k_target": None if decision.k_target is None
                       else decision.k_target.tolist(),
                       "model_sojourn_current": decision.model_sojourn_current,
                       "model_sojourn_target": decision.model_sojourn_target,
                       "measured_sojourn": decision.measured_sojourn},
          "allocation_applied": applied, "allocation_final": engine.k(),
          "mu_hat": dict(zip(graph.names, snap.mu_hat.tolist())),
          "lam_hat": dict(zip(graph.names, snap.lam_hat.tolist())),
          "sojourn_p50_ms": float(np.percentile(soj, 50) * 1e3) if completed else None,
          "sojourn_p95_ms": float(np.percentile(soj, 95) * 1e3) if completed else None,
          "frames_per_s": completed / elapsed, "seconds": elapsed, "drained": drained,
          "launches": launches})
    check(drained and completed == injected,
          f"vld_live: {completed} of {injected} injected frames completed (drained={drained})")
    check(len(detections) == completed,
          f"vld_live: {len(detections)} detection rows for {completed} completed frames")
    check(launches["match_count"] == injected,
          f"vld_live: match_count launched {launches['match_count']} times for "
          f"{injected} frames")
    return launches


# --------------------------------------------------------------------------- #
# Phase 8a: the window-at-a-time control loop (negotiated scenarios)
# --------------------------------------------------------------------------- #
def twin_loop_phase(dev):
    """The window-at-a-time loop on the card: the 256 ``scenario_matrix``
    scenarios as generated (72 negotiated) tiled to TWIN_B lanes through
    ``ScenarioRunner(backend="torch")``; ``expected_sojourn_batch`` on the
    card at the final allocations; the first 256 lanes on the CPU and
    through the float64 twin.  Returns the path's launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.core.batched import expected_sojourn_batch
    from repro_torch.core.controller import ACTIONS
    from repro_torch.kernels import KERNELS, LAUNCHES
    from repro_torch.streaming.scenarios import scenario_matrix

    distinct = scenario_matrix(DISTINCT, seed=5, horizon=30.0, warmup=5.0, dt=0.05, k_max=48)
    negotiated = sum(s.negotiated for s in distinct)
    check(negotiated == 72, f"twin_loop: {negotiated} negotiated scenarios of 256, expected 72")
    fleet = distinct * (TWIN_B // DISTINCT)

    def runner(scens, **kw):
        r = ScenarioRunner(scens, tick_interval=5.0, **kw)
        check(not r.fused, "twin_loop: the negotiated fleet must take the window-at-a-time loop")
        return r

    runner(distinct[:16], device=dev).run()  # CUDA handles outside the timed run
    card = runner(fleet, device=dev)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    reports = card.run()
    counts = {k: LAUNCHES[k] for k in KERNELS}
    n_ticks = len(card.decisions[0])
    want = {"queue_step": 0, "queue_window": n_ticks, "erlang_c": 0, "gain_topr": 0,
            "decide_fused": 0}
    check(counts == want, f"twin_loop: launches {counts}, expected {want}")
    codes = np.array([[ACTIONS.index(d.action) for d in decs] for decs in card.decisions]).T
    k_ticks = [np.stack([d.k_current for d in decs]) for decs in card.decisions]
    check(np.isfinite(card.sim.q).all() and (card.sim.q >= 0).all(),
          "twin_loop: non-finite or negative backlog")
    check(all(r.provisioned_total <= s.k_max for r, s in zip(reports, fleet)),
          "twin_loop: an allocation past its scenario's k_max")
    actions = dict(zip(ACTIONS, np.bincount(codes.ravel(), minlength=len(ACTIONS)).tolist()))
    check(actions["scale_out"] + actions["scale_in"] > 0,
          f"twin_loop: no lease moved on the negotiated lanes ({actions})")

    # One more run under torch.profiler: device time and launches per tick.
    spares = [runner(fleet, device=dev) for _ in range(PROFILE_ATTEMPTS)]
    torch.cuda.synchronize()

    def run():
        r = spares.pop()
        r.run()
        return r.loop_seconds

    events, profiled_s = profiled(run)
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(r[1] for r in rows) / 1e3
    kernels = sum(c for k, _t, c in rows if not k.startswith(("Memcpy", "Memset")))
    window = [(t, c) for k, t, c in rows if any(sym in k for sym in LOOP_SYMBOLS["queue_window"])]
    loop_ms = card.loop_seconds * 1e3

    # expected_sojourn_batch on the card at the final allocations.
    LAUNCHES.clear()
    rel = 0.0
    for bi, s in enumerate(distinct):
        top, k = s.mean_topology(), card.k[bi:bi + 1, : s.graph.n]
        got = expected_sojourn_batch(top, k, device=dev)
        ref = expected_sojourn_batch(top, k, backend="numpy")
        check(np.array_equal(np.isfinite(got), np.isfinite(ref)),
              f"twin_loop: E[T] finite pattern differs on {s.name}")
        fin = np.isfinite(ref)
        if fin.any():
            rel = max(rel, float(np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin]))))
    sojourn_launches = LAUNCHES["erlang_c"]
    check(sojourn_launches == DISTINCT,
          f"twin_loop: {sojourn_launches} erlang_c launches for {DISTINCT} E[T] calls")
    check(rel <= TWIN_SOJOURN_RTOL,
          f"twin_loop: card E[T] off numpy by {rel} (rtol {TWIN_SOJOURN_RTOL})")

    # The first 256 lanes on the CPU (the plain window) and the float64 twin.
    cpu = runner(fleet[:DISTINCT], device="cpu")
    cpu.run()
    twin = runner(fleet[:DISTINCT], backend="numpy")
    twin.run()

    def cells(r):
        return (np.array([[ACTIONS.index(d.action) for d in decs] for decs in r.decisions]).T,
                [np.stack([d.k_current for d in decs]) for decs in r.decisions])

    def differ(r):
        c, k = cells(r)
        codes_diff = int((c != codes[:, :DISTINCT]).sum())
        k_diff = int(sum((a != b).any(axis=-1).sum() for a, b in zip(k, k_ticks)))
        return codes_diff, k_diff

    cpu_codes, cpu_k = differ(cpu)
    twin_codes, twin_k = differ(twin)
    emit({"phase": "twin_loop", "B": len(fleet), "distinct": DISTINCT,
          "negotiated_distinct": negotiated, "ticks": n_ticks,
          "steps_per_tick": card._steps_per_tick, "launches": counts,
          "wall_ms_per_tick": loop_ms / n_ticks,
          "scenario_ticks_per_s": len(fleet) * n_ticks / card.loop_seconds,
          "profile": {"device_ms_per_tick": device_ms / n_ticks,
                      "launches_per_tick": kernels / n_ticks,
                      "queue_window_us_per_launch": (sum(t for t, _c in window)
                                                     / max(sum(c for _t, c in window), 1)),
                      "profiled_wall_ms_per_tick": profiled_s * 1e3 / n_ticks,
                      "device_busy_share": device_ms / loop_ms,
                      "top": [{"kernel": k[:90], "device_ms_per_tick": t / 1e3 / n_ticks,
                               "launches_per_tick": c / n_ticks} for k, t, c in
                              sorted(rows, key=lambda r: -r[1])[:6]]},
          "actions": actions,
          "expected_sojourn_batch": {"calls": DISTINCT, "erlang_c_launches": sojourn_launches,
                                     "max_rel_err_vs_numpy": rel, "rtol": TWIN_SOJOURN_RTOL},
          "card_vs_cpu": {"tick_lane_cells": n_ticks * DISTINCT, "codes_differ": cpu_codes,
                          "allocations_differ": cpu_k},
          "float32_vs_float64_twin_info": {"codes_differ": twin_codes,
                                           "allocations_differ": twin_k},
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
    check(cpu_codes == 0 and cpu_k == 0,
          f"twin_loop: card and CPU differ in {cpu_codes} codes / {cpu_k} allocations of "
          f"{n_ticks * DISTINCT} (tick, lane) cells")
    return {"queue_window": counts["queue_window"], "erlang_c": sojourn_launches}


# --------------------------------------------------------------------------- #
# Phase 7b: the proactive (forecast/MPC) and compacted loop
# --------------------------------------------------------------------------- #
# The float outputs compaction must leave bitwise unchanged, beside the
# decisions.
PROACTIVE_EXACT = ("codes", "k", "applied", "mpc_used", "confident", "sojourn", "et_cur",
                   "et_target", "miss", "k_final", "q_final", "offered", "served", "dropped",
                   "ext_admitted", "ext_offered", "q_int", "q_max")
PROACTIVE_CPU_LANES = 256  # card vs CPU: half from the first tile, half from the last


def proactive_fleet():
    """fleet-4096 with its last tile on deterministic arrivals: a
    Poisson-sampled lane measures a new window every tick, so it reprices
    every tick by design; a deterministic constant lane measures the same
    window once its transient drains, and the sparse decide skips it."""
    import dataclasses

    distinct, fleet = fleet_scenarios()
    quiet = [dataclasses.replace(s, arrival_kind="deterministic") for s in distinct]
    return fleet[:-DISTINCT] + quiet


def loop_launch_rule(out, n_ticks, *, fused_decide, compact):
    """The loop kernels' launches per proactive run: per tick one
    ``queue_window`` and one ``erlang_c`` (``stationary_wait``'s table);
    the decide one ``decide_fused`` (fused) or one ``erlang_c`` and one
    ``gain_topr`` (two-pass); the planner one ``erlang_c`` (its table over
    the B (H+1) N peak and horizon loads) and one ``decide_fused`` (its
    allocator over the 3B candidate rows, fused) or ``gain_topr`` (two-pass).
    Under compaction the decide runs on a tick only if it reprices a lane,
    the planner only if a lane is eligible (the run's own ``repriced`` /
    ``eligible``)."""
    import numpy as np

    ones = np.ones(n_ticks, dtype=bool)
    dec = int((out["repriced"].any(axis=1) if compact else ones).sum())
    mpc = int((out["eligible"].any(axis=1) if compact else ones).sum())
    return {"queue_step": 0, "queue_window": n_ticks,
            "erlang_c": n_ticks + (0 if fused_decide else dec) + mpc,
            "gain_topr": 0 if fused_decide else dec + mpc,
            "decide_fused": dec + mpc if fused_decide else 0}


def planner_kernel_rows(fleet, dev):
    """``decide_fused`` and ``gain_topr`` on the planner's own inputs at 3B
    rows (captured from one dense run of each dispatch, its launches not
    counted) and the planner's Erlang-B table over B (H+1) N loads: each
    against its plain version (bitwise), timed beside its bound."""
    import torch

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decide_fused import kernel as dk, ops as do, ref as dr
    from repro_torch.kernels.erlang_c import kernel as ek, ops as eo, ref as er
    from repro_torch.kernels.gain_topr import kernel as gk, ops as go, ref as gr

    m = 3 * len(fleet)
    seen = {}

    def capture(mod, attr, key, rows):
        real = getattr(mod, attr)

        def wrapped(*args, **kw):
            if rows(args):
                seen[key] = ([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                             {k: v.clone() if isinstance(v, torch.Tensor) else v
                              for k, v in kw.items()})
            return real(*args, **kw)

        setattr(mod, attr, wrapped)
        return real

    reals = [(do, "batch_decide", capture(do, "batch_decide", "decide_fused",
                                          lambda a: a[0].shape[0] == m)),
             (go, "gain_topr", capture(go, "gain_topr", "gain_topr",
                                       lambda a: a[0].shape[0] == m)),
             (eo, "erlang_b_table", capture(eo, "erlang_b_table", "erlang_c",
                                            lambda a: a[0].shape[0] == len(fleet) * 4 * N_OPS))]
    try:
        for fd in (False, True):
            ScenarioRunner(fleet, tick_interval=5.0, proactive=True, fused_decide=fd,
                           device=dev).run()
    finally:
        for mod, attr, real in reals:
            setattr(mod, attr, real)
        LAUNCHES.clear()
    check(set(seen) == {"decide_fused", "gain_topr", "erlang_c"},
          f"proactive_loop: the planner's kernel calls at 3B rows were not seen ({sorted(seen)})")
    rows = {}
    args, kw = seen["decide_fused"]
    got, want = dk.batch_decide(*args, **kw), dr.batch_decide(*args, **kw)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(err == 0.0 and bool((kw["k_cur"] == 0).all()),
          f"proactive_loop: decide_fused at {m} planner rows differs from plain ({err})")
    lanes = m * N_OPS
    rows["decide_fused"] = dict(
        M=m, k_hi=kw["k_hi"], j_cap=kw["j_cap"], max_abs_err=err,
        ms=median_ms(lambda: dk.batch_decide(*args, **kw)),
        plain_ms=median_ms(lambda: dr.batch_decide(*args, **kw), runs=5, inner=2),
        device_us=device_us_per_call(lambda: dk.batch_decide(*args, **kw),
                                     LOOP_SYMBOLS["decide_fused"], calls=20),
        bound=bound(4 * (6 + 4) * lanes + 4 * m,
                    25 * lanes * K_HI + 33 * 4 * lanes * K_HI))
    (cand, budget), _kw = seen["gain_topr"]
    err = max_abs_err(gk.gain_topr(cand, budget), gr.gain_topr(cand, budget))
    check(err == 0.0, f"proactive_loop: gain_topr at {m} planner rows differs from plain ({err})")
    rows["gain_topr"] = dict(
        M=m, J=cand.shape[-1], max_abs_err=err, ms=median_ms(lambda: gk.gain_topr(cand, budget)),
        plain_ms=median_ms(lambda: gr.gain_topr(cand, budget), runs=5, inner=2),
        device_us=device_us_per_call(lambda: gk.gain_topr(cand, budget),
                                     LOOP_SYMBOLS["gain_topr"], calls=20),
        bound=topr_bound(cand))
    (a,), kw = seen["erlang_c"]
    err = max_abs_err(ek.erlang_b_table(a, **kw), er.erlang_b_table(a, **kw))
    check(err == 0.0, f"proactive_loop: the planner's erlang_c table differs from plain ({err})")
    s = a.shape[0]
    rows["erlang_c"] = dict(
        S=s, k_hi=kw["k_hi"], max_abs_err=err, ms=median_ms(lambda: ek.erlang_b_table(a, **kw)),
        plain_ms=median_ms(lambda: er.erlang_b_table(a, **kw), runs=5, inner=2),
        device_us=device_us_per_call(lambda: ek.erlang_b_table(a, **kw),
                                     LOOP_SYMBOLS["erlang_c"], calls=20),
        bound=bound(4 * s + 4 * s * (kw["k_hi"] + 1), 4 * s * kw["k_hi"]))
    return rows


def proactive_loop_phase(dev):
    """fleet-4096 (its last tile on deterministic arrivals) through
    ``ScenarioRunner(proactive=True)`` with the fused decide off / on and the
    sparse decide off / on, in turns.  Checks: (a) compact and dense runs
    bitwise equal on every output; (b) the two dispatches on codes, k and
    ``mpc_used``; (c) card and CPU on 256 lanes, no (tick, lane) cell of
    codes, k or ``mpc_used`` differs; (d) each run's launches equal
    :func:`loop_launch_rule`; (e) some lane commits ``"proactive"`` and some
    tick reprices fewer than all lanes.  Returns the path's launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.core.controller import ACTIONS, make_fused_loop
    from repro_torch.kernels import KERNELS, LAUNCHES

    fleet = proactive_fleet()
    b = len(fleet)
    configs = [(False, None), (True, None), (False, True), (True, True)]

    def runner(scens, fd, compact, device=dev):
        return ScenarioRunner(scens, tick_interval=5.0, proactive=True, compact=compact,
                              fused_decide=fd, device=device)

    for fd, compact in configs:  # CUDA handles outside the counted runs
        runner(fleet[:16], fd, compact).run()
    outs, launches, rows = {}, {}, []
    for fd, compact in configs + configs[::-1]:
        r = runner(fleet, fd, compact)
        check(r.fused, "proactive_loop: the static-budget fleet must take the fused loop")
        torch.cuda.synchronize()
        LAUNCHES.clear()
        r.run()
        counts = {k: LAUNCHES[k] for k in KERNELS}
        out = r.outputs
        n_ticks = out["codes"].shape[0]
        want = loop_launch_rule(out, n_ticks, fused_decide=fd, compact=compact)
        check(counts == want,
              f"proactive_loop fused_decide={fd} compact={compact}: launches {counts}, "
              f"expected {want}")
        check(np.isfinite(out["q_final"]).all() and (out["q_final"] >= 0).all(),
              "proactive_loop: non-finite or negative backlog")
        prev = outs.setdefault((fd, compact), out)
        for key in PROACTIVE_EXACT:
            check(np.array_equal(prev[key], out[key], equal_nan=out[key].dtype.kind == "f"),
                  f"proactive_loop: two runs of fused_decide={fd} compact={compact} differ "
                  f"on {key}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        rows.append({"fused_decide": fd, "compact": bool(compact), "launches": counts,
                     "wall_ms_per_tick": r.loop_seconds * 1e3 / n_ticks,
                     "scenario_ticks_per_s": b * n_ticks / r.loop_seconds})
    for fd in (False, True):  # (a) compaction changes no output
        dense, comp = outs[(fd, None)], outs[(fd, True)]
        for key in PROACTIVE_EXACT:
            check(np.array_equal(dense[key], comp[key], equal_nan=dense[key].dtype.kind == "f"),
                  f"proactive_loop: compact and dense differ on {key} (fused_decide={fd})")
    for key in ("codes", "k", "mpc_used"):  # (b) the two dispatches
        check(np.array_equal(outs[(False, None)][key], outs[(True, None)][key]),
              f"proactive_loop: fused decide on/off disagree on {key}")
    card = outs[(False, True)]
    repriced, eligible = card["repriced"], card["eligible"]
    n_ticks = card["codes"].shape[0]
    proactive_cells = int((card["codes"] == ACTIONS.index("proactive")).sum())
    check(proactive_cells > 0 and int(repriced.sum(axis=1).min()) < b,
          f"proactive_loop: {proactive_cells} proactive commits, repriced per tick "
          f"{repriced.sum(axis=1).tolist()} of {b}")

    # (c) the card against the CPU's plain versions on 256 lanes.
    half = PROACTIVE_CPU_LANES // 2
    lanes = np.r_[0:half, b - half:b]
    cpu = runner([fleet[i] for i in lanes], False, True, device="cpu")
    cpu.run()
    differ = {key: int((cpu.outputs[key] != card[key][:, lanes]).reshape(n_ticks, len(lanes), -1)
                       .any(axis=-1).sum()) for key in ("codes", "k", "mpc_used")}

    # Device time and launches per tick: one more run of each config's
    # loop, built (and its inputs staged on the card) outside the trace.
    profiles = []
    for fd, compact in configs:
        r = runner(fleet, fd, compact)
        loop, _ = make_fused_loop(r.arrays, r.static, r.params,
                                  steps_per_tick=r._steps_per_tick,
                                  warmup_seconds=fleet[0].warmup, proactive=r.proactive_cfg,
                                  compact=r.compact, device=dev)
        states = [loop.init(r.k0) for _ in range(PROFILE_ATTEMPTS)]
        torch.cuda.synchronize()

        def run():
            t0 = time.perf_counter()
            loop.run(states.pop())
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        events, profiled_s = profiled(run)
        ev = [(e.key, e.self_device_time_total, e.count) for e in events
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(t for _k, t, _c in ev) / 1e3
        copies_ms = sum(t for k, t, _c in ev if k.startswith(("Memcpy", "Memset"))) / 1e3
        kernels = sum(c for k, _t, c in ev if not k.startswith(("Memcpy", "Memset")))
        ours = {}
        for name, symbols in LOOP_SYMBOLS.items():
            hits = [(t, c) for k, t, c in ev if any(s in k for s in symbols)]
            if hits:
                ours[name] = {"launches_per_tick": sum(c for _t, c in hits) / n_ticks,
                              "device_us_per_launch": sum(t for t, _c in hits)
                              / sum(c for _t, c in hits)}
        wall = [x["wall_ms_per_tick"] for x in rows
                if (x["fused_decide"], x["compact"]) == (fd, bool(compact))]
        profiles.append({"fused_decide": fd, "compact": bool(compact),
                         "device_ms_per_tick": device_ms / n_ticks,
                         "copies_ms_per_tick": copies_ms / n_ticks,
                         "launches_per_tick": kernels / n_ticks,
                         "unprofiled_wall_ms_per_tick": wall,
                         "profiled_wall_ms_per_tick": profiled_s * 1e3 / n_ticks,
                         "device_busy_share": device_ms / n_ticks / min(wall),
                         "port_kernels": ours,
                         "top": [{"kernel": k[:90], "device_ms_per_tick": t / 1e3 / n_ticks,
                                  "launches_per_tick": c / n_ticks}
                                 for k, t, c in sorted(ev, key=lambda r: -r[1])[:6]]})
    planner = planner_kernel_rows(fleet, dev)
    emit({"phase": "proactive_loop", "B": b, "ticks": n_ticks, "runs": rows,
          "repriced_share_per_tick": (repriced.sum(axis=1) / b).tolist(),
          "eligible_per_tick": eligible.sum(axis=1).tolist(),
          "mpc_used_per_tick": card["mpc_used"].sum(axis=1).tolist(),
          "proactive_commits": proactive_cells,
          "actions": dict(zip(ACTIONS, np.bincount(card["codes"].ravel(),
                                                   minlength=len(ACTIONS)).tolist())),
          "card_vs_cpu": {"lanes": len(lanes), "tick_lane_cells": n_ticks * len(lanes),
                          "differ": differ},
          "profile": profiles,
          "planner_kernels": {k: {kk: (vv if kk != "bound" else
                                       {"ms": vv[0], "by": vv[1]})
                                  for kk, vv in v.items()} for k, v in planner.items()},
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
    check(not any(differ.values()),
          f"proactive_loop: card and CPU differ in {differ} of {n_ticks * len(lanes)} "
          f"(tick, lane) cells")
    return launches


# --------------------------------------------------------------------------- #
# Phases 7c-7e: the checkpointed soak, the fleet planner, the live fleet
# --------------------------------------------------------------------------- #
SOAK_EXACT_CPU = ("codes", "k")  # card vs CPU cells of the 2 h day
FLEET_POOL_EXTRA = 2048  # fleet_plan: the pool is the floors + this
FLEET_LOW_POOL = 3000  # fleet_plan: a pool below the floors (3,011)
FPD_LIVE = dict(n_items=32, max_pattern_size=3, window=50_000, support_threshold=3_125)
FLEET_LIVE_K_MAX = 16
FLEET_LIVE_TICKS = 3
FLEET_LIVE_INJECT_S = 1.5  # injection between two fleet ticks


def soak_launch_rule(out, n_ticks, *, proactive, fused_decide, compact):
    """:func:`loop_launch_rule` for a reactive or proactive run: a reactive
    run has no planner launches."""
    import numpy as np

    if proactive:
        return loop_launch_rule(out, n_ticks, fused_decide=fused_decide, compact=compact)
    dec = int((out["repriced"].any(axis=1) if compact else np.ones(n_ticks, bool)).sum())
    return {"queue_step": 0, "queue_window": n_ticks,
            "erlang_c": n_ticks + (0 if fused_decide else dec),
            "gain_topr": 0 if fused_decide else dec,
            "decide_fused": dec if fused_decide else 0}


def loop_profile(make_loop, n_ticks):
    """Device ms, device launches (copies left out) and our kernels'
    launches per tick of one more run of a loop under torch.profiler; the
    loop and its tick-0 states are built outside the trace."""
    import torch
    from torch.autograd import DeviceType

    loop, k0 = make_loop()
    states = [loop.init(k0) for _ in range(PROFILE_ATTEMPTS)]
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        loop.run(states.pop())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    events, profiled_s = profiled(run)
    ev = [(e.key, e.self_device_time_total, e.count) for e in events
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    ours = {name: sum(c for k, _t, c in ev if any(s in k for s in symbols)) / n_ticks
            for name, symbols in LOOP_SYMBOLS.items()}
    return {"device_ms_per_tick": sum(t for _k, t, _c in ev) / 1e3 / n_ticks,
            "launches_per_tick": sum(c for k, _t, c in ev
                                     if not k.startswith(("Memcpy", "Memset"))) / n_ticks,
            "port_kernels_per_tick": {k: v for k, v in ours.items() if v},
            "profiled_wall_ms_per_tick": profiled_s * 1e3 / n_ticks}


def soak_phase(dev):
    """The checkpointed soak on the card (float32): the full day (720
    ticks of 240 steps, a crash and restore every 96 ticks) reactive
    (two-pass decide) and proactive (fused decide), the 2 h day with
    ``compact`` off and on (bitwise, and card vs CPU 0 cells of codes / k),
    and fleet-4096 saved and restored every 2 ticks with ``compact`` on.
    Every stitched run must equal its straight run bitwise outside
    ``DIAGNOSTIC_KEYS``; every straight run's launches must equal
    :func:`soak_launch_rule`.  Returns the phase's launches."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.kernels import KERNELS, LAUNCHES
    from repro_torch.streaming import soak

    launches = {}
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="soak_", dir=ROOT / "build"))

    def counted(fn, *args, **kw):
        LAUNCHES.clear()
        out = fn(*args, **kw)
        counts = {k: LAUNCHES[k] for k in KERNELS}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    def one(name, cfg, *, proactive=False, fused_decide=False, compact=None, scenarios=None,
            tick_interval=None, cpu=False):
        kw = dict(proactive=proactive, fused_decide=fused_decide, compact=compact,
                  scenarios=scenarios, tick_interval=tick_interval)
        t_straight, t_chk = {}, {}
        ref, counts = counted(soak.run_straight, cfg, device=dev, timings=t_straight, **kw)
        n_ticks = ref["codes"].shape[0]
        want = soak_launch_rule(ref, n_ticks, proactive=proactive, fused_decide=fused_decide,
                                compact=compact)
        check(counts == want, f"soak {name}: straight-run launches {counts}, expected {want}")
        directory = scratch / name
        chk, chk_counts = counted(soak.run_checkpointed, cfg, directory, device=dev,
                                  timings=t_chk, **kw)
        shutil.rmtree(directory, ignore_errors=True)
        try:
            soak.assert_bit_identical(ref, chk)
            identical = True
        except AssertionError as exc:
            identical = str(exc).splitlines()[0]
        n_chunks = -(-n_ticks // cfg.checkpoint_every)
        row = {"run": name, "B": int(ref["codes"].shape[1]), "ticks": n_ticks,
               "proactive": proactive, "fused_decide": fused_decide,
               "compact": bool(compact), "n_restores": chk["n_restores"],
               "bit_identical": identical,
               "straight_wall_ms_per_tick": t_straight["run"][0] / n_ticks,
               "stitched_wall_ms_per_tick": sum(t_chk["run"]) / n_ticks,
               "launches_per_tick": {k: v / n_ticks for k, v in counts.items() if v},
               "stitched_launches": {k: v for k, v in chk_counts.items() if v},
               "build_ms": t_straight["rebuild"][0],
               "rebuild_ms": t_chk["rebuild"], "save_async_ms": t_chk["save_async"],
               "wait_ms": t_chk["wait"], "restore_ms": t_chk["restore"],
               "save_ms": t_chk["save"]}
        if scenarios is None:
            row["report"] = soak.soak_report(cfg, chk).summary()
            row["report_straight"] = soak.soak_report(cfg, ref).summary()
        if cpu:
            host = soak.run_straight(cfg, device="cpu", **kw)
            row["card_vs_cpu_differ"] = {
                key: int((host[key] != ref[key]).reshape(n_ticks, -1).any(axis=-1).sum())
                for key in SOAK_EXACT_CPU}
        emit({"phase": "soak", **row})
        check(identical is True, f"soak {name}: stitched run differs from straight: {identical}")
        check(chk["n_restores"] == n_chunks - 1,
              f"soak {name}: {chk['n_restores']} restores, expected {n_chunks - 1}")
        check(np.isfinite(ref["q_final"]).all(), f"soak {name}: non-finite backlog")
        if cpu:
            check(not any(row["card_vs_cpu_differ"].values()),
                  f"soak {name}: card and CPU differ in {row['card_vs_cpu_differ']} ticks")
        return ref

    try:
        day = soak.SoakConfig()
        one("day-reactive", day)
        one("day-proactive-fused", day, proactive=True, fused_decide=True)
        smoke = soak.SoakConfig.smoke()
        for compact in (None, True):
            one(f"2h{'-compact' if compact else ''}", smoke, compact=compact, cpu=True)
        # Device time per tick: one more profiled run of the 2 h day per mode.
        profiles = {}
        for name, proactive, fd in (("reactive", False, False),
                                    ("proactive-fused", True, True)):
            def make_loop(proactive=proactive, fd=fd):
                r, loop, _ = soak._runner_and_loop(smoke, proactive=proactive, compact=None,
                                                   fused_decide=fd, device=dev, dtype=None)
                return loop, r.k
            profiles[name] = loop_profile(make_loop, smoke.n_ticks)
        emit({"phase": "soak_profile", "config": "2h", "profiles": profiles,
              "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
        _distinct, fleet = fleet_scenarios()
        one("fleet-4096-compact", soak.SoakConfig(checkpoint_every=2), compact=True,
            scenarios=fleet, tick_interval=5.0)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return launches


def fleet_tenants(count=DISTINCT):
    """``count`` fleet scenarios (``scenario_matrix(count, seed=5)``) as
    planner tenants: each its mean topology and its t_max.  The 256
    distinct fleet scenarios have 1,298 operator rows (102 tenants without
    a t_max); 1,024 have 5,128."""
    from repro_torch.core.planner import Tenant
    from repro_torch.streaming.scenarios import scenario_matrix

    scens = scenario_matrix(count, seed=5, horizon=30.0, warmup=5.0, dt=0.05, k_max=48)
    return [Tenant(s.name, topology=s.mean_topology(), t_max=s.t_max) for s in scens]


def fleet_tile(planner, dev):
    """The planner's merged candidate tile ``[1, R, budget]`` float32 and its
    budget on ``dev``: the one ``gain_topr`` call of ``plan_batched``."""
    import torch

    from repro_torch.core.allocator import candidate_window

    resolved, ctx = planner._floors(None, None)
    g, k_start, _ = planner._gain_rows(resolved, ctx["starts"], ctx["budget"])
    cand = torch.as_tensor(candidate_window(g, k_start, ctx["budget"]), device=dev
                           ).to(torch.float32)[None].contiguous()
    return cand, torch.tensor([ctx["budget"]], dtype=torch.int32, device=dev)


def fleet_planner(count, dev=None):
    """``(planner, floors)``: ``count`` fleet tenants at a pool of their
    Program-(6) floors + ``FLEET_POOL_EXTRA``."""
    from repro_torch.core.planner import FleetPlanner

    tenants = fleet_tenants(count)
    _res, ctx = FleetPlanner(tenants, 10 ** 9)._floors(None, None)
    floors = ctx["needed_total"]
    return FleetPlanner(tenants, floors + FLEET_POOL_EXTRA), floors


def topr_bound(cand):
    """``gain_topr``'s bound on a tile: the tile and budgets read, the takes
    written; a compare and a count per gain in each of the grid route's
    four passes over it (three radix digits, the row counts)."""
    b, n, _j = cand.shape
    return bound(4 * cand.numel() + 4 * b + 4 * b * n, 4 * 2 * cand.numel())


def fleet_plan_phase(dev):
    """``FleetPlanner.plan_batched`` for 256 tenants on the card: the whole
    fleet one scenario of ``gain_topr``'s grid route ([1, 1298, 2048]
    float32).  Hard: the plan equals the plain float32 version's (on the
    CPU) take for take, one launch per plan, ``total <= k_max``, and a pool
    below the floors comes back overloaded as the scalar plan does.
    Information: operators whose takes differ from the float64 scalar
    plan.  The kernel call is timed beside its plain version and its
    bound.  Returns the phase's launches."""
    import torch

    from repro_torch.core.planner import FleetPlanner
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.gain_topr import kernel as gk, ref as gr

    planner, floors = fleet_planner(DISTINCT)
    tenants = planner.tenants
    rows_n = sum(t.topology.n for t in tenants)
    pool = planner.k_max
    t0 = time.perf_counter()
    scalar = planner.plan()
    scalar_ms = (time.perf_counter() - t0) * 1e3
    plain = planner.plan_batched(device="cpu")
    planner.plan_batched(device=dev)  # CUDA context and library outside the count
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    card = planner.plan_batched(device=dev)
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = {"gain_topr": LAUNCHES["gain_topr"]}
    differ_plain = sum(int((card.k[n] != plain.k[n]).sum()) for n in card.k)
    differ_scalar = sum(int((card.k[n] != scalar.k[n]).sum()) for n in card.k)

    LAUNCHES.clear()
    low_card = FleetPlanner(tenants, FLEET_LOW_POOL).plan_batched(device=dev)
    launches["gain_topr"] += LAUNCHES["gain_topr"]
    low_scalar = FleetPlanner(tenants, FLEET_LOW_POOL).plan()

    # The kernel call alone, on the plan's own candidate tile.
    cand, budget = fleet_tile(planner, dev)
    row = topr_row(cand, budget)
    emit({"phase": "fleet_plan", "tenants": len(tenants), "operator_rows": rows_n,
          "floors": floors, "pool": pool, "budget": int(budget[0]),
          "total": card.total, "overloaded": card.overloaded, "unmet": len(card.unmet),
          "takes_differ_from_plain": differ_plain,
          "operators_differ_from_float64_scalar": differ_scalar,
          "plan_batched_ms": card_ms, "scalar_plan_ms": scalar_ms,
          "low_pool": {"k_max": FLEET_LOW_POOL, "overloaded": low_card.overloaded,
                       "scalar_overloaded": low_scalar.overloaded, "total": low_card.total},
          "launches": launches, "gain_topr": row,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
    check(differ_plain == 0 and row["max_abs_err"] == 0.0,
          f"fleet_plan: the card's takes differ from the plain float32 version's in "
          f"{differ_plain} operators (kernel vs plain max err {row['max_abs_err']})")
    check(row["route"][0] == "grid", f"fleet_plan: gain_topr planned {row['route']}")
    check(card.total <= pool and low_card.total <= FLEET_LOW_POOL,
          f"fleet_plan: totals {card.total} / {low_card.total} past the pools")
    check(low_card.overloaded and low_card.overloaded == low_scalar.overloaded
          and not card.overloaded,
          f"fleet_plan: overloaded flags {card.overloaded} / {low_card.overloaded}, "
          f"scalar {low_scalar.overloaded}")
    check(launches["gain_topr"] == 2, f"fleet_plan: {launches} for two batched plans")
    return launches


def topr_row(cand, budget):
    """One ``gain_topr`` call on a planner's tile: its route, max error
    against the plain version, ms, device us, plain ms and bound."""
    from repro_torch.kernels.gain_topr import kernel as gk, ref as gr

    b, n, j = cand.shape
    bound_ms, bound_by = topr_bound(cand)
    return dict(B=b, N=n, J=j, tile_mb=4 * cand.numel() / 1e6, route=list(gk.plan(n, j)),
                max_abs_err=max_abs_err(gk.gain_topr(cand, budget), gr.gain_topr(cand, budget)),
                ms=median_ms(lambda: gk.gain_topr(cand, budget)),
                plain_ms=median_ms(lambda: gr.gain_topr(cand, budget), runs=5, inner=2),
                device_us=device_us_per_call(lambda: gk.gain_topr(cand, budget),
                                             LOOP_SYMBOLS["gain_topr"], calls=20),
                bound={"ms": bound_ms, "by": bound_by})


MESH_B = MAIN_B - 6  # fleet_mesh: 4,090 lanes, so four ranks pad two
MESH_RANKS = 4
MESH_SHARD = -(-MESH_B // MESH_RANKS)  # lanes per rank: 4,092 / 4
#: fleet_mesh's loop modes: ScenarioRunner keywords.
MESH_MODES = {"dense": {}, "fused": {"fused_decide": True}, "compact": {"compact": True},
              "proactive": {"proactive": True}}
#: Outputs a sharded run must equal bitwise (the fleet's decisions,
#: allocations and integer aggregates); the E[T] diagnostics are printed.
MESH_EXACT = ("codes", "k", "applied", "miss", "warm_windows", "k_final", "q_final",
              "offered", "served", "dropped", "ext_admitted", "ext_offered", "q_int",
              "q_max", "mpc_used", "confident")
MESH_CLOSE = ("sojourn", "et_cur", "et_target")


def mesh_fleet():
    """fleet-4096 cut to ``MESH_B`` lanes."""
    return fleet_scenarios()[1][:MESH_B]


def mesh_runner_out(fleet, mode, mesh, dev):
    """One ``ScenarioRunner`` run of ``fleet`` in ``mode``: (outputs, wall
    ms per tick)."""
    from repro_torch.api.session import ScenarioRunner

    runner = ScenarioRunner(fleet, tick_interval=5.0, mesh=mesh, device=dev,
                            **MESH_MODES[mode])
    runner.run()
    ticks = runner.outputs["codes"].shape[0]
    return runner.outputs, runner.loop_seconds * 1e3 / ticks


def mesh_differences(ref, got):
    """(exact keys that differ, the largest relative difference of the
    E[T] diagnostics)."""
    import numpy as np

    bad = [k for k in MESH_EXACT if k in ref and not np.array_equal(ref[k], got[k])]
    rel = 0.0
    for k in MESH_CLOSE:
        a, b = np.asarray(ref[k], np.float64), np.asarray(got[k], np.float64)
        both = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            bad.append(k)
        if both.any():
            rel = max(rel, float(np.max(np.abs(a[both] - b[both])
                                         / np.maximum(np.abs(a[both]), 1e-30))))
    return bad, rel


def mesh_carry(fleet, mesh, dev):
    """The fused loop (fused decide) over ``fleet`` on ``mesh`` (None:
    unsharded), run as a chunked resume (one tick, then the rest): the
    lanes this rank's carry and per-tick outputs hold between runs, the
    ``all_gather`` calls ``init`` and ``run`` made (through a wrapped
    ``FleetMesh.all_gather``), the peak device memory of the build and the
    runs over what was allocated before, and wall ms per tick; with the
    gathered outputs."""
    import torch

    from repro_torch.api.session import ScenarioRunner
    from repro_torch.core import controller as ctl
    from repro_torch.distributed import FleetMesh

    runner = ScenarioRunner(fleet, tick_interval=5.0, mesh=mesh, device=dev, fused_decide=True)
    calls = [0]
    plain = FleetMesh.all_gather

    def counted(self, x, dim=0):
        calls[0] += 1
        return plain(self, x, dim)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    FleetMesh.all_gather = counted
    try:
        loop, n_ticks = ctl.make_fused_loop(
            runner.arrays, runner.static, runner.params, steps_per_tick=runner._steps_per_tick,
            warmup_seconds=fleet[0].warmup, mesh=mesh, device=dev)
        state = loop.init(runner.k)
        t0 = time.perf_counter()
        state, _first = loop.run(state, 1)
        state, out = loop.run(state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_ticks
        in_runs = calls[0]
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        carry = sorted({t.shape[0] for t in (state.q, state.served_prev, state.k, *state.acc)})
        out_lanes = int(out["codes"].shape[1])
        whole = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in loop.gather(out).items()}
    finally:
        FleetMesh.all_gather = plain
    return {"carry_lanes": carry, "out_lanes": out_lanes, "gathers_in_runs": in_runs,
            "peak_mb": peak_mb, "ms_per_tick": ms}, whole


def _mesh_rank(rank, world, work_dir):
    """One of ``MESH_RANKS`` ranks on the card (gloo on CUDA tensors): the
    mesh fleet in every mode, then the 256-tenant plan; each result saved
    under ``work_dir`` for the parent."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import fleet_backend, fleet_mesh

    work = pathlib.Path(work_dir)
    backend = fleet_backend("cuda", world)
    dist.init_process_group(backend, init_method=(work / "store").as_uri(), world_size=world,
                            rank=rank)
    try:
        dev = torch.device("cuda")
        mesh = fleet_mesh(world, device=dev)
        fleet = mesh_fleet()
        info = {"rank": rank, "device": str(mesh.device), "backend": mesh.backend}
        for mode in MESH_MODES:
            out, ms = mesh_runner_out(fleet, mode, mesh, dev)
            np.savez(work / f"r{rank}-{mode}.npz", **out)
            info[f"{mode}_ms_per_tick"] = ms
        info["carry"], whole = mesh_carry(fleet, mesh, dev)
        np.savez(work / f"r{rank}-carry.npz", **whole)
        planner, _floors = fleet_planner(DISTINCT)
        plan = planner.plan_batched(mesh=mesh, device=dev)
        np.savez(work / f"r{rank}-plan.npz", **plan.k)
        (work / f"r{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def fleet_mesh_phase(dev):
    """The mesh-sharded control plane on the card (``fleet_mesh``).
    (a) one rank on NCCL: ``ScenarioRunner(mesh=fleet_mesh())`` over the
    4,090-lane fleet with the fused decide off and on; (b) four ranks
    sharing the card (spawned, gloo on CUDA tensors): the same fleet
    (two padded lanes) off and on, one ``compact`` and one ``proactive``
    run; (c) the 256-tenant ``plan_batched(mesh=)`` on those ranks; (d)
    the 1,024-tenant fleet's plan (5,128 rows) on the one-rank mesh.
    Hard: every run equals the unsharded card run on the exact keys and
    on which E[T] values are finite, every rank returns the whole fleet,
    the plans equal the unsharded plans take for take, and (d) equals the
    plain float32 plan.  Reported: each rank's device and backend, wall
    ms per tick against the unsharded run, (d)'s ``gain_topr`` call beside
    its plain version and its bound.  Returns the phase's launches in this
    process (the unsharded runs and plan, the one-rank runs and (d)'s
    plan; the four ranks count in their own processes)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.distributed import fleet_mesh
    from repro_torch.kernels import LAUNCHES

    t_phase = time.perf_counter()
    fleet = mesh_fleet()
    LAUNCHES.clear()
    plain = {mode: mesh_runner_out(fleet, mode, None, dev) for mode in MESH_MODES}
    planner, _floors = fleet_planner(DISTINCT)
    plain_plan = planner.plan_batched(device=dev)
    plain_carry, plain_whole = mesh_carry(fleet, None, dev)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = pathlib.Path(tmp)
        # (a) and (d): one rank, NCCL.
        dist.init_process_group("nccl", init_method=(work / "nccl").as_uri(), world_size=1,
                                rank=0)
        try:
            one = fleet_mesh()
            one_rank = {}
            for mode in ("dense", "fused"):
                out, ms = mesh_runner_out(fleet, mode, one, dev)
                bad, rel = mesh_differences(plain[mode][0], out)
                check(not bad, f"fleet_mesh (a) {mode}: {bad} differ from the unsharded run")
                one_rank[mode] = {"ms_per_tick": ms, "unsharded_ms_per_tick": plain[mode][1],
                                  "et_max_rel_diff": rel}
            one_rank["carry"], one_whole = mesh_carry(fleet, one, dev)
            bad, _rel = mesh_differences(plain_whole, one_whole)
            check(not bad and one_rank["carry"]["gathers_in_runs"] == 0
                  and one_rank["carry"]["carry_lanes"] == [MESH_B],
                  f"fleet_mesh (a) carry: {one_rank['carry']}, {bad} differ")
            big, big_floors = fleet_planner(4 * DISTINCT)
            t0 = time.perf_counter()
            big_card = big.plan_batched(mesh=one, device=dev)
            big_ms = (time.perf_counter() - t0) * 1e3
            backend = one.backend
        finally:
            dist.destroy_process_group()
        launches = {k: LAUNCHES[k] for k in ("queue_window", "erlang_c", "gain_topr",
                                             "decide_fused")}
        big_plain = big.plan_batched(device="cpu")
        big_row = topr_row(*fleet_tile(big, dev))
        big_differ = sum(int((big_card.k[n] != big_plain.k[n]).sum()) for n in big_card.k)
        check(big_differ == 0 and big_row["max_abs_err"] == 0.0,
              f"fleet_mesh (d): {big_differ} takes differ from the plain float32 plan "
              f"(kernel vs plain {big_row['max_abs_err']})")
        check(big_row["N"] > 4093 and big_row["route"][0] == "grid",
              f"fleet_mesh (d): tile {big_row['N']} rows on {big_row['route']}")
        # (b) and (c): four ranks sharing the card.
        t0 = time.perf_counter()
        ctx = mp.spawn(_mesh_rank, args=(MESH_RANKS, str(work)), nprocs=MESH_RANKS,
                       join=False)
        try:
            while not ctx.join(timeout=5.0):
                check(time.perf_counter() - t0 < 300, "fleet_mesh (b): ranks still running")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((work / f"r{r}.json").read_text()) for r in range(MESH_RANKS)]
        rels = {}
        for mode in MESH_MODES:
            for r in range(MESH_RANKS):
                with np.load(work / f"r{r}-{mode}.npz") as z:
                    got = {k: z[k] for k in z.files}
                bad, rel = mesh_differences(plain[mode][0], got)
                check(not bad, f"fleet_mesh (b) {mode}, rank {r}: {bad} differ from the "
                               "unsharded run")
                check(got["codes"].shape[1] == MESH_B, f"fleet_mesh (b): rank {r} shape")
                rels[mode] = max(rels.get(mode, 0.0), rel)
        for r in range(MESH_RANKS):
            with np.load(work / f"r{r}-carry.npz") as z:
                bad, _rel = mesh_differences(plain_whole, {k: z[k] for k in z.files})
            carry = ranks[r]["carry"]
            check(not bad and carry["gathers_in_runs"] == 0
                  and carry["carry_lanes"] == [MESH_SHARD]
                  and carry["out_lanes"] == MESH_SHARD,
                  f"fleet_mesh (b) carry, rank {r}: {carry}, {bad} differ")
        for r in range(MESH_RANKS):
            with np.load(work / f"r{r}-plan.npz") as z:
                differ = sum(int((z[n] != plain_plan.k[n]).sum()) for n in plain_plan.k)
            check(differ == 0, f"fleet_mesh (c): rank {r}'s plan differs in {differ} takes")
    emit({"phase": "fleet_mesh", "B": MESH_B, "ranks": MESH_RANKS,
          "one_rank": {"backend": backend, **one_rank},
          "carry": {"unsharded": plain_carry, "one_rank": one_rank["carry"],
                    "four_ranks": [r["carry"] for r in ranks],
                    "peak_mb_per_rank_over_unsharded": [r["carry"]["peak_mb"]
                                                        / plain_carry["peak_mb"]
                                                        for r in ranks]},
          "four_ranks": {"ranks": ranks, "spawn_and_run_s": spawn_s,
                         "unsharded_ms_per_tick": {m: plain[m][1] for m in MESH_MODES},
                         "et_max_rel_diff": rels},
          "plan_256": {"ranks": MESH_RANKS, "equal": True},
          "plan_1024": {"tenants": 4 * DISTINCT, "floors": big_floors,
                        "pool": big.k_max, "total": big_card.total,
                        "plan_batched_ms": big_ms, "takes_differ_from_plain": big_differ,
                        "gain_topr": big_row},
          "launches": launches, "seconds": time.perf_counter() - t_phase,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
    return launches


def fleet_live_phase(dev):
    """A batched ``FleetSession`` over two live engine tenants on the card:
    VLD at ``vld_live``'s width and FPD at the paper's window (32 items,
    patterns up to 3, 50,000 transactions, threshold 3,125), its window
    filled through ``apply`` first.  Hard: every VLD frame completes with
    one ``match_count`` launch; FPD's incremental counts equal one
    ``support_counts`` over the final window; every plan within the pool;
    one ``gain_topr`` launch per batched plan.  Returns the phase's
    launches."""
    import numpy as np
    import torch

    from repro_torch.api import FleetSession, SchedulerConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.streaming.apps.fpd import (
        FPDConfig, build_fpd_graph, random_transaction, support_counts,
    )
    from repro_torch.streaming.apps.vld import VLDConfig, build_vld_graph, logo_library, make_frame

    vcfg = VLDConfig(**VLD_WIDTH)
    lib = logo_library(vcfg)
    fcfg = FPDConfig(**FPD_LIVE)
    rng = np.random.default_rng(0)
    vgraph, detections = build_vld_graph(vcfg, lib, fps=4.0, device=dev)
    fgraph, state, reports = build_fpd_graph(fcfg, rate=4.0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    changes = 0
    for _ in range(fcfg.window):
        changes += len(state.apply(random_transaction(fcfg, rng), True))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fleet = FleetSession(
        {"vld": vgraph.bind("engine", config=SchedulerConfig(t_max=2.0), device=dev),
         "fpd": fgraph.bind("engine", config=SchedulerConfig(t_max=4.0), device=dev)},
        k_max=FLEET_LIVE_K_MAX, solver="batched", device=dev,
    )
    LAUNCHES.clear()
    frames = events = 0
    decisions = []
    t_start = time.perf_counter()
    try:
        started = fleet.start()
        for _ in range(FLEET_LIVE_TICKS):
            t_end = time.perf_counter() + FLEET_LIVE_INJECT_S
            while time.perf_counter() < t_end:
                if fleet.sessions["vld"].inject(make_frame(vcfg, rng, lib,
                                                           rng.random() < 0.4)) is not None:
                    frames += 1
                for _ in range(8):
                    if fleet.sessions["fpd"].inject((random_transaction(fcfg, rng), True)
                                                    ) is not None:
                        events += 1
                time.sleep(0.01)
            decisions.append(fleet.tick())
        drained = {name: s.drain(timeout=120.0) for name, s in fleet.sessions.items()}
        elapsed = time.perf_counter() - t_start
    finally:
        fleet.stop()
    counts = {k: LAUNCHES[k] for k in ("gain_topr", "match_count", "pairwise_sq_l2")}
    plans = [d.plan for d in decisions if d.plan is not None]
    n_plans = 1 + len(plans)  # start() plans once
    window = torch.as_tensor(np.asarray(state.window, dtype=np.int64), device=dev)
    recount = support_counts(state.patterns_dev, window).to(torch.int64)
    counts_equal = bool(torch.equal(recount, state.counts))
    failures = {name: {k: v for k, v in s.backend.engine.failures.items() if v}
                for name, s in fleet.sessions.items()}
    vld_done = len(fleet.sessions["vld"].completed_sojourns)
    fpd_done = len(fleet.sessions["fpd"].completed_sojourns)
    emit({"phase": "fleet_live", "k_max": FLEET_LIVE_K_MAX, "vld": VLD_WIDTH, "fpd": FPD_LIVE,
          "start": started,
          "decisions": [{"action": d.action, "reason": d.reason, "k": d.k,
                         "overloaded_tenants": list(d.overloaded_tenants),
                         "plan_total": None if d.plan is None else d.plan.total,
                         "needed_total": None if d.plan is None else d.plan.needed_total}
                        for d in decisions],
          "allocations_final": fleet.allocations(),
          "fpd_fill": {"events": fcfg.window, "seconds": fill_s,
                       "detector_ms_per_event": fill_s * 1e3 / fcfg.window,
                       "mfp_changes": changes},
          "vld_frames": {"injected": frames, "completed": vld_done,
                         "detection_rows": len(detections), "per_s": vld_done / elapsed},
          "fpd_events": {"injected": events, "completed": fpd_done, "per_s": fpd_done / elapsed,
                         "reports": len(reports), "mfps": int(state.mfp_np.sum())},
          "fpd_counts_equal_recount": counts_equal, "drained": drained, "failures": failures,
          "seconds": elapsed, "plans": n_plans, "launches": counts,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")})
    check(all(drained.values()) and not any(failures.values()),
          f"fleet_live: tenants not drained ({drained}) or operators failed ({failures})")
    check(vld_done == frames and len(detections) == frames
          and counts["match_count"] == frames,
          f"fleet_live: {vld_done} of {frames} frames completed, {len(detections)} detection "
          f"rows, {counts['match_count']} match_count launches")
    check(fpd_done == events, f"fleet_live: {fpd_done} of {events} FPD events completed")
    check(counts_equal, "fleet_live: FPD's incremental counts differ from support_counts")
    check(all(p.total <= p.k_max <= FLEET_LIVE_K_MAX for p in plans)
          and sum(sum(v.values()) for v in fleet.allocations().values()) <= FLEET_LIVE_K_MAX,
          "fleet_live: a plan or the allocation in force is past the pool")
    check(counts["gain_topr"] == n_plans,
          f"fleet_live: {counts['gain_topr']} gain_topr launches for {n_plans} batched plans")
    return counts


# --------------------------------------------------------------------------- #
# Phases 9-13 and 15: the LLM kernels and serving (the dense, moe and vlm
# families, and the scan families' serving paths)
# --------------------------------------------------------------------------- #
LLM_ARCH = "llama3.2-1b"
# The head-dim-128 dense archs, the scan archs and the moe / vlm archs.
DENSE128_ARCHS = ("phi3-medium-14b", "yi-34b", "command-r-35b")
PHI3_ARCH = DENSE128_ARCHS[0]
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
ZAMBA = SSM_ARCHS[1]
MIXTRAL, KIMI, QWEN_VL = "mixtral-8x22b", "kimi-k2-1t-a32b", "qwen2-vl-2b"
WHISPER = "whisper-medium"
# whisper-serve-16x1500: 16 segments of 30 s (1,500 frames each), a
# 224-token prompt (n_text_ctx // 2, the previous-text conditioning) in a
# cache of n_text_ctx = 448 rows.
WHISPER_B, WHISPER_PROMPT, WHISPER_SMAX = 16, 224, 448
# prefill_32k (src/repro/configs/shapes.py:42) cut from 32 x 32768 to 4 x 4096
SERVE_B, SERVE_S, SERVE_STEPS = 4, 4096, 32
# decode_32k cut from batch 128 (137 GB of KV) to 16 (17.2 GB)
DEC_B, DEC_SMAX, DEC_LEN, DEC_STEPS = 16, 32768, 32000, 8
# long_500k (src/repro/configs/shapes.py:44): one new token against a cache
# of 524,288 rows at batch 1, for the archs the reference gates it to;
# LONG_STEPS timed steps from LONG_LEN end at a full cache.
LONG_S, LONG_STEPS = 524_288, 32
LONG_LEN = LONG_S - LONG_STEPS
# Its cells: rwkv6 whole, its state from one real prefill of LONG_PREFILL
# tokens; zamba2 and mixtral cut in depth to fit one card's 80 GB beside
# their K / V (zamba2's 14 sites need 105.2 GB, mixtral's 56 layers 120 GB
# and ~282 GB of weights): zamba2 at 42 of 81 layers, 7 sites, 52.6 GB of
# K / V and 7.4 GB of weights; mixtral at 8 of 56 layers, 17.2 GB of K / V
# and 40.9 GB of weights.
LONG_ARCHS = (SSM_ARCHS[0], ZAMBA, MIXTRAL)
LONG_LAYERS = {ZAMBA: 42, MIXTRAL: 8}
LONG_PREFILL = LONG_LEN
# llama3.2-1b's attention and FFN widths, and the kernel-only prefill length
HQ, HKV, DH, D_MODEL, D_FF, FLASH_S = 32, 8, 64, 2048, 8192, 2048
# Attention: kernel and plain version both compute in float32 and round the
# output once, so in bf16 they differ by at most one ulp, 2^-7 of the output
# row's largest value; the limit is two.  The float32 limit sits ~10x above
# the summation-order noise and below what one key too many or too few
# moves an output at 32k keys (~1e-4).
ATTN_TOL = {"bfloat16": (2 ** -6, "row"), "float32": (2e-5, "element")}
SWIGLU_TOL = {"bfloat16": (5e-2, "tensor"), "float32": (2e-3, "tensor")}
# The routed experts round as ``models/ffn.py:_experts`` does, step for
# step; only the order of accumulation inside a product differs, which
# moves a bf16 output by a few ulps (2^-8 of its value each): 2e-2 of the
# largest value, as tests/test_torch_moe.py holds the bf16 layer.  A
# wrong expert, column tile or gate is off by the values themselves.
MOE_TOL = {"bfloat16": (2e-2, "tensor")}
# Every device function of each kernel (bf16 flash and scans on the tensor
# cores, float32 on CUDA cores; decode's one kernel, its consumers on the
# tensor cores or the CUDA cores).
LLM_SYMBOLS = {"flash_attention": ("flash_wgmma_kernel", "flash_fwd_kernel"),
               "decode_attention": ("decode_tma_kernel",),
               "swiglu": ("swiglu_wgmma_kernel", "swiglu_stream_kernel",
                          "swiglu_stream_f32_kernel", "swiglu_reduce_kernel",
                          "swiglu_f32_tile_kernel"),
               "moe_experts": ("experts_wgmma_kernel",),
               "rwkv6_scan": ("rwkv6_mma_kernel", "rwkv6_scan_kernel"),
               "ssd_scan": ("ssd_mma_kernel", "ssd_scan_kernel")}


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def close_err(got, want, tol, rule="element"):
    """(max |got - want|, whether every difference is within tolerance): at
    most ``tol * (1 + |want|)`` ("element"), ``tol`` times the largest
    ``|want|`` in the same last-axis row ("row"), ``tol`` times one plus it
    ("row1"), or ``tol`` times the largest in the whole tensor ("tensor")."""
    import torch

    got, want = got.double(), want.double()
    diff = (got - want).abs()
    limit = {"element": lambda: tol * (1 + want.abs()),
             "row": lambda: tol * want.abs().amax(-1, keepdim=True),
             "row1": lambda: tol * (1 + want.abs().amax(-1, keepdim=True)),
             "tensor": lambda: tol * want.abs().max()}[rule]()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= limit).all())
    return float(diff.max()), ok


def hold(phase, name, case, got, want, tol_rule):
    """Emit and check one parity case; returns the max abs error."""
    tol, rule = tol_rule
    err, ok = close_err(got, want, tol, rule)
    emit({"phase": phase, "kernel": name, "case": case, "max_abs_err": err, "tol": tol,
          "tol_rule": rule, "ok": ok})
    check(ok and got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {case}: kernel differs from its reference (max abs err {err}, "
          f"tol {tol})")
    return err


def device_us_per_call(fn, symbols, calls=5):
    """Device time per call of ``fn`` (torch.profiler), summed over the
    kernels whose names contain one of ``symbols``; None if none ran."""
    _wall_ms, _device_ms, rows = profile_breakdown(fn, calls, expect=(tuple(symbols),))
    return sum(t for k, t, _c in rows if any(s in k for s in symbols)) or None


# The LLM kernels' cases at each arch's own heads and widths (its full
# config), one row each: flash (group, arch, B, S or (Sq, Skv), window,
# causal, timed);
# decode (group, arch, B, S_max, length, window, timed); SwiGLU (group,
# arch, T, dtypes, timed).  Every case is held to the plain version in
# float32 and bf16 (SwiGLU: in ``dtypes``); a timed case is also timed in
# bf16.  Group "main" is the kernel table's row (llama's serving shapes);
# the others are its sub-rows: "llama" llama's other shapes, "zamba2" head
# dim 112 (MHA), "dh128" the dense family at head dim 128, "moe_vlm" the
# moe and vlm archs (mixtral windowed at its 2 x 8192 prefill, so the
# window cuts every query past 4096), "audio" whisper's encoder, cross and
# decoder attention and its (64, 1) decode over the cross and self caches,
# "long_500k" the decode steps of the ``long_500k`` phase on a full
# 524,288-row cache (zamba2 over every row, mixtral over its window) and
# zamba2's shared-block SwiGLU at its batch-1 step (T 1); "bounds" decode
# at B 3 over 4,128 rows, where the blocks' ranges (~47 rows at llama's 3
# x 8 groups) end mid-tile and cross from one group into the next, on the
# tensor cores (llama, kimi) and the CUDA cores (zamba2).  Every decode
# case is also called twice, bits held equal.
STEP = (SERVE_B, SERVE_S + SERVE_STEPS, SERVE_S + 1)  # a B 4 step over 4,097 cached
EMPTY = (SERVE_B, SERVE_S + SERVE_STEPS, 0)  # length 0: the mean of V, as ref.py
LONG = (DEC_B, DEC_SMAX, DEC_LEN)
BOTH, BF16 = ("float32", "bfloat16"), ("bfloat16",)
FLASH_CASES = (
    ("main", LLM_ARCH, SERVE_B, SERVE_S, None, True, True),
    ("llama", LLM_ARCH, 1, FLASH_S, None, True, True),
    ("llama", LLM_ARCH, 1, FLASH_S, 256, True, False),
    ("llama", LLM_ARCH, 1, 1000, None, False, False),
    ("zamba2", ZAMBA, SERVE_B, SERVE_S, None, True, True),
    ("zamba2", ZAMBA, 1, 1000, 100, True, False),  # a window across key tiles
    ("zamba2", ZAMBA, 1, 1000, None, False, False),
    ("dh128", PHI3_ARCH, SERVE_B, SERVE_S, None, True, True),
    ("dh128", PHI3_ARCH, 1, FLASH_S, 256, True, False),
    ("dh128", PHI3_ARCH, 1, 1000, None, False, False),
    ("moe_vlm", MIXTRAL, 2, 8192, 4096, True, True),
    ("moe_vlm", KIMI, SERVE_B, SERVE_S, None, True, True),
    ("audio", WHISPER, WHISPER_B, 1500, None, False, True),
    ("audio", WHISPER, WHISPER_B, (WHISPER_PROMPT, 1500), None, False, True),
    ("audio", WHISPER, WHISPER_B, WHISPER_PROMPT, None, True, False),
)
DECODE_CASES = (
    ("main", LLM_ARCH, *LONG, None, True),
    ("llama", LLM_ARCH, *LONG, 1024, False),
    ("llama", LLM_ARCH, *STEP, None, True),
    ("llama", LLM_ARCH, *EMPTY, None, False),
    ("llama", LLM_ARCH, *EMPTY, 64, False),
    ("zamba2", ZAMBA, *STEP, None, True),
    ("zamba2", ZAMBA, *EMPTY, None, False),
    *(("dh128", arch, *cell, None, cell == STEP) for arch in DENSE128_ARCHS
      for cell in (STEP, EMPTY)),
    ("dh128", PHI3_ARCH, *LONG, None, True),
    ("moe_vlm", MIXTRAL, *STEP, 4096, True),
    ("moe_vlm", MIXTRAL, *EMPTY, 4096, False),
    ("moe_vlm", QWEN_VL, *STEP, None, False),
    ("moe_vlm", QWEN_VL, *EMPTY, None, False),
    ("moe_vlm", KIMI, *STEP, None, True),
    ("moe_vlm", KIMI, *EMPTY, None, False),
    ("audio", WHISPER, WHISPER_B, 1500, 1500, None, True),  # cross: every row
    ("audio", WHISPER, WHISPER_B, WHISPER_SMAX, WHISPER_PROMPT + 1, None, True),  # self, a step
    ("audio", WHISPER, WHISPER_B, WHISPER_SMAX, 0, None, False),
    # long_500k: zamba2's shared block over every row, mixtral's window at
    # the cache's end
    ("long_500k", ZAMBA, 1, LONG_S, LONG_S, None, True),
    ("long_500k", MIXTRAL, 1, LONG_S, LONG_S, 4096, True),
    *(("bounds", arch, 3, 4128, length, window, False) for arch in (LLM_ARCH, KIMI, ZAMBA)
      for length, window in ((1, None), (257, None), (4097, None), (4097, 1000))),
)
SWIGLU_CASES = (  # T 16,384: a 4 x 4096 prefill (the wgmma route); T 4-16: a step (streaming)
    ("main", LLM_ARCH, SERVE_B * SERVE_S, BF16, True),
    ("llama", LLM_ARCH, 16, BOTH, True),
    ("llama", LLM_ARCH, 4096, BOTH, True),
    ("zamba2", ZAMBA, 4, BOTH, True),
    ("zamba2", ZAMBA, 16, BF16, False),
    ("zamba2", ZAMBA, SERVE_B * SERVE_S, BF16, True),
    *(("dh128", arch, t, dtypes, timed) for arch in DENSE128_ARCHS
      for t, dtypes, timed in ((16, BOTH, False), (4096, BF16, False),
                               (SERVE_B * SERVE_S, BF16, True))),
    *(("moe_vlm", arch, t, BOTH, t > SERVE_B) for arch in (KIMI, QWEN_VL)
      for t in (SERVE_B, SERVE_B * SERVE_S)),
    ("long_500k", ZAMBA, 1, BOTH, True),  # zamba2's shared block at a batch-1 step
)
# The routed experts' grouped kernels (group, arch, tokens, timed), bf16
# (the kernels take nothing else), full width: mixtral's layer in the
# ``mixtral-prefill-4x4096`` cell (E 8 x capacity 5,120, D 6,144, F 16,384,
# filled as the cell's traced calls kept, ``MOE_COUNTS``: 30,837 slots, two
# experts overflowing, from 400,878 kept pairs over 13 layers) is the kernel
# table's row; kimi's 384 routed experts (D 7,168, F 2,048) at the same 4 x
# 4,096 prefill (capacity 426) and mixtral's and kimi's B 4 step (capacity
# 1) fill from a uniform top-k routing.
MOE_COUNTS = (5120, 5120, 4600, 4100, 3800, 3300, 2700, 2097)
MOE_CASES = (
    ("main", MIXTRAL, SERVE_B * SERVE_S, True),
    ("moe_vlm", KIMI, SERVE_B * SERVE_S, True),
    ("moe_vlm", MIXTRAL, SERVE_B, True),
    ("moe_vlm", KIMI, SERVE_B, True),
)
# Above this size of [B, Hq, S, S] float32 logits the plain attention runs
# one KV head (and its query heads) at a time: the same function (each
# group's softmax is its own), whose whole logits at mixtral's 2 x 8192 x
# 48 heads (25.8 GB, three such blocks live) do not fit beside the rest.
PLAIN_ATTN_WHOLE_BYTES = 12e9


def _plain_attention(q, k, v, **kw):
    import torch

    from repro_torch.kernels.flash_attention import ref as fr

    b, hq, s, _ = q.shape
    if 4 * b * hq * s * s <= PLAIN_ATTN_WHOLE_BYTES:
        return fr.attention(q, k, v, **kw)
    hkv = k.shape[1]
    n_rep = hq // hkv
    return torch.cat([fr.attention(q[:, g * n_rep:(g + 1) * n_rep], k[:, g:g + 1],
                                   v[:, g:g + 1], **kw) for g in range(hkv)], dim=1)


def llm_kernels_phase(dev):
    """``flash_attention``, ``decode_attention``, ``swiglu`` and
    ``moe_experts`` against their plain versions on the card at every case
    of ``FLASH_CASES``, ``DECODE_CASES``, ``SWIGLU_CASES`` and
    ``MOE_CASES``, each within ``ATTN_TOL`` / ``SWIGLU_TOL`` / ``MOE_TOL``
    (the experts on their filled slots: the kernels leave the tiles past
    them unwritten); the timed cases in bf16 (CUDA events, and the device
    time by ``torch.profiler``) beside the plain version, the PyTorch call
    that computes the same function (SDPA with ``enable_gqa=True``, decode
    on the valid prefix; none for SwiGLU, two GEMMs and a gate; the
    experts' padded ``torch.bmm`` products, ``models/ffn.py:_experts``), that
    call's (or, without one, the plain version's) device time, and the
    bound.  SDPA takes a window only as a dense mask, which moves it off
    its flash backend: a windowed case has no library time, and its masked
    SDPA time is kept as ``masked_sdpa_ms``, not a like-for-like time.
    Returns the kernel-table rows: the "main" case's numbers, the largest
    bf16 error of every case, and each other group's timed cases."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, cost as kcost
    from repro_torch.kernels.decode_attention import kernel as dk, ref as dr
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_experts import kernel as mk, ref as mr
    from repro_torch.kernels.swiglu import kernel as sk, ref as sr
    from repro_torch.models import ffn

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(77)
    bf16 = torch.bfloat16
    heavy = dict(runs=5, inner=2)
    cases = {}  # kernel -> group -> case -> row

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def run_case(kernel, group, arch, case, dtypes, make, timed, work, quick=False):
        """Hold ``make(dtype)``'s kernel call to its plain call in each of
        ``dtypes``; when ``timed``, time the bf16 calls (``make`` returns
        {"run", "plain", "library" (or None), "other" ({key: call})}, and
        may return "keep", a mask of the output elements held)."""
        row = {}
        for name in dtypes:
            dtype = getattr(torch, name)
            calls = make(dtype)
            tol = {"swiglu": SWIGLU_TOL, "moe_experts": MOE_TOL}.get(kernel, ATTN_TOL)[name]
            got, want = calls["run"](), calls["plain"]()
            if "keep" in calls:
                got, want = (torch.where(calls["keep"], t, 0) for t in (got, want))
            err = hold("llm_parity", kernel, f"{arch},{case},{name}", got, want, tol)
            del want
            if kernel == "decode_attention":  # the partials merge in a fixed order
                check(torch.equal(calls["run"](), got),
                      f"{kernel} {arch},{case},{name}: two calls differ")
            del got
            row["max_abs_err" if dtype == bf16 else f"max_abs_err_{name}"] = err
            if timed and dtype == bf16:
                kw = {} if quick else heavy
                run, library = calls["run"], calls["library"]
                row.update(
                    ms=median_ms(run, **kw), plain_ms=median_ms(calls["plain"], runs=3, inner=1),
                    library_ms=None if library is None else median_ms(library, **kw),
                    device_us=device_us_per_call(run, LLM_SYMBOLS[kernel]),
                    **{"library_device_us" if library else "plain_device_us":
                       profile_breakdown(library or calls["plain"], calls=5)[1] * 1e3},
                    **{key: median_ms(fn, **kw) for key, fn in calls["other"].items()},
                    bound=bound(*work, PEAK_BF16_OPS_PER_S))
            del calls
            torch.cuda.empty_cache()
        row["timed"] = timed
        cases.setdefault(kernel, {}).setdefault(group, {})[f"{arch},{case}"] = row

    for group, arch, b, s, window, causal, timed in FLASH_CASES:
        cfg = get_config(arch, "full")
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        kw = dict(window=window, causal=causal)
        sq, skv = s if isinstance(s, tuple) else (s, s)

        def make(dtype):
            q = randn((b, sq, hq, dh), dtype).transpose(1, 2)  # the model's [B, S, H, Dh]
            k, v = (randn((b, skv, hkv, dh), dtype).transpose(1, 2) for _ in range(2))
            calls = {"run": lambda: fk.attention(q, k, v, **kw),
                     "plain": lambda: _plain_attention(q, k, v, **kw), "other": {}}
            if window is None:
                calls["library"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            else:
                calls["library"] = None
                i = torch.arange(sq, device=dev)
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
                calls["other"]["masked_sdpa_ms"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            return calls

        shape = (f"B={b},S={s}" if sq == skv else f"B={b},Sq={sq},Skv={skv}") + (
            f",H={hq}/{hkv},Dh={dh}") + (
            f",window={window}" if window else ",causal" if causal else ",bidirectional")
        run_case("flash_attention", group, arch, shape, BOTH, make, timed,
                 kcost.flash_work(b, hq, hkv, sq, skv, dh, causal=causal, window=window))

    for group, arch, b, s_max, length, window, timed in DECODE_CASES:
        cfg = get_config(arch, "full")
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        lo = max(0, length - window) if window else 0  # the keys a query sees

        def make(dtype):
            qd = randn((b, hq, dh), dtype)
            kc, vc = (randn((b, s_max, hkv, dh), dtype) for _ in range(2))
            n = torch.tensor(length, dtype=torch.int32, device=dev)
            calls = {"run": lambda: dk.decode_attention(qd, kc, vc, n, window=window),
                     "plain": lambda: dr.decode_attention(qd, kc, vc, n, window=window),
                     "library": None, "other": {}}
            if timed and length:  # SDPA on the valid prefix, laid out heads-first
                q4 = qd[:, :, None]
                kv = [t[:, lo:length].transpose(1, 2).contiguous() for t in (kc, vc)]
                calls["library"] = lambda: F.scaled_dot_product_attention(q4, *kv,
                                                                          enable_gqa=True)
            return calls

        shape = f"B={b},S_max={s_max},length={length},H={hq}/{hkv},Dh={dh}" + (
            f",window={window}" if window else "")
        run_case("decode_attention", group, arch, shape, BOTH, make, timed,
                 kcost.decode_work(b, hq, hkv, dh, length - lo), quick=True)

    for group, arch, t, dtypes, timed in SWIGLU_CASES:
        cfg = get_config(arch, "full")
        d, f = cfg.d_model, cfg.d_ff  # kimi: its shared expert's width

        def make(dtype):
            args = (randn((t, d), dtype), randn((d, f), dtype, d ** -0.5),
                    randn((d, f), dtype, d ** -0.5), randn((f, d), dtype, f ** -0.5))
            return {"run": lambda: sk.swiglu(*args), "plain": lambda: sr.swiglu(*args),
                    "library": None, "other": {}}

        run_case("swiglu", group, arch, f"T={t},D={d},F={f}", dtypes, make, timed,
                 kcost.swiglu_work(t, d, f))

    for group, arch, t, timed in MOE_CASES:
        cfg = get_config(arch, "full")
        e, d, f, cap = cfg.n_experts, cfg.d_model, cfg.expert_ff, ffn.moe_capacity(cfg, t)
        if arch == MIXTRAL and t == SERVE_B * SERVE_S:
            counts = torch.tensor(MOE_COUNTS, dtype=torch.int32, device=dev)
        else:  # each token's top-k of uniform scores
            pick = torch.rand(t, e, generator=gen, device=dev).topk(cfg.top_k).indices
            counts = pick.flatten().bincount(minlength=e).clamp(max=cap).to(torch.int32)
        keep = (torch.arange(cap, device=dev)[None, :] < counts[:, None])[..., None]

        def make(dtype):  # weights drawn in bf16: kimi's three are 33.8 GB
            buf = torch.where(keep, randn((e, cap, d), dtype), 0)
            args = (buf, *(torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(sc)
                           for shape, sc in (((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
                                             ((e, f, d), f ** -0.5))))
            return {"run": lambda: mk.experts(*args, counts),
                    "plain": lambda: mr.experts(*args, counts),
                    "library": lambda: ffn._experts(*args), "other": {}, "keep": keep}

        n = counts.tolist()
        with torch.no_grad():
            run_case("moe_experts", group, arch,
                     f"E={e},C={cap},D={d},F={f},filled={sum(n)},experts={sum(map(bool, n))}",
                     BF16, make, timed, kcost.moe_experts_work(n, d, f))
        del keep
    _build.LAUNCHES.clear()  # parity and timing launches are not the path's
    emit({"phase": "llm_kernels", "seconds": time.perf_counter() - t_phase, "cases": cases})

    rows = {}
    for kernel, source, replaces in (
            ("flash_attention", "flash_attention.cu", "kernels/flash_attention/kernel.py:106"),
            ("decode_attention", "decode_attention.cu", "kernels/decode_attention/kernel.py:94"),
            ("swiglu", "swiglu.cu", "kernels/swiglu/kernel.py:60"),
            ("moe_experts", "moe_experts.cu", "models/ffn.py:101")):  # its einsums, no kernel
        groups = dict(cases[kernel])
        err = max(r["max_abs_err"] for g in groups.values() for r in g.values())
        (shape, main), = groups.pop("main").items()
        rows[kernel] = dict(
            source=f"src/repro_torch/csrc/{source}", replaces=f"src/repro/{replaces}", shape=shape,
            **{k: v for k, v in main.items() if k not in ("max_abs_err", "timed")},
            max_abs_err=err,
            shapes={g: {c: {k: v for k, v in r.items() if k != "timed"}
                        for c, r in rs.items() if r["timed"]} for g, rs in groups.items()})
    return rows


def _cpu_copy(params):
    return {k: _cpu_copy(v) if isinstance(v, dict) else v.to("cpu", copy=True)
            for k, v in params.items()}


def card_vs_cpu(dev, cfg, phase, b=2, s=256, steps=8, bf16_tol=5e-2, n_patches=0):
    """``cfg`` with parameters drawn on the card from seed 1: a greedy run
    on the card (the kernels) against the CPU's plain versions
    teacher-forced on the card's tokens.  Logits within ``tol * (1 +
    |cpu|)`` (1e-3 in float32, ``bf16_tol`` in bf16), greedy tokens
    agreeing on all (float32) or >= 75 % (bf16).  ``n_patches``: the vlm
    prompt's stub patch embeddings ahead of its ``s`` tokens (qwen2-vl's
    grid layout of M-RoPE ids); the audio family's prompts carry
    ``enc_seq`` stub frames each.  The moe family's routing (each token's
    experts and kept pairs, every call and layer) must be equal card vs CPU
    in float32, the smallest top-k margin is recorded, and a token routed
    otherwise fails the phase with its margin; in bf16 the tokens routed
    otherwise are counted and their rows' logits left out of the
    comparison (a token within a rounding of another expert takes it)."""
    import torch

    from repro_torch.models import serve
    from repro_torch.models.common import mrope_positions
    from repro_torch.models.transformer import init_params

    cpu = torch.device("cpu")
    dtype = cfg.dtype
    tol = {torch.float32: 1e-3, torch.bfloat16: bf16_tol}[dtype]
    min_agree = {torch.float32: 1.0, torch.bfloat16: 0.75}[dtype]
    t_phase = time.perf_counter()
    params = init_params(cfg, seed=1, device=dev)
    params_cpu = _cpu_copy(params)
    gen = torch.Generator().manual_seed(3)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen)}
    if n_patches:
        prompt["patch_embeds"] = torch.randn(b, n_patches, cfg.d_model, generator=gen).to(dtype)
        prompt["positions_3d"] = mrope_positions(b, n_patches, s)
    if cfg.family == "audio":
        prompt["frames"] = torch.randn(b, cfg.enc_seq, cfg.d_model, generator=gen).to(dtype)
    moe = cfg.family == "moe"
    routes = {"card": [], "cpu": []}

    def routing(side):
        if not moe:
            return None
        routes[side].append([])
        return routes[side][-1]

    s_max = n_patches + s + steps
    cache = serve.init_cache(cfg, b, s_max, device=dev)
    lg, cache = serve.prefill(params, cfg, {k: v.to(dev) for k, v in prompt.items()}, cache,
                              device=dev, routing=routing("card"))
    card, fed = [lg.float().cpu()], []
    for _ in range(steps):
        tok = lg.argmax(-1)
        fed.append(tok.cpu())
        lg, cache = serve.decode_step(params, cfg, tok, cache, device=dev,
                                      routing=routing("card"))
        card.append(lg.float().cpu())
    t_cpu = time.perf_counter()
    cache_c = serve.init_cache(cfg, b, s_max, device=cpu)
    lg, cache_c = serve.prefill(params_cpu, cfg, prompt, cache_c, device=cpu,
                                routing=routing("cpu"))
    host = [lg.float()]
    for tok in fed:
        lg, cache_c = serve.decode_step(params_cpu, cfg, tok, cache_c, device=cpu,
                                        routing=routing("cpu"))
        host.append(lg.float())
    cpu_s = time.perf_counter() - t_cpu
    rows = [torch.ones(b, dtype=torch.bool) for _ in card]  # the logits rows compared
    route = None
    if moe:
        differ, margin = [], math.inf
        for c, (rc, rh) in enumerate(zip(routes["card"], routes["cpu"])):
            for layer, (x, y) in enumerate(zip(rc, rh)):
                same = ((x["experts"].cpu() == y["experts"]).all(1)
                        & (x["kept"].cpu() == y["kept"]).all(1))
                m = x["margin"].cpu()
                margin = min(margin, float(m.min()))
                n = m.shape[0] // b  # tokens per sequence in this call
                for t in torch.nonzero(~same).flatten().tolist():
                    differ.append({"call": c, "layer": layer, "token": t, "margin": float(m[t])})
                    seq, pos = divmod(t, n)
                    if pos == n - 1:  # the token whose logits the call compares
                        rows[c][seq] = False
        pairs = sum(int(x["kept"].numel()) for rc in routes["card"] for x in rc)
        dropped = sum(int((~x["kept"]).sum()) for rc in routes["card"] for x in rc)
        route = {"tokens_routed_otherwise": differ[:20], "n_routed_otherwise": len(differ),
                 "min_topk_margin": margin, "dropped_share": dropped / pairs,
                 "logit_rows_left_out": sum(int((~r).sum()) for r in rows)}
    errs = [close_err(a[r], c[r], tol) for a, c, r in zip(card, host, rows) if bool(r.any())]
    check(bool(errs), f"{phase} {cfg.arch}: every logits row routed otherwise")
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum()) for a, c in zip(card, host))
    share = agree / (b * (steps + 1))
    ok = all(e[1] for e in errs)
    name = dtype_name(dtype)
    emit({"phase": phase, "arch": cfg.arch, "dtype": name, "layers": cfg.n_layers,
          "experts": cfg.n_experts or None, "prompts": b, "prompt_tokens": s,
          "patches": n_patches, "frames": prompt["frames"].shape[1] if "frames" in prompt else 0,
          "greedy_steps": steps,
          "max_abs_logit_err": max(e[0] for e in errs), "tol": tol,
          "logits_within_tol": ok, "greedy_agree_share": share,
          "logit_abs_max": float(max(c.abs().max() for c in host)), "routing": route,
          "cache_length": [int(cache["length"]), int(cache_c["length"])],
          "cpu_seconds": cpu_s, "seconds": time.perf_counter() - t_phase})
    check(ok, f"{phase} {cfg.arch} {name}: logits differ beyond {tol}")
    check(share >= min_agree, f"{phase} {cfg.arch} {name}: greedy tokens agree on {share:.3f}")
    check(int(cache["length"]) == int(cache_c["length"]) == s_max,
          f"{phase} {cfg.arch}: cache length")
    if moe and dtype == torch.float32:
        check(not route["n_routed_otherwise"],
              f"{phase} {cfg.arch}: {route['n_routed_otherwise']} tokens routed otherwise on "
              f"the card than on the CPU, margins {route['tokens_routed_otherwise']}")
    del params, params_cpu, cache, cache_c
    torch.cuda.empty_cache()


# card_vs_cpu cases: (arch, its cut, prompts, prompt tokens, greedy steps),
# each in bf16 and float32.  The head-dim-128 archs take 1 x 128 prompt
# tokens and 4 steps (command-r's 256,000 x 8,192 embedding alone is 8.4 GB
# in float32 on the host, whose plain versions run the CPU half); mixtral
# one layer (2.5 B parameters, 10 GB in float32 on the host); kimi one
# layer with 32 of its 384 experts (top-8 and the shared expert kept: one
# full layer is 68 GB in float32 on the host); qwen2-vl with its 256 stub
# patches ahead of the tokens; zamba2's two layers hold one shared-block
# site; whisper 2 + 2 layers, 1,500 stub frames and 224 tokens per prompt.
CARD_VS_CPU = (
    (LLM_ARCH, dict(n_layers=2), 2, 256, 8),
    *((arch, dict(n_layers=2), 1, 128, 4) for arch in DENSE128_ARCHS),
    *((arch, dict(n_layers=2), 2, 256, 8) for arch in SSM_ARCHS),
    (QWEN_VL, dict(n_layers=2), 2, 128, 4),
    (MIXTRAL, dict(n_layers=1), 2, 128, 4),
    (KIMI, dict(n_layers=1, n_experts=32), 2, 128, 4),
    (WHISPER, dict(n_layers=2, enc_layers=2), 2, WHISPER_PROMPT, 8),
)


def card_vs_cpu_phase(dev):
    """Each ``CARD_VS_CPU`` case at full width through :func:`card_vs_cpu`.
    The decoders' bf16 logit tolerance is llama's 5e-2 times sqrt(d_model /
    2048) past llama's width: the two sides round their hidden states to
    bf16 at different places (the kernels keep attention's and the FFN's
    intermediates in float32, the plain versions round them), and the
    logit's share of that noise grows as the root of the width of the
    products it sums (0.079 / 0.094 / 0.100 at d_model 5,120 / 7,168 /
    8,192); the scan archs' and whisper's (d_model 1,024) is 5e-2."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.qwen2_vl_2b import N_PATCHES
    from repro_torch.models.transformer import DECODER_FAMILIES

    for arch, cut, b, s, steps in CARD_VS_CPU:
        cfg = get_config(arch, "full")
        decoder = cfg.family in DECODER_FAMILIES
        tol = 5e-2 * math.sqrt(max(cfg.d_model, D_MODEL) / D_MODEL) if decoder else 5e-2
        scan = cfg.family in ("ssm", "hybrid")
        for dtype in (torch.bfloat16, torch.float32):
            card_vs_cpu(dev, dataclasses.replace(cfg, dtype=dtype, **cut),
                        "ssm_card_vs_cpu" if scan else "llm_card_vs_cpu", b=b, s=s,
                        steps=steps, bf16_tol=tol,
                        n_patches=N_PATCHES if cfg.family == "vlm" else 0)


def profile_breakdown(fn, calls=1, expect=()):
    """(unprofiled wall ms, device kernel ms, rows) per call of ``fn``;
    rows: (kernel name, device us, launches) by device time; ``expect`` as
    :func:`profiled`'s."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls

    def run():
        for _ in range(calls):
            fn()

    rows = [(e.key, e.self_device_time_total / calls, e.count / calls)
            for e in profiled(run, expect)[0]
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows) / 1e3, rows


def breakdown_json(wall_ms, device_ms, rows):
    ours = {name: {"device_ms": sum(t for k, t, _c in rows if any(s in k for s in syms)) / 1e3,
                   "launches": sum(c for k, _t, c in rows if any(s in k for s in syms))}
            for name, syms in LLM_SYMBOLS.items()}
    return {"unprofiled_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_launches": sum(c for _k, _t, c in rows), "port_kernels": ours,
            "top": [{"kernel": k[:90], "device_ms": t / 1e3, "launches": c}
                    for k, t, c in rows[:10]]}


# Serving cells: prefill_32k (src/repro/configs/shapes.py:42) cut from 32 x
# 32768 to 4 x 4096 (SERVE_B x SERVE_S), and for mixtral to 2 x 8192, so
# its 4,096-token window cuts every query past 4096.  Depth cuts: mixtral
# at the most layers whose serving peak stays under 75 GB (5.0 GB of bf16
# weights a layer; `tools/train_peak.py mixtral-8x22b 12 13 --serve --batch
# 2 --seq 8192`: 66.95 / 72.02 GB), kimi at 1 of its 61 layers with all
# 384 experts (34.1 GB a layer, 4.7 GB of embeddings; 50.11 GB).  An arch
# cut in depth is planned under no name; the others serve whole.  whisper's
# cell is a batch of transcription windows (WHISPER_B x 1,500 frames, a
# WHISPER_PROMPT-token prompt) in a cache of WHISPER_SMAX rows.
SERVE_CELL = {MIXTRAL: (2, 8192), WHISPER: (WHISPER_B, WHISPER_PROMPT)}
SERVE_SMAX = {WHISPER: WHISPER_SMAX}
SERVE_LAYERS = {MIXTRAL: 13, KIMI: 1}
SERVED_ARCHS = (LLM_ARCH, PHI3_ARCH, *SSM_ARCHS, MIXTRAL, KIMI, QWEN_VL, WHISPER)


def serve_launch_rule(cfg, tokens: int = 0):
    """(prefill, one step) kernel launches of ``cfg``'s serving path: per
    prefill one ``flash_attention`` per decoder layer (dense, moe, vlm) or
    zamba2 shared-block site, one ``rwkv6_scan`` per rwkv6 layer, one
    ``ssd_scan`` per mamba layer; per step one ``decode_attention`` per
    decoder layer or site (the scans' steps run the plain recurrence); and
    per call two ``swiglu`` per layer or site that runs a SwiGLU on every
    token (all but the moe layers without a shared expert).  The routed
    experts run two ``moe_experts`` per moe layer in a prefill of
    ``tokens`` tokens whose capacity is at least ``MIN_SLOTS`` slots an
    expert; a step's few slots, and a forward under autograd (``tokens`` 0,
    as training's), run them on ``torch.bmm``.  whisper: per prefill one
    ``flash_attention`` per encoder layer and two (self, cross) per decoder
    layer, per step two ``decode_attention`` per decoder layer; its GELU
    MLP runs no kernel."""
    from repro_torch.kernels import LLM_KERNELS, SSM_KERNELS
    from repro_torch.kernels.moe_experts import MIN_SLOTS
    from repro_torch.models.ffn import moe_capacity
    from repro_torch.models.transformer import shared_sites

    zero = dict.fromkeys(LLM_KERNELS + SSM_KERNELS, 0)
    if cfg.family == "audio":
        return ({**zero, "flash_attention": cfg.enc_layers + 2 * cfg.n_layers},
                {**zero, "decode_attention": 2 * cfg.n_layers})
    if cfg.family == "ssm":
        return {**zero, "rwkv6_scan": cfg.n_layers}, dict(zero)
    if cfg.family == "hybrid":
        g = len(shared_sites(cfg))
        return ({**zero, "ssd_scan": cfg.n_layers, "flash_attention": g, "swiglu": 2 * g},
                {**zero, "decode_attention": g, "swiglu": 2 * g})
    ffn = 2 * cfg.n_layers if (cfg.n_experts == 0 or cfg.n_shared_experts > 0) else 0
    grouped = cfg.n_experts > 0 and tokens > 0 and moe_capacity(cfg, tokens) >= MIN_SLOTS
    return ({**zero, "flash_attention": cfg.n_layers, "swiglu": ffn,
             "moe_experts": 2 * cfg.n_layers if grouped else 0},
            {**zero, "decode_attention": cfg.n_layers, "swiglu": ffn})


def serve_phase(dev, arch):
    """``arch`` at full width in bf16 (parameters drawn on the card from
    seed 0; cut in depth to ``SERVE_LAYERS`` where it says so): its
    prefill cell of ``SERVE_CELL`` (default 4 x 4096; qwen2-vl's prompts
    are 256 stub patches ahead of 3,840 tokens) and 32 greedy steps, each
    kernel's launches exactly :func:`serve_launch_rule`, timed without
    diagnostics: prefill tokens / s, ms per step, peak memory (under
    ``TRAIN_PEAK_GB``) and ``torch.profiler`` breakdowns of a prefill and
    a step.  whisper's prompts carry ``enc_seq`` stub frames each (seeded
    standard normal in bf16) and its cache holds ``SERVE_SMAX`` rows.  The
    moe archs' dropped share of (token, slot) pairs comes from a second,
    untimed prefill and 32 steps that record the routing.
    The prefill's and the steps' own peaks (``max_memory_allocated`` after
    a reset just before each) and device ms per call (the profiles) go to
    the ``dryrun`` phase.  Returns (launches, prompts / s, step tokens / s,
    params, cfg, those measurements)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.qwen2_vl_2b import N_PATCHES
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import serve
    from repro_torch.models.common import mrope_positions
    from repro_torch.models.transformer import init_params, shared_sites
    from repro_torch.tree import flatten_with_paths

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS.get(arch, full.n_layers))
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    b, s = SERVE_CELL.get(arch, (SERVE_B, SERVE_S))
    patches = N_PATCHES if cfg.family == "vlm" else 0
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (b, s - patches), generator=gen, device=dev)}
    if patches:
        prompt["patch_embeds"] = torch.randn(b, patches, cfg.d_model, generator=gen,
                                             device=dev).to(cfg.dtype)
        prompt["positions_3d"] = mrope_positions(b, patches, s - patches, device=dev)
    if cfg.family == "audio":
        prompt["frames"] = torch.randn(b, cfg.enc_seq, cfg.d_model, generator=gen,
                                       device=dev).to(cfg.dtype)
    warm = serve.init_cache(cfg, 1, 160, device=dev)  # cuBLAS handles, first launches
    first = {"tokens": prompt["tokens"][:1, :128],
             **({"frames": prompt["frames"][:1]} if "frames" in prompt else {})}
    lg, warm = serve.prefill(params, cfg, first, warm, device=dev)
    serve.decode_step(params, cfg, lg.argmax(-1), warm, device=dev)
    del warm
    cache = serve.init_cache(cfg, b, SERVE_SMAX.get(arch, s + SERVE_STEPS), device=dev)
    want_pre, want_step = serve_launch_rule(cfg, b * s)
    want_steps = {k: n * SERVE_STEPS for k, n in want_step.items()}
    torch.cuda.synchronize()

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()  # each call's own peak, for the dry-run's
    LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, cache = serve.prefill(params, cfg, prompt, cache, device=dev)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pre_launches = {k: LAUNCHES[k] for k in want_pre}
    prefill_finite = bool(torch.isfinite(logits).all())
    cache_prefill = dict(cache)  # length S (the steps below update the tensors in place)
    tok = logits.argmax(-1)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        logits, cache = serve.decode_step(params, cfg, tok, cache, device=dev)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated()
    step_launches = {k: LAUNCHES[k] for k in want_steps}
    length = int(cache["length"])
    decode_finite = bool(torch.isfinite(logits).all())
    state_gb = sum(v.numel() * v.element_size() for v in cache.values()) / 1e9

    moe = cfg.family == "moe"
    dropped = {}
    if moe:  # the routing, recorded off the clock: moe_layer sorts its logits once more
        pre_routes, step_routes = [], []
        lg, c = serve.prefill(params, cfg, prompt, cache_prefill, device=dev,
                              routing=pre_routes)
        for _ in range(SERVE_STEPS):
            lg, c = serve.decode_step(params, cfg, lg.argmax(-1), c, device=dev,
                                      routing=step_routes)
        for key, routes in (("prefill", pre_routes), ("decode", step_routes)):
            pairs = sum(int(r["kept"].numel()) for r in routes)
            dropped[key] = sum(int((~r["kept"]).sum()) for r in routes) / pairs
        del lg, c, pre_routes, step_routes
    pre = breakdown_json(*profile_breakdown(
        lambda: serve.prefill(params, cfg, prompt, cache_prefill, device=dev),
        expect=[LLM_SYMBOLS[k] for k, n in want_pre.items() if n]))
    step = breakdown_json(*profile_breakdown(
        lambda: serve.decode_step(params, cfg, tok, cache_prefill, device=dev), calls=5,
        expect=[LLM_SYMBOLS[k] for k, n in want_step.items() if n]))
    peak_gb = max(peak_before, prefill_peak, step_peak, torch.cuda.max_memory_allocated()) / 1e9
    phase = ({"moe": "moe_serve", "vlm": "vlm_serve", "audio": "audio_serve"}.get(cfg.family)
             or ("llm_serve" if arch == LLM_ARCH else arch.split("-")[0] + "_serve"))
    emit({"phase": phase, "arch": arch, "layers": cfg.n_layers, "layers_full": full.n_layers,
          "sites": len(shared_sites(cfg)) if cfg.family == "hybrid" else None,
          "experts": cfg.n_experts or None, "dtype": "bfloat16", "params": cfg.params_count(),
          "weights_gb": 2 * sum(t.numel() for _k, t in flatten_with_paths(params)) / 1e9,
          "prompts": b, "prompt_tokens": s, "patches": patches,
          "frames": cfg.enc_seq if cfg.family == "audio" else 0,
          "cache_rows": SERVE_SMAX.get(arch, s + SERVE_STEPS), "decode_steps": SERVE_STEPS,
          "capacity_prefill": (max(1, int(cfg.capacity_factor * b * s * cfg.top_k
                                          / cfg.n_experts)) if moe else None),
          "capacity_step": (max(1, int(cfg.capacity_factor * b * cfg.top_k / cfg.n_experts))
                            if moe else None),
          "dropped_share_prefill": dropped.get("prefill"),
          "dropped_share_decode": dropped.get("decode"),
          "launches_prefill": pre_launches, "launches_prefill_expected": want_pre,
          "launches_decode": step_launches, "launches_decode_expected": want_steps,
          "cache_length": length, "cache_gb": state_gb, "init_seconds": init_s,
          "prefill_seconds": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
          "prefill_prompts_per_s": b / prefill_s,
          "decode_ms_per_step": decode_s * 1e3 / SERVE_STEPS,
          "decode_tokens_per_s": b * SERVE_STEPS / decode_s,
          "prefill_profile": pre, "decode_step_profile": step, "peak_memory_gb": peak_gb,
          "prefill_peak_gb": prefill_peak / 1e9, "decode_peak_gb": step_peak / 1e9,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu"),
          "seconds": time.perf_counter() - t_phase})
    check(prefill_finite and decode_finite, f"{phase} {arch}: non-finite logits")
    check(length == s + SERVE_STEPS, f"{phase} {arch}: cache length {length}")
    check(pre_launches == want_pre,
          f"{phase} {arch} prefill: launches {pre_launches}, expected {want_pre}")
    check(step_launches == want_steps,
          f"{phase} {arch} decode: launches {step_launches}, expected {want_steps}")
    check(peak_gb < TRAIN_PEAK_GB, f"{phase} {arch}: peak memory {peak_gb:.2f} GB")
    del cache, cache_prefill, prompt
    torch.cuda.empty_cache()
    launches = {k: pre_launches[k] + step_launches[k] for k in want_pre}
    measured = {"arch": arch, "layers": cfg.n_layers, "b": b, "s": s,
                "cache_rows": SERVE_SMAX.get(arch, s + SERVE_STEPS),
                "prefill_device_ms": pre["device_ms"], "step_device_ms": step["device_ms"],
                "prefill_peak_bytes": prefill_peak, "step_peak_bytes": step_peak}
    return launches, b / prefill_s, b * SERVE_STEPS / decode_s, params, cfg, measured


def llm_decode_32k_phase(dev, params, cfg):
    """The decode step against 16 x 32,000 cached tokens; returns
    (launches, tokens/s)."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import serve

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cache = serve.init_cache(cfg, DEC_B, DEC_SMAX, device=dev)
    gen = torch.Generator(device=dev).manual_seed(32)
    for key in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[key][layer].normal_(generator=gen)
    cache["length"] = torch.full((), DEC_LEN, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab, (DEC_B,), generator=gen, device=dev)
    serve.decode_step(params, cfg, tok, cache, device=dev)  # warm-up (rewritten below)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t_phase

    LAUNCHES.clear()
    t0 = time.perf_counter()
    step_cache = cache
    for _ in range(DEC_STEPS):
        logits, step_cache = serve.decode_step(params, cfg, tok, step_cache, device=dev)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DEC_STEPS
    want = {k: n * DEC_STEPS for k, n in serve_launch_rule(cfg)[1].items()}
    launches = {k: LAUNCHES[k] for k in want}
    finite = bool(torch.isfinite(logits).all())
    length = int(step_cache["length"])
    prof = breakdown_json(*profile_breakdown(
        lambda: serve.decode_step(params, cfg, tok, cache, device=dev), calls=3))
    # The step's bound: the valid K / V prefix of every layer (after this
    # step's write) and every weight once, over the HBM rate.
    kv = [2 * cfg.n_layers * DEC_B * (DEC_LEN + 1 + i) * cfg.kv_dim * 2 for i in range(DEC_STEPS)]
    weights = 2 * cfg.params_count()
    bound_ms = (sum(kv) / DEC_STEPS + weights) / PEAK_BYTES_PER_S * 1e3
    emit({"phase": "llm_decode_32k", "batch": DEC_B, "s_max": DEC_SMAX, "length_start": DEC_LEN,
          "steps": DEC_STEPS, "cache_gb": 2 * cache["k"].numel() * 2 / 1e9,
          "launches": launches, "launches_expected": want, "cache_length": length,
          "ms_per_step": step_s * 1e3, "tokens_per_s": DEC_B / step_s,
          "bound_ms_per_step": bound_ms, "bound_share": bound_ms / (step_s * 1e3),
          "profile": prof, "fill_seconds": fill_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu"),
          "seconds": time.perf_counter() - t_phase})
    check(finite, "llm_decode_32k: non-finite logits")
    check(length == DEC_LEN + DEC_STEPS, f"llm_decode_32k: cache length {length}")
    check(launches == want, f"llm_decode_32k: launches {launches}, expected {want}")
    del cache, step_cache
    torch.cuda.empty_cache()
    return launches, DEC_B / step_s


def long_500k_phase(dev, arch):
    """The ``long_500k`` shape on the card through the serving entry points
    (``init_cache`` / ``prefill`` / ``decode_step``) for ``arch`` at full
    width in bf16, cut in depth as ``LONG_LAYERS`` says, batch 1, a
    ``LONG_S``-row cache: rwkv6's state from one prefill of
    ``LONG_PREFILL`` seeded tokens, zamba2's and mixtral's K / V (and
    zamba2's SSM states) drawn on the card, layer by layer or site by site,
    from a seeded generator; ``length`` set to ``LONG_LEN``.  One warm-up
    step on a small cache, then ``LONG_STEPS`` greedy steps timed with CUDA
    events to a full cache, their launches exactly
    :func:`serve_launch_rule`; then one step on the full cache, which must
    write the cache's last row (the reference's ``dynamic_update_slice``
    clamps its start there), leave the row before it and stay finite.
    Reported: ms per step beside the step's bound (every weight -- the MoE
    decode reads every expert -- the valid K / V rows a layer or site reads
    after its write, and the recurrent state read and written, over 3.35
    TB/s), a ``torch.profiler`` breakdown of a step, the peaks of the fill,
    the steps and the full-cache step (each under ``TRAIN_PEAK_GB``), and
    RoPE at the last 64 positions on the card against the CPU (within 4e-7
    of (1 + the row's largest |x|): both rotate by the CPU's frequency
    table).  Returns (launches, the dry-run's measurements)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import serve
    from repro_torch.models.common import apply_rope
    from repro_torch.models.transformer import init_params, shared_sites
    from repro_torch.tree import flatten_with_paths

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, n_layers=LONG_LAYERS.get(arch, full.n_layers))
    params = init_params(cfg, seed=0, device=dev)
    weights = 2 * sum(t.numel() for _k, t in flatten_with_paths(params))
    gen = torch.Generator(device=dev).manual_seed(500)
    tok = torch.randint(0, cfg.vocab, (1,), generator=gen, device=dev)
    serve.decode_step(params, cfg, tok, serve.init_cache(cfg, 1, 256, device=dev),
                      device=dev)  # cuBLAS handles, first launches
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    want_pre, want_step = serve_launch_rule(cfg)

    t0 = time.perf_counter()
    cache = serve.init_cache(cfg, 1, LONG_S, device=dev)
    prefill = {}
    if cfg.family == "ssm":
        prompt = torch.randint(0, cfg.vocab, (1, LONG_PREFILL), generator=gen, device=dev)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t1 = time.perf_counter()
        logits, cache = serve.prefill(params, cfg, {"tokens": prompt}, cache, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        prefill = {"tokens": LONG_PREFILL, "seconds": seconds,
                   "tokens_per_s": LONG_PREFILL / seconds,
                   "launches": {k: LAUNCHES[k] for k in want_pre},
                   "launches_expected": want_pre,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(bool(torch.isfinite(logits).all()), f"long_500k {arch}: non-finite prefill logits")
        check(prefill["launches"] == want_pre,
              f"long_500k {arch} prefill: launches {prefill['launches']}, expected {want_pre}")
        tok = logits.argmax(-1)
        del prompt, logits
    else:
        for key in ("k", "v", "ssm"):
            for i in range(cache[key].shape[0] if key in cache else 0):
                cache[key][i].normal_(generator=gen)
    cache["length"] = torch.full((), LONG_LEN, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(v.numel() * v.element_size() for v in cache.values())

    torch.cuda.reset_peak_memory_stats()
    want_steps = {k: n * LONG_STEPS for k, n in want_step.items()}
    LAUNCHES.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LONG_STEPS):
        logits, cache = serve.decode_step(params, cfg, tok, cache, device=dev)
        tok = logits.argmax(-1)
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / LONG_STEPS
    step_launches = {k: LAUNCHES[k] for k in want_steps}
    step_peak = torch.cuda.max_memory_allocated()
    length = int(cache["length"])
    finite = bool(torch.isfinite(logits).all())

    # one step on the full cache: the last row rewritten, the one before kept
    torch.cuda.reset_peak_memory_stats()
    kv = "k" in cache
    if kv:  # the last site's or layer's last two rows
        tail = cache["k"][-1, 0, LONG_S - 2:].clone()
    LAUNCHES.clear()
    full_logits, full_cache = serve.decode_step(params, cfg, tok, cache, device=dev)
    torch.cuda.synchronize()
    full_launches = {k: LAUNCHES[k] for k in want_step}
    full_peak = torch.cuda.max_memory_allocated()
    full_length = int(full_cache["length"])
    full_finite = bool(torch.isfinite(full_logits).all())
    wrote_last = (not kv or (torch.equal(cache["k"][-1, 0, LONG_S - 2], tail[0])
                             and not torch.equal(cache["k"][-1, 0, LONG_S - 1], tail[1])))
    prof = breakdown_json(*profile_breakdown(
        lambda: serve.decode_step(params, cfg, tok, cache, device=dev), calls=3,
        expect=[LLM_SYMBOLS[k] for k, n in want_step.items() if n]))

    # The step's bound: every weight once, the valid K / V rows a layer or
    # site reads after its write (mixtral: its window), and the recurrent
    # state read and written.
    def kv_rows(i):
        rows = min(LONG_LEN + 1 + i, LONG_S)
        return min(rows, cfg.swa_window) if cfg.attention == "swa" else rows

    sites = len(shared_sites(cfg)) if cfg.family == "hybrid" else cfg.n_layers
    kv_bytes = (0 if not kv else sum(2 * sites * kv_rows(i) * cfg.kv_dim * 2
                                     for i in range(LONG_STEPS)) / LONG_STEPS)
    recurrent = 2 * sum(v.numel() * v.element_size() for k, v in cache.items()
                        if k in ("wkv", "tm_shift", "cm_shift", "ssm"))
    bound_ms = (weights + kv_bytes + recurrent) / PEAK_BYTES_PER_S * 1e3

    rope = None
    if cfg.family != "ssm":  # RoPE's float32 angles at ~5e5 rad, card against CPU
        x = torch.randn((1, 64, 2, cfg.head_dim_), generator=gen, device=dev)
        pos = torch.arange(LONG_S - 64, LONG_S, device=dev)[None]
        got = apply_rope(x, pos, cfg.rope_theta)
        want = apply_rope(x.cpu(), pos.cpu(), cfg.rope_theta)
        limit = 4e-7 * (1 + x.abs().amax(-1, keepdim=True).cpu())
        rope = {"positions": [LONG_S - 64, LONG_S - 1], "head_dim": cfg.head_dim_,
                "theta": cfg.rope_theta, "max_abs_err": float((got.cpu() - want).abs().max()),
                "x_max": float(x.abs().max()),
                "ok": bool(((got.cpu() - want).abs() <= limit).all())}
    peak_gb = max(fill_peak, step_peak, full_peak) / 1e9
    emit({"phase": "long_500k", "arch": arch, "layers": cfg.n_layers,
          "layers_full": full.n_layers,
          "sites": len(shared_sites(cfg)) if cfg.family == "hybrid" else None,
          "window": cfg.swa_window if cfg.attention == "swa" else None, "dtype": "bfloat16",
          "batch": 1, "cache_rows": LONG_S, "length_start": LONG_LEN, "steps": LONG_STEPS,
          "weights_gb": weights / 1e9, "cache_gb": state_bytes / 1e9, "prefill": prefill,
          "init_seconds": init_s, "fill_seconds": fill_s, "ms_per_step": ms_per_step,
          "tokens_per_s": 1e3 / ms_per_step, "bound_ms_per_step": bound_ms,
          "bound_share": bound_ms / ms_per_step, "step_profile": prof,
          "launches": step_launches, "launches_expected": want_steps,
          "cache_length": length, "full_cache_step": {
              "length": full_length, "launches": full_launches, "finite": full_finite,
              "wrote_last_row": wrote_last, "peak_gb": full_peak / 1e9},
          "fill_peak_gb": fill_peak / 1e9, "step_peak_gb": step_peak / 1e9,
          "peak_memory_gb": peak_gb, "rope_card_vs_cpu": rope,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu"),
          "seconds": time.perf_counter() - t_phase})
    check(finite and full_finite, f"long_500k {arch}: non-finite logits")
    check(length == LONG_S and full_length == LONG_S + 1,
          f"long_500k {arch}: cache length {length}, then {full_length}")
    check(step_launches == want_steps,
          f"long_500k {arch}: launches {step_launches}, expected {want_steps}")
    check(full_launches == want_step,
          f"long_500k {arch} full-cache step: launches {full_launches}, expected {want_step}")
    check(wrote_last, f"long_500k {arch}: the full-cache step did not write only the last row")
    check(rope is None or rope["ok"],
          f"long_500k {arch}: RoPE at the last positions differs card vs CPU ({rope})")
    check(peak_gb < TRAIN_PEAK_GB, f"long_500k {arch}: peak memory {peak_gb:.2f} GB")
    launches = {k: step_launches[k] + full_launches[k] + prefill.get("launches", {}).get(k, 0)
                for k in want_step}
    measured = {"arch": arch, "layers": cfg.n_layers, "b": 1, "s": LONG_S,
                "cache_rows": LONG_S, "step_device_ms": prof["device_ms"],
                "step_peak_bytes": step_peak}
    del params, cache, full_cache, logits, full_logits
    torch.cuda.empty_cache()
    return launches, measured


def serving_plan_phase(prompts_per_s, tokens_per_s, arch=LLM_ARCH):
    """DRS's chip split of the serving pipeline from the card's own rates of
    the arch's serving cell (default B = 4: a 4 x 4096 prefill's prompts /
    s, the B = 4 decode step's tokens / s; whisper B = 16), through the
    port's launcher (``launch/serve.py``:
    ``stage_rates``, ``plan`` at its defaults of 4 requests / s, 24 chips
    and 64 tokens, then ``serving_sim``); returns the rates and the split."""
    from repro_torch.launch import serve as launcher

    rates, src = launcher.stage_rates(arch, prefill_rate=prompts_per_s,
                                      decode_rate=tokens_per_s)
    model, alloc, split = launcher.plan(rates, 4.0, chips=24, mean_tokens=64.0)
    b, s = SERVE_CELL.get(arch, (SERVE_B, SERVE_S))
    emit({"phase": "serving_plan", "arch": arch, "rates_from": src,
          "cell": f"B = {b}: {b} x {s} prefill, B = {b} decode step",
          "rates": {"prefill_prompts_per_s_per_chip": prompts_per_s,
                    "decode_tokens_per_s_per_chip": tokens_per_s},
          "lam0": 4.0, "k_max": 24, "mean_output_tokens": 64, "split": split,
          "expected_sojourn_s": alloc.expected_sojourn,
          "expected_latency_s": model.expected_latency(4.0, split)})
    check(split["prefill"] >= 1 and split["decode"] >= 1, f"serving_plan: split {split}")
    serving_sim_phase(model, split, arch)
    return {"prefill": prompts_per_s, "decode": tokens_per_s, "split": split}


def serving_sim_phase(model, split, arch):
    """The plan just printed through the launcher's discrete-event serving
    simulation (host code): simulated mean and p95 latency beside the
    model's E[T]."""
    from repro_torch.launch import serve as launcher

    t0 = time.perf_counter()
    rep = launcher.simulate(model, split, 4.0, horizon=600.0)
    emit({"phase": "serving_sim", "arch": arch, "split": split, "lam0": 4.0,
          "horizon_s": 600.0, "warmup_s": 60.0, "completed": rep.completed,
          "mean_latency_s": rep.mean_latency, "p95_latency_s": rep.p95_latency,
          "model_latency_s": rep.model_latency,
          "mean_over_model": rep.mean_latency / rep.model_latency,
          "seconds": time.perf_counter() - t0})
    check(rep.completed > 0 and math.isfinite(rep.mean_latency)
          and math.isfinite(rep.p95_latency),
          f"serving_sim: {rep.completed} completed, mean {rep.mean_latency}, "
          f"p95 {rep.p95_latency}")


# The dry-run (launch/dryrun.py): the serving records of the six planned
# archs and the long_500k records of its three archs on pod16x16, and the
# card's own serving shapes costed on a one-device mesh and held to what
# the card did in this run (keys of the measurements: the served arch, or
# "{arch} long_500k").
DRYRUN_ARCHS = (LLM_ARCH, *SSM_ARCHS, PHI3_ARCH, QWEN_VL, WHISPER)
DRYRUN_HELD = ((LLM_ARCH, "prefill"), (LLM_ARCH, "step"), (PHI3_ARCH, "prefill"),
               (f"{ZAMBA} long_500k", "step"), (f"{MIXTRAL} long_500k", "step"))
DRYRUN_PEAK_FACTOR = 1.5  # the predicted peak against max_memory_allocated, either way
# The roofline plans' pool: a record's prefill serves 32k-token prompts, so
# zamba2's and phi3's 4 requests / s need ~50 chips (24 serve the card's
# 4,096-token cells).
DRYRUN_CHIPS = 64


def dryrun_phase(measured):
    """``python -m repro_torch.launch.dryrun``'s ``run_cell`` (host code on
    meta tensors) for ``prefill_32k`` and ``decode_32k`` of
    :data:`DRYRUN_ARCHS` and ``long_500k`` of :data:`LONG_ARCHS` on
    pod16x16, at full depth, each record saved under ``build/dryrun`` with
    its dominant term and bound printed; then each shape of
    :data:`DRYRUN_HELD` -- the serving cell ``serve_phase`` or
    ``long_500k_phase`` ran (``measured``: arch, layers, batch, prompt,
    cache rows; a step reads its whole cache, or its window)
    -- costed on a one-device mesh: its roofline bound must not exceed the
    device ms the card took for it (a bound above it would mean the model
    overcounts), and its predicted peak (arguments + temporaries) must be
    within :data:`DRYRUN_PEAK_FACTOR` of ``max_memory_allocated`` over that
    call."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW, LogicalMesh

    t0 = time.perf_counter()
    records = {}
    cells = [(a, s) for a in DRYRUN_ARCHS for s in ("prefill_32k", "decode_32k")]
    for arch, shape in cells + [(a, "long_500k") for a in LONG_ARCHS]:
        rec = dryrun.run_cell(arch, shape)
        check(rec["status"] == "ok", f"dryrun {arch} {shape}: {rec.get('error')}")
        path = str(dryrun.save_record(rec).relative_to(ROOT))
        r = rec["roofline"]
        records[f"{arch} {shape}"] = {
            "dominant": r["dominant"], "bound_s": max(r["compute_s"], r["memory_s"],
                                                      r["collective_s"]),
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "trace_s": rec["trace_s"],
            "temp_gb": rec["memory_analysis"]["temp_size_in_bytes"] / 1e9, "record": path}
    records_s = time.perf_counter() - t0
    one = LogicalMesh((1, 1, 1), ("pod", "data", "model"))
    held = {}
    for key, what in DRYRUN_HELD:
        m = measured[key]
        arch = m["arch"]
        kind = "prefill" if what == "prefill" else "decode"
        cfg = dataclasses.replace(get_config(arch, "full"), n_layers=m["layers"])
        mem, cost = dryrun.step_cost(cfg, kind, m["b"], m["s"], one,
                                     shd.rules_for(kind, arch=arch), cache_rows=m["cache_rows"])
        compute_ms = cost.flops / HW.PEAK_FLOPS_BF16 * 1e3
        memory_ms = cost.traffic_bytes / HW.HBM_BW * 1e3
        bound_ms = max(compute_ms, memory_ms)
        device_ms = m[f"{what}_device_ms"]
        peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        card_peak = m[f"{what}_peak_bytes"]
        held[f"{key} {what}"] = {
            "layers": m["layers"], "batch": m["b"], "prompt": m["s"],
            "cache_rows": m["cache_rows"],
            "flops": cost.flops, "traffic_bytes": cost.traffic_bytes, "compute_ms": compute_ms,
            "memory_ms": memory_ms, "bound_ms": bound_ms, "device_ms": device_ms,
            "bound_over_device": bound_ms / device_ms, "predicted_peak_gb": peak / 1e9,
            "card_peak_gb": card_peak / 1e9, "peak_over_card": peak / card_peak}
        check(bound_ms <= device_ms,
              f"dryrun {key} {what}: bound {bound_ms:.3f} ms above the card's {device_ms:.3f}")
        check(1 / DRYRUN_PEAK_FACTOR <= peak / card_peak <= DRYRUN_PEAK_FACTOR,
              f"dryrun {key} {what}: predicted peak {peak / 1e9:.3f} GB against the card's "
              f"{card_peak / 1e9:.3f} GB")
    emit({"phase": "dryrun", "mesh": "pod16x16", "hw": HW.NAME, "records": records,
          "records_seconds": records_s, "held_to_the_card": held,
          "card": smi("name,power.limit"), "seconds": time.perf_counter() - t0})


def dryrun_train_phase(card_peak):
    """:func:`dryrun_phase`'s held train shape, once ``train`` has run it:
    the dry-run's ``step_cost`` of llama3.2-1b cut as ``TRAIN_CUTS`` says,
    a ``TRAIN_B`` x ``TRAIN_S`` batch, float32 moments, on a one-device
    mesh (every layer rematerialised, as the port trains); its predicted
    peak (arguments + temporaries) must be within
    :data:`DRYRUN_PEAK_FACTOR` of ``card_peak``, the ``train`` run's
    ``max_memory_allocated``.  Its roofline bound is reported beside."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW, LogicalMesh

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_ARCH, "full"), **TRAIN_CUTS[LLM_ARCH])
    one = LogicalMesh((1, 1, 1), ("pod", "data", "model"))
    mem, cost = dryrun.step_cost(cfg, "train", TRAIN_B, TRAIN_S, one,
                                 shd.rules_for("train", arch=LLM_ARCH))
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    emit({"phase": "dryrun_train", "arch": LLM_ARCH, "layers": cfg.n_layers, "batch": TRAIN_B,
          "seq_len": TRAIN_S, "flops": cost.flops, "traffic_bytes": cost.traffic_bytes,
          "kernel_calls": dict(cost.kernel_calls),
          "bound_ms": max(cost.flops / HW.PEAK_FLOPS_BF16, cost.traffic_bytes / HW.HBM_BW) * 1e3,
          "argument_gb": mem["argument_size_in_bytes"] / 1e9,
          "temp_gb": mem["temp_size_in_bytes"] / 1e9, "predicted_peak_gb": peak / 1e9,
          "card_peak_gb": card_peak / 1e9, "peak_over_card": peak / card_peak,
          "card": smi("name,power.limit"), "seconds": time.perf_counter() - t0})
    check(1 / DRYRUN_PEAK_FACTOR <= peak / card_peak <= DRYRUN_PEAK_FACTOR,
          f"dryrun train {LLM_ARCH}: predicted peak {peak / 1e9:.3f} GB against the card's "
          f"{card_peak / 1e9:.3f} GB")


def launch_serve_phase(plans):
    """``python -m repro_torch.launch.serve`` as a user runs it, in this
    process (``main(argv)``), for each arch on its B = 4 rates measured
    above (``--prefill-rate`` / ``--decode-rate``, ``--horizon 600``): the
    split must be the one ``serving_plan`` printed, every request finite;
    then once per :data:`DRYRUN_ARCHS` arch with no rates (``--chips
    64 --horizon 120``): the rates must come from the ``dryrun`` phase's records
    (``"dry-run roofline"``), every request finite."""
    import contextlib
    import io

    from repro_torch.launch import serve as launcher

    t0 = time.perf_counter()
    out = {}
    for arch, plan in plans.items():
        argv = ["--arch", arch, "--prefill-rate", repr(plan["prefill"]),
                "--decode-rate", repr(plan["decode"]), "--horizon", "600"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = launcher.main(argv)
        rep = res["report"]
        out[arch] = {"argv": argv, "source": res["source"], "split": res["split"],
                     "expected_sojourn_s": res["alloc"].expected_sojourn,
                     "mean_latency_s": rep.mean_latency, "p95_latency_s": rep.p95_latency,
                     "completed": rep.completed, "printed_lines": len(buf.getvalue().splitlines())}
        check(res["split"] == plan["split"] and res["source"] == "measured on the card",
              f"launch_serve {arch}: split {res['split']} from {res['source']}, "
              f"serving_plan had {plan['split']}")
        check(rep.completed > 0 and math.isfinite(rep.mean_latency),
              f"launch_serve {arch}: {rep.completed} completed")
    roofline = {}
    for arch in DRYRUN_ARCHS:
        argv = ["--arch", arch, "--chips", str(DRYRUN_CHIPS), "--horizon", "120"]
        with contextlib.redirect_stdout(io.StringIO()):
            res = launcher.main(argv)
        rep, rates = res["report"], res["rates"]
        roofline[arch] = {"argv": argv, "source": res["source"], "split": res["split"],
                          "prefill_per_chip": rates.prefill_per_chip,
                          "decode_per_chip": rates.decode_per_chip,
                          "expected_sojourn_s": res["alloc"].expected_sojourn,
                          "mean_latency_s": rep.mean_latency, "completed": rep.completed}
        check(res["source"] == "dry-run roofline",
              f"launch_serve {arch}: rates from {res['source']}, not the dry-run records")
        check(rep.completed > 0 and math.isfinite(rep.mean_latency),
              f"launch_serve {arch} (dry-run rates): {rep.completed} completed")
    emit({"phase": "launch_serve", "archs": out, "dryrun_plans": roofline,
          "seconds": time.perf_counter() - t0})

# --------------------------------------------------------------------------- #
# Phase 14: the scans of the ssm and hybrid families (rwkv6-1.6b, zamba2-7b)
# --------------------------------------------------------------------------- #
# rwkv6-1.6b: 32 WKV heads of 64, chunk 32; zamba2-7b: 112 SSD heads of 64,
# state 64, chunk 64.
RWKV_H, RWKV_D, SSD_H, SSD_D = 32, 64, 112, 64
# The scans against their plain versions: both compute in float32 (the
# kernel with fmaf, its own summation order and exp of a difference where
# the plain version subtracts in another order), so float32 is held to
# 1e-4 of (1 + the output row's largest |value|) -- states carried over
# 4096 steps and outputs that cancel carry their row's rounding -- and bf16,
# rounded once from those values, to two ulps of the row's largest value.
SCAN_TOL = {"bfloat16": (2 ** -6, "row"), "float32": (1e-4, "row1")}


def scan_bound(work, tensor_cores):
    """(ms, "bytes" or "operations"): the least time of a scan call, its
    bytes over 3.35 TB/s against its operations -- in bf16 the products
    over the 989 TFLOP/s tensor cores plus the rest over the 67 TFLOP/s
    float32 rate, in float32 all at 67 TFLOP/s."""
    nbytes, ops, mma = work
    if not tensor_cores:
        return bound(nbytes, ops)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (mma / PEAK_BF16_OPS_PER_S + (ops - mma) / PEAK_F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssm_kernels_phase(dev):
    """``rwkv6_scan`` and ``ssd_scan`` against their plain versions at the
    serving shapes (B = 4, S = 4096) in bf16 and float32 with seeded decays
    spread over the models' clamp ranges and a non-zero initial state, at
    the clamp floors against a float64 step recurrence, in the [BH] layout
    with a short last chunk; each timed.  (The attention and SwiGLU kernels
    at zamba2's widths are ``llm_kernels``' "zamba2" cases.)  Returns the
    two scans' kernel-table rows."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.cost import scan_work
    from repro_torch.kernels.rwkv6_scan import kernel as rk, ref as rr
    from repro_torch.kernels.ssd_scan import kernel as sk, ref as sr

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(91)
    bf16, f32 = torch.bfloat16, torch.float32
    heavy = dict(runs=5, inner=2)
    b, s = SERVE_B, SERVE_S
    rows, extra = {}, {}

    def randn(shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def log_uniform(shape, lo, hi):  # -exp(U(log lo, log hi)): log-decays in [-hi, -lo]
        x = torch.rand(shape, generator=gen, device=dev) * (math.log(hi) - math.log(lo))
        return -torch.exp(x + math.log(lo))

    # rwkv6: the model's [B, S, H, D] projections as [B, H, S, D] views; log-
    # decays over [log 0.05, log 0.9995] (the model's clamp), a bonus per
    # head, a non-zero state.
    def rwkv_inputs(dtype, bb=b, ss=s, hh=RWKV_H, floor=None):
        r, k, v = (randn((bb, ss, hh, RWKV_D), dtype).transpose(1, 2) for _ in range(3))
        lw = log_uniform((bb, ss, hh, RWKV_D), 5e-4, -math.log(0.05)).transpose(1, 2)
        if floor is not None:  # every decay at w = floor
            lw = torch.full_like(lw, math.log(floor))
        u = torch.rand((hh, RWKV_D), generator=gen, device=dev) * 0.6 - 0.3
        return r, k, v, lw, u, randn((bb, hh, RWKV_D, RWKV_D))

    def rwkv_f64(r, k, v, lw, u, s0):
        r, k, v, w = (t.double() for t in (r, k, v, lw.exp()))
        st, u = s0.double(), u.double()
        out = torch.empty_like(v)
        for t in range(r.shape[2]):
            kv = k[:, :, t, :, None] * v[:, :, t, None, :]
            out[:, :, t] = torch.einsum("bhk,bhkv->bhv", r[:, :, t], st + u[..., None] * kv)
            st = w[:, :, t, :, None] * st + kv
        return out, st

    err = 0.0
    for dtype in (f32, bf16):
        args = rwkv_inputs(dtype)
        o, st = rk.rwkv6_scan(*args, chunk=32)
        po, pst = rr.rwkv6_scan(*args, chunk=32)
        case = f"B={b},S={s},H={RWKV_H},D={RWKV_D},{dtype_name(dtype)},chunk=32"
        e = hold("ssm_parity", "rwkv6_scan", case, o, po, SCAN_TOL[dtype_name(dtype)])
        hold("ssm_parity", "rwkv6_scan", case + ",state", st, pst, SCAN_TOL["float32"])
        err = max(err, e) if dtype == bf16 else err
        if dtype == f32:
            extra["rwkv6_scan_float32"] = {
                "ms": median_ms(lambda: rk.rwkv6_scan(*args, chunk=32), **heavy),
                "plain_ms": median_ms(lambda: rr.rwkv6_scan(*args, chunk=32), runs=3, inner=1),
                "bound_ms": scan_bound(scan_work("rwkv6", b, RWKV_H, s, RWKV_D, RWKV_D, 32, 4),
                                       False)[0]}
    # The serving shape runs the tensor-core kernel, not the CUDA-core one.
    ran = [k for k, _t, _c in profile_breakdown(lambda: rk.rwkv6_scan(*args, chunk=32),
                                                expect=(LLM_SYMBOLS["rwkv6_scan"],))[2]]
    check(any("rwkv6_mma_kernel" in k for k in ran)
          and not any("rwkv6_scan_kernel" in k for k in ran),
          f"rwkv6_scan bf16 at the serving shape ran {ran}, not rwkv6_mma_kernel")
    emit({"phase": "ssm_parity", "kernel": "rwkv6_scan", "route": "rwkv6_mma_kernel",
          "vb": rk.plan(b, RWKV_H, RWKV_D, RWKV_D, _build.sm_count(dev.index or 0),
                        tensor_cores=True)})
    rows["rwkv6_scan"] = dict(
        source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan/kernel.py:89",
        shape=f"B={b},S={s},H={RWKV_H},Dk=Dv={RWKV_D},bf16,chunk=32", max_abs_err=err,
        ms=median_ms(lambda: rk.rwkv6_scan(*args, chunk=32), **heavy),
        plain_ms=median_ms(lambda: rr.rwkv6_scan(*args, chunk=32), runs=3, inner=1),
        library_ms=None,
        device_us=device_us_per_call(lambda: rk.rwkv6_scan(*args, chunk=32),
                                     LLM_SYMBOLS["rwkv6_scan"]),
        bound=scan_bound(scan_work("rwkv6", b, RWKV_H, s, RWKV_D, RWKV_D, 32, 2), True),
    )
    for dtype in (f32, bf16):  # bf16: the tensor cores' anchored factors at chunk 32
        args = rwkv_inputs(dtype, bb=1, ss=256, hh=4, floor=0.05)
        o, st = rk.rwkv6_scan(*args, chunk=32)
        wo, wst = rwkv_f64(*args)
        case = f"floor w=0.05,B=1,S=256,H=4,{dtype_name(dtype)} vs float64 steps"
        hold("ssm_parity", "rwkv6_scan", case, o, wo.to(dtype), SCAN_TOL[dtype_name(dtype)])
        hold("ssm_parity", "rwkv6_scan", case + ",state", st, wst.float(), SCAN_TOL["float32"])
    # bf16 past the anchors' span: every chunk on the exact per-pair loop
    # (w = 1e-8, the ssm module's clamp; chunk 64 at the floor).
    for floor, chunk in ((1e-8, 32), (0.05, 64)):
        args = rwkv_inputs(bf16, bb=1, ss=256, hh=4, floor=floor)
        o, st = rk.rwkv6_scan(*args, chunk=chunk)
        po, pst = rr.rwkv6_scan(*args, chunk=chunk)
        case = f"floor w={floor},B=1,S=256,H=4,bfloat16,chunk={chunk}"
        hold("ssm_parity", "rwkv6_scan", case, o, po, SCAN_TOL["bfloat16"])
        hold("ssm_parity", "rwkv6_scan", case + ",state", st, pst, SCAN_TOL["float32"])
    r, k, v, lw, u, s0 = rwkv_inputs(f32, bb=2, ss=100, hh=3)  # [BH] streams, short last chunk
    flat = [t.reshape(6, *t.shape[2:]) for t in (r.contiguous(), k.contiguous(),
                                                  v.contiguous(), lw.contiguous())]
    args = (*flat, u.repeat(2, 1), s0.reshape(6, RWKV_D, RWKV_D))
    o, st = rk.rwkv6_scan(*args, chunk=32)
    po, pst = rr.rwkv6_scan(*args, chunk=32)
    hold("ssm_parity", "rwkv6_scan", "BH=6,S=100,float32,[BH] layout", o, po, SCAN_TOL["float32"])
    hold("ssm_parity", "rwkv6_scan", "BH=6,S=100 state", st, pst, SCAN_TOL["float32"])
    del args, flat, r, k, v, lw, u, s0
    torch.cuda.empty_cache()
    # long_500k: one layer's inputs at B 1 over rwkv6's long prefill (its
    # chunks' state carried in one launch); the largest error of the first
    # and of the last 64 tokens shows any drift along the stream.
    long = {}
    for dtype in (f32, bf16):
        name = dtype_name(dtype)
        args = rwkv_inputs(dtype, bb=1, ss=LONG_PREFILL)
        o, st = rk.rwkv6_scan(*args, chunk=32)
        po, pst = rr.rwkv6_scan(*args, chunk=32)
        case = f"long_500k,B=1,S={LONG_PREFILL},H={RWKV_H},D={RWKV_D},{name},chunk=32"
        row = {"max_abs_err": hold("ssm_parity", "rwkv6_scan", case, o, po, SCAN_TOL[name]),
               "state_max_abs_err": hold("ssm_parity", "rwkv6_scan", case + ",state", st, pst,
                                         SCAN_TOL["float32"]),
               "first_64_err": close_err(o[:, :, :64], po[:, :, :64], *SCAN_TOL[name])[0],
               "last_64_err": close_err(o[:, :, -64:], po[:, :, -64:], *SCAN_TOL[name])[0]}
        del o, st, po, pst
        if dtype == bf16:
            row.update(
                ms=median_ms(lambda: rk.rwkv6_scan(*args, chunk=32), runs=5, inner=1),
                plain_ms=median_ms(lambda: rr.rwkv6_scan(*args, chunk=32), runs=1, inner=1,
                                   warmup=0),
                library_ms=None,
                device_us=device_us_per_call(lambda: rk.rwkv6_scan(*args, chunk=32),
                                             LLM_SYMBOLS["rwkv6_scan"], calls=1),
                bound=scan_bound(scan_work("rwkv6", 1, RWKV_H, LONG_PREFILL, RWKV_D, RWKV_D,
                                           32, 2), True))
        long[f"B=1,S={LONG_PREFILL},H={RWKV_H},Dk=Dv={RWKV_D},{name},chunk=32"] = row
        del args
        torch.cuda.empty_cache()
    rows["rwkv6_scan"]["shapes"] = {"long_500k": long}

    # ssd: zamba2's [B, S, H, 64] input as a [B, H, S, 64] view, B and C
    # [B, S, 64] shared by every head (expanded views), log-decays over
    # [-6, -1e-3] (the model clamps at -6), a non-zero state.
    def ssd_inputs(dtype, bb=b, ss=s, hh=SSD_H, floor=False):
        x = randn((bb, ss, hh, SSD_D), dtype).transpose(1, 2)
        a = log_uniform((bb, ss, hh), 1e-3, 6.0).transpose(1, 2)
        if floor:
            a = torch.full_like(a, -6.0)
        bm, cm = (randn((bb, ss, SSD_D), dtype)[:, None].expand(bb, hh, ss, SSD_D)
                  for _ in range(2))
        return x, a, bm, cm, randn((bb, hh, SSD_D, SSD_D))

    def ssd_f64(x, a, bm, cm, s0):
        x, a, bm, cm = (t.double() for t in (x, a, bm, cm))
        st = s0.double()
        y = torch.empty_like(x)
        for t in range(x.shape[2]):
            st = a[:, :, t, None, None].exp() * st + bm[:, :, t, :, None] * x[:, :, t, None, :]
            y[:, :, t] = torch.einsum("bhs,bhsd->bhd", cm[:, :, t], st)
        return y, st

    err = 0.0
    for dtype in (f32, bf16):
        args = ssd_inputs(dtype)
        y, st = sk.ssd_scan(*args, chunk=64)
        py, pst = sr.ssd_scan(*args, chunk=64)
        case = f"B={b},S={s},H={SSD_H},Dh=Dst={SSD_D},{dtype_name(dtype)},chunk=64,shared B/C"
        e = hold("ssm_parity", "ssd_scan", case, y, py, SCAN_TOL[dtype_name(dtype)])
        hold("ssm_parity", "ssd_scan", case + ",state", st, pst, SCAN_TOL["float32"])
        err = max(err, e) if dtype == bf16 else err
        if dtype == f32:
            extra["ssd_scan_float32"] = {
                "ms": median_ms(lambda: sk.ssd_scan(*args, chunk=64), **heavy),
                "plain_ms": median_ms(lambda: sr.ssd_scan(*args, chunk=64), runs=3, inner=1),
                "bound_ms": scan_bound(scan_work("ssd", b, SSD_H, s, SSD_D, SSD_D, 64, 4,
                                                 shared_bc=True), False)[0]}
    rows["ssd_scan"] = dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:74",
        shape=f"B={b},S={s},H={SSD_H},Dh=Dst={SSD_D},bf16,chunk=64,shared B/C", max_abs_err=err,
        ms=median_ms(lambda: sk.ssd_scan(*args, chunk=64), **heavy),
        plain_ms=median_ms(lambda: sr.ssd_scan(*args, chunk=64), runs=3, inner=1),
        library_ms=None,
        device_us=device_us_per_call(lambda: sk.ssd_scan(*args, chunk=64),
                                     LLM_SYMBOLS["ssd_scan"]),
        bound=scan_bound(scan_work("ssd", b, SSD_H, s, SSD_D, SSD_D, 64, 2, shared_bc=True),
                         True),
    )
    args = ssd_inputs(f32, bb=1, ss=256, hh=4, floor=True)
    y, st = sk.ssd_scan(*args, chunk=64)
    wy, wst = ssd_f64(*args)
    hold("ssm_parity", "ssd_scan", "floor log a=-6,B=1,S=256,H=4,float32 vs float64 steps",
         y, wy.float(), SCAN_TOL["float32"])
    hold("ssm_parity", "ssd_scan", "floor state vs float64 steps", st, wst.float(),
         SCAN_TOL["float32"])
    x, a, bm, cm, s0 = ssd_inputs(f32, bb=2, ss=100, hh=3)  # [BH] streams, short last chunk
    args = (x.reshape(6, 100, SSD_D), a.reshape(6, 100), bm.reshape(6, 100, SSD_D),
            cm.reshape(6, 100, SSD_D), s0.reshape(6, SSD_D, SSD_D))
    y, st = sk.ssd_scan(*args, chunk=64)
    py, pst = sr.ssd_scan(*args, chunk=64)
    hold("ssm_parity", "ssd_scan", "BH=6,S=100,float32,[BH] layout", y, py, SCAN_TOL["float32"])
    hold("ssm_parity", "ssd_scan", "BH=6,S=100 state", st, pst, SCAN_TOL["float32"])
    del args, x, a, bm, cm, s0
    torch.cuda.empty_cache()

    _build.LAUNCHES.clear()  # parity and timing launches are not the path's
    emit({"phase": "ssm_kernels", "seconds": time.perf_counter() - t_phase,
          "rows": {k: {kk: (list(vv) if kk == "bound" else vv) for kk, vv in v.items()
                       if kk not in ("source", "replaces")} for k, v in rows.items()},
          "other_shapes": extra})
    return rows


# --------------------------------------------------------------------------- #
# Phases 16-18: training
# --------------------------------------------------------------------------- #
# train_4k (src/repro/configs/shapes.py:40) cut from batch 256 to 2 to fit
# one card: params, grads and moments ~15 GB, float32 logits and their grad
# ~8.4 GB, the plain attention backward's [2, 32, 4096, 4096] float32 score
# block ~4.3 GB (a few live at once) per layer.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 2, 4096, 8, 4
# Cuts of ``train`` (every layer rematerialised, as the port trains):
# llama at 4 of its 16 layers (a time cut: the moe and vlm runs add ~180 s
# to the script); rwkv6-1.6b whole; zamba2-7b at ZAMBA_TRAIN_LAYERS of
# its 81, the most one card holds (the whole model's 6.75 B parameters,
# gradients and moments alone are ~81 GB; tools/train_peak.py zamba2-7b
# 24 33 34 35 36 peaks 52.08 / 69.30 / 71.21 / 73.12 / 75.04 GB, 42 runs
# out of memory: past the activations, what bounds it is AdamW's float32
# temporaries on the stacked in_proj leaf, [L, 3584, 14336]; 35 layers,
# alone under 75 GB, run out of memory in this script after its earlier
# phases, 11.5 GiB of the card reserved but unallocated), 4 straight
# steps, no resume (its checkpoints would copy ~10 bytes per parameter
# four times over); mixtral-8x22b at MIXTRAL_TRAIN_LAYERS of its 56 (a
# memory cut: a layer's parameters, gradients and moments are ~30 GB;
# tools/train_peak.py: 1 layer peaks at 61.78 GB, 2 run out of memory),
# with llama's crash-and-resume; kimi-k2-1t-a32b at 1 of its 61 layers
# with 32 of its 384 experts (one full layer's parameters, gradients and
# moments are ~233 GB) and its batch cut to 1 (at 2 the 64-head plain
# attention backward's [2, 64, 4096, 4096] float32 blocks take it past 80
# GB), 4 straight steps; qwen2-vl-2b whole, 4 straight steps, its
# sequence 256 stub patches + 3,840 tokens.  Every run's peak stays under
# TRAIN_PEAK_GB.
ZAMBA_TRAIN_LAYERS, TRAIN_SHORT_STEPS, TRAIN_PEAK_GB = 34, 4, 75.0
MIXTRAL_TRAIN_LAYERS = 1
TRAIN_CUTS = {LLM_ARCH: dict(n_layers=4), ZAMBA: dict(n_layers=ZAMBA_TRAIN_LAYERS),
              MIXTRAL: dict(n_layers=MIXTRAL_TRAIN_LAYERS),
              KIMI: dict(n_layers=1, n_experts=32)}
TRAIN_BATCH = {KIMI: 1}
# ``train``'s runs: (arch, steps, crash-and-resume).  rwkv6-1.6b runs 4
# straight steps (a time cut: its resume took 34 s and its steps ~1.9 s
# each; llama and mixtral hold the resume on the card, and the CPU tests
# rwkv6's).
TRAIN_RUNS = ((LLM_ARCH, TRAIN_STEPS, True), (SSM_ARCHS[0], TRAIN_SHORT_STEPS, False),
              (ZAMBA, TRAIN_SHORT_STEPS, False), (MIXTRAL, TRAIN_STEPS, True),
              (KIMI, TRAIN_SHORT_STEPS, False), (QWEN_VL, TRAIN_SHORT_STEPS, False),
              (WHISPER, TRAIN_SHORT_STEPS, False))
# SwiGLUFn at two llama sequences of train_4k's length.
TRAIN_T = TRAIN_B * TRAIN_S
# train_card_vs_cpu: full width, 2 layers, float32, B 2 x S 256 (the scan
# archs 128: 4 / 2 chunks, so the state recurrence between chunks and its
# backward run; the CPU half is most of the phase), 3 steps.
TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_CPU_STEPS, TRAIN_CPU_TOL = 2, 256, 3, 1e-3
TRAIN_SCAN_CPU_S = 128


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block (with
    the cuBLAS workspace setting it asks for)."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _fwd_bwd(fn, inputs, grad_out):
    """One forward and backward of ``fn`` on fresh leaves of ``inputs``."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, grad_out)


def train_kernels_phase(dev):
    """``FlashAttentionFn`` at llama's training shape (B 2, Hq 32 / Hkv 8,
    S 4096, Dh 64) and ``SwiGLUFn`` at T 8,192, D 2,048, F 8,192, in bf16
    and float32: the forward held to the plain version within ``ATTN_TOL``
    / ``SWIGLU_TOL`` and equal to the kernel's output bitwise (the routing
    check: the Function launches the kernel), every input's gradient within
    the same tolerance of autograd of the plain version on the same inputs
    and output gradient (the backward recomputes the plain version, so this
    checks its wiring: strides, GQA grouping, which inputs get one); forward +
    backward ms of the Function against the plain version's (CUDA events).
    Returns the kernel-table fields of the two kernels (bf16)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.flash_attention.grad import FlashAttentionFn
    from repro_torch.kernels.swiglu import kernel as gk, ref as gr
    from repro_torch.kernels.swiglu.grad import SwiGLUFn

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

        # the model's layout: [B, S, H, Dh] buffers as heads-first views
        q = rnd(TRAIN_B, TRAIN_S, HQ, DH).transpose(1, 2)
        k = rnd(TRAIN_B, TRAIN_S, HKV, DH).transpose(1, 2)
        v = rnd(TRAIN_B, TRAIN_S, HKV, DH).transpose(1, 2)
        go = rnd(TRAIN_B, HQ, TRAIN_S, DH)

        def attn_fn(a, b, c):
            return FlashAttentionFn.apply(a, b, c, True, None, None)

        out, grads = _fwd_bwd(attn_fn, (q, k, v), go)
        with torch.no_grad():
            # routing: the Function's forward is the kernel's launch
            check(torch.equal(out, fk.attention(q, k, v)),
                  f"train_kernels: FlashAttentionFn {name} forward is not the kernel's")
        plain_out, want = _fwd_bwd(fr.attention, (q, k, v), go)
        fwd_err = hold("train_kernels", "flash_attention", f"forward {name}", out.detach(),
                       plain_out.detach(), ATTN_TOL[name])
        errs = {g: hold("train_kernels", "flash_attention", f"grad {g} {name}", got, w,
                        ATTN_TOL[name])
                for g, got, w in zip("qkv", grads, want)}
        del out, grads, plain_out, want
        torch.cuda.empty_cache()
        fn_ms = median_ms(lambda: _fwd_bwd(attn_fn, (q, k, v), go), runs=5, inner=2)
        plain_ms = median_ms(lambda: _fwd_bwd(fr.attention, (q, k, v), go), runs=3, inner=1)
        emit({"phase": "train_kernels", "kernel": "flash_attention", "dtype": name,
              "shape": {"B": TRAIN_B, "Hq": HQ, "Hkv": HKV, "S": TRAIN_S, "Dh": DH},
              "forward_bitwise_kernel": True, "forward_max_abs_err": fwd_err,
              "grad_max_abs_err": errs, "fwd_bwd_ms": fn_ms, "plain_fwd_bwd_ms": plain_ms,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        if dtype == torch.bfloat16:
            rows["flash_attention"] = {"train_fwd_bwd_ms": fn_ms,
                                       "train_plain_fwd_bwd_ms": plain_ms}
        del q, k, v, go
        torch.cuda.empty_cache()

        x = rnd(TRAIN_T, D_MODEL)
        wg, wu = rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5), rnd(D_MODEL, D_FF,
                                                                scale=D_MODEL ** -0.5)
        wo = rnd(D_FF, D_MODEL, scale=D_FF ** -0.5)
        go = rnd(TRAIN_T, D_MODEL)
        out, grads = _fwd_bwd(SwiGLUFn.apply, (x, wg, wu, wo), go)
        with torch.no_grad():
            # routing: the Function's forward is the kernel's launches
            check(torch.equal(out, gk.swiglu(x, wg, wu, wo)),
                  f"train_kernels: SwiGLUFn {name} forward is not the kernel's")
        plain_out, want = _fwd_bwd(gr.swiglu, (x, wg, wu, wo), go)
        fwd_err = hold("train_kernels", "swiglu", f"forward {name}", out.detach(),
                       plain_out.detach(), SWIGLU_TOL[name])
        errs = {g: hold("train_kernels", "swiglu", f"grad {g} {name}", got, w,
                        SWIGLU_TOL[name])
                for g, got, w in zip(("x", "wg", "wu", "wo"), grads, want)}
        fn_ms = median_ms(lambda: _fwd_bwd(SwiGLUFn.apply, (x, wg, wu, wo), go), runs=5,
                          inner=3)
        plain_ms = median_ms(lambda: _fwd_bwd(gr.swiglu, (x, wg, wu, wo), go), runs=5, inner=3)
        emit({"phase": "train_kernels", "kernel": "swiglu", "dtype": name,
              "shape": {"T": TRAIN_T, "D": D_MODEL, "F": D_FF},
              "forward_bitwise_kernel": True, "forward_max_abs_err": fwd_err,
              "grad_max_abs_err": errs,
              "fwd_bwd_ms": fn_ms, "plain_fwd_bwd_ms": plain_ms})
        if dtype == torch.bfloat16:
            rows["swiglu"] = {"train_fwd_bwd_ms": fn_ms, "train_plain_fwd_bwd_ms": plain_ms}
        del x, wg, wu, wo, go, out, grads, plain_out, want
        torch.cuda.empty_cache()
        rows.update(_train_scan_kernels(dev, gen, dtype))
    emit({"phase": "train_kernels", "seconds": time.perf_counter() - t_phase})
    return rows


def _train_scan_kernels(dev, gen, dtype):
    """``train_kernels``' two scans in ``dtype``: ``Rwkv6ScanFn`` at rwkv6's
    training shape (B 2, H 32, S 4096, Dk = Dv = 64, chunk 32) and
    ``SsdScanFn`` at zamba2's (B 2, H 112, S 4096, Dh = Dst = 64, chunk 64,
    B and C [B, S, Dst] leaves expanded over the heads inside the call, so
    their gradients are summed over the heads by autograd), each with a
    non-zero initial state and gradients on both outputs: the forward
    within ``SCAN_TOL`` of the plain version and bitwise the kernel's,
    every input's gradient (the state's and the bonus's included) within
    ``SCAN_TOL`` of autograd of the plain version.  In bf16: forward +
    backward ms of the Function and of the plain version, and one profiled
    Function call (device ms, launches, busy share: the plain backward's
    chunk loop runs on the host).  Returns the bf16 kernel-table fields."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as rk, ref as rr
    from repro_torch.kernels.rwkv6_scan.grad import Rwkv6ScanFn
    from repro_torch.kernels.ssd_scan import kernel as sk, ref as sr
    from repro_torch.kernels.ssd_scan.grad import SsdScanFn

    name, f32 = dtype_name(dtype), torch.float32
    b, s = TRAIN_B, TRAIN_S
    rows = {}

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def log_uniform(shape, lo, hi):
        x = torch.rand(shape, generator=gen, device=dev) * (math.log(hi) - math.log(lo))
        return -torch.exp(x + math.log(lo))

    h, d = RWKV_H, RWKV_D
    rwkv = dict(
        inputs=(*(rnd(b, s, h, d).transpose(1, 2) for _ in range(3)),
                log_uniform((b, s, h, d), 5e-4, -math.log(0.05)).transpose(1, 2),
                torch.rand((h, d), generator=gen, device=dev) * 0.6 - 0.3,
                rnd(b, h, d, d, dt=f32)),
        grad_out=(rnd(b, h, s, d), rnd(b, h, d, d, dt=f32)),
        fn=lambda *t: Rwkv6ScanFn.apply(*t, 32),
        plain=lambda *t: rr.rwkv6_scan(*t, chunk=32),
        kernel=lambda *t: rk.rwkv6_scan(*t, chunk=32),
        names=("r", "k", "v", "lw", "u", "s0"),
        shape={"B": b, "H": h, "S": s, "Dk": d, "Dv": d, "chunk": 32})
    h, d = SSD_H, SSD_D

    def expand(t):
        return t[:, None].expand(b, h, s, d)

    ssd = dict(
        inputs=(rnd(b, s, h, d).transpose(1, 2),
                log_uniform((b, s, h), 1e-3, 6.0).transpose(1, 2),
                rnd(b, s, d), rnd(b, s, d), rnd(b, h, d, d, dt=f32)),
        grad_out=(rnd(b, h, s, d), rnd(b, h, d, d, dt=f32)),
        fn=lambda x, a, bm, cm, s0: SsdScanFn.apply(x, a, expand(bm), expand(cm), s0, 64),
        plain=lambda x, a, bm, cm, s0: sr.ssd_scan(x, a, expand(bm), expand(cm), s0, chunk=64),
        kernel=lambda x, a, bm, cm, s0: sk.ssd_scan(x, a, expand(bm), expand(cm), s0, chunk=64),
        names=("x", "a", "bmat", "cmat", "s0"),
        shape={"B": b, "H": h, "S": s, "Dh": d, "Dst": d, "chunk": 64, "shared_bc": True})
    for kname, case in (("rwkv6_scan", rwkv), ("ssd_scan", ssd)):
        inputs, grad_out = case["inputs"], case["grad_out"]
        out, grads = _fwd_bwd(case["fn"], inputs, grad_out)
        with torch.no_grad():
            kern = case["kernel"](*inputs)
        check(all(torch.equal(a, k) for a, k in zip(out, kern)),
              f"train_kernels: {kname} Function {name} forward is not the kernel's")
        plain_out, want = _fwd_bwd(case["plain"], inputs, grad_out)
        fwd_err = [hold("train_kernels", kname, f"forward {part} {name}", o.detach(),
                        p.detach(), SCAN_TOL[name if part == "out" else "float32"])
                   for part, o, p in zip(("out", "state"), out, plain_out)]
        errs = {g: hold("train_kernels", kname, f"grad {g} {name}", got, w,
                        SCAN_TOL[dtype_name(got.dtype)])
                for g, got, w in zip(case["names"], grads, want)}
        check(all(g.shape == t.shape for g, t in zip(grads, inputs)),
              f"train_kernels: {kname} gradient shapes")
        del out, grads, plain_out, want, kern
        torch.cuda.empty_cache()
        row = {"phase": "train_kernels", "kernel": kname, "dtype": name, "shape": case["shape"],
               "forward_bitwise_kernel": True, "forward_max_abs_err": fwd_err,
               "grad_max_abs_err": errs}
        if dtype == torch.bfloat16:
            fn_ms = median_ms(lambda: _fwd_bwd(case["fn"], inputs, grad_out), runs=2, inner=1,
                              warmup=1)
            plain_ms = median_ms(lambda: _fwd_bwd(case["plain"], inputs, grad_out), runs=2,
                                 inner=1, warmup=1)
            wall_ms, device_ms, prof = profile_breakdown(
                lambda: _fwd_bwd(case["fn"], inputs, grad_out))
            row.update(fwd_bwd_ms=fn_ms, plain_fwd_bwd_ms=plain_ms,
                       profile=breakdown_json(wall_ms, device_ms, prof))
            rows[kname] = {"train_fwd_bwd_ms": fn_ms, "train_plain_fwd_bwd_ms": plain_ms}
        emit({**row, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return rows


def train_card_vs_cpu_phase(dev, arch=LLM_ARCH):
    """``arch`` (llama3.2-1b, rwkv6-1.6b, zamba2-7b, whisper-medium) at full
    width cut to 2 layers (zamba2: two mamba layers and one shared-block
    site; whisper 2 + 2, each batch with ``enc_seq`` stub frames from
    :func:`stub_inputs`, drawn on the card and copied to the CPU), float32,
    B 2 x S 256 (the scan archs S 128):
    the gradients of one batch on the card (every parameter's non-zero;
    repeated bitwise under deterministic algorithms, and the leaves that a
    default second backward does not repeat bitwise reported; under
    deterministic algorithms bitwise those of the same backward with each
    layer's checkpoint replaced by a direct call), then
    ``TRAIN_CPU_STEPS`` ``make_train_step`` steps on the card and on the
    CPU (plain versions) from the same parameters and stream: losses and
    grad norms within ``TRAIN_CPU_TOL`` relative."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import TrainState, make_train_step
    from repro_torch.tree import flatten_with_paths, tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch, "full"), n_layers=2, dtype=torch.float32)
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, enc_layers=2)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    seq = TRAIN_SCAN_CPU_S if cfg.family in ("ssm", "hybrid") else TRAIN_CPU_S
    data = DataConfig(vocab=cfg.vocab, batch=TRAIN_CPU_B, seq_len=seq, seed=2)
    params = init_params(cfg, seed=2, device=dev)
    inputs = stub_inputs(cfg, data.seed)
    # the stub inputs of each step, drawn on the card once: both runs read them
    source = SyntheticTokens(data)
    extras = [inputs(i, {k: torch.as_tensor(v, device=dev) for k, v in next(source).items()})
              if inputs else {} for i in range(TRAIN_CPU_STEPS)]
    if "w_lora_b" in params.get("layers", {}):
        # rwkv6 starts its decay LoRA's second factor at zero, which zeroes
        # the first factor's gradient; drawn here so every leaf has one.
        lora_b = params["layers"]["w_lora_b"]
        lora_b.copy_(torch.randn(lora_b.shape, generator=torch.Generator(device=dev)
                                 .manual_seed(3), device=dev) * lora_b.shape[1] ** -0.5)
    batch0 = {k: torch.as_tensor(v, device=dev).long()
              for k, v in next(SyntheticTokens(data)).items()}
    batch0.update(extras[0])

    def gradients():
        tree = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = flatten_with_paths(tree)
        total, _ = loss_fn(tree, cfg, batch0)
        return dict(zip([k for k, _t in leaves],
                        torch.autograd.grad(total, [t for _k, t in leaves])))

    grads = gradients()
    zero = [k for k, g in grads.items() if not bool((g != 0).any())]
    # the same backward twice, by default and under deterministic algorithms:
    # the leaves whose gradient is not bitwise repeatable
    repeat = {"default": [k for k, g in gradients().items() if not torch.equal(g, grads[k])]}
    with _deterministic():
        first = gradients()
        repeat["deterministic"] = [k for k, g in gradients().items()
                                   if not torch.equal(g, first[k])]
        # the same backward with each layer's checkpoint replaced by a direct
        # call: rematerialising must not change a bit
        real, tr.checkpoint = tr.checkpoint, lambda fn, *args, **_kw: fn(*args)
        try:
            remat_differs = [k for k, g in gradients().items() if not torch.equal(g, first[k])]
        finally:
            tr.checkpoint = real
    del grads, first

    def run(device, params):
        state = TrainState(params, adamw_init(params, opt),
                           torch.zeros((), dtype=torch.int32, device=device))
        step = make_train_step(cfg, opt)
        source = SyntheticTokens(data)
        hist = []
        t0 = time.perf_counter()
        for i in range(TRAIN_CPU_STEPS):
            batch = {k: torch.as_tensor(v, device=device).long() for k, v in next(source).items()}
            batch.update({k: v.to(device) for k, v in extras[i].items()})
            state, m = step(state, batch)
            hist.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
        return hist, time.perf_counter() - t0

    params_cpu = _cpu_copy(params)
    card, card_s = run(dev, params)
    del params
    torch.cuda.empty_cache()
    host, cpu_s = run(torch.device("cpu"), params_cpu)
    del extras
    rel = max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(card, host)
              for key in ("loss", "grad_norm"))
    emit({"phase": "train_card_vs_cpu", "arch": cfg.arch, "dtype": "float32",
          "layers": cfg.n_layers,
          "batch": TRAIN_CPU_B, "seq_len": seq, "steps": TRAIN_CPU_STEPS,
          "card": card, "cpu": host, "max_rel_diff": rel, "tol": TRAIN_CPU_TOL,
          "zero_gradient_params": zero, "grads_not_repeatable": repeat,
          "remat_grads_differing": remat_differs, "card_seconds": card_s, "cpu_seconds": cpu_s,
          "seconds": time.perf_counter() - t_phase})
    check(not zero, f"train_card_vs_cpu {arch}: parameters with an all-zero gradient: {zero}")
    check(not repeat["deterministic"], f"train_card_vs_cpu {arch}: gradients not repeatable "
          f"under deterministic algorithms: {repeat['deterministic']}")
    check(not remat_differs, f"train_card_vs_cpu {arch}: gradients with the layers "
          f"rematerialised differ from those without in {remat_differs}")
    check(rel <= TRAIN_CPU_TOL and all(math.isfinite(h["loss"]) for h in card),
          f"train_card_vs_cpu {arch}: card vs CPU relative difference {rel}")


def train_launch_rule(cfg, steps):
    """Kernel launches of ``steps`` training steps: each step's forward
    launches what a prefill does (:func:`serve_launch_rule`), and the
    backward reruns every rematerialised layer's body before it
    differentiates it, so each layer's kernels launch twice a step -- all
    but zamba2's shared block, which runs outside any checkpoint (its
    ``flash_attention`` and ``swiglu`` launch once); the backward itself
    runs the plain versions."""
    forward = serve_launch_rule(cfg)[0]
    recompute = ({"ssd_scan": forward["ssd_scan"]} if cfg.family == "hybrid" else forward)
    return {k: (n + recompute.get(k, 0)) * steps for k, n in forward.items()}


def vlm_stub_inputs(cfg, seed):
    """``TrainLoop``'s ``batch_inputs`` for the vlm family, whose loader
    yields tokens only: ``N_PATCHES`` stub patch embeddings (standard
    normal in ``cfg.dtype``, drawn on the batch's device from ``seed`` and
    the stream position, so a resumed run sees the same) ahead of the text,
    and their M-RoPE ids (qwen2-vl's grid layout)."""
    import torch

    from repro_torch.configs.qwen2_vl_2b import N_PATCHES
    from repro_torch.models.common import mrope_positions

    def inputs(position, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        gen = torch.Generator(device=tokens.device).manual_seed(seed * 1_000_003 + position)
        patches = torch.randn((b, N_PATCHES, cfg.d_model), generator=gen, device=tokens.device)
        return {"patch_embeds": patches.to(cfg.dtype),
                "positions_3d": mrope_positions(b, N_PATCHES, s, device=tokens.device)}

    return inputs


def audio_stub_inputs(cfg, seed):
    """``TrainLoop``'s ``batch_inputs`` for the audio family, whose loader
    yields tokens only: ``enc_seq`` stub frame embeddings per sequence (the
    mel / conv front end is a stub input in the reference too; standard
    normal in ``cfg.dtype``, drawn on the batch's device from ``seed`` and
    the stream position, so a resumed run sees the same)."""
    import torch

    def inputs(position, batch):
        tokens = batch["tokens"]
        gen = torch.Generator(device=tokens.device).manual_seed(seed * 1_000_003 + position)
        frames = torch.randn((tokens.shape[0], cfg.enc_seq, cfg.d_model), generator=gen,
                             device=tokens.device)
        return {"frames": frames.to(cfg.dtype)}

    return inputs


def stub_inputs(cfg, seed):
    """The ``batch_inputs`` that ``cfg``'s family needs beside the token
    stream (vlm: :func:`vlm_stub_inputs`, audio: :func:`audio_stub_inputs`),
    else None."""
    make = {"vlm": vlm_stub_inputs, "audio": audio_stub_inputs}.get(cfg.family)
    return make(cfg, seed) if make else None


def train_phase(dev, arch=LLM_ARCH, steps=TRAIN_STEPS, resume=True):
    """``arch`` at full width, cut as ``TRAIN_CUTS`` says (bf16 parameters,
    float32 moments), through ``TrainLoop``: ``train_4k``'s sequence of
    4096 (the vlm family's 256 stub patches from :func:`vlm_stub_inputs`
    and 3,840 tokens; the audio family's 4,096 decoder tokens beside
    ``enc_seq`` stub frames from :func:`audio_stub_inputs`) with its batch
    cut from 256 to 2 (kimi's to 1,
    ``TRAIN_BATCH``), ``steps`` steps without
    checkpoints (``ckpt_every=0``; launches counted exactly,
    :func:`train_launch_rule`), then, with ``resume``, a second loop that
    checkpoints every ``TRAIN_CKPT`` and crashes at step ``TRAIN_CKPT`` and a
    third that resumes from that checkpoint to ``steps`` without writing
    one, so the disk holds one checkpoint (mixtral's is 29 GB; the card's
    machine takes a 45 GiB high-water mark of writes).  The loops run under
    ``torch.use_deterministic_algorithms`` (an op with a nondeterministic
    CUDA implementation, such as the accumulating backward of the
    embedding gather, takes its deterministic one or raises), so a resume
    that restores every leaf and the stream position repeats the straight
    run exactly.  Hard: losses finite, peak memory under ``TRAIN_PEAK_GB``,
    the resumed losses and the final parameters bitwise the straight run's
    (the reference's test allows 2e-2, which a resume from the wrong state
    would also meet at this learning rate).  Reported: tokens / s, step
    ms, peak memory, checkpoint times, the loader's worker counts.
    Returns the straight run's launches and its ``max_memory_allocated``
    (bytes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.qwen2_vl_2b import N_PATCHES
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.optimizer import AdamWConfig

    t_phase = time.perf_counter()
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, **TRAIN_CUTS.get(arch, {}))
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, decay_steps=steps)
    # the vlm sequence: the stub patches (vlm_stub_inputs), then the text
    seq = TRAIN_S - (N_PATCHES if cfg.family == "vlm" else 0)
    data = DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH.get(arch, TRAIN_B), seq_len=seq,
                      seed=0)
    with _deterministic():
        out = _train_loops(dev, cfg, opt, data, steps, resume)
    return _train_report(cfg, steps, *out, time.perf_counter() - t_phase)


def _train_loops(dev, cfg, opt, data, steps, resume):
    """``train_phase``'s loops: the straight run (launches, times, peak
    memory) and, with ``resume``, the crash at ``TRAIN_CKPT`` and the
    resume (else those three are None)."""
    import tempfile

    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.tree import flatten_with_paths

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = pathlib.Path(tmp)

        def loop(name, every):
            return TrainLoop(cfg, opt, LoopConfig(total_steps=steps, ckpt_every=every,
                                                  log_every=1),
                             ckpt_dir=work / name, data_cfg=data, device=dev,
                             batch_inputs=stub_inputs(cfg, data.seed))

        torch.cuda.reset_peak_memory_stats()
        straight = loop("straight", 0)  # the reference run writes no checkpoint
        LAUNCHES.clear()
        t0 = time.perf_counter()
        state_a = straight.run()
        straight_s = time.perf_counter() - t0
        want = train_launch_rule(cfg, steps)
        launches = {k: LAUNCHES[k] for k in want}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        workers = straight.loader_workers
        # host copies in the parameters' own dtype: compared bitwise below
        params_a = ({k: t.cpu() for k, t in flatten_with_paths(state_a.params)} if resume
                    else None)
        del state_a
        torch.cuda.empty_cache()
        first = second = None
        crashed, resumed_s, diff, differ = False, None, 0.0, []
        if resume:
            first = loop("resumed", TRAIN_CKPT)
            t0 = time.perf_counter()
            try:
                first.run(crash_at=TRAIN_CKPT)
            except RuntimeError:
                crashed = True
            second = loop("resumed", 0)  # restores TRAIN_CKPT, writes nothing
            state_b = second.run()
            resumed_s = time.perf_counter() - t0
            params_b = {k: t.cpu() for k, t in flatten_with_paths(state_b.params)}
            differ = [k for k, t in params_b.items() if not torch.equal(params_a[k], t)]
            diff = max((float((params_a[k].float() - params_b[k].float()).abs().max())
                        for k in differ), default=0.0)
            del state_b, params_a, params_b
            torch.cuda.empty_cache()
    return (straight, first, second, crashed, launches, want, peak_gb, workers, straight_s,
            resumed_s, diff, differ)


def _train_report(cfg, steps, straight, first, second, crashed, launches, want, peak_gb,
                  workers, straight_s, resumed_s, diff, differ, seconds):
    """Emit ``train_phase``'s record, make its checks, return its launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.qwen2_vl_2b import N_PATCHES
    from repro_torch.models.transformer import shared_sites

    full = get_config(cfg.arch)
    losses = [m["loss"] for m in straight.metrics_history]
    norms = [m["grad_norm"] for m in straight.metrics_history]
    resumed = (None if first is None
               else [m["loss"] for m in first.metrics_history + second.metrics_history])
    steps_ms = [m["step_time"] * 1e3 for m in straight.metrics_history]
    steady = statistics.median(steps_ms[1:])
    sites = len(shared_sites(cfg)) if cfg.family == "hybrid" else None
    emit({"phase": "train", "arch": cfg.arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "sites": sites, "experts": cfg.n_experts or None,
          "params": cfg.params_count(),
          "params_full_depth": full.params_count(), "param_dtype": "bfloat16",
          "moment_dtype": "float32",
          "cut": f"train_4k batch 256 -> {straight.data_cfg.batch} (sequence {TRAIN_S} kept" + (
              f": {N_PATCHES} stub patches + {TRAIN_S - N_PATCHES} tokens)"
              if cfg.family == "vlm" else
              f" beside {cfg.enc_seq} stub frames)" if cfg.family == "audio" else ")") + (
              f"; depth {full.n_layers} -> {cfg.n_layers} layers"
              if full.n_layers != cfg.n_layers else "") + (
              f"; experts {full.n_experts} -> {cfg.n_experts}"
              if full.n_experts != cfg.n_experts else ""),
          "steps": steps, "ckpt_every": TRAIN_CKPT, "losses": losses,
          "resumed_losses": resumed, "grad_norms": norms,
          "step_ms": steps_ms, "step_ms_median_after_first": steady,
          "tokens_per_s": straight.data_cfg.batch * TRAIN_S / (steady / 1e3),
          "peak_memory_gb": peak_gb, "peak_limit_gb": TRAIN_PEAK_GB, "loader_workers": workers,
          "straight_run_s": straight_s, "crash_and_resume_s": resumed_s,
          "deterministic_algorithms": True,
          "resume_losses_equal": None if resumed is None else resumed == losses,
          "resume_max_abs_param_diff": diff, "resume_params_differing": differ,
          "stragglers": len(straight.straggler_events),
          "launches": launches, "launches_expected": want,
          "card": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu"),
          "seconds": seconds})
    name = f"train {cfg.arch}"
    check(all(math.isfinite(x) for x in losses + norms + (resumed or [])),
          f"{name}: non-finite loss or grad norm")
    check(peak_gb < TRAIN_PEAK_GB, f"{name}: peak memory {peak_gb:.2f} GB")
    check(sites is None or sites >= 2, f"{name}: fewer than two shared-block sites")
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    if resumed is not None:
        check(crashed and len(second.metrics_history) == steps - TRAIN_CKPT,
              f"{name}: the crash-and-resume did not resume at the checkpoint")
        check(resumed == losses,
              f"{name}: resumed losses {resumed} are not the straight run's {losses}")
        check(not differ, f"{name}: resumed parameters differ from the straight run's in "
                          f"{differ} (max abs diff {diff})")
    return launches, peak_gb * 1e9


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    quick = "--kernels-only" in sys.argv[1:]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    print(card, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    # TF32 would change float32 products; the port holds the plain versions
    # to full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=quick)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib_path.relative_to(ROOT))})

    rows = kernel_phase(dev)
    rows.update(llm_kernels_phase(dev))
    rows.update(ssm_kernels_phase(dev))
    if quick:
        emit({"phase": "kernels_only", "rows": {k: {kk: vv for kk, vv in v.items()
                                                      if kk not in ("bound", "shapes")}
                                                  for k, v in rows.items()}})
        return 0
    launches = main_path_phase(dev)
    for k, n in launches.items():
        check(n > 0 or k in OFF_PATH, f"kernel {k} was never launched on the main path")
    vld_card_vs_cpu_phase(dev)
    launches.update(vld_live_phase(dev))
    for k, n in twin_loop_phase(dev).items():
        launches[k] += n
    for k, n in proactive_loop_phase(dev).items():
        launches[k] += n
    for phase in (soak_phase, fleet_plan_phase, fleet_live_phase, fleet_mesh_phase):
        for k, n in phase(dev).items():
            launches[k] += n
    by_path = {}  # kernel -> path -> launches, for the LLM and scan kernels

    def count(path, counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
            if n:
                by_path.setdefault(k, {})[path] = n

    card_vs_cpu_phase(dev)
    plans, measured = {}, {}
    for arch in SERVED_ARCHS:
        served, prompts_per_s, tokens_per_s, params, cfg, measured[arch] = serve_phase(dev, arch)
        count(f"{arch} serve", served)
        if arch == LLM_ARCH:
            count("llm_decode_32k", llm_decode_32k_phase(dev, params, cfg)[0])
        del params
        torch.cuda.empty_cache()
        if arch not in SERVE_LAYERS:  # an arch cut in depth is planned under no name
            plans[arch] = serving_plan_phase(prompts_per_s, tokens_per_s, arch)
    for arch in LONG_ARCHS:
        served, measured[f"{arch} long_500k"] = long_500k_phase(dev, arch)
        count(f"{arch} long_500k", served)
    dryrun_phase(measured)
    launch_serve_phase(plans)
    train_rows = train_kernels_phase(dev)
    for arch in (LLM_ARCH, *SSM_ARCHS, WHISPER):
        train_card_vs_cpu_phase(dev, arch)
    train_peaks = {}
    for arch, steps, resume in TRAIN_RUNS:
        launched, train_peaks[arch] = train_phase(dev, arch, steps, resume)
        count(f"{arch} train", launched)
    dryrun_train_phase(train_peaks[LLM_ARCH])

    kernels = []
    for k, row in rows.items():
        check(launches[k] > 0 or k in OFF_PATH, f"kernel {k} never ran on its path")
        bound_ms, bound_by = row["bound"]
        kernels.append({
            "name": k, "route": "cuda", "source": row["source"], "replaces": row["replaces"],
            "launches": launches[k], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": row.get("library_ms"), **train_rows.get(k, {}),
            **({"launches_by_path": by_path[k]} if k in by_path else {}),
            **({"shapes": row["shapes"]} if "shapes" in row else {}),
        })
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
