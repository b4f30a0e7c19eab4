"""Smoke test of qoc_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit
(nvcc) installed:

    python3 chip_smoke.py

(``--phases 16,20`` runs only the listed phases that stand alone, after the
build, for a quick check of a kernel.) Phases, one line each:
1. the device (name and power limit as nvidia-smi reports them);
2. build the kernels (K1/K2/K5/K3/K4/K6, K2/K5/K6 with their per-step-seed
   mode) from qoc_tpu_torch/csrc with nvcc;
3. K1 (forward) and K2 (adjoint) against their plain PyTorch versions in
   float32, at d = 64 and 21 basis terms, at weights scaled onto every
   Taylor ladder level (degree 4/8/12/19 and the squaring branch), at step
   counts that split unevenly into segments, at the headline's own shapes,
   and the op's total against a float64 product of torch.linalg.matrix_exp;
4. the Table-3 headline loss and gradient (d = 64, 10 complex controls,
   10^4 steps, seed 0), kernel route against the plain route;
5. grape_schroedinger_discrete on that problem, 2 warm-up + 10 timed Adam
   iterations, with every kernel's launch counter set to 0 before the run
   and read after it (K1 and K2 launched, K5 not);
6. K1 and K2 times beside their plain versions, their bounds and
   torch.linalg.matrix_exp of the same generators, at the headline shapes;
7. K5 (forward and adjoint of the plane chain) against its plain versions
   in float32, at d = 64 and 16 with planes scaled onto every ladder level,
   at 3, 37 and 2001 steps, the padded rows and steps exactly the identity,
   the op's total against a float64 matrix_exp product, and at the M4
   problem's own planes;
8. the headline problem with its Hamiltonian as a torch callable (the plane
   route, K5) against the LinearHamiltonian (the fused route, K1/K2): M2
   loss and control gradient at 10^4 steps;
9. grape_schroedinger_discrete under Magnus-M4 on the JAX package's
   bench_m4 problem (d = 64, 10 complex controls, 2001 steps, T = 20, seed
   0), 2 warm-up + 10 timed iterations, counters read around the run (K5
   launched, K1/K2 not); then the two-transmon iSWAP problem of
   examples/2_iswap_gate.py written with torch operations (d = 16, 241
   steps, M2 callable), 20 iterations;
10. K5 times at the M4 shapes beside their plain versions, their bounds,
   torch.linalg.matrix_exp of the same planes (exps only, no chain) and the
   conjugate transpose of the planes that the adjoint kernel does on load;
11. K3 (expm) and K4 (its Fréchet derivative) against their plain versions
   in float32 on every ladder level, at d = 16, 64, 96, 128 and 256 and
   batches 1, 37 and 2000, the padded rows exact, and against float64
   torch.linalg.matrix_exp and its autograd;
12. the slice at full width: grape_schroedinger_discrete on the d = 2^7
   problem (bench.py's construction at d = 128, 10 complex controls, 2001
   points, T = 20, M2: the blocked route), 2 warm-up + 10 timed
   iterations, counters read around the run (K3 and K4 launched every
   iteration, K1/K2/K5 never);
13. the M4 problem through the blocked route (allow_plane_chain=False,
   K3/K4) against the plane route (K5): loss, gradient and time;
14. the Table-1 d = 2^10 single-step backprop (the blocked route on
   torch.matmul), 20 timed iterations, K3/K4 counters at 0, the gradient
   against a float64 run of the same route;
15. K3 and K4 times at the d = 128 GRAPE's planes and at the M4 planes,
   beside their plain versions, their bounds and torch.linalg.matrix_exp's
   forward and backward on the same inputs;
16. K6 (forward and adjoint of the streamed chain) against its plain
   versions in float32 at d = 260, 400 and 512 (padded 320, 448, 512),
   decaying non-normal planes on every ladder level, 1, 3, 37 and 100
   steps, the padded rows and steps exactly the identity, and the op's
   total against a float64 matrix_exp product;
17. Schrödinger through K6: the Table-1 construction at d = 2^9 (one step)
   against the same loss over the plain op, and a d = 300 problem of 21
   steps through a LinearHamiltonian and a torch callable under M2 and M4,
   K6 alone launched;
18. the slice at full width: grape_lindblad_discrete on the JAX package's
   bench_lindblad_d20 configuration (d = 20, superoperator 400, 1 complex
   control, 101 points, T = 10, T1 rate 1e-3, MAGNUS_EXPM: the streamed
   route), 2 warm-up + 10 timed iterations, counters read around the run
   (K6 launched every iteration, K1-K5 never), and the loss and gradient
   against a float64 run of the same route over the plain versions;
19. Lindblad on the other routes: example 1 (d = 2, T1 = 1000, 11 control
   points, 20 steps) through K1/K2 and a d = 12 problem (superoperator
   144) through K3/K4, with counters and final densities against float64;
20. K6 times at the d = 20 cell's planes and at d = 2^9, beside their plain
   versions and bounds, with the grid (clusters and SMs) and the segment
   merge's device time;
21. K2, K5 and K6 in their per-step-seed mode (the trajectory form, where
   every prefix carries a gradient) against their plain versions in
   float32 on every ladder level: K2 and K5 at d = 64 and 16 over 3, 37
   and 2001 steps, K6 at d = 260, 400 and 512 over 1, 3 and 37 steps; the
   adjoint alone, and the trajectory op's total, prefixes and gradient;
   with seeds zero but at the last step each equals its last-step mode
   bitwise;
22. the slice at full width: grape_schroedinger_discrete on the step-cost
   headline (the JAX package's bench_stepcost, bench.py:251-273: the
   Table-3 problem with ForbidStates of |1> at multiplier 0.1), 2 warm-up
   + 10 timed iterations, counters read around the run (K1 and K2 in its
   per-step mode once an iteration, nothing else), then with
   cost_eval_step 10; loss and gradient against the float64 plain route on
   the card, with the final cost and for the step cost alone;
23. step costs on the other routes: the M4 problem as a torch callable with
   TargetStateInfidelityTime, a GRAPE through K5 (per-step mode) with
   counters, and the d = 2^7 step-cost loss through K3/K4 and the prefix
   scan with counters, each against float64;
24. the d = 20 Lindblad cell with ForbidDensities and
   TargetDensityInfidelityTime: a GRAPE through K6 (per-step mode) with
   counters and a float64 check, and evolve_lindblad_discrete with
   intermediate densities against float64;
25. the per-step modes' times at their main paths' shapes (K2 at the
   step-cost headline, K5 at the M4 planes, K6 at the d = 20 planes)
   beside their plain versions, the last-step mode and their bounds, and
   the trajectory glue's device times at the headline.

Any failure exits non-zero. The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Tolerances (tests/test_chain.py:49,60 of the JAX package): relative to the
# largest magnitude of the plain result.
FWD_RTOL = 1e-4
GRAD_RTOL = 1e-3

# Table-3 configuration (bench.py:62-109 of the JAX package).
D = 64
CONTROL_COUNT = 10
SYSTEM_EVAL_COUNT = 10_000
CONTROL_EVAL_COUNT = 10_000
EVOLUTION_TIME = 100.0
WARMUP_ITERATIONS = 2
TIMED_ITERATIONS = 10
# Magnus-M4 configuration (bench.py:276-291 of the JAX package): the
# Table-3 widths over 2001 steps of T = 20.
M4_STEPS = 2001
M4_EVOLUTION_TIME = 20.0
ISWAP_ITERATIONS = 20
# The d = 2^7 configuration (the reference's expm benchmark dimension,
# BASELINE.md): bench.py's _bench_problem at d = 128, 10 complex controls,
# 2001 points, T = 20, M2.
D128 = 128
D128_STEPS = 2001
D128_EVOLUTION_TIME = 20.0
# The Table-1 configuration (bench.py:156-174 of the JAX package): d = 2^10,
# one step, timed over 20 iterations after 2 warm-up ones.
D1024 = 1024
BACKPROP_ITERATIONS = 20
# K3/K4 against their plain versions: these d (padded to 64, 128, 128, 128,
# 256) and batches, on every ladder level.
EXPM_DIMS = (16, 64, 96, 128, 256)
EXPM_BATCHES = (1, 37, 2000)
# K6 against its plain versions: these d (padded 320, 448, 512) and steps,
# on every ladder level.
STREAM_DIMS = (260, 400, 512)
STREAM_STEPS = (1, 3, 37, 100)
# Schrödinger through K6: the Table-1 construction at d = 2^9 (one step),
# and a d = 300 problem of 21 steps.
D512 = 512
D300 = 300
D300_STEPS = 21
# The Lindblad d = 20 cell (bench.py bench_lindblad_d20 of the JAX
# package): superoperator 400, 101 points (100 steps), T = 10.
D20 = 20
D20_POINTS = 101
D20_EVOLUTION_TIME = 10.0
# The step-cost headline (bench.py:251-273 of the JAX package): ForbidStates
# of |1> at multiplier 0.1 on the Table-3 problem, at every step, and
# thinned to every 10th.
STEP_COST_MULTIPLIER = 0.1
THINNED_COST_EVAL_STEP = 10
# The per-step-seed modes against their plain versions, on every ladder
# level: K2/K5 at these d and steps, K6 at STREAM_DIMS and these steps.
STEP_DIMS = (D, 16)
STEP_STEPS = (3, 37, M4_STEPS)
STREAM_STEP_STEPS = (1, 3, 37)

# One H100 SXM (NVIDIA's data sheet, dense, at 700 W): FP32 outside the
# tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Complex DP^3 products a step of the Taylor ladder per level: degree
# 4/8/12/19, and degree 19 before the squarings of the last level.
LADDER_PRODUCTS = (2, 3, 5, 7, 7)
LEVEL_NORMS = (0.03, 0.3, 1.0, 2.5, 7.0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _random_hermitian(rng, d):
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return ((h + h.conj().T) / 2).astype(np.complex64)


def bench_problem(d, control_count, control_eval_count, system_eval_count,
                  evolution_time, magnus="M2", iteration_count=1,
                  step_costs=(), cost_eval_step=1):
    """The JAX package's bench.py _bench_problem (:82-109) with seed 0:
    (pstate, hamiltonian, costs), ``step_costs`` after its final cost."""
    from qoc_tpu_torch.core.common import initialize_controls
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy, LinearHamiltonian,
                                      MagnusPolicy)
    from qoc_tpu_torch import Adam, TargetStateInfidelity

    rng = np.random.default_rng(0)
    h0 = _random_hermitian(rng, d)
    control_ops = np.stack(
        [_random_hermitian(rng, d) for _ in range(control_count)])
    hamiltonian = LinearHamiltonian(h0, control_ops)
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    costs = [TargetStateInfidelity(target)] + list(step_costs)
    initial_controls, max_norms = initialize_controls(
        True, control_count, control_eval_count, evolution_time, None, None)
    pstate = GrapeSchroedingerDiscreteState(
        True, control_count, control_eval_count, cost_eval_step, costs,
        evolution_time,
        hamiltonian, None, initial_controls, initial,
        InterpolationPolicy.LINEAR, iteration_count, 0, max_norms,
        MagnusPolicy[magnus], 0, Adam(), None, False, 0, system_eval_count)
    return pstate, hamiltonian, costs


def table3_problem(iteration_count, system_eval_count=SYSTEM_EVAL_COUNT,
                   evolution_time=EVOLUTION_TIME, magnus="M2"):
    """The headline problem (d = 64, 10 controls). With 2001 steps, T = 20
    and M4 it is bench_m4's problem."""
    return bench_problem(D, CONTROL_COUNT, system_eval_count,
                         system_eval_count, evolution_time, magnus,
                         iteration_count)


def m4_problem(iteration_count):
    return table3_problem(iteration_count, M4_STEPS, M4_EVOLUTION_TIME, "M4")


def d128_problem():
    """The d = 2^7 problem: bench_problem at d = 128 over 2001 points,
    T = 20, M2 (the blocked route, K3/K4)."""
    return bench_problem(D128, CONTROL_COUNT, D128_STEPS, D128_STEPS,
                         D128_EVOLUTION_TIME)


def d1024_problem():
    """The Table-1 problem: bench.py's bench_d1024_backprop (:156-174),
    d = 2^10, one step (the blocked route on torch.matmul)."""
    return bench_problem(D1024, CONTROL_COUNT, 2, 2, 0.05)


def torch_callable(hamiltonian, dev, cdtype=torch.complex64):
    """The LinearHamiltonian's H(c, t) = h0 + Σ c_i A_i + conj(c_i) A_i^H
    written as a plain torch callable: it takes the plane route."""
    h0 = torch.as_tensor(hamiltonian.h0, dtype=cdtype, device=dev)
    ops = torch.as_tensor(hamiltonian.operators, dtype=cdtype, device=dev)

    def h(controls, t):
        drive = torch.einsum("i,iab->ab", controls, ops)
        return h0 + drive + drive.mH
    return h


def m4_planes(dev):
    """The M4 problem's generator planes (2000, 64, 64)."""
    return initial_planes(*m4_problem(1)[:2], dev)


def initial_planes(pstate, hamiltonian, dev):
    """A problem's generator planes, one a step, at its initial controls,
    built as its loss builds them."""
    from qoc_tpu_torch.core.schroedinger import plane_builder
    dt = float(pstate.dt)
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    planes = plane_builder(hamiltonian, pstate.magnus_policy, cet, dt)
    times = torch.arange(pstate.system_eval_count - 1, dtype=torch.float32,
                         device=dev) * dt
    controls = torch.as_tensor(pstate.initial_controls,
                               dtype=torch.complex64, device=dev)
    with torch.no_grad():
        return planes(controls, times).to(torch.complex64)


def kernel_bound(step_norms, level, dual, tensors, dp=D, chain=True):
    """(bound ms, what bounds it, GFLOP) of one kernel call: the larger of
    its complex dp^3 products over the FP32 peak and the bytes of its
    inputs and outputs (``tensors``, each once) over the HBM rate.
    ``step_norms`` are the 1-norms of the matrices the ladder exponentiates
    (A_t forward, A_t^H adjoint), one per step or matrix: at the squaring
    level they give this run's squarings. ``chain``: a chain kernel, which
    also multiplies each step into its prefix (forward) or does the T update
    and gU (adjoint); else K3/K4, exps only. Elementwise work is not
    counted."""
    n = step_norms.shape[0]
    ladder = LADDER_PRODUCTS[level] * n
    if level == len(LADDER_PRODUCTS) - 1:
        ladder += int(torch.clamp(torch.ceil(torch.log2(
            torch.clamp(step_norms, min=1.0))), 0, 60).sum())
    # Dual products are 3 complex products each.
    products = 3 * ladder if dual else ladder
    if chain:
        products += 2 * n if dual else n
    flops = products * 8 * dp ** 3
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def _wrappers():
    from qoc_tpu_torch.ops import chain, expm_cuda
    return {"K1": chain.chain_fwd, "K2": chain.chain_bwd,
            "K5 fwd": chain.plane_fwd, "K5 bwd": chain.plane_bwd,
            "K3": expm_cuda.expm_fwd, "K4": expm_cuda.expm_frechet_fwd,
            "K6 fwd": chain.stream_fwd, "K6 bwd": chain.stream_bwd}


# The adjoint wrappers also count their launches in the per-step-seed mode
# (``step_launches``, a part of ``launches``), read as "<key> step".
STEP_MODES = ("K2", "K5 bwd", "K6 bwd")


def reset_launches():
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for key in STEP_MODES:
        wrappers[key].step_launches = 0


def read_launches():
    wrappers = _wrappers()
    launches = {key: fn.launches for key, fn in wrappers.items()}
    launches.update({key + " step": wrappers[key].step_launches
                     for key in STEP_MODES})
    return launches


def headline_weights(pstate, dev):
    """The chain op's weight rows for the initial controls."""
    from qoc_tpu_torch.core.schroedinger import fused_weights
    n_steps = pstate.system_eval_count - 1
    times = torch.arange(n_steps, dtype=torch.float32, device=dev) * pstate.dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    controls = torch.as_tensor(pstate.initial_controls,
                               dtype=torch.complex64, device=dev)
    return fused_weights(controls, times, cet, float(pstate.dt))


def cuda_ms(fn, repeats):
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs an NVIDIA GPU.")
    if not (ROOT / "qoc_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: qoc_tpu_torch/csrc not found beside "
                         "this script; run it from a checkout of the "
                         "repository.")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print("phase 1 device: {} | torch {} cuda {}".format(
        torch.cuda.get_device_name(0), torch.__version__,
        torch.version.cuda), flush=True)
    return card


def phase_build():
    from qoc_tpu_torch.ops import chain
    start = time.perf_counter()
    chain.load_kernels()
    seconds = time.perf_counter() - start
    print("phase 2 build: K1/K2/K5/K3/K4/K6 ready in {:.1f} s (nvcc sm_90a, "
          "qoc_tpu_torch/csrc)".format(seconds), flush=True)
    return seconds


def _scaled_basis(rng, d, n_b, w, target_norm):
    """Anti-Hermitian basis (unitary steps) scaled so the batch-max 1-norm
    of the generators is ``target_norm``."""
    basis = np.stack([-1j * _random_hermitian(rng, d).astype(np.complex128)
                      for _ in range(n_b)])
    norm = np.abs(np.einsum("jk,kab->jab", w, basis)).sum(-2).max()
    return basis * (target_norm / norm)


def _compare_kernels(op, w):
    """K1 and K2 against their plain versions on the same inputs: returns
    (max |err| K1, rel K1, max |err| K2, rel K2)."""
    from qoc_tpu_torch.ops import chain
    n_steps = w.shape[0]
    s_count, length = chain.segment_plan(n_steps)
    w_seg = torch.zeros((s_count * length, op.n_b), device=w.device)
    w_seg[:n_steps] = w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(w, op.basis_ri, op.d)
    pref_k = chain.chain_fwd(w_seg, op.basis, n1)
    pref_p = chain.chain_fwd_plain(w_seg, op.basis, n1)
    gen = torch.Generator(device=w.device).manual_seed(1)
    seeds = torch.randn((s_count, op.dp, op.dp), dtype=torch.complex64,
                        device=w.device, generator=gen)
    ga_k = chain.chain_bwd(w_seg, op.basis_h, ninf, pref_p, seeds)
    ga_p = chain.chain_bwd_plain(w_seg, op.basis_h, ninf, pref_p, seeds)
    torch.cuda.synchronize()
    for name, x in (("K1", pref_k), ("K2", ga_k)):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(name + " produced non-finite values")
    return (float((pref_k - pref_p).abs().max()), _rel(pref_k, pref_p),
            float((ga_k - ga_p).abs().max()), _rel(ga_k, ga_p),
            chain.ladder_level(n1), chain.ladder_level(ninf))


def phase_kernels(dev, headline_w):
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    rng = np.random.default_rng(0)
    n_b = 1 + 2 * CONTROL_COUNT
    # Ladder levels 0..4 at step counts that split unevenly (segment plan
    # S x L = 126 x 8 for 1001 steps, 5 x 8 for 37).
    for n_steps, targets in ((1001, (0.03, 0.3, 1.0, 2.5, 7.0)),
                             (37, (0.03, 7.0))):
        w = rng.normal(size=(n_steps, n_b)).astype(np.float32)
        for target in targets:
            basis = _scaled_basis(rng, D, n_b, w, target)
            op_k = ChainExpmPropagate(basis, dev, torch.float32)
            op_p = ChainExpmPropagate(basis, dev, torch.float32, plain=True)
            err1, rel1, err2, rel2, lv1, lv2 = _compare_kernels(
                op_k, torch.as_tensor(w, device=dev))
            # The autograd op end to end: total and weight gradient.
            tgt = torch.as_tensor(_random_hermitian(rng, D), device=dev)
            outs = []
            for op in (op_k, op_p):
                wt = torch.as_tensor(w, device=dev).requires_grad_(True)
                total = op(wt)
                loss = torch.sum(torch.abs(total - tgt) ** 2)
                grad, = torch.autograd.grad(loss, wt)
                outs.append((total.detach(), grad))
            torch.cuda.synchronize()
            rel_total = _rel(outs[0][0], outs[1][0])
            rel_grad = _rel(outs[0][1], outs[1][1])
            print("phase 3 kernels: steps={} level fwd/bwd={}/{} K1 rel "
                  "{:.2e} K2 rel {:.2e} total rel {:.2e} grad rel {:.2e}"
                  "".format(n_steps, lv1, lv2, rel1, rel2, rel_total,
                            rel_grad), flush=True)
            if max(rel1, rel_total) > FWD_RTOL or max(rel2, rel_grad) > \
                    GRAD_RTOL:
                raise RuntimeError("kernel disagrees with its plain version")
    # The headline's own shapes and weights (10^4 steps, S x L = 127 x 79).
    op = ChainExpmPropagate(table3_basis(), dev, torch.float32)
    err1, rel1, err2, rel2, lv1, lv2 = _compare_kernels(op, headline_w)
    print("phase 3 kernels: headline shapes level fwd/bwd={}/{} K1 max|err| "
          "{:.3e} (rel {:.2e}) K2 max|err| {:.3e} (rel {:.2e})".format(
              lv1, lv2, err1, rel1, err2, rel2), flush=True)
    if rel1 > FWD_RTOL or rel2 > GRAD_RTOL:
        raise RuntimeError("kernel disagrees with its plain version at the "
                           "headline shapes")
    worst = {"K1": err1, "K2": err2}
    # Independent reference on a small input: float64 matrix_exp product.
    w = rng.normal(size=(37, n_b)).astype(np.float32)
    basis = _scaled_basis(rng, D, n_b, w, 1.0)
    total = ChainExpmPropagate(basis, dev, torch.float32)(
        torch.as_tensor(w, device=dev))
    a = torch.einsum("jk,kab->jab", torch.as_tensor(w, dtype=torch.float64,
                                                    device=dev).to(
                                                        torch.complex128),
                     torch.as_tensor(basis, device=dev))
    want = torch.eye(D, dtype=torch.complex128, device=dev)
    for u in torch.linalg.matrix_exp(a):
        want = u @ want
    rel = _rel(total.to(torch.complex128), want)
    print("phase 3 kernels: 37 steps vs float64 matrix_exp product rel "
          "{:.2e}".format(rel), flush=True)
    if rel > FWD_RTOL:
        raise RuntimeError("chain op disagrees with the matrix_exp product")
    return worst


def table3_basis():
    pstate, hamiltonian, _ = table3_problem(1)
    return hamiltonian.generator_basis(float(pstate.dt))


def phase_headline(dev):
    """Loss and gradient of the Table-3 problem: the kernel route
    (build_schroedinger_loss) against the same loss over the plain op."""
    from qoc_tpu_torch.core.common import (slap_controls_torch,
                                           strip_controls)
    from qoc_tpu_torch.core.schroedinger import (build_schroedinger_loss,
                                                 fused_weights)
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate

    pstate, hamiltonian, costs = table3_problem(1)
    shape = pstate.controls_shape
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    kernel_loss = build_schroedinger_loss(pstate, dev, torch.float32)
    plain_op = ChainExpmPropagate(hamiltonian.generator_basis(dt), dev,
                                  torch.float32, plain=True)
    times = torch.arange(n_steps, dtype=torch.float32, device=dev) * dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    initial = torch.as_tensor(pstate.initial_states, dtype=torch.complex64,
                              device=dev)

    def plain_loss(controls):
        states = plain_op(fused_weights(controls, times, cet, dt)) @ initial
        return costs[0].cost(controls, states, n_steps), states

    flat0 = strip_controls(True, pstate.initial_controls)
    results = []
    for loss in (kernel_loss, plain_loss):
        flat = torch.as_tensor(flat0, dtype=torch.float32,
                               device=dev).requires_grad_(True)
        error, states = loss(slap_controls_torch(True, flat, shape))
        grad, = torch.autograd.grad(error, flat)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(error)) and
                bool(torch.isfinite(grad).all())):
            raise RuntimeError("non-finite headline loss or gradient")
        results.append((error.detach(), grad))
    rel_err = float(abs(results[0][0] - results[1][0]) / abs(results[1][0]))
    rel_grad = _rel(results[0][1], results[1][1])
    print("phase 4 headline loss: kernel {:.8f} plain {:.8f} rel {:.2e}; "
          "gradient rel {:.2e} ({} params)".format(
              float(results[0][0]), float(results[1][0]), rel_err, rel_grad,
              results[0][1].numel()), flush=True)
    if rel_err > GRAD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("headline loss/gradient: kernel route disagrees "
                           "with the plain route")


def phase_grape(dev):
    from qoc_tpu_torch import grape_schroedinger_discrete

    pstate, hamiltonian, costs = table3_problem(1)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, CONTROL_EVAL_COUNT, costs, EVOLUTION_TIME,
        hamiltonian, pstate.initial_states, SYSTEM_EVAL_COUNT,
        complex_controls=True, initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = read_launches()
    errors = np.asarray(result.errors)
    print("phase 5 grape: {} iterations, {:.2f} it/s steady ({} timed after "
          "{} warm-up), error {:.6f} -> {:.6f}, launches {}".format(
              result.iteration_count_ran, result.iterations_per_s,
              TIMED_ITERATIONS, WARMUP_ITERATIONS, errors[0], errors[-1],
              launches), flush=True)
    if result.iteration_count_ran != iterations:
        raise RuntimeError("GRAPE stopped early")
    if not (np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_states))):
        raise RuntimeError("non-finite GRAPE result")
    if not errors[-1] < errors[0]:
        raise RuntimeError("GRAPE error did not fall")
    if min(launches["K1"], launches["K2"]) < 1:
        raise RuntimeError("the GRAPE run did not launch both kernels")
    if launches["K5 fwd"] or launches["K5 bwd"]:
        raise RuntimeError("the fused route launched the plane kernels")
    if launches["K2 step"]:
        raise RuntimeError("the final cost alone ran K2's per-step mode")
    return launches, result.iterations_per_s


def phase_timing(dev, headline_w):
    from qoc_tpu_torch.ops import chain

    op = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32)
    n_steps = headline_w.shape[0]
    s_count, length = chain.segment_plan(n_steps)
    w_seg = torch.zeros((s_count * length, op.n_b), device=dev)
    w_seg[:n_steps] = headline_w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(headline_w, op.basis_ri, op.d)
    pref = chain.chain_fwd(w_seg, op.basis, n1)
    seeds = torch.eye(op.dp, dtype=torch.complex64, device=dev).expand(
        s_count, op.dp, op.dp).contiguous()
    ms = {
        "K1": cuda_ms(lambda: chain.chain_fwd(w_seg, op.basis, n1), 10),
        "K1 plain": cuda_ms(
            lambda: chain.chain_fwd_plain(w_seg, op.basis, n1), 3),
        "K2": cuda_ms(lambda: chain.chain_bwd(w_seg, op.basis_h, ninf, pref,
                                              seeds), 10),
        "K2 plain": cuda_ms(lambda: chain.chain_bwd_plain(
            w_seg, op.basis_h, ninf, pref, seeds), 3),
    }
    plain_op = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32,
                                        plain=True)

    def fwd_bwd(the_op):
        w = headline_w.detach().requires_grad_(True)
        torch.autograd.grad(torch.sum(torch.abs(the_op(w)) ** 2), w)

    ms["op fwd+bwd"] = cuda_ms(lambda: fwd_bwd(op), 5)
    ms["op fwd+bwd plain"] = cuda_ms(lambda: fwd_bwd(plain_op), 2)
    # The generators the kernels exponentiate, for the bounds and the
    # library yardstick (exps only, no chain).
    a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, op.n_b).to(
        torch.complex64), op.basis)
    ms["matrix_exp"] = cuda_ms(lambda: torch.linalg.matrix_exp(a), 3)
    absa = a.abs()
    bounds = {
        "K1": kernel_bound(absa.sum(-2).amax(-1), chain.ladder_level(n1),
                           False, [w_seg, op.basis, n1, pref]),
        "K2": kernel_bound(absa.sum(-1).amax(-1), chain.ladder_level(ninf),
                           True, [w_seg, op.basis_h, ninf, pref, seeds,
                                  pref[:, 1:]]),
    }
    print("phase 6 timing (S x L = {} x {}, levels {}/{}): ".format(
        s_count, length, chain.ladder_level(n1), chain.ladder_level(ninf))
        + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
        + "; " + ", ".join(
            "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time"
            "".format(k, b[0], b[1], b[2], b[0] / ms[k])
            for k, b in bounds.items()), flush=True)
    return ms, bounds


def _unit_planes(rng, n_steps, d):
    """(n_steps, d, d) anti-Hermitian planes (unitary steps) with unit
    batch-max 1-norm, complex128 numpy."""
    h = rng.normal(size=(n_steps, d, d)) + 1j * rng.normal(
        size=(n_steps, d, d))
    a = -0.5j * (h + np.conjugate(np.swapaxes(h, -1, -2)))
    return a / np.abs(a).sum(-2).max()


def _segment_planes(a):
    """The plane op's kernel inputs for planes ``a`` (B, d, d): a_seg
    (S, L, 64, 64) zero-padded, and the batch-max 1- and inf-norms."""
    from qoc_tpu_torch.ops import chain
    n_steps, d = a.shape[0], a.shape[-1]
    s_count, length = chain.segment_plan(n_steps)
    a_seg = torch.zeros((s_count * length, chain.KERNEL_DP,
                         chain.KERNEL_DP), dtype=torch.complex64,
                        device=a.device)
    a_seg[:n_steps, :d, :d] = a
    n1, ninf = chain._plane_norm_max(a)
    return a_seg.reshape(s_count, length, chain.KERNEL_DP,
                         chain.KERNEL_DP), n1, ninf


def _compare_plane_kernels(a):
    """K5 forward and adjoint against their plain versions on the same
    inputs: (max |err| fwd, rel fwd, max |err| bwd, rel bwd, levels,
    kernel prefixes)."""
    from qoc_tpu_torch.ops import chain
    a_seg, n1, ninf = _segment_planes(a)
    pref_k = chain.plane_fwd(a_seg, n1)
    pref_p = chain.plane_fwd_plain(a_seg, n1)
    gen = torch.Generator(device=a.device).manual_seed(1)
    seeds = torch.randn((a_seg.shape[0], chain.KERNEL_DP, chain.KERNEL_DP),
                        dtype=torch.complex64, device=a.device, generator=gen)
    ga_k = chain.plane_bwd(a_seg, ninf, pref_p, seeds)
    ga_p = chain.plane_bwd_plain(a_seg, ninf, pref_p, seeds)
    torch.cuda.synchronize()
    for name, x in (("K5 fwd", pref_k), ("K5 bwd", ga_k)):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(name + " produced non-finite values")
    return (float((pref_k - pref_p).abs().max()), _rel(pref_k, pref_p),
            float((ga_k - ga_p).abs().max()), _rel(ga_k, ga_p),
            (chain.ladder_level(n1), chain.ladder_level(ninf)), pref_k)


def _check_padding(pref, d, n_steps):
    """Padded rows and columns of every prefix, and the prefixes after the
    last real step, exactly the identity's."""
    eye = torch.eye(pref.shape[-1] - d, dtype=pref.dtype, device=pref.device)
    last = n_steps - (pref.shape[0] - 1) * (pref.shape[1] - 1)
    tail = pref[-1, last:]
    if not (torch.equal(pref[..., d:, d:], eye.expand_as(pref[..., d:, d:]))
            and not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
            and torch.equal(tail, tail[:1].expand_as(tail))):
        raise RuntimeError("chain padding is not exactly the identity "
                           "(d = {}, {} steps)".format(d, n_steps))


def phase_plane_kernels(dev):
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    rng = np.random.default_rng(0)
    for d in (D, 16):
        for n_steps in (3, 37, M4_STEPS):
            base = _unit_planes(rng, n_steps, d)
            tgt = torch.as_tensor(_random_hermitian(rng, d), device=dev)
            rows = []
            for target in LEVEL_NORMS:
                a = torch.as_tensor((base * target).astype(np.complex64),
                                    device=dev)
                err1, rel1, err2, rel2, levels, pref = \
                    _compare_plane_kernels(a)
                if d < D:
                    _check_padding(pref, d, n_steps)
                # The autograd op end to end: total and plane gradient.
                outs = []
                for plain in (False, True):
                    at = a.clone().requires_grad_(True)
                    total = plane_chain_propagate(at, plain)
                    loss = torch.sum(torch.abs(total - tgt) ** 2)
                    grad, = torch.autograd.grad(loss, at)
                    outs.append((total.detach(), grad))
                torch.cuda.synchronize()
                rel_total = _rel(outs[0][0], outs[1][0])
                rel_grad = _rel(outs[0][1], outs[1][1])
                rows.append("{}/{} {:.1e} {:.1e} {:.1e} {:.1e}".format(
                    *levels, rel1, rel2, rel_total, rel_grad))
                if max(rel1, rel_total) > FWD_RTOL or \
                        max(rel2, rel_grad) > GRAD_RTOL:
                    raise RuntimeError(
                        "K5 disagrees with its plain version (d = {}, {} "
                        "steps, levels {})".format(d, n_steps, levels))
            print("phase 7 plane kernels: d={} steps={} (levels fwd/bwd, rel "
                  "fwd, bwd, op total, op grad): {}{}".format(
                      d, n_steps, "; ".join(rows),
                      "; padding exact" if d < D else ""), flush=True)
    # Independent reference on a small input: float64 matrix_exp product.
    a = torch.as_tensor(_unit_planes(rng, 37, D).astype(np.complex64),
                        device=dev)
    total = plane_chain_propagate(a)
    want = torch.eye(D, dtype=torch.complex128, device=dev)
    for u in torch.linalg.matrix_exp(a.to(torch.complex128)):
        want = u @ want
    rel = _rel(total.to(torch.complex128), want)
    # The main path's own inputs: the M4 problem's planes.
    err1, rel1, err2, rel2, levels, _ = _compare_plane_kernels(m4_planes(dev))
    print("phase 7 plane kernels: 37 steps vs float64 matrix_exp product rel "
          "{:.2e}; M4 planes levels fwd/bwd {}/{} K5 fwd max|err| {:.3e} (rel "
          "{:.2e}) K5 bwd max|err| {:.3e} (rel {:.2e})".format(
              rel, *levels, err1, rel1, err2, rel2), flush=True)
    if rel > FWD_RTOL:
        raise RuntimeError("plane op disagrees with the matrix_exp product")
    if rel1 > FWD_RTOL or rel2 > GRAD_RTOL:
        raise RuntimeError("K5 disagrees with its plain version at the M4 "
                           "planes")
    return {"K5 fwd": err1, "K5 bwd": err2}


def phase_cross_route(dev):
    """The headline's M2 chain through K1/K2 and through K5: the same
    exp(-i dt H(c(t_mid))) steps, built two ways."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss

    pstate, hamiltonian, _ = table3_problem(1)
    shape = pstate.controls_shape
    flat0 = strip_controls(True, pstate.initial_controls)
    results = []
    for ham in (hamiltonian, torch_callable(hamiltonian, dev)):
        pstate.hamiltonian = ham
        reset_launches()
        loss = build_schroedinger_loss(pstate, dev, torch.float32)
        flat = torch.as_tensor(flat0, dtype=torch.float32,
                               device=dev).requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat, shape))
        grad, = torch.autograd.grad(error, flat)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(error)) and
                bool(torch.isfinite(grad).all())):
            raise RuntimeError("non-finite cross-route loss or gradient")
        results.append((error.detach(), grad, read_launches()))
    (fused, g_fused, l_fused), (plane, g_plane, l_plane) = results
    rel_err = float(abs(plane - fused) / abs(fused))
    rel_grad = _rel(g_plane, g_fused)
    print("phase 8 cross-route ({} steps, M2): fused K1/K2 {:.8f} plane "
          "K5 {:.8f} rel {:.2e}; gradient rel {:.2e}; launches fused {} "
          "plane {}".format(pstate.system_eval_count - 1, float(fused),
                            float(plane), rel_err, rel_grad, l_fused,
                            l_plane), flush=True)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the plane route disagrees with the fused route")
    if not (l_fused["K1"] and l_fused["K2"] and l_plane["K5 fwd"]
            and l_plane["K5 bwd"] and not l_plane["K1"]
            and not l_fused["K5 fwd"]):
        raise RuntimeError("a route did not run its own kernels")


def iswap_problem(dev):
    """examples/2_iswap_gate.py of the JAX package with torch operations:
    two 4-level transmons (d = 16), iSWAP as 4-state transfer."""
    from qoc_tpu_torch import TargetStateInfidelity
    levels = 4
    a = np.diag(np.sqrt(np.arange(1, levels)), 1)
    a1 = np.kron(a, np.eye(levels))
    a2 = np.kron(np.eye(levels), a)
    anharmonicity, coupling = -0.2 * 2 * np.pi, 0.01 * 2 * np.pi
    h0 = (anharmonicity / 2 * (a1.T @ a1.T @ a1 @ a1)
          + anharmonicity / 2 * (a2.T @ a2.T @ a2 @ a2)
          + coupling * (a1.T @ a2 + a2.T @ a1))
    h0_t, a1_t, a2_t = (torch.as_tensor(x, dtype=torch.complex64, device=dev)
                        for x in (h0, a1, a2))

    def hamiltonian(controls, time):
        return (h0_t + controls[0] * a1_t + controls[0].conj() * a1_t.T
                + controls[1] * a2_t + controls[1].conj() * a2_t.T)

    def basis(i, j):
        v = np.zeros((levels * levels, 1))
        v[i * levels + j] = 1
        return v

    initial = np.stack([basis(0, 0), basis(0, 1), basis(1, 0), basis(1, 1)])
    target = np.stack([basis(0, 0), 1j * basis(1, 0), 1j * basis(0, 1),
                       basis(1, 1)])
    return hamiltonian, initial, [TargetStateInfidelity(target)]


def phase_m4_grape(dev):
    from qoc_tpu_torch import grape_schroedinger_discrete
    from qoc_tpu_torch.models import MagnusPolicy

    pstate, hamiltonian, costs = m4_problem(1)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, M4_STEPS, costs, M4_EVOLUTION_TIME, hamiltonian,
        pstate.initial_states, M4_STEPS, complex_controls=True,
        initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        magnus_policy=MagnusPolicy.M4,
        max_control_norms=pstate.max_control_norms,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = read_launches()
    errors = np.asarray(result.errors)
    print("phase 9 M4 grape: {} iterations, {:.2f} it/s steady ({} timed "
          "after {} warm-up), error {:.6f} -> {:.6f}, launches {}".format(
              result.iteration_count_ran, result.iterations_per_s,
              TIMED_ITERATIONS, WARMUP_ITERATIONS, errors[0], errors[-1],
              launches), flush=True)
    if result.iteration_count_ran != iterations:
        raise RuntimeError("M4 GRAPE stopped early")
    if not (np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_states))):
        raise RuntimeError("non-finite M4 GRAPE result")
    if not errors[-1] < errors[0]:
        raise RuntimeError("M4 GRAPE error did not fall")
    if min(launches["K5 fwd"], launches["K5 bwd"]) < 1 or \
            launches["K1"] or launches["K2"]:
        raise RuntimeError("the M4 GRAPE run did not go through K5 alone")

    hamiltonian, initial, costs = iswap_problem(dev)
    iswap = grape_schroedinger_discrete(
        2, 241, costs, 120.0, hamiltonian, initial, 241,
        complex_controls=True, iteration_count=ISWAP_ITERATIONS,
        log_iteration_step=0,
        max_control_norms=np.full(2, 0.05 * 2 * np.pi), device=dev)
    iswap_errors = np.asarray(iswap.errors)
    print("phase 9 iSWAP grape (d=16, 4 states, 241 steps, M2 callable): {} "
          "iterations, error {:.6f} -> {:.6f}".format(
              iswap.iteration_count_ran, iswap_errors[0], iswap_errors[-1]),
          flush=True)
    if not (np.all(np.isfinite(iswap_errors))
            and iswap_errors[-1] < iswap_errors[0]):
        raise RuntimeError("iSWAP GRAPE error did not fall")
    return launches, result.iterations_per_s


def phase_plane_timing(dev):
    from qoc_tpu_torch.ops import chain

    a = m4_planes(dev)
    a_seg, n1, ninf = _segment_planes(a)
    s_count, length = a_seg.shape[:2]
    pref = chain.plane_fwd(a_seg, n1)
    seeds = torch.eye(chain.KERNEL_DP, dtype=torch.complex64,
                      device=dev).expand(s_count, chain.KERNEL_DP,
                                         chain.KERNEL_DP).contiguous()
    ms = {
        "K5 fwd": cuda_ms(lambda: chain.plane_fwd(a_seg, n1), 10),
        "K5 fwd plain": cuda_ms(lambda: chain.plane_fwd_plain(a_seg, n1), 3),
        "K5 bwd": cuda_ms(lambda: chain.plane_bwd(a_seg, ninf, pref, seeds),
                          10),
        "K5 bwd plain": cuda_ms(lambda: chain.plane_bwd_plain(
            a_seg, ninf, pref, seeds), 3),
        "matrix_exp": cuda_ms(lambda: torch.linalg.matrix_exp(a), 10),
        "planes mH": cuda_ms(lambda: a_seg.mH.contiguous(), 10),
    }
    absa = a_seg.reshape(-1, chain.KERNEL_DP, chain.KERNEL_DP).abs()
    bounds = {
        "K5 fwd": kernel_bound(absa.sum(-2).amax(-1), chain.ladder_level(n1),
                               False, [a_seg, n1, pref]),
        "K5 bwd": kernel_bound(absa.sum(-1).amax(-1),
                               chain.ladder_level(ninf), True,
                               [a_seg, ninf, pref, seeds, pref[:, 1:]]),
    }
    print("phase 10 timing (M4 planes, S x L = {} x {}, levels {}/{}): "
          "".format(s_count, length, chain.ladder_level(n1),
                    chain.ladder_level(ninf))
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time"
              "".format(k, b[0], b[1], b[2], b[0] / ms[k])
              for k, b in bounds.items()), flush=True)
    return ms, bounds


def _random_planes(gen, batch, d, target_norm, dev):
    """(batch, d, d) anti-Hermitian complex64 matrices (unitary exps) with
    batch-max 1-norm ``target_norm``, drawn on the card from ``gen``."""
    h = torch.randn((batch, d, d), dtype=torch.complex64, device=dev,
                    generator=gen)
    a = -0.5j * (h + h.mH)
    return a * (target_norm / a.abs().sum(-2).amax())


def _compare_expm_kernels(a, b, g):
    """K3 at a and K4 at (b, g) against their plain versions: (rel K3,
    rel K4, max |err| K3, max |err| K4, ladder levels of a and b)."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    k3, p3 = expm_cuda.expm_fwd(a), expm_cuda.expm_fwd_plain(a)
    k4 = expm_cuda.expm_frechet_fwd(b, g)
    p4 = expm_cuda.expm_frechet_plain(b, g)
    torch.cuda.synchronize()
    for name, x in (("K3", k3), ("K4", k4)):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(name + " produced non-finite values")
    levels = tuple(chain.ladder_level(expm_cuda._norm_max(x)) for x in (a, b))
    return (_rel(k3, p3), _rel(k4, p4), float((k3 - p3).abs().max()),
            float((k4 - p4).abs().max()), levels)


def _check_expm_padding(a):
    """K3's padded rows and columns exactly the identity's and K4's exactly
    zero, read from the kernels' padded outputs."""
    from qoc_tpu_torch.ops import expm_cuda
    d = a.shape[-1]
    dp = expm_cuda.kernel_dp(d)
    x = expm_cuda._padded(a, dp)
    norm = expm_cuda._norm_max(x)
    u = expm_cuda._launch(False, dp, norm, x)
    dl = expm_cuda._launch(True, dp, norm, x, expm_cuda._padded(a, dp))
    eye = torch.eye(dp - d, dtype=u.dtype, device=u.device).expand(
        u.shape[0], dp - d, dp - d)
    if not (torch.equal(u[:, d:, d:], eye)
            and not bool(u[:, :d, d:].any() or u[:, d:, :d].any())
            and not bool(dl[:, d:].any() or dl[:, :, d:].any())):
        raise RuntimeError("K3/K4 padding is not exact (d = {})".format(d))


def phase_expm_kernels(dev):
    """K3/K4 against their plain versions on every ladder level, at each d
    of EXPM_DIMS and each batch of EXPM_BATCHES; padding exact; and, at
    batch 37, against float64 matrix_exp and its autograd."""
    from qoc_tpu_torch.ops import expm_cuda
    gen = torch.Generator(device=dev).manual_seed(3)
    for d in EXPM_DIMS:
        for batch in EXPM_BATCHES:
            g = torch.randn((batch, d, d), dtype=torch.complex64, device=dev,
                            generator=gen)
            rows = []
            for target in LEVEL_NORMS:
                a = _random_planes(gen, batch, d, target, dev)
                rel3, rel4, _, _, (level, _) = _compare_expm_kernels(a, a, g)
                rows.append("{} {:.1e} {:.1e}".format(level, rel3, rel4))
                if rel3 > FWD_RTOL or rel4 > GRAD_RTOL:
                    raise RuntimeError(
                        "K3/K4 disagree with their plain versions (d = {}, "
                        "batch {}, level {})".format(d, batch, level))
                if batch == 37:
                    _check_expm_padding(a)
                    a64 = a.to(torch.complex128).requires_grad_(True)
                    u64 = torch.linalg.matrix_exp(a64)
                    grad64, = torch.autograd.grad(u64, a64,
                                                  g.to(torch.complex128))
                    rel_u = _rel(expm_cuda.expm_fwd(a).to(torch.complex128),
                                 u64.detach())
                    rel_g = _rel(expm_cuda.expm_frechet_fwd(a.mH, g).to(
                        torch.complex128), grad64)
                    rows[-1] += " f64 {:.1e} {:.1e}".format(rel_u, rel_g)
                    if rel_u > FWD_RTOL or rel_g > GRAD_RTOL:
                        raise RuntimeError(
                            "K3/K4 disagree with float64 matrix_exp (d = {}, "
                            "level {})".format(d, level))
            print("phase 11 expm kernels: d={} (padded {}) batch={} (level, "
                  "rel K3, K4 vs plain[, vs float64 matrix_exp]): {}{}"
                  "".format(d, expm_cuda.kernel_dp(d), batch,
                            "; ".join(rows),
                            "; padding exact" if batch == 37 else ""),
                  flush=True)


def phase_d128_grape(dev):
    """The slice at full width: the d = 2^7 GRAPE through the blocked route,
    K3 and K4 launched every iteration, K1/K2/K5 never."""
    from qoc_tpu_torch import grape_schroedinger_discrete
    pstate, hamiltonian, costs = d128_problem()
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, D128_STEPS, costs, D128_EVOLUTION_TIME, hamiltonian,
        pstate.initial_states, D128_STEPS, complex_controls=True,
        initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = read_launches()
    errors = np.asarray(result.errors)
    print("phase 12 d=128 grape (10 complex controls, {} points, M2, blocked "
          "route): {} iterations, {:.2f} it/s steady ({} timed after {} "
          "warm-up), error {:.6f} -> {:.6f}, launches {}".format(
              D128_STEPS, result.iteration_count_ran,
              result.iterations_per_s, TIMED_ITERATIONS, WARMUP_ITERATIONS,
              errors[0], errors[-1], launches), flush=True)
    if result.iteration_count_ran != iterations:
        raise RuntimeError("d = 128 GRAPE stopped early")
    if not (np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_states))):
        raise RuntimeError("non-finite d = 128 GRAPE result")
    if not errors[-1] < errors[0]:
        raise RuntimeError("d = 128 GRAPE error did not fall")
    if launches["K3"] != iterations or launches["K4"] != iterations:
        raise RuntimeError("the d = 128 GRAPE did not launch K3 and K4 "
                           "every iteration")
    if any(launches[k] for k in ("K1", "K2", "K5 fwd", "K5 bwd")):
        raise RuntimeError("the d = 128 GRAPE launched a chain kernel")
    return launches, result.iterations_per_s


def _loss_grad(loss, pstate, dev, dtype=torch.float32):
    """(loss, gradient) of ``loss`` at the problem's initial controls."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    flat = torch.as_tensor(strip_controls(True, pstate.initial_controls),
                           dtype=dtype, device=dev).requires_grad_(True)
    error = loss(slap_controls_torch(True, flat, pstate.controls_shape))[0]
    grad, = torch.autograd.grad(error, flat)
    return error.detach(), grad


def phase_blocked_vs_plane(dev):
    """The M4 problem through the blocked route (allow_plane_chain=False:
    K3/K4) and the plane route (K5): loss, gradient, time and launches."""
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    pstate, _, _ = m4_problem(1)
    out, ms = {}, {}
    for route, allow in (("blocked", False), ("plane", True)):
        loss = build_schroedinger_loss(pstate, dev, torch.float32,
                                       allow_plane_chain=allow)
        reset_launches()
        error, grad = _loss_grad(loss, pstate, dev)
        torch.cuda.synchronize()
        launches = read_launches()
        if not (bool(torch.isfinite(error)) and
                bool(torch.isfinite(grad).all())):
            raise RuntimeError("non-finite {} loss or gradient".format(route))
        out[route] = (error, grad, launches)
        ms[route] = cuda_ms(lambda: _loss_grad(loss, pstate, dev), 5)
    (e_b, g_b, l_b), (e_p, g_p, l_p) = out["blocked"], out["plane"]
    rel_err = float(abs(e_b - e_p) / abs(e_p))
    rel_grad = _rel(g_b, g_p)
    print("phase 13 blocked vs plane (M4, {} steps): blocked K3/K4 {:.8f} "
          "plane K5 {:.8f} rel {:.2e}; gradient rel {:.2e}; loss+gradient "
          "blocked {:.3f} ms, plane {:.3f} ms; launches blocked {} plane {}"
          "".format(pstate.system_eval_count - 1, float(e_b), float(e_p),
                    rel_err, rel_grad, ms["blocked"], ms["plane"], l_b, l_p),
          flush=True)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the blocked route disagrees with the plane route")
    if not (l_b["K3"] == 1 and l_b["K4"] == 1 and l_p["K5 fwd"] == 1
            and l_p["K5 bwd"] == 1 and not l_b["K5 fwd"] and not l_p["K3"]):
        raise RuntimeError("a route did not run its own kernels")
    return ms


def make_iteration(pstate, dev, build_loss=None):
    """One GRAPE iteration of core/graperunner.py on ``pstate`` (clip,
    loss, gradient, Adam update); returns the error. ``build_loss``:
    build_schroedinger_loss, or build_lindblad_loss for a Lindblad
    state."""
    from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                           slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    shape = pstate.controls_shape
    loss = (build_loss or build_schroedinger_loss)(pstate, dev,
                                                   torch.float32)
    mcn = torch.as_tensor(pstate.max_control_norms, dtype=torch.float32,
                          device=dev)
    adam = pstate.optimizer
    params = strip_controls_torch(True, torch.as_tensor(
        pstate.initial_controls, dtype=torch.complex64, device=dev))
    state = {"params": params, "opt": adam.init_state(params)}

    def iteration():
        controls = clip_control_norms_torch(
            slap_controls_torch(True, state["params"], shape), mcn)
        flat = strip_controls_torch(True, controls).detach()
        flat.requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat, shape))
        grads, = torch.autograd.grad(error, flat)
        state["opt"], state["params"] = adam.update(state["opt"], grads,
                                                    state["params"])
        return error
    return iteration


def phase_d1024_backprop(dev):
    """The Table-1 d = 2^10 single-step backprop through the blocked route
    on torch.matmul (no kernel): 20 timed GRAPE iterations (clip, loss,
    gradient, Adam) after 2 warm-up ones, K3/K4 never launched, and the
    gradient against a float64 run of the same route on the card."""
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss

    pstate, _, _ = d1024_problem()
    iteration = make_iteration(pstate, dev)
    reset_launches()
    for _ in range(WARMUP_ITERATIONS):
        iteration()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(BACKPROP_ITERATIONS):
        error = iteration()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3 / BACKPROP_ITERATIONS
    launches = read_launches()
    results = [_loss_grad(build_schroedinger_loss(pstate, dev, dtype), pstate,
                          dev, dtype)
               for dtype in (torch.float32, torch.float64)]
    torch.cuda.synchronize()
    (e32, g32), (e64, g64) = results
    rel_err = float(abs(e32.double() - e64) / abs(e64))
    rel_grad = _rel(g32.double(), g64)
    print("phase 14 d=1024 backprop (1 step, blocked route, torch.matmul "
          "Taylor): {:.3f} ms/iteration over {} iterations ({:.2f} it/s), "
          "error {:.6f}; float32 vs float64 loss rel {:.2e}, gradient rel "
          "{:.2e}; launches {}".format(
              ms, BACKPROP_ITERATIONS, 1e3 / ms, float(error.detach()),
              rel_err, rel_grad, launches), flush=True)
    if not bool(torch.isfinite(error)):
        raise RuntimeError("non-finite d = 1024 loss")
    if any(launches.values()):
        raise RuntimeError("the d = 1024 route launched a kernel")
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the d = 1024 gradient disagrees with float64")
    return ms


def phase_expm_timing(dev):
    """K3 and K4 as the blocked route calls them (K3 at the planes A, K4 at
    (A^H, G)), at the d = 128 GRAPE's planes and at the M4 planes: kernel
    and plain times, bounds, and torch.linalg.matrix_exp forward and
    backward on the same inputs (the library yardstick, only timed here)."""
    from qoc_tpu_torch.ops import expm_cuda
    out = {}
    for label, a in (("d=128", initial_planes(*d128_problem()[:2], dev)),
                     ("M4", m4_planes(dev))):
        gen = torch.Generator(device=dev).manual_seed(2)
        g = torch.randn(a.shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        ah = a.mH.contiguous()
        rel3, rel4, err3, err4, (lv3, lv4) = _compare_expm_kernels(a, ah, g)
        if rel3 > FWD_RTOL or rel4 > GRAD_RTOL:
            raise RuntimeError("K3/K4 disagree with their plain versions at "
                               "the {} planes".format(label))
        a_req = a.clone().requires_grad_(True)
        u = torch.linalg.matrix_exp(a_req)
        ms = {
            "K3": cuda_ms(lambda: expm_cuda.expm_fwd(a), 10),
            "K3 plain": cuda_ms(lambda: expm_cuda.expm_fwd_plain(a), 3),
            "K3 library": cuda_ms(lambda: torch.linalg.matrix_exp(a), 5),
            "K4": cuda_ms(lambda: expm_cuda.expm_frechet_fwd(ah, g), 10),
            "K4 plain": cuda_ms(
                lambda: expm_cuda.expm_frechet_plain(ah, g), 3),
            "K4 library": cuda_ms(lambda: torch.autograd.grad(
                u, a_req, g, retain_graph=True), 3),
        }
        dp = expm_cuda.kernel_dp(a.shape[-1])
        bounds = {
            "K3": kernel_bound(a.abs().sum(-2).amax(-1), lv3, False, [a, a],
                               dp, chain=False),
            "K4": kernel_bound(ah.abs().sum(-2).amax(-1), lv4, True,
                               [ah, g, g], dp, chain=False),
        }
        print("phase 15 expm timing ({} planes {}, levels K3/K4 {}/{}, rel "
              "vs plain {:.1e}/{:.1e}): ".format(
                  label, tuple(a.shape), lv3, lv4, rel3, rel4)
              + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
              + "; " + ", ".join(
                  "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its "
                  "time".format(k, b[0], b[1], b[2], b[0] / ms[k])
                  for k, b in bounds.items()), flush=True)
        out[label] = (ms, bounds, {"K3": err3, "K4": err4})
    return out["d=128"]


def _stream_planes(gen, n_steps, d, target_norm, dev):
    """(n_steps, d, d) complex64 planes K + D, drawn on the card: K
    anti-Hermitian, D = -N N^H Hermitian negative semidefinite at a tenth of
    K's 1-norm (a decaying, non-normal step, as a Lindblad generator is;
    exp(A)^H is not its inverse), scaled to batch-max 1-norm
    ``target_norm``."""
    h = torch.randn((n_steps, d, d), dtype=torch.complex64, device=dev,
                    generator=gen)
    n = torch.randn((n_steps, d, d), dtype=torch.complex64, device=dev,
                    generator=gen)
    k = -0.5j * (h + h.mH)
    nn = n @ n.mH
    scale = k.abs().sum(-2).amax(-1) / nn.abs().sum(-2).amax(-1)
    a = k - 0.1 * scale[:, None, None] * nn
    return a * (target_norm / a.abs().sum(-2).amax())


def _stream_inputs(a):
    """The plane op's K6 inputs for planes ``a`` (B, d, d): a_seg (S, L, dp,
    dp) zero-padded on K6's segment plan, and the batch-max 1- and
    inf-norms."""
    from qoc_tpu_torch.ops import chain
    n_steps, d = a.shape[0], a.shape[-1]
    dp = chain.kernel_dp(d)
    s_count, length = chain.stream_segment_plan(n_steps)
    a_seg = torch.zeros((s_count * length, dp, dp), dtype=torch.complex64,
                        device=a.device)
    a_seg[:n_steps, :d, :d] = a
    n1, ninf = chain._plane_norm_max(a)
    return a_seg.reshape(s_count, length, dp, dp), n1, ninf


def _compare_stream_kernels(a):
    """K6 forward and adjoint against their plain versions on the same
    inputs: (rel fwd, rel bwd, max |err| fwd, max |err| bwd, levels, kernel
    prefixes)."""
    from qoc_tpu_torch.ops import chain
    a_seg, n1, ninf = _stream_inputs(a)
    pref_k = chain.stream_fwd(a_seg, n1)
    pref_p = chain.stream_fwd_plain(a_seg, n1)
    gen = torch.Generator(device=a.device).manual_seed(1)
    seeds = torch.randn((a_seg.shape[0],) + a_seg.shape[2:],
                        dtype=torch.complex64, device=a.device, generator=gen)
    ga_k = chain.stream_bwd(a_seg, ninf, pref_p, seeds)
    ga_p = chain.stream_bwd_plain(a_seg, ninf, pref_p, seeds)
    torch.cuda.synchronize()
    for name, x in (("K6 fwd", pref_k), ("K6 bwd", ga_k)):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(name + " produced non-finite values")
    return (_rel(pref_k, pref_p), _rel(ga_k, ga_p),
            float((pref_k - pref_p).abs().max()),
            float((ga_k - ga_p).abs().max()),
            (chain.ladder_level(n1), chain.ladder_level(ninf)), pref_k)


def phase_stream_kernels(dev):
    """K6 against its plain versions in float32 at d = 260, 400 and 512
    (padded 320, 448, 512), planes on every ladder level, 1, 3, 37 and 100
    steps; padded rows and steps exactly the identity; the op's total and
    plane gradient against the plain op, and against a float64
    matrix_exp product."""
    from qoc_tpu_torch.ops import chain
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {"K6 fwd": 0.0, "K6 bwd": 0.0}
    for d in STREAM_DIMS:
        for n_steps in STREAM_STEPS:
            rows = []
            for target in LEVEL_NORMS:
                a = _stream_planes(gen, n_steps, d, target, dev)
                rel1, rel2, err1, err2, levels, pref = \
                    _compare_stream_kernels(a)
                if d < pref.shape[-1]:
                    _check_padding(pref, d, n_steps)
                tgt = torch.randn((d, d), dtype=torch.complex64, device=dev,
                                  generator=gen)
                outs = []
                for plain in (False, True):
                    at = a.clone().requires_grad_(True)
                    total = plane_chain_propagate(at, plain)
                    loss = torch.sum(torch.abs(total - tgt) ** 2)
                    grad, = torch.autograd.grad(loss, at)
                    outs.append((total.detach(), grad))
                torch.cuda.synchronize()
                rel_total = _rel(outs[0][0], outs[1][0])
                rel_grad = _rel(outs[0][1], outs[1][1])
                rows.append("{}/{} {:.1e} {:.1e} {:.1e} {:.1e}".format(
                    *levels, rel1, rel2, rel_total, rel_grad))
                if max(rel1, rel_total) > FWD_RTOL or \
                        max(rel2, rel_grad) > GRAD_RTOL:
                    raise RuntimeError(
                        "K6 disagrees with its plain version (d = {}, {} "
                        "steps, levels {}): {}".format(d, n_steps, levels,
                                                       rows[-1]))
                worst["K6 fwd"] = max(worst["K6 fwd"], err1)
                worst["K6 bwd"] = max(worst["K6 bwd"], err2)
            print("phase 16 stream kernels: d={} (padded {}) steps={} S x L "
                  "= {} x {} (levels fwd/bwd, rel fwd, bwd, op total, op "
                  "grad): {}; padding exact".format(
                      d, chain.kernel_dp(d), n_steps,
                      *chain.stream_segment_plan(n_steps), "; ".join(rows)),
                  flush=True)
    # Independent reference: a float64 matrix_exp product at d = 260.
    a = _stream_planes(gen, 37, STREAM_DIMS[0], 1.0, dev)
    total = plane_chain_propagate(a)
    want = torch.eye(a.shape[-1], dtype=torch.complex128, device=dev)
    for u in torch.linalg.matrix_exp(a.to(torch.complex128)):
        want = u @ want
    rel = _rel(total.to(torch.complex128), want)
    print("phase 16 stream kernels: d={} 37 steps vs float64 matrix_exp "
          "product rel {:.2e}; worst max|err| fwd {:.3e} bwd {:.3e}".format(
              STREAM_DIMS[0], rel, worst["K6 fwd"], worst["K6 bwd"]),
          flush=True)
    if rel > FWD_RTOL:
        raise RuntimeError("the K6 plane op disagrees with the matrix_exp "
                           "product")
    return worst


def d512_problem():
    """bench.py's Table-1 construction at d = 2^9: _bench_problem(512, 10,
    2, 2, 0.05), one step (the streamed route, K6 at padded 512)."""
    return bench_problem(D512, CONTROL_COUNT, 2, 2, 0.05)


def _stream_launches(launches):
    """True where only K6 launched (forward and adjoint both)."""
    return (launches["K6 fwd"] >= 1 and launches["K6 bwd"] >= 1
            and not any(v for k, v in launches.items()
                        if not k.startswith("K6")))


def phase_stream_schroedinger(dev):
    """Schrödinger through K6: the d = 2^9 single step against the same
    loss over the plain plane op, and a d = 300 problem (21 steps) through
    its four ways in (LinearHamiltonian or torch callable, M2 or M4), each
    pair of one Magnus order against each other. Only K6 launches."""
    from qoc_tpu_torch.core.schroedinger import (build_schroedinger_loss,
                                                 fused_weights)
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    pstate, hamiltonian, costs = d512_problem()
    dt = float(pstate.dt)
    reset_launches()
    kernel = _loss_grad(build_schroedinger_loss(pstate, dev, torch.float32),
                        pstate, dev)
    torch.cuda.synchronize()
    launches = read_launches()
    basis = torch.as_tensor(hamiltonian.generator_basis(dt),
                            dtype=torch.complex64, device=dev)
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    times = torch.zeros(1, dtype=torch.float32, device=dev)
    initial = torch.as_tensor(pstate.initial_states, dtype=torch.complex64,
                              device=dev)

    def plain_loss(controls):
        w = fused_weights(controls, times, cet, dt).to(torch.complex64)
        a = torch.einsum("jk,kab->jab", w, basis)
        states = plane_chain_propagate(a, True) @ initial
        return costs[0].cost(controls, states, 1), states

    plain = _loss_grad(plain_loss, pstate, dev)
    rel_err = float(abs(kernel[0] - plain[0]) / abs(plain[0]))
    rel_grad = _rel(kernel[1], plain[1])
    print("phase 17 stream Schroedinger: d={} one step, kernel {:.8f} plain "
          "{:.8f} rel {:.2e}; gradient rel {:.2e}; launches {}".format(
              D512, float(kernel[0]), float(plain[0]), rel_err, rel_grad,
              launches), flush=True)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the d = 512 K6 route disagrees with the plain op")
    if not _stream_launches(launches):
        raise RuntimeError("the d = 512 route did not run K6 alone")
    out = {}
    for magnus in ("M2", "M4"):
        pstate, hamiltonian, _ = bench_problem(D300, 2, D300_STEPS + 1,
                                               D300_STEPS + 1, 1.0, magnus)
        for way, ham in (("linear", hamiltonian),
                         ("callable", torch_callable(hamiltonian, dev))):
            pstate.hamiltonian = ham
            reset_launches()
            error, grad = _loss_grad(build_schroedinger_loss(
                pstate, dev, torch.float32), pstate, dev)
            torch.cuda.synchronize()
            launches = read_launches()
            if not (bool(torch.isfinite(error)) and
                    bool(torch.isfinite(grad).all())):
                raise RuntimeError("non-finite d = 300 loss or gradient")
            if not _stream_launches(launches):
                raise RuntimeError("the d = 300 {} {} route did not run K6 "
                                   "alone: {}".format(way, magnus, launches))
            out[magnus, way] = (error, grad)
        (e_l, g_l), (e_c, g_c) = out[magnus, "linear"], out[magnus,
                                                            "callable"]
        rel_err = float(abs(e_l - e_c) / abs(e_c))
        rel_grad = _rel(g_l, g_c)
        print("phase 17 stream Schroedinger: d={} {} steps {}: "
              "LinearHamiltonian {:.8f} callable {:.8f} rel {:.2e}; "
              "gradient rel {:.2e}".format(D300, D300_STEPS, magnus,
                                           float(e_l), float(e_c), rel_err,
                                           rel_grad), flush=True)
        if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
            raise RuntimeError("the d = 300 ways in disagree under " + magnus)


def lindblad_problem(d, control_eval_count, system_eval_count,
                     evolution_time, step_costs=()):
    """bench.py's bench_lindblad_d20 construction (:294-349) at Hilbert d:
    H = 0.1 n + c a + c* a^H (one complex control), T1 rate 1e-3 on a,
    TargetDensityInfidelity from |0><0| to |1><1| (``step_costs`` after
    it), flat initial controls (deterministic: the seed draws nothing).
    Returns the keyword arguments of grape_lindblad_discrete."""
    from qoc_tpu_torch import (ConstantLindblad, LinearHamiltonian,
                               TargetDensityInfidelity)
    from qoc_tpu_torch.core.common import initialize_controls
    from qoc_tpu_torch.models import LindbladMethod
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(np.complex64)
    n_op = (a.conj().T @ a).astype(np.complex64)
    initial = np.zeros((1, d, d), dtype=complex)
    initial[0, 0, 0] = 1
    target = np.zeros((1, d, d), dtype=complex)
    target[0, 1, 1] = 1
    controls, norms = initialize_controls(True, 1, control_eval_count,
                                          evolution_time, None, None)
    return dict(control_count=1, control_eval_count=control_eval_count,
                costs=[TargetDensityInfidelity(target)] + list(step_costs),
                evolution_time=evolution_time, initial_densities=initial,
                system_eval_count=system_eval_count, complex_controls=True,
                hamiltonian=LinearHamiltonian(0.1 * n_op, np.stack((a,))),
                initial_controls=controls, max_control_norms=norms,
                lindblad_data=ConstantLindblad(np.array([1e-3]),
                                               np.stack((a,))),
                method=LindbladMethod.MAGNUS_EXPM)


def lindblad_d20_problem(step_costs=()):
    """The d = 20 cell: 1 complex control, 101 points (100 steps), T = 10."""
    return lindblad_problem(D20, D20_POINTS, D20_POINTS, D20_EVOLUTION_TIME,
                            step_costs)


def lindblad_d20_pstate(step_costs=()):
    """The d = 20 cell as a GrapeLindbladDiscreteState (MAGNUS_EXPM, Adam),
    for build_lindblad_loss."""
    from qoc_tpu_torch import Adam
    from qoc_tpu_torch.models import (GrapeLindbladDiscreteState,
                                      InterpolationPolicy)
    kw = lindblad_d20_problem(step_costs)
    pstate = GrapeLindbladDiscreteState(
        True, 1, kw["control_eval_count"], 1, kw["costs"],
        kw["evolution_time"], kw["hamiltonian"], None, kw["initial_controls"],
        kw["initial_densities"], InterpolationPolicy.LINEAR, 1,
        kw["lindblad_data"], 0, kw["max_control_norms"], 0, Adam(), None,
        False, 0, kw["system_eval_count"])
    pstate.method_ = kw["method"]
    return pstate


def lindblad_d20_planes(dev, dtype=torch.float32, step_costs=()):
    """The d = 20 cell's superoperator planes (100, 400, 400) at its initial
    controls, built as the streamed route builds them, and the cell's loss
    over the plain plane op in ``dtype`` (the float64 reference): with
    ``step_costs`` (on every step) through its trajectory form, the loss
    returning the densities after every step as well."""
    from qoc_tpu_torch.config import complex_dtype
    from qoc_tpu_torch.core.schroedinger import fused_weights, step_cost_sum
    from qoc_tpu_torch.ops.chain import (plane_chain_propagate,
                                         plane_chain_propagate_prefixes)
    kw = lindblad_d20_problem(step_costs)
    cdtype = complex_dtype(dtype)
    n_steps = kw["system_eval_count"] - 1
    dt = kw["evolution_time"] / n_steps
    rates, ops = kw["lindblad_data"](0.0)
    basis = torch.as_tensor(kw["hamiltonian"].superoperator_basis(
        dt, rates, ops), dtype=cdtype, device=dev)
    cet = torch.as_tensor(np.linspace(0, kw["evolution_time"],
                                      kw["control_eval_count"]),
                          dtype=dtype, device=dev)
    times = torch.arange(n_steps, dtype=dtype, device=dev) * dt
    vec0 = torch.as_tensor(kw["initial_densities"], dtype=cdtype,
                           device=dev).reshape(1, -1)

    def planes(controls):
        w = fused_weights(controls, times, cet, dt).to(cdtype)
        return torch.einsum("jk,kab->jab", w, basis)

    def plain_loss(controls):
        if not step_costs:
            vec = vec0 @ plane_chain_propagate(planes(controls), True).mT
            densities = vec.reshape(1, D20, D20)
            return kw["costs"][0].cost(controls, densities, n_steps), \
                densities
        total, prefixes = plane_chain_propagate_prefixes(planes(controls),
                                                         True)
        every = (vec0 @ prefixes.mT).reshape(n_steps, 1, D20, D20)
        densities = (vec0 @ total.mT).reshape(1, D20, D20)
        error = kw["costs"][0].cost(controls, densities, n_steps)
        error = error + step_cost_sum(list(step_costs), controls,
                                      lambda sel: every[sel], 0, n_steps, 1,
                                      dev)
        return error, densities, every

    controls = torch.as_tensor(kw["initial_controls"], dtype=cdtype,
                               device=dev)
    with torch.no_grad():
        a = planes(controls)
    return a, plain_loss


def phase_lindblad_d20(dev):
    """The slice at full width: grape_lindblad_discrete on the d = 20 cell
    (MAGNUS_EXPM, the streamed route), 2 warm-up + 10 timed Adam
    iterations, K6 launched every iteration and K1-K5 never; then the
    loss and gradient at the initial controls against a float64 run of the
    same route over the plain versions on the card."""
    from qoc_tpu_torch import grape_lindblad_discrete
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    kw = lindblad_d20_problem()
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_lindblad_discrete(
        iteration_count=iterations, log_iteration_step=0,
        fused_chunk=WARMUP_ITERATIONS, device=dev, **kw)
    launches = read_launches()
    errors = np.asarray(result.errors)
    print("phase 18 Lindblad d=20 grape (superoperator 400, padded 448, 100 "
          "steps, MAGNUS_EXPM, streamed route): {} iterations, {:.2f} it/s "
          "steady ({} timed after {} warm-up), error {:.6f} -> {:.6f}, "
          "launches {}".format(
              result.iteration_count_ran, result.iterations_per_s,
              TIMED_ITERATIONS, WARMUP_ITERATIONS, errors[0], errors[-1],
              launches), flush=True)
    if result.iteration_count_ran != iterations:
        raise RuntimeError("d = 20 Lindblad GRAPE stopped early")
    if not (np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_densities))):
        raise RuntimeError("non-finite d = 20 Lindblad GRAPE result")
    if not errors[-1] < errors[0]:
        raise RuntimeError("d = 20 Lindblad GRAPE error did not fall")
    if launches["K6 fwd"] != iterations or launches["K6 bwd"] != iterations:
        raise RuntimeError("the d = 20 GRAPE did not launch K6 every "
                           "iteration")
    if any(v for k, v in launches.items() if not k.startswith("K6")):
        raise RuntimeError("the d = 20 GRAPE launched another kernel")
    pstate = lindblad_d20_pstate()
    e32, g32 = _loss_grad(build_lindblad_loss(pstate, dev, torch.float32),
                          pstate, dev)
    _, plain_loss = lindblad_d20_planes(dev, torch.float64)
    e64, g64 = _loss_grad(plain_loss, pstate, dev, torch.float64)
    torch.cuda.synchronize()
    rel_err = float(abs(e32.double() - e64) / abs(e64))
    rel_grad = _rel(g32.double(), g64)
    print("phase 18 Lindblad d=20: float32 kernel route vs float64 plain "
          "route loss {:.8f} / {:.8f} rel {:.2e}, gradient rel {:.2e}".format(
              float(e32), float(e64), rel_err, rel_grad), flush=True)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the d = 20 loss or gradient disagrees with its "
                           "float64 run")
    return launches, result.iterations_per_s


def phase_lindblad_routes(dev):
    """Lindblad on the other routes: example 1 (d = 2, T1 = 1000, 11 control
    points, 20 steps) through K1/K2, and the d = 12 problem (superoperator
    144) through K3/K4, each a short GRAPE with its launch counters and its
    best final densities against float64 (the same controls evolved on the
    CPU)."""
    from qoc_tpu_torch import (ConstantLindblad, LinearHamiltonian,
                               evolve_lindblad_discrete,
                               grape_lindblad_discrete)
    a2 = np.array([[0, 1], [0, 0]], dtype=complex)
    example1 = lindblad_problem(2, 11, 21, 10.0)
    example1.update(
        hamiltonian=LinearHamiltonian(np.diag([0.5, -0.5]) + 0j, a2[None]),
        lindblad_data=ConstantLindblad(np.array([1e-3]), a2[None]),
        max_control_norms=np.array([5.0]))
    for label, kw, kernels in (
            ("example 1 (d=2)", example1, ("K1", "K2")),
            ("d=12", lindblad_problem(12, 21, 21, 2.0), ("K3", "K4"))):
        iterations = 10
        reset_launches()
        result = grape_lindblad_discrete(iteration_count=iterations,
                                         log_iteration_step=0, device=dev,
                                         **kw)
        launches = read_launches()
        errors = np.asarray(result.errors)
        evolve_kw = {k: kw[k] for k in ("evolution_time",
                                        "initial_densities",
                                        "system_eval_count", "costs",
                                        "hamiltonian", "lindblad_data",
                                        "method")}
        want = evolve_lindblad_discrete(controls=result.best_controls,
                                        device="cpu", **evolve_kw)
        err = float(np.abs(result.best_final_densities
                           - want.final_densities).max())
        print("phase 19 Lindblad {}: {} iterations, error {:.6f} -> {:.6f}, "
              "launches {}; best final densities vs float64 max|err| {:.2e}"
              "".format(label, iterations, errors[0], errors[-1], launches,
                        err), flush=True)
        if not (np.all(np.isfinite(errors)) and errors[-1] < errors[0]):
            raise RuntimeError("Lindblad {} GRAPE error did not fall".format(
                label))
        if any(launches[k] != iterations for k in kernels) or any(
                v for k, v in launches.items() if k not in kernels):
            raise RuntimeError("Lindblad {} did not run {} alone: {}".format(
                label, "/".join(kernels), launches))
        if err > FWD_RTOL:
            raise RuntimeError("Lindblad {} final densities disagree with "
                               "float64".format(label))


def _time_stream(label, a, launches):
    """K6 forward and adjoint on the plane op's inputs for planes ``a``:
    kernel and plain times, bounds, grid, and the merge's device time."""
    from qoc_tpu_torch.ops import chain
    a_seg, n1, ninf = _stream_inputs(a)
    s_count, length, dp = a_seg.shape[:3]
    d = a.shape[-1]
    pref = chain.stream_fwd(a_seg, n1)
    gen = torch.Generator(device=a.device).manual_seed(2)
    seeds = torch.randn((s_count, dp, dp), dtype=torch.complex64,
                        device=a.device, generator=gen)
    rel1, rel2, err1, err2, levels, _ = _compare_stream_kernels(a)
    if rel1 > FWD_RTOL or rel2 > GRAD_RTOL:
        raise RuntimeError("K6 disagrees with its plain version at the {} "
                           "planes".format(label))
    cums, prods = chain._merge(pref, d)
    grad_total = torch.randn((d, d), dtype=torch.complex64, device=a.device,
                             generator=gen)
    ms = {
        "K6 fwd": cuda_ms(lambda: chain.stream_fwd(a_seg, n1), 5),
        "K6 fwd plain": cuda_ms(lambda: chain.stream_fwd_plain(a_seg, n1), 2),
        "K6 bwd": cuda_ms(lambda: chain.stream_bwd(a_seg, ninf, pref, seeds),
                          5),
        "K6 bwd plain": cuda_ms(lambda: chain.stream_bwd_plain(
            a_seg, ninf, pref, seeds), 2),
        "merge": cuda_ms(lambda: chain._merge(pref, d), 5),
        "seeds": cuda_ms(lambda: chain._segment_seeds(pref, cums, prods, dp,
                                                      grad_total), 5),
    }
    absa = a.abs()
    bounds = {
        "K6 fwd": kernel_bound(absa.sum(-2).amax(-1), levels[0], False,
                               [a_seg, n1, pref], dp),
        "K6 bwd": kernel_bound(absa.sum(-1).amax(-1), levels[1], True,
                               [a_seg, ninf, pref, seeds, pref[:, 1:]], dp),
    }
    grids = {key: chain.stream_grid(dual, dp, s_count, a.device)[0]
             for key, dual in (("K6 fwd", False), ("K6 bwd", True))}
    resident = chain._stream_plan(False, dp, a.device.index)[:2]
    print("phase 20 stream timing ({} planes {}, padded {}, S x L = {} x {}, "
          "levels {}/{}; grid fwd {} / bwd {} clusters of {} blocks, {} "
          "resident: {} of 132 SMs busy): ".format(
              label, tuple(a.shape), dp, s_count, length, *levels,
              grids["K6 fwd"], grids["K6 bwd"], resident[1], resident[0],
              grids["K6 fwd"] * resident[1])
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time; "
              "launches {} an iteration".format(k, b[0], b[1], b[2],
                                                b[0] / ms[k], launches)
              for k, b in bounds.items()), flush=True)
    return ms, bounds, {"K6 fwd": err1, "K6 bwd": err2}


def phase_stream_timing(dev):
    """K6 times at the d = 20 cell's planes (one launch each an iteration)
    and at the d = 2^9 single step, beside their plain versions and bounds;
    no single PyTorch call computes an ordered exp chain (library: none)."""
    a20, _ = lindblad_d20_planes(dev)
    out = _time_stream("d=20 Lindblad", a20, 1)
    pstate, hamiltonian, _ = d512_problem()
    _time_stream("d=512", initial_planes(pstate, hamiltonian, dev), 1)
    return out


def _last_level(d, density=False):
    """|d-1> as (1, d, 1), or |1><1| as (1, d, d): the targets of
    bench_problem and lindblad_problem."""
    if density:
        target = np.zeros((1, d, d), dtype=complex)
        target[0, 1, 1] = 1
    else:
        target = np.zeros((1, d, 1), dtype=complex)
        target[0, -1] = 1
    return target


def forbid_level(d, system_eval_count, level=1, cost_eval_step=1):
    """bench_stepcost's step cost (bench.py:251-273 of the JAX package):
    ForbidStates of |level>, multiplier 0.1."""
    from qoc_tpu_torch import ForbidStates
    forbidden = np.zeros((1, 1, d, 1), dtype=complex)
    forbidden[0, 0, level] = 1
    return ForbidStates(forbidden, system_eval_count, cost_eval_step,
                        cost_multiplier=STEP_COST_MULTIPLIER)


def stepcost_problem(cost_eval_step=1, final_cost=True):
    """The step-cost headline (bench_stepcost): the Table-3 problem with
    ForbidStates of |1> (multiplier 0.1) at every ``cost_eval_step``-th
    step; ``final_cost=False`` drops the final TargetStateInfidelity, so
    every gradient flows through the per-step prefixes."""
    pstate, hamiltonian, costs = bench_problem(
        D, CONTROL_COUNT, SYSTEM_EVAL_COUNT, SYSTEM_EVAL_COUNT,
        EVOLUTION_TIME, step_costs=[forbid_level(
            D, SYSTEM_EVAL_COUNT, cost_eval_step=cost_eval_step)],
        cost_eval_step=cost_eval_step)
    if not final_cost:
        pstate.costs = costs = costs[1:]
    return pstate, hamiltonian, costs


def d20_step_costs():
    """The d = 20 cell's step costs: ForbidDensities of |2><2| (the level
    above the target; multiplier 0.1) and TargetDensityInfidelityTime of the
    target, at every step."""
    from qoc_tpu_torch import ForbidDensities, TargetDensityInfidelityTime
    leak = np.zeros((1, 1, D20, D20), dtype=complex)
    leak[0, 0, 2, 2] = 1
    return [ForbidDensities(leak, D20_POINTS,
                            cost_multiplier=STEP_COST_MULTIPLIER),
            TargetDensityInfidelityTime(D20_POINTS,
                                        _last_level(D20, density=True))]


def float64_planes(pstate, hamiltonian, dev):
    """controls -> a Schrödinger problem's step generators (B, d, d) in
    complex128 on the card: weight rows times the generator basis for a
    LinearHamiltonian under M2 (the steps of the fused route), else the
    Magnus terms of ``plane_builder`` (``hamiltonian`` a complex128
    callable)."""
    from qoc_tpu_torch.core.schroedinger import fused_weights, plane_builder
    from qoc_tpu_torch.models import LinearHamiltonian, MagnusPolicy
    dt = float(pstate.dt)
    times = torch.arange(pstate.system_eval_count - 1, dtype=torch.float64,
                         device=dev) * dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float64,
                          device=dev)
    if (isinstance(hamiltonian, LinearHamiltonian)
            and pstate.magnus_policy == MagnusPolicy.M2):
        basis = torch.as_tensor(hamiltonian.generator_basis(dt),
                                dtype=torch.complex128, device=dev)
        return lambda controls: torch.einsum(
            "jk,kab->jab", fused_weights(controls, times, cet, dt).to(
                torch.complex128), basis)
    build = plane_builder(hamiltonian, pstate.magnus_policy, cet, dt)
    return lambda controls: build(controls, times).to(torch.complex128)


def schroedinger_reference(pstate, dev, planes):
    """A Schrödinger problem's loss in float64 on the card, apart from the
    kernels: its generators (``planes``, float64_planes) through the plain
    plane op's trajectory form (d <= 64: K5's plain versions) or
    torch.linalg.matrix_exp and an inclusive prefix scan (d = 128), the
    step costs at their cost steps, the final costs after the last step."""
    from qoc_tpu_torch.core.schroedinger import step_cost_sum
    from qoc_tpu_torch.ops import chain
    n_steps = pstate.system_eval_count - 1
    initial = torch.as_tensor(pstate.initial_states, dtype=torch.complex128,
                              device=dev)
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]

    def loss(controls):
        a = planes(controls)
        if a.shape[-1] <= chain.KERNEL_DP:
            total, prefixes = chain.plane_chain_propagate_prefixes(a, True)
        else:
            prefixes = chain._prefix_products(torch.linalg.matrix_exp(a))
            total = prefixes[-1]
        error = step_cost_sum(pstate.step_costs, controls,
                              lambda sel: prefixes[sel, None] @ initial, 0,
                              n_steps, pstate.cost_eval_step, dev)
        states = total @ initial
        for cost in final_costs:
            error = error + cost.cost(controls, states, n_steps)
        return error, states

    return loss


def _against_float64(label, loss, reference, pstate, dev):
    """(loss, gradient) of the float32 kernel route ``loss`` and the float64
    ``reference`` at the initial controls; raises past 1e-4 / 1e-3."""
    e32, g32 = _loss_grad(loss, pstate, dev)
    e64, g64 = _loss_grad(reference, pstate, dev, torch.float64)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(e32)) and bool(torch.isfinite(g32).all())):
        raise RuntimeError("non-finite {} loss or gradient".format(label))
    rel_err = float(abs(e32.double() - e64) / abs(e64))
    rel_grad = _rel(g32.double(), g64)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("{}: the kernel route disagrees with float64: "
                           "loss rel {:.2e}, gradient rel {:.2e}".format(
                               label, rel_err, rel_grad))
    return "{} {:.8f} / {:.8f} rel {:.2e}, gradient rel {:.2e}".format(
        label, float(e32), float(e64), rel_err, rel_grad)


def _compare_trajectory(run, x, gen):
    """The trajectory form ``run(x, plain)`` -> (total, prefixes) over the
    kernels against the plain versions, for random gradients on both
    outputs: the relative errors of the total, the prefixes and the
    gradient to x."""
    outs, cotangents = [], None
    for plain in (False, True):
        xt = x.clone().requires_grad_(True)
        total, prefixes = run(xt, plain)
        if cotangents is None:
            cotangents = [torch.randn(y.shape, dtype=y.dtype,
                                      device=y.device, generator=gen)
                          for y in (total, prefixes)]
        grad, = torch.autograd.grad((total, prefixes), xt, cotangents)
        outs.append((total.detach(), prefixes.detach(), grad))
    torch.cuda.synchronize()
    return [_rel(k, p) for k, p in zip(*outs)]


def _check_step_mode(bwd, bwd_plain, args, dp, gen):
    """An adjoint kernel ``bwd(*args, seeds)`` in its per-step-seed mode
    against its plain version on random per-step seeds (S, L, dp, dp):
    (relative error, max |err|, the seeds). With every seed zero but each
    segment's last, it must equal the last-step mode bitwise."""
    prefpad = args[-1]
    seeds = torch.randn((prefpad.shape[0], prefpad.shape[1] - 1, dp, dp),
                        dtype=torch.complex64, device=prefpad.device,
                        generator=gen)
    got, want = bwd(*args, seeds), bwd_plain(*args, seeds)
    last = seeds[:, -1].contiguous()
    only_last = torch.zeros_like(seeds)
    only_last[:, -1] = last
    same = torch.equal(bwd(*args, only_last), bwd(*args, last))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(got)).all()):
        raise RuntimeError(bwd.__name__ + " (per-step seeds) produced "
                           "non-finite values")
    if not same:
        raise RuntimeError(bwd.__name__ + ": per-step seeds zero but the "
                           "last differ from the last-step mode")
    return _rel(got, want), float((got - want).abs().max()), seeds


def _step_row(level, rel_kernel, rels, name):
    """One ladder level's line of phase 21, raising past the tolerances."""
    rel_total, rel_pref, rel_grad = rels
    if max(rel_total, rel_pref) > FWD_RTOL or \
            max(rel_kernel, rel_grad) > GRAD_RTOL:
        raise RuntimeError("{} per-step mode disagrees with its plain "
                           "version at level {}: kernel {:.1e}, total {:.1e}, "
                           "prefixes {:.1e}, gradient {:.1e}".format(
                               name, level, rel_kernel, *rels))
    return "{} {:.1e} {:.1e} {:.1e} {:.1e}".format(level, rel_kernel, *rels)


def phase_step_kernels(dev):
    """K2, K5 and K6 in their per-step-seed mode against their plain
    versions in float32 on every ladder level: K2 (the chain op's trajectory
    form) and K5 (the plane op's) at d = 64 and 16 over 3, 37 and 2001
    steps, K6 (the plane op's) at d = 260, 400 and 512 over 1, 3 and 37;
    each adjoint alone on random per-step seeds, and the op's total,
    prefixes and input gradient for random gradients on both outputs; and
    each mode with seeds zero but at the last step bitwise the last-step
    mode."""
    from qoc_tpu_torch.ops import chain
    from qoc_tpu_torch.ops.chain import (ChainExpmPropagate,
                                         plane_chain_propagate_prefixes)
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(21)
    n_b = 1 + 2 * CONTROL_COUNT
    for d in STEP_DIMS:
        for n_steps in STEP_STEPS:
            w = torch.as_tensor(rng.normal(size=(n_steps, n_b)).astype(
                np.float32), device=dev)
            base = _unit_planes(rng, n_steps, d)
            rows = {"K2": [], "K5 bwd": []}
            for target in LEVEL_NORMS:
                basis = _scaled_basis(rng, d, n_b, w.cpu().numpy(), target)
                ops = {plain: ChainExpmPropagate(basis, dev, torch.float32,
                                                 plain=plain,
                                                 return_prefixes=True)
                       for plain in (False, True)}
                rels = _compare_trajectory(lambda x, plain: ops[plain](x), w,
                                           gen)
                op = ops[False]
                s_count, length = chain.segment_plan(n_steps)
                w_seg = torch.zeros((s_count * length, n_b), device=dev)
                w_seg[:n_steps] = w
                w_seg = w_seg.reshape(s_count, length, n_b)
                n1, ninf = chain._norm_max(w, op.basis_ri, op.d)
                pref = chain.chain_fwd_plain(w_seg, op.basis, n1)
                rel, _, _ = _check_step_mode(
                    chain.chain_bwd, chain.chain_bwd_plain,
                    (w_seg, op.basis_h, ninf, pref), op.dp, gen)
                rows["K2"].append(_step_row(chain.ladder_level(ninf), rel,
                                            rels, "K2"))
                a = torch.as_tensor((base * target).astype(np.complex64),
                                    device=dev)
                rels = _compare_trajectory(plane_chain_propagate_prefixes, a,
                                           gen)
                a_seg, n1, ninf = _segment_planes(a)
                pref = chain.plane_fwd_plain(a_seg, n1)
                rel, _, _ = _check_step_mode(
                    chain.plane_bwd, chain.plane_bwd_plain,
                    (a_seg, ninf, pref), chain.KERNEL_DP, gen)
                rows["K5 bwd"].append(_step_row(chain.ladder_level(ninf),
                                                rel, rels, "K5"))
            for key, lines in rows.items():
                print("phase 21 per-step {}: d={} steps={} S x L = {} x {} "
                      "(level, rel adjoint, op total, prefixes, gradient): "
                      "{}; last seeds only = last-step mode bitwise".format(
                          key, d, n_steps, *chain.segment_plan(n_steps),
                          "; ".join(lines)), flush=True)
    for d in STREAM_DIMS:
        for n_steps in STREAM_STEP_STEPS:
            rows = []
            for target in LEVEL_NORMS:
                a = _stream_planes(gen, n_steps, d, target, dev)
                rels = _compare_trajectory(plane_chain_propagate_prefixes, a,
                                           gen)
                a_seg, n1, ninf = _stream_inputs(a)
                pref = chain.stream_fwd_plain(a_seg, n1)
                rel, _, _ = _check_step_mode(
                    chain.stream_bwd, chain.stream_bwd_plain,
                    (a_seg, ninf, pref), a_seg.shape[-1], gen)
                rows.append(_step_row(chain.ladder_level(ninf), rel, rels,
                                      "K6"))
            print("phase 21 per-step K6 bwd: d={} (padded {}) steps={} S x L "
                  "= {} x {} (level, rel adjoint, op total, prefixes, "
                  "gradient): {}; last seeds only = last-step mode bitwise"
                  "".format(d, chain.kernel_dp(d), n_steps,
                            *chain.stream_segment_plan(n_steps),
                            "; ".join(rows)), flush=True)


def _grape_launches(label, result, launches, kernels, iterations):
    """Checks of a GRAPE run of ``iterations``: ran them all, finite, its
    error fell, and launched each of ``kernels`` (read_launches keys) once
    an iteration and nothing else."""
    errors = np.asarray(result.errors)
    if result.iteration_count_ran != iterations:
        raise RuntimeError(label + " GRAPE stopped early")
    evolved = getattr(result, "best_final_states", None)
    if evolved is None:
        evolved = result.best_final_densities
    if not (np.all(np.isfinite(errors)) and np.all(np.isfinite(evolved))):
        raise RuntimeError("non-finite {} GRAPE result".format(label))
    if not errors[-1] < errors[0]:
        raise RuntimeError(label + " GRAPE error did not fall")
    if any(n != (iterations if key in kernels else 0)
           for key, n in launches.items()):
        raise RuntimeError("{} GRAPE did not launch {} once an iteration "
                           "and nothing else: {}".format(label, kernels,
                                                         launches))
    return errors


def phase_stepcost_grape(dev):
    """The slice at full width: grape_schroedinger_discrete on the step-cost
    headline (bench.py:251-273 of the JAX package: the Table-3 problem with
    ForbidStates of |1>, multiplier 0.1, cost_eval_step 1), 2 warm-up + 10
    timed Adam iterations, counters read around the run (K1, and K2 in its
    per-step-seed mode, once an iteration; nothing else); the same with
    cost_eval_step 10; then loss and gradient against the float64 plain
    route on the card, with the final cost and for the step cost alone."""
    from qoc_tpu_torch import grape_schroedinger_discrete
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    out = {}
    for ces in (1, THINNED_COST_EVAL_STEP):
        pstate, hamiltonian, costs = stepcost_problem(ces)
        reset_launches()
        result = grape_schroedinger_discrete(
            CONTROL_COUNT, CONTROL_EVAL_COUNT, costs, EVOLUTION_TIME,
            hamiltonian, pstate.initial_states, SYSTEM_EVAL_COUNT,
            complex_controls=True, cost_eval_step=ces,
            initial_controls=pstate.initial_controls,
            iteration_count=iterations, log_iteration_step=0,
            max_control_norms=pstate.max_control_norms,
            fused_chunk=WARMUP_ITERATIONS, device=dev)
        launches = read_launches()
        errors = _grape_launches("the step-cost headline", result, launches,
                                 ("K1", "K2", "K2 step"), iterations)
        print("phase 22 step-cost grape (ForbidStates |1> x 0.1, "
              "cost_eval_step {}): {} iterations, {:.2f} it/s steady ({} "
              "timed after {} warm-up), error {:.6f} -> {:.6f}, launches {}"
              "".format(ces, result.iteration_count_ran,
                        result.iterations_per_s, TIMED_ITERATIONS,
                        WARMUP_ITERATIONS, errors[0], errors[-1], launches),
              flush=True)
        out[ces] = (launches, result.iterations_per_s)
    lines = []
    for label, final in (("bench_stepcost loss", True),
                         ("step cost alone", False)):
        pstate, hamiltonian, _ = stepcost_problem(1, final)
        lines.append(_against_float64(
            label, build_schroedinger_loss(pstate, dev, torch.float32),
            schroedinger_reference(pstate, dev, float64_planes(
                pstate, hamiltonian, dev)), pstate, dev))
    print("phase 22 step-cost headline, float32 kernel route vs float64 "
          "plain route (K5's plain trajectory form): " + "; ".join(lines),
          flush=True)
    return out


def phase_stepcost_routes(dev):
    """Step costs on the other Schrödinger routes: the M4 problem (bench_m4)
    as a torch callable with TargetStateInfidelityTime, a 12-iteration GRAPE
    through K5 (per-step mode) with counters; and the d = 2^7 problem with
    ForbidStates and TargetStateInfidelityTime, one loss and gradient
    through K3/K4 and the prefix scan, with counters; each against float64
    on the card."""
    from qoc_tpu_torch import (TargetStateInfidelityTime,
                               grape_schroedinger_discrete)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    from qoc_tpu_torch.models import MagnusPolicy
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    pstate, hamiltonian, costs = bench_problem(
        D, CONTROL_COUNT, M4_STEPS, M4_STEPS, M4_EVOLUTION_TIME, "M4",
        step_costs=[TargetStateInfidelityTime(M4_STEPS, _last_level(D))])
    reset_launches()
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, M4_STEPS, costs, M4_EVOLUTION_TIME,
        torch_callable(hamiltonian, dev), pstate.initial_states, M4_STEPS,
        complex_controls=True, initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        magnus_policy=MagnusPolicy.M4,
        max_control_norms=pstate.max_control_norms,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = read_launches()
    errors = _grape_launches("the M4 step-cost", result, launches,
                             ("K5 fwd", "K5 bwd", "K5 bwd step"), iterations)
    pstate.hamiltonian = torch_callable(hamiltonian, dev)
    check = _against_float64(
        "loss", build_schroedinger_loss(pstate, dev, torch.float32),
        schroedinger_reference(pstate, dev, float64_planes(
            pstate, torch_callable(hamiltonian, dev, torch.complex128),
            dev)), pstate, dev)
    print("phase 23 M4 step-cost grape (torch callable, "
          "TargetStateInfidelityTime, {} steps, plane route): {} iterations, "
          "{:.2f} it/s steady, error {:.6f} -> {:.6f}, launches {}; vs "
          "float64: {}".format(M4_STEPS - 1, result.iteration_count_ran,
                               result.iterations_per_s, errors[0],
                               errors[-1], launches, check), flush=True)
    pstate, hamiltonian, _ = bench_problem(
        D128, CONTROL_COUNT, D128_STEPS, D128_STEPS, D128_EVOLUTION_TIME,
        step_costs=[forbid_level(D128, D128_STEPS),
                    TargetStateInfidelityTime(D128_STEPS,
                                              _last_level(D128))])
    loss = build_schroedinger_loss(pstate, dev, torch.float32)
    reset_launches()
    _loss_grad(loss, pstate, dev)
    torch.cuda.synchronize()
    d128_launches = read_launches()
    # One K3 and one K4 launch a time block (chain_block_plan: the
    # trajectory's prefix scan keeps more a step, so it takes several).
    blocks = d128_launches["K3"]
    if blocks < 1 or any(n != (blocks if key in ("K3", "K4") else 0)
                         for key, n in d128_launches.items()):
        raise RuntimeError("the d = 128 step-cost loss did not run K3 and K4 "
                           "alone, once a block: {}".format(d128_launches))
    check = _against_float64(
        "loss", loss, schroedinger_reference(pstate, dev, float64_planes(
            pstate, hamiltonian, dev)), pstate, dev)
    ms = cuda_ms(lambda: _loss_grad(loss, pstate, dev), 3)
    print("phase 23 d=128 step-cost loss (ForbidStates + "
          "TargetStateInfidelityTime, {} steps, blocked route + prefix "
          "scan, {} time blocks): loss and gradient {:.3f} ms, launches {}; "
          "vs float64 (matrix_exp and a prefix scan): {}".format(
              D128_STEPS - 1, blocks, ms, d128_launches, check), flush=True)
    return launches, result.iterations_per_s


def phase_stepcost_lindblad(dev):
    """The d = 20 Lindblad cell with step costs (d20_step_costs): a
    12-iteration GRAPE through K6 (per-step mode) with counters, loss and
    gradient against the float64 plain route, and
    evolve_lindblad_discrete(save_intermediate_densities=True) on the card
    (K6 forward alone) against the float64 densities after every step."""
    from qoc_tpu_torch import evolve_lindblad_discrete, grape_lindblad_discrete
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    step_costs = d20_step_costs()
    kw = lindblad_d20_problem(step_costs)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_lindblad_discrete(
        iteration_count=iterations, log_iteration_step=0,
        fused_chunk=WARMUP_ITERATIONS, device=dev, **kw)
    launches = read_launches()
    errors = _grape_launches("the d = 20 step-cost Lindblad", result,
                             launches, ("K6 fwd", "K6 bwd", "K6 bwd step"),
                             iterations)
    pstate = lindblad_d20_pstate(step_costs)
    _, reference = lindblad_d20_planes(dev, torch.float64, step_costs)
    check = _against_float64(
        "loss", build_lindblad_loss(pstate, dev, torch.float32), reference,
        pstate, dev)
    reset_launches()
    evolved = evolve_lindblad_discrete(
        kw["evolution_time"], kw["initial_densities"],
        kw["system_eval_count"], controls=kw["initial_controls"],
        costs=kw["costs"], hamiltonian=kw["hamiltonian"],
        lindblad_data=kw["lindblad_data"], method=kw["method"],
        save_intermediate_densities=True, device=dev)
    evolve_launches = read_launches()
    with torch.no_grad():
        error64, _, every64 = reference(torch.as_tensor(
            kw["initial_controls"], dtype=torch.complex128, device=dev))
    got = evolved.intermediate_densities
    want = np.concatenate((kw["initial_densities"][None],
                           every64.cpu().numpy()))
    err = float(np.abs(got - want).max())
    rel_error = abs(evolved.error - float(error64)) / abs(float(error64))
    print("phase 24 Lindblad d=20 step-cost grape (ForbidDensities |2><2| x "
          "0.1 + TargetDensityInfidelityTime, streamed route): {} "
          "iterations, {:.2f} it/s steady, error {:.6f} -> {:.6f}, launches "
          "{}; vs float64: {}; evolve with intermediate densities {} "
          "max|err| {:.2e} vs float64, error rel {:.2e}, launches {}".format(
              result.iteration_count_ran, result.iterations_per_s, errors[0],
              errors[-1], launches, check, got.shape, err, rel_error,
              evolve_launches), flush=True)
    # The last intermediate is the last prefix applied, the final densities
    # the merged total: the same product, rounded in another order.
    if got.shape != (D20_POINTS, 1, D20, D20) or np.abs(
            got[-1] - evolved.final_densities).max() > FWD_RTOL:
        raise RuntimeError("evolve's intermediate densities are not the "
                           "(101, 1, 20, 20) stack ending at the final ones")
    if err > FWD_RTOL or rel_error > FWD_RTOL:
        raise RuntimeError("evolve's intermediate densities or error "
                           "disagree with float64")
    if any(n != (1 if key == "K6 fwd" else 0)
           for key, n in evolve_launches.items()):
        raise RuntimeError("the d = 20 evolve did not run K6's forward "
                           "alone: {}".format(evolve_launches))
    return launches, result.iterations_per_s


def _time_step_mode(key, bwd, bwd_plain, args, dp, step_norms, level,
                    gen, repeats):
    """An adjoint kernel in its per-step-seed mode at a main path's shapes
    (``args`` its inputs but the seeds, prefpad last): kernel and plain
    times on random per-step seeds, the last-step mode's time in the same
    call, the bound, and max |err| against the plain version."""
    rel, err, seeds = _check_step_mode(bwd, bwd_plain, args, dp, gen)
    if rel > GRAD_RTOL:
        raise RuntimeError("{} per-step mode disagrees with its plain "
                           "version at the main path's shapes".format(key))
    last = seeds[:, -1].contiguous()
    ms = {key + " step": cuda_ms(lambda: bwd(*args, seeds), repeats),
          key + " step plain": cuda_ms(lambda: bwd_plain(*args, seeds), 2),
          key + " last-step": cuda_ms(lambda: bwd(*args, last), repeats)}
    bound = kernel_bound(step_norms, level, True,
                         list(args) + [seeds, args[-1][:, 1:]], dp)
    return ms, bound, err


def phase_step_timing(dev, headline_w=None):
    """The per-step modes at their main paths' shapes: K2 at the step-cost
    headline's (10^4 steps, d = 64), K5 at the M4 planes, K6 at the d = 20
    cell's planes; kernel, plain and last-step-mode times and the bounds
    (the per-step seeds are one more input); and the trajectory glue at the
    headline: the per-step seeds (_segment_seeds), the prefix composition,
    and the chain op's forward and backward with and without prefixes."""
    from qoc_tpu_torch.ops import chain
    gen = torch.Generator(device=dev).manual_seed(25)
    if headline_w is None:
        headline_w = headline_weights(table3_problem(1)[0], dev)
    op = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32)
    n_steps = headline_w.shape[0]
    s_count, length = chain.segment_plan(n_steps)
    w_seg = torch.zeros((s_count * length, op.n_b), device=dev)
    w_seg[:n_steps] = headline_w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(headline_w, op.basis_ri, op.d)
    pref = chain.chain_fwd(w_seg, op.basis, n1)
    a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, op.n_b).to(
        torch.complex64), op.basis)
    ms, bound, err = _time_step_mode(
        "K2", chain.chain_bwd, chain.chain_bwd_plain,
        (w_seg, op.basis_h, ninf, pref), op.dp,
        a.abs().sum(-1).amax(-1), chain.ladder_level(ninf), gen, 10)
    bounds, errs = {"K2 step": bound}, {"K2 step": err}
    # The trajectory glue at the headline.
    cums, prods = chain._merge(pref, op.d)
    g_total = torch.randn((op.d, op.d), dtype=torch.complex64, device=dev,
                          generator=gen)
    g_pref = torch.randn((n_steps, op.d, op.d), dtype=torch.complex64,
                         device=dev, generator=gen)
    traj = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32,
                                    return_prefixes=True)

    def fwd_bwd(the_op, trajectory):
        w = headline_w.detach().requires_grad_(True)
        if trajectory:
            total, prefixes = the_op(w)
            torch.autograd.grad((total, prefixes), w, (g_total, g_pref))
        else:
            torch.autograd.grad(the_op(w), w, g_total)

    ms.update({
        "seeds per-step": cuda_ms(lambda: chain._segment_seeds(
            pref, cums, prods, op.dp, g_total, g_pref), 5),
        "seeds last-step": cuda_ms(lambda: chain._segment_seeds(
            pref, cums, prods, op.dp, g_total), 5),
        "compose prefixes": cuda_ms(lambda: chain._compose_prefixes(
            pref, cums, n_steps), 5),
        "op fwd+bwd": cuda_ms(lambda: fwd_bwd(op, False), 5),
        "op fwd+bwd trajectory": cuda_ms(lambda: fwd_bwd(traj, True), 5),
    })
    # K5 at the M4 planes, K6 at the d = 20 cell's.
    for key, planes, inputs, bwd, bwd_plain, fwd in (
            ("K5 bwd", m4_planes(dev), _segment_planes, chain.plane_bwd,
             chain.plane_bwd_plain, chain.plane_fwd),
            ("K6 bwd", lindblad_d20_planes(dev)[0], _stream_inputs,
             chain.stream_bwd, chain.stream_bwd_plain, chain.stream_fwd)):
        a_seg, n1, ninf = inputs(planes)
        pref = fwd(a_seg, n1)
        step_ms, bound, err = _time_step_mode(
            key, bwd, bwd_plain, (a_seg, ninf, pref), a_seg.shape[-1],
            planes.abs().sum(-1).amax(-1), chain.ladder_level(ninf), gen,
            10 if key == "K5 bwd" else 5)
        ms.update(step_ms)
        bounds[key + " step"] = bound
        errs[key + " step"] = err
    print("phase 25 per-step timing (K2 at the step-cost headline, S x L = "
          "{} x {}; K5 at the M4 planes; K6 at the d = 20 planes): ".format(
              s_count, length)
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time, "
              "max|err| {:.2e}".format(k, b[0], b[1], b[2], b[0] / ms[k],
                                       errs[k])
              for k, b in bounds.items()), flush=True)
    return ms, bounds, errs


def _kernel_row(name, source, replaces, launches, err, ms, plain_ms, bound,
                library_ms=None):
    return {"name": name, "route": "cuda",
            "source": "qoc_tpu_torch/csrc/" + source,
            "replaces": "qoc_tpu/ops/" + replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phases", help="comma-separated phases that stand alone to run "
        "after the build ({}), for a quick check of a kernel; prints no "
        "summary".format(", ".join(map(str, sorted(STANDALONE)))))
    args = parser.parse_args()
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_s = phase_build()
    if args.phases:
        for phase in args.phases.split(","):
            STANDALONE[int(phase)](dev)
        return
    pstate, _, _ = table3_problem(1)
    headline_w = headline_weights(pstate, dev)
    worst = phase_kernels(dev, headline_w)
    phase_headline(dev)
    launches, it_s = phase_grape(dev)
    ms, bounds = phase_timing(dev, headline_w)
    worst.update(phase_plane_kernels(dev))
    phase_cross_route(dev)
    m4_launches, m4_it_s = phase_m4_grape(dev)
    plane_ms, plane_bounds = phase_plane_timing(dev)
    launches.update({k: m4_launches[k] for k in ("K5 fwd", "K5 bwd")})
    ms.update(plane_ms)
    bounds.update(plane_bounds)
    phase_expm_kernels(dev)
    d128_launches, d128_it_s = phase_d128_grape(dev)
    launches.update({k: d128_launches[k] for k in ("K3", "K4")})
    route_ms = phase_blocked_vs_plane(dev)
    backprop_ms = phase_d1024_backprop(dev)
    expm_ms, expm_bounds, expm_err = phase_expm_timing(dev)
    ms.update(expm_ms)
    bounds.update(expm_bounds)
    worst.update(expm_err)
    phase_stream_kernels(dev)
    phase_stream_schroedinger(dev)
    d20_launches, d20_it_s = phase_lindblad_d20(dev)
    launches.update({k: d20_launches[k] for k in ("K6 fwd", "K6 bwd")})
    phase_lindblad_routes(dev)
    stream_ms, stream_bounds, stream_err = phase_stream_timing(dev)
    ms.update(stream_ms)
    bounds.update(stream_bounds)
    worst.update(stream_err)
    phase_step_kernels(dev)
    stepcost = phase_stepcost_grape(dev)
    launches["K2 step"] = stepcost[1][0]["K2 step"]
    m4_step_launches, m4_step_it_s = phase_stepcost_routes(dev)
    launches["K5 bwd step"] = m4_step_launches["K5 bwd step"]
    d20_step_launches, d20_step_it_s = phase_stepcost_lindblad(dev)
    launches["K6 bwd step"] = d20_step_launches["K6 bwd step"]
    step_ms, step_bounds, step_err = phase_step_timing(dev, headline_w)
    ms.update(step_ms)
    bounds.update(step_bounds)
    worst.update(step_err)
    kernels = [
        _kernel_row(name, source, replaces, launches[key], worst[key],
                    ms[key], ms[key + " plain"], bounds[key],
                    ms.get(key + " library"))
        for name, source, replaces, key in (
            ("chain_fwd", "chain_fwd.cu", "chain_pallas.py:236", "K1"),
            ("chain_bwd", "chain_bwd.cu", "chain_pallas.py:262", "K2"),
            ("plane_fwd", "plane_fwd.cu", "chain_pallas.py:695", "K5 fwd"),
            ("plane_bwd", "plane_bwd.cu", "chain_pallas.py:718", "K5 bwd"),
            ("expm_fwd", "expm_fwd.cu", "expm_pallas.py:264", "K3"),
            ("expm_frechet", "expm_frechet.cu", "expm_pallas.py:397",
             "K4"),
            ("stream_fwd", "stream_fwd.cu", "chain_pallas.py:442", "K6 fwd"),
            ("stream_bwd", "stream_bwd.cu", "chain_pallas.py:463",
             "K6 bwd"),
            ("chain_bwd (per-step seeds)", "chain_bwd.cu",
             "chain_pallas.py:262", "K2 step"),
            ("plane_bwd (per-step seeds)", "plane_bwd.cu",
             "chain_pallas.py:718", "K5 bwd step"),
            ("stream_bwd (per-step seeds)", "stream_bwd.cu",
             "chain_pallas.py:463", "K6 bwd step"))]
    print("summary: card {} | build {:.1f} s | headline GRAPE {:.2f} it/s | "
          "M4 GRAPE {:.2f} it/s | d=128 GRAPE {:.2f} it/s | M4 loss+gradient "
          "blocked {:.3f} ms, plane {:.3f} ms | d=1024 backprop {:.3f} ms | "
          "Lindblad d=20 GRAPE {:.2f} it/s | step-cost headline GRAPE {:.2f} "
          "it/s (cost_eval_step {}: {:.2f}) | M4 step-cost GRAPE {:.2f} it/s "
          "| Lindblad d=20 step-cost GRAPE {:.2f} it/s".format(
              card, build_s, it_s, m4_it_s, d128_it_s, route_ms["blocked"],
              route_ms["plane"], backprop_ms, d20_it_s, stepcost[1][1],
              THINNED_COST_EVAL_STEP, stepcost[THINNED_COST_EVAL_STEP][1],
              m4_step_it_s, d20_step_it_s))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# Phases that need nothing from an earlier one (--phases).
STANDALONE = {11: phase_expm_kernels, 16: phase_stream_kernels,
              17: phase_stream_schroedinger, 18: phase_lindblad_d20,
              19: phase_lindblad_routes, 20: phase_stream_timing,
              21: phase_step_kernels, 22: phase_stepcost_grape,
              23: phase_stepcost_routes, 24: phase_stepcost_lindblad,
              25: phase_step_timing}


if __name__ == "__main__":
    main()
