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
   torch.linalg.matrix_exp of the same generators, at the headline shapes,
   with each kernel's design: threads and shared memory a block, ptxas
   registers and spills (build.log) and its share of the bound;
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
   conjugate transpose of the planes that the adjoint kernel does on load,
   with both kernels' design as in phase 6;
11. K3 (expm) and K4 (its Fréchet derivative) against their plain versions
   in float32 on every ladder level, at d = 16, 64, 96, 128, 180 and 256
   (padded 64, 64, 128, 128, 192, 256) and batches 1, 37, 133 and 2000
   (133: a ragged last wave of blocks), the padded rows exact, and against
   float64 torch.linalg.matrix_exp and its autograd;
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
   forward and backward on the same inputs, with each kernel's design:
   cluster size and grid, shared memory a block, ptxas registers and
   spills (build.log) and its share of the bound;
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
   versions and bounds, with the grid (clusters and SMs), shared memory a
   block, ptxas registers and spills, the share of the bound, and the
   segment merge's device time;
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
   beside their plain versions, the last-step mode and their bounds, K2's
   and K5's design as in phase 6, and the trajectory glue's device times at
   the headline;
26. K1/K2's member axis (the chains of ensembles and multistart, one
   launch for all chains) against their plain versions in float32 on every
   ladder level and in both seed modes, at 2 and 5 members with S_m > 1
   segments a chain, 9 members and 512 chains with one segment a chain,
   and 133 chains (a ragged last wave): totals, prefixes and the weight
   gradient, each member against itself run alone through the
   single-chain op, the padded rows and steps exactly the identity, and
   the totals against float64 matrix_exp products;
27. the ensemble at full width: grape_schroedinger_ensemble on bench_m4's
   widths under M2 (d = 64, 10 complex controls, 2001 points, T = 20) with
   the drift an EnsembleLinearHamiltonian (1 + δ)·H0, 4 and 16 members,
   δ = linspace(-0.05, 0.05, M), 2 warm-up + 10 timed iterations,
   counters read around each run (K1 and K2 once a time block, K3-K6
   never), then with ForbidStates of |1> (0.1) every step (K2 per step);
   loss and gradient against float64 over the plain versions;
28. the generic member route: the 4-member ensemble under M4 through the
   blocked route (K3/K4 launched, K1/K2/K5 never), against float64;
29. grape_schroedinger_multistart at full width on bench.py's
   bench_multistart problem (d = 64, 10 complex controls, 201 points,
   T = 2, Adam, fused_chunk 12): 512 candidates for 48 iterations, 1024 and
   2048 for 24, candidate-iterations/s (steady), time blocks and launches
   an iteration, peak memory and the best error; the 512 candidates' losses
   and gradients at their seeds against float64; then a robust multistart
   of 64 candidates x the 4-member ensemble of phase 27 (8 iterations);
30. K1/K2 at the 512-candidate shapes (512 chains x 200 steps), both seed
   modes, beside their plain versions, bounds and design, and the member
   merge and seed glue's device times at phase 27's 4 and 16 members;
31. the plane op's member axis (K6 and K5, one launch for all chains)
   against the plain versions in float32 on every ladder level and in both
   seed modes: K6 at d = 260 and 400 (padded 320, 448) with 2, 5 and 16
   members (S_m > 1), 15 chains (one segment a chain, the 15 resident
   clusters) and 17 (a ragged second wave), K5 at d = 16 and 64 with 3
   members and 133 chains: totals, prefixes and the plane gradient, each chain against
   itself run alone, the padded rows and steps exactly the identity, and
   the totals against float64 matrix_exp products;
32. the slice at full width: grape_lindblad_ensemble on the d = 20 cell
   (bench_lindblad_d20's construction with the drift an
   EnsembleLinearHamiltonian (1 + δ)·0.1 n̂, δ = linspace(-0.05, 0.05, M),
   MAGNUS_EXPM, M2) with 4 and 16 members (S_m = 7 and 5 segments a
   chain in the first time block, rows in waves of the 15 clusters),
   2 warm-up + 5 timed iterations, counters read around each run (K6
   forward and adjoint once a time block, K1-K5 never), peak memory; the
   4-member loss and gradient against float64 over the plain versions;
   then the 4 members with phase 24's density step costs (K6 per step);
33. grape_lindblad_multistart on the same cell: 16 candidates,
   candidate-iterations/s, time blocks, launches, peak memory and
   the best error; 4 candidates' losses and gradients at their seeds
   against float64; then 4 candidates x phase 32's 4 members;
34. the other member routes, each with counters and against float64:
   examples/6_lindblad_ensemble_robust.py at its own widths (d = 2, 8
   detuning members, 21 points) through K1/K2's member axis, its GRAPE and
   its 8 x 8 robust multistart; a d = 12 Lindblad ensemble of 4 members
   through the blocked route (K3/K4); a Schrödinger ensemble of 4 members
   at d = 300 (phase 17's problem, 21 steps) through K6's member axis;
35. K6's member-batched forward and adjoint (both seed modes) at phase
   32's 16-member shapes, and K5's at the M4 ensemble's planes (4 members
   x 2000 steps), beside their plain versions, bounds, grid and design; the
   member merge and seed glue's device time at 4 members;
36. the bf16_3x precision mode (QOC_TPU_MXU_PRECISION, config.MXU_MODE;
   phases 1-35 run with it pinned to "highest"): the mode's kernels (3 x
   TF32 tensor-core products, _D12A at degree 12) against their plain
   versions in the mode, in float32, on every ladder level and in both
   seed modes: K1/K2 at d = 64 and 21 terms on one chain of 1001 steps, 2
   and 5 members, 133 and 512 chains and at the headline's own shapes; K5
   at d = 64 and 16, one chain and on the member axis; K3/K4 at padded 64
   (d = 16 and 64, batches 37, 133 and 2000); the padded rows and steps
   exactly the identity; the resident forwards (K1, K5's, K3: FwdTC) and
   adjoints (K2, K5's, K4: AdjointTC) each within MODE_RTOL of its plain
   version, the worst printed with its margin; each also against the
   exact-f32 kernel and float64 matrix_exp products, within the mode's
   envelope; on K5's d = 16, 2001-step case at the last level, the mode
   kernel, its plain version in the mode and the exact kernel each against
   a float64 chain of matrix_exp in complex128 of the same planes;
37. the slice at full width in the mode: the Table-3 headline GRAPE (2
   warm-up + 10 timed iterations) with counters (the mode forms of K1 and
   K2 launched, the exact forms not), its rate beside phase 5's, its loss
   and gradient against the float64 plain route and its loss beside the
   exact kernels'; then the step-cost headline GRAPE (K2 per step), the M4
   GRAPE (K5) and its step-cost loss (K5 per step), the M4 loss through
   the blocked route (K3/K4 at padded 64), the 4-member ensemble and the
   512-candidate multistart, each in the mode with its rate and counters;
38. the mode's kernels timed at the headline shapes, the M4 planes and the
   512-candidate shapes, beside the exact kernel in the same call, the
   plain version in the mode and the mode's bound (the ladder's complex
   products at 24 dp^3 FLOP over the TF32 tensor-core peak, against the
   bytes over the HBM rate), with threads, shared memory, ptxas registers
   and spills, and the resident forward form's design;
39. the tiled kernels' cells in the mode: the d = 2^7 GRAPE (K3/K4 at
   padded 128), the Lindblad d = 20 GRAPE (K6) and the 4-member d = 20
   Lindblad ensemble GRAPE (K6's member axis), each with counters (the
   mode forms launched, the exact forms not), its rate beside the exact
   phase's, the error falling and its loss at the initial controls within
   5e-5 (relative) of the exact kernels' (its gradient within 1e-3); then
   the d = 20 step-cost loss in the mode (K6 per step);
40. the tiled kernels' bf16_3x forms (3 x TF32 tensor-core products on the
   tiled product, _D12A at degree 12) against their plain versions in the
   mode within 1.5e-5 on every ladder level: K3/K4 at padded 128, 192 and
   256 (also against the exact kernels and float64 matrix_exp), K6 at
   padded 320, 384, 448 and 512 on one chain (both seed modes) and on the
   member axis; padding and padded steps exact;
41. their times beside the exact forms in the same call (K3/K4 at the
   d = 2^7 planes, K6 at the d = 20 planes and a time block of the
   4-member ensemble), the plain versions in the mode, matrix_exp, both
   modes' bounds, design lines and every tiled TC instantiation's ptxas
   registers and spills;
42. the adaptive RKDP5 integrator (qoc_tpu's default Lindblad method,
   plain torch, no kernel), through the entry points called without a
   method: examples/1_transmon_pi_decoherence.py's problem (d = 2, T1 =
   1000, 11 control points, one interval, T = 10) in float64 at atol 1e-12
   and rkdp5_max_steps 16384, 3 Adam iterations, finite and falling and
   within 1e-9 of the same run on the CPU; in float32 at atol 1e-8, its
   first error within 1e-5 of float64's; the d = 20 cell's evolve in
   float64 against the CPU, with its gap to MAGNUS_EXPM (K6); a 4-member
   ensemble whose members each equal their single-member run within 1e-12
   (float64), and a 16-candidate multistart in float32 for 2 iterations;
   the CPU runs in a spawned process beside the card's; each line with the
   attempts an interval, host reads a loss and it/s;
43. the optimizers and the host loop at full width: the Table-3 headline
   GRAPE with the device L-BFGS (LBFGS(), 5 iterations), exact and in the
   mode, with counters (K1 launched ls_steps + 2 times and K2 once an
   iteration, nothing else) and its best error under the initial
   controls'; the same exact run through an identity
   impose_control_conditions hook (the host loop and LBFGS's numpy twin),
   its errors of iterations 0 and 1 within 1e-4 (relative) of the fused
   run's; LBFGSB() on the headline for 5 iterations, its error falling,
   with the device evaluations an iteration; example 1 under RKDP5 with
   LBFGSB() in float64 for 3 iterations against the same call on the CPU
   (a spawned process) within 1e-9; a 64-candidate multistart with
   LBFGS() for 3 iterations on phase 29's problem (d = 64, 201 points),
   every candidate's error finite, the winner under candidate 0's initial
   error, launches counted; each line with its it/s and the card;
44. save files and resume at full width: whether h5py imports (where it
   does not, the save files go through qoc_tpu_torch.io.h5's writer on
   memory, said on a line of its own); the Table-3 headline GRAPE (Adam,
   save_iteration_step 2, intermediate states, chunks of 2) run 6
   iterations (A) and 4 then resumed into its own file to 6 (B), B's rows,
   errors and final params within 1e-6 (relative) of A's, launches counted
   (K1 once an iteration and once a save row for the trajectory, K2 once
   an iteration, nothing else); the headline's it/s at save_iteration_step
   0, 1 and 10; LBFGSB() on the host loop stopped and resumed at its
   checkpoint; the 64-candidate multistart of phase 29's problem stopped
   after a chunk and resumed, within 1e-6 of the uninterrupted run;
45. expm's forward choice (set_expm_forward): "auto", "pallas", "taylor"
   and "pade" at d = 100 (padded 128) and 300 against float64 matrix_exp
   and its autograd within FWD_RTOL / GRAD_RTOL in both modes, K3/K4
   launched under "auto" and "pallas" at padded <= 256 and nothing
   otherwise; Padé-13 against Taylor at d = 300, 512 and 1024 (batches 1
   and 64, 8 at 1024) and at phase 14's own step, forward and with the
   gradient, in both modes, each the fastest of interleaved calls, and
   "auto"'s choice above padded 256 not slower than the other beyond 10%
   where every one of its calls was slower (the spreads apart).

Every phase prints its wall time, the summary the script's total.

Any failure exits non-zero. The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import ctypes
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
# K3/K4 against their plain versions: these d (padded to 64, 64, 128, 128,
# 192, 256) and batches, on every ladder level.
EXPM_DIMS = (16, 64, 96, 128, 180, 256)
EXPM_BATCHES = (1, 37, 133, 2000)
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
# K1/K2's member axis against their plain versions: (members, steps) with
# S_m > 1 segments a chain (2 and 5 members), one segment a chain (9 members
# over 8 steps, and the multistart's 512 chains of 200 steps), and 133
# chains, whose rows leave a ragged last wave on the H100's 132 SMs.
MEMBER_CASES = ((2, 1001), (5, 203), (9, 8), (133, 37), (512, 200))
# The ensemble of phases 27-28: bench_m4's widths (2001 points, T = 20),
# the drift miscalibrated as (1 + δ)·H0, δ = linspace(-0.05, 0.05, M).
ENSEMBLE_MEMBERS = (4, 16)
ENSEMBLE_DELTA = 0.05
# The multistart of phase 29 (bench.py:352-375 of the JAX package): d = 64,
# 10 complex controls, 201 points, T = 2, Adam, fused_chunk 12; (candidates,
# iterations) of each run, and the robust multistart over phase 27's 4
# members.
MULTISTART_POINTS = 201
MULTISTART_TIME = 2.0
MULTISTART_CHUNK = 12
MULTISTART_RUNS = ((512, 48), (1024, 24), (2048, 24))
ROBUST_CANDIDATES = 64
ROBUST_ITERATIONS = 8
ROBUST_CHUNK = 4
# The plane op's member axis (K6, K5) against its plain versions: (d,
# chains, steps). K6 at d = 260 and 400 with S_m > 1 segments a chain (2
# and 5 members, and phase 32's 16 members x 20 steps: 80 rows in 6 waves
# of the 15 resident clusters), one segment a chain (15 chains fill the
# clusters) and 17 chains of one step (a ragged second wave of the
# clusters' loop); K5 at d = 16 and 64 with 3 members (S_m > 1) and 133
# chains (one segment a chain, a ragged last wave of blocks).
PLANE_MEMBER_CASES = (
    tuple((d, m, n) for d in (260, 400)
          for m, n in ((2, 9), (5, 7), (16, 20), (15, 2), (17, 1)))
    + tuple((d, m, n) for d in (16, 64) for m, n in ((3, 37), (133, 5))))
# The Lindblad ensemble of phases 32-33 and 35: the d = 20 cell with the
# drift miscalibrated as (1 + δ)·0.1 n̂, δ = linspace(-0.05, 0.05, M), 4
# and 16 members, 5 timed iterations after the warm-up; the multistart's 16
# candidates and 4 candidates x 4 members.
LINDBLAD_MEMBERS = (4, 16)
LINDBLAD_TIMED = 5
LINDBLAD_CANDIDATES = 16
LINDBLAD_ROBUST_CANDIDATES = 4
# examples/6_lindblad_ensemble_robust.py of the JAX package: d = 2, 8
# detuning members δ = linspace(-0.02, 0.02, 8), T1 = 1000, 11 control
# points, 21 points, T = 10, Adam(0.02), 8 candidates; the d = 12 ensemble
# of phase 34 (superoperator 144, the blocked route).
EXAMPLE6_MEMBERS = 8
EXAMPLE6_DELTA = 0.02
EXAMPLE6_ITERATIONS = 20
D12 = 12

# One H100 SXM (NVIDIA's data sheet, dense, at 700 W): FP32 outside the
# tensor cores, TF32 on them, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_PER_S = 3.35e12
# Complex DP^3 products a step of the Taylor ladder per level: degree
# 4/8/12/19, and degree 19 before the squarings of the last level; in the
# bf16_3x mode degree 12 takes 4 (_D12A).
LADDER_PRODUCTS = (2, 3, 5, 7, 7)
MODE_LADDER_PRODUCTS = (2, 3, 4, 7, 7)
# The bf16_3x precision mode (phases 36-38). K1/K2 against their plain
# versions in the mode: (members, steps) of one chain (S = 126 segments),
# S_m > 1 segments a chain (2 and 5 members), 133 chains (a ragged last
# wave) and the 512-candidate shapes; K5: (d, chains, steps); K3/K4 at
# padded 64: (d, batch).
MODE = "bf16_3x"
MODE_MEMBER_CASES = ((1, 1001), (2, 1001), (5, 203), (133, 37), (512, 200))
MODE_PLANE_CASES = ((64, 1, 37), (16, 1, 2001), (64, 3, 37), (16, 133, 5))
MODE_EXPM_CASES = ((16, 37), (64, 133), (64, 2000))
LEVEL_NORMS = (0.03, 0.3, 1.0, 2.5, 7.0)
# The mode on the tiled kernels (phases 39-41): K3/K4 at d = 100, 180, 256
# (padded 128, 192, 256; batches 37, and 133 at padded 128), K6 at d = 260,
# 330, 400, 512 (padded 320, 384, 448, 512) on one chain of 37 steps and on
# 3 member chains of 5, each against its plain version in the mode within
# MODE_RTOL; the cells' losses in the mode within MODE_LOSS_RTOL (relative)
# of the exact kernels'.
MODE_TILED_EXPM_DIMS = (100, 180, 256)
MODE_TILED_BATCHES = (37, 133)
MODE_STREAM_DIMS = (260, 330, 400, 512)
MODE_STREAM_CASES = ((1, 37), (3, 5))
MODE_RTOL = 1.5e-5
# Phase 36's K5 case nearest MODE_RTOL (d, chains, steps), held on its last
# level against a float64 chain.
MODE_F64_CASE = (16, 1, 2001)
MODE_LOSS_RTOL = 5e-5

# Phase 42: the adaptive RKDP5 integrator (qoc_tpu's default Lindblad
# method), plain torch on the card, taken by the entry points without a
# method argument. Example 1 at the reference's atol and rkdp5_max_steps
# in float64, and at atol 1e-8 in float32, whose first error must lie
# within RKDP5_F32_TOL of float64's; the d = 20 cell's evolve in float64;
# the lanes (members, candidates) at RKDP5_LANE_ATOL. The RKDP5 attempt
# is host-bound, so the iteration counts stay small: the script's time
# limit holds on a slow host too.
RKDP5_MAX_STEPS = 16384
RKDP5_ITERATIONS = 3
RKDP5_F32_ATOL = 1e-8
RKDP5_F32_ITERATIONS = 2
RKDP5_F32_TOL = 1e-5
RKDP5_CPU_TOL = 1e-9
RKDP5_MEMBERS = 4
RKDP5_LANE_ATOL = 1e-10
RKDP5_LANE_TOL = 1e-12
RKDP5_CANDIDATES = 16
RKDP5_MS_ITERATIONS = 2
# Phase 43: the optimizers and the host loop.
LBFGS_ITERATIONS = 5
LBFGSB_ITERATIONS = 5
EXAMPLE1_LBFGSB_ITERATIONS = 3
LBFGS_CANDIDATES = 64
LBFGS_MS_ITERATIONS = 3
HOST_TWIN_RTOL = 1e-4

# Phase 44: save and resume on the headline: run A SAVE_ITERATIONS Adam
# iterations, run B SAVE_STOP then resumed to SAVE_ITERATIONS, a save row
# every SAVE_STEP iterations with the intermediate states, chunks of
# SAVE_CHUNK, B held to A within SAVE_RTOL (relative); the it/s at each
# SAVE_RATE_STEPS; LBFGSB on the host loop stopped after SAVE_HOST_STOP
# evaluations and resumed; the 64-candidate multistart (phase 29's
# problem) stopped after a chunk and resumed to SAVE_MS_ITERATIONS.
SAVE_ITERATIONS = 6
SAVE_STOP = 4
SAVE_STEP = 2
SAVE_CHUNK = 2
SAVE_RTOL = 1e-6
SAVE_RATE_STEPS = (0, 1, 10)
SAVE_RATE_ITERATIONS = 30
SAVE_RATE_CHUNK = 10
SAVE_HOST_STOP = 2
SAVE_MS_ITERATIONS = 4

# Phase 45: expm's forward choice. Each name checked at padded <= 256 and
# above; Padé-13 against Taylor timed at these (d, batch) (the blocked
# route's single step and a block of 64 steps, 8 at d = 1024) and at phase
# 14's own step, the fastest of 2 x APPROXIMANT_ROUNDS calls each. "auto"
# takes the faster with its gradient, one within APPROXIMANT_TIE of it, or
# one whose calls' spread overlaps the other's (launch-bound batches, where
# the host's jitter decides: unresolved).
APPROXIMANT_CHECK_DIMS = (100, 300)
APPROXIMANT_CASES = ((300, 1), (300, 64), (512, 1), (512, 64), (1024, 1),
                     (1024, 8))
APPROXIMANT_NORM = 2.0
APPROXIMANT_ROUNDS = 3
APPROXIMANT_TIE = 1.10


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


def kernel_bound(step_norms, level, dual, tensors, dp=D, chain=True,
                 mode="highest"):
    """(bound ms, what bounds it, GFLOP) of one kernel call: the larger of
    its complex dp^3 products over the FP32 peak (8 dp^3 FLOP each) and the
    bytes of its inputs and outputs (``tensors``, each once) over the HBM
    rate. In the bf16_3x ``mode`` a complex product is 3 TF32 passes of its
    4 real products, 24 dp^3 FLOP over the TF32 peak, and degree 12 takes
    4 products.
    ``step_norms`` are the 1-norms of the matrices the ladder exponentiates
    (A_t forward, A_t^H adjoint), one per step or matrix: at the squaring
    level they give this run's squarings. ``chain``: a chain kernel, which
    also multiplies each step into its prefix (forward) or does the T update
    and gU (adjoint); else K3/K4, exps only. Elementwise work is not
    counted."""
    n = step_norms.shape[0]
    tf32 = mode == MODE
    ladder = (MODE_LADDER_PRODUCTS if tf32 else LADDER_PRODUCTS)[level] * n
    if level == len(LADDER_PRODUCTS) - 1:
        ladder += int(torch.clamp(torch.ceil(torch.log2(
            torch.clamp(step_norms, min=1.0))), 0, 60).sum())
    # Dual products are 3 complex products each.
    products = 3 * ladder if dual else ladder
    if chain:
        products += 2 * n if dual else n
    flops = products * (24 if tf32 else 8) * dp ** 3
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_ops = flops / (PEAK_TF32_FLOPS if tf32 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def _wrappers():
    from qoc_tpu_torch.ops import chain, expm_cuda
    return {"K1": chain.chain_fwd, "K2": chain.chain_bwd,
            "K5 fwd": chain.plane_fwd, "K5 bwd": chain.plane_bwd,
            "K3": expm_cuda.expm_fwd, "K4": expm_cuda.expm_frechet_fwd,
            "K6 fwd": chain.stream_fwd, "K6 bwd": chain.stream_bwd}


# The adjoint wrappers also count their launches in the per-step-seed mode
# (``step_launches``, a part of ``launches``), read as "<key> step"; the
# wrappers of kernels with a bf16_3x form those in that precision mode
# (``mode_launches``), read as "<key> mode".
STEP_MODES = ("K2", "K5 bwd", "K6 bwd")
PRECISION_MODES = ("K1", "K2", "K5 fwd", "K5 bwd", "K3", "K4", "K6 fwd",
                   "K6 bwd")


def reset_launches():
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for key in STEP_MODES:
        wrappers[key].step_launches = 0
    for key in PRECISION_MODES:
        wrappers[key].mode_launches = 0


def read_launches():
    wrappers = _wrappers()
    launches = {key: fn.launches for key, fn in wrappers.items()}
    launches.update({key + " step": wrappers[key].step_launches
                     for key in STEP_MODES})
    launches.update({key + " mode": wrappers[key].mode_launches
                     for key in PRECISION_MODES})
    return launches


@contextlib.contextmanager
def precision(mode):
    """config.MXU_MODE set to ``mode`` inside the block, restored after
    (errors pass through)."""
    from qoc_tpu_torch import config
    old = config.MXU_MODE
    config.MXU_MODE = mode
    try:
        yield
    finally:
        config.MXU_MODE = old


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


def ptxas_report(*entry):
    """(registers, spill-store bytes) that ptxas reported in the kernels'
    build.log for the first entry function whose mangled name holds every
    string of ``entry`` (e.g. "stream_bwd_kernelILi7E")."""
    from qoc_tpu_torch.ops import chain
    regs = spill = None
    current = None
    for line in (chain.build_dir() / "build.log").read_text().splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line
        elif current and all(part in current for part in entry):
            if "spill stores" in line and spill is None:
                spill = int(line.split("bytes spill stores")[0].split(",")[-1])
            if "Used" in line and "registers" in line and regs is None:
                regs = int(line.split("Used")[1].split("registers")[0])
    return regs, spill


def design_line(name, entry, clusters, blocks, smem, bound_ms, ms,
                threads=256):
    """A kernel's launch design as phases 6, 10, 15, 20 and 25 print it;
    ``entry``: the strings of ptxas_report."""
    regs, spill = ptxas_report(*entry)
    return ("{}: {} threads a block, cluster {} blocks, grid {} clusters ({} "
            "blocks), {} B shared memory a block, {} registers, {} B spilled, "
            "{:.0%} of its bound".format(
                name, threads, blocks, clusters, clusters * blocks, smem,
                regs, spill, bound_ms / ms))


# ptxas entry strings of the resident kernels, exact and (True) in the
# bf16_3x mode: the forwards' by the form they launch (chain_common.cuh Fwd,
# FwdTC), the adjoints' (K2, K5 bwd, K4 at dp = 64) by their Adjoint
# (adjoint_entry).
RESIDENT_ENTRY = {
    tc: {"K1": ("chain_fwd_kernel", form),
         "K5 fwd": ("plane_fwd_kernel", form),
         "K3": ("expm_resident_kernel", form)}
    for tc, form in ((False, "3FwdE"), (True, "FwdTC"))}
ADJOINT_KERNEL = {"K2": "chain_bwd_kernel", "K5 bwd": "plane_bwd_kernel",
                  "K4": "frechet_resident_kernel"}


def adjoint_entry(key, tf32):
    """ptxas entry strings of the resident adjoint ``key`` (K2, "K5 bwd", K4
    at dp = 64) as its C entry launches it for ``tf32`` (0 exact, 1 the
    bf16_3x mode: chain_common.cuh AdjointNTA, AdjointTC)."""
    from qoc_tpu_torch.ops import chain
    threads = chain.resident_block(key, tf32)[0]
    return (ADJOINT_KERNEL[key],
            "AdjointILi{}ELb0ELb0ELi4ELi7ELb{}ELb0EE".format(
                threads, int(bool(tf32))))


def resident_design_line(key, s_count, bound_ms, ms):
    """design_line of a resident chain kernel launched on s_count segment
    chains, one block each (a key ending in " mode": its bf16_3x form)."""
    from qoc_tpu_torch.ops import chain
    tc = key.endswith(" mode")
    base = key.replace(" mode", "").replace(" step", "").replace(
        " member", "")
    threads, smem = chain.resident_block(base, int(tc))
    entry = (adjoint_entry(base, int(tc)) if base in ADJOINT_KERNEL else
             RESIDENT_ENTRY[tc][base])
    return design_line(key, entry, s_count, 1, smem, bound_ms, ms, threads)


def _card(card):
    """The card's name and power limit as nvidia-smi gives them."""
    if card is not None:
        return card
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs an NVIDIA GPU.")
    if not (ROOT / "qoc_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: qoc_tpu_torch/csrc not found beside "
                         "this script; run it from a checkout of the "
                         "repository.")
    card = _card(None)
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
    for key in ("K1", "K2"):
        print("phase 6 design: " + resident_design_line(
            key, s_count, bounds[key][0], ms[key]), flush=True)
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
    for key in ("K5 fwd", "K5 bwd"):
        print("phase 10 design: " + resident_design_line(
            key, s_count, bounds[key][0], ms[key]), flush=True)
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


def _check_expm_padding(a, tf32=0):
    """K3's padded rows and columns exactly the identity's and K4's exactly
    zero, read from the kernels' padded outputs (``tf32``: the bf16_3x
    mode's forms)."""
    from qoc_tpu_torch.ops import expm_cuda
    d = a.shape[-1]
    dp = expm_cuda.kernel_dp(d)
    x = expm_cuda._padded(a, dp)
    norm = expm_cuda._norm_max(x)
    u = expm_cuda._launch(False, dp, norm, x, tf32=tf32)
    dl = expm_cuda._launch(True, dp, norm, x, expm_cuda._padded(a, dp),
                           tf32=tf32)
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


def make_iteration(pstate, dev, build_loss=None, optimizer=None):
    """One GRAPE iteration of core/graperunner.py on ``pstate`` (clip,
    loss, gradient, the update of ``optimizer``, by default
    ``pstate.optimizer``, given the error and the clip-projected loss as
    the runner gives them, which only LBFGS's line search reads); returns
    the error.
    ``build_loss``: build_schroedinger_loss, or build_lindblad_loss for a
    Lindblad state."""
    from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                           slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    shape = pstate.controls_shape
    loss = (build_loss or build_schroedinger_loss)(pstate, dev,
                                                   torch.float32)
    mcn = torch.as_tensor(pstate.max_control_norms, dtype=torch.float32,
                          device=dev)
    optimizer = optimizer or pstate.optimizer
    params = strip_controls_torch(True, torch.as_tensor(
        pstate.initial_controls, dtype=torch.complex64, device=dev))
    state = {"params": params, "opt": optimizer.init_state(params)}

    def clipped(p):
        return strip_controls_torch(True, clip_control_norms_torch(
            slap_controls_torch(True, p, shape), mcn))

    def projected_loss(p):
        return loss(slap_controls_torch(True, clipped(p), shape))[0]

    def iteration():
        flat = clipped(state["params"]).detach()
        flat.requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat, shape))
        grads, = torch.autograd.grad(error, flat)
        state["opt"], state["params"] = optimizer.update(
            state["opt"], grads, state["params"], error.detach(),
            projected_loss)
        return error
    return iteration


def make_multistart_iteration(pstate, hamiltonian, params, n_starts, dev):
    """One iteration of the multistart runner (parallel/_msrunner.py) on
    ``n_starts`` candidates from their seeds over the members ``params``
    (or one member): clip, the candidates' errors and gradients from one
    backward of their sum, the per-candidate Adam update; returns the
    errors."""
    from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                           slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    shape = pstate.controls_shape
    loss = build_chain_loss(pstate, hamiltonian, params, dev, torch.float32,
                            n_candidates=n_starts)
    slap = torch.func.vmap(lambda p: slap_controls_torch(True, p, shape))
    strip = torch.func.vmap(lambda c: strip_controls_torch(True, c))
    mcn = torch.as_tensor(pstate.max_control_norms, dtype=torch.float32,
                          device=dev)
    adam = pstate.optimizer
    params0 = torch.as_tensor(candidate_seeds(pstate, n_starts, 0),
                              dtype=torch.float32, device=dev)
    state = {"params": params0, "opt": adam.init_state_batch(params0)}

    def iteration():
        flat = strip(clip_control_norms_torch(slap(state["params"]),
                                              mcn)).detach()
        flat.requires_grad_(True)
        errors = loss(slap(flat))[0].mean(dim=1)
        grads, = torch.autograd.grad(errors.sum(), flat)
        errors = errors.detach()
        state["opt"], state["params"] = adam.update_batch(
            state["opt"], grads, state["params"], errors <= 0.0)
        return errors
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
    from qoc_tpu_torch.ops import chain, expm_cuda
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
        for key, dual in (("K3", False), ("K4", True)):
            blocks = expm_cuda.launch_grid(dual, dp, a.shape[0], dev.index)[0]
            smem = expm_cuda._plan(dual, dp, dev.index)[2]
            # K4 at dp = 64 runs the resident adjoint's block.
            threads = chain.resident_block("K4")[0] if dual and dp == 64 \
                else 256
            entry = ((adjoint_entry(key, 0) if dual else
                      RESIDENT_ENTRY[False][key]) if dp == 64 else
                     tiled_entry(key, dp, False))
            print("phase 15 design ({} planes): ".format(label)
                  + design_line(key, entry, blocks, 1, smem, bounds[key][0],
                                ms[key], threads), flush=True)
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
    return lindblad_pstate(lindblad_d20_problem(step_costs))


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
    for key, dual in (("K6 fwd", False), ("K6 bwd", True)):
        _, blocks, _, smem = chain._stream_plan(dual, dp, a.device.index)
        entry = tiled_entry(key, dp, False)
        print("phase 20 design ({} planes): ".format(label)
              + design_line(key, entry, grids[key], blocks, smem,
                            bounds[key][0], ms[key]), flush=True)
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
        error = 0.0
        if pstate.step_costs:
            error = step_cost_sum(pstate.step_costs, controls,
                                  lambda sel: prefixes[sel, None] @ initial,
                                  0, n_steps, pstate.cost_eval_step, dev)
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
    designs = [resident_design_line("K2 step", s_count, bound[0],
                                    ms["K2 step"])]
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
        if key == "K5 bwd":
            designs.append(resident_design_line(
                "K5 bwd step", a_seg.shape[0], bound[0], ms["K5 bwd step"]))
    print("phase 25 per-step timing (K2 at the step-cost headline, S x L = "
          "{} x {}; K5 at the M4 planes; K6 at the d = 20 planes): ".format(
              s_count, length)
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time, "
              "max|err| {:.2e}".format(k, b[0], b[1], b[2], b[0] / ms[k],
                                       errs[k])
              for k, b in bounds.items()), flush=True)
    for line in designs:
        print("phase 25 design: " + line, flush=True)
    return ms, bounds, errs


# ---------------------------------------------------------------------------
# Ensembles and multistart: the member-batched K1/K2 (phases 26-30)
# ---------------------------------------------------------------------------


def _member_case(rng, n_members, n_steps, target_norm, dev, d=None):
    """(kernel op, plain op, weights (M, steps, 21)) of a member-batched
    chain at d (default D) whose generators' batch-max 1-norm is
    ``target_norm``; the members' weights differ."""
    from qoc_tpu_torch.ops import chain
    d = d or D
    n_b = 1 + 2 * CONTROL_COUNT
    w = rng.normal(size=(n_members, n_steps, n_b)).astype(np.float32)
    basis = np.stack([-1j * _random_hermitian(rng, d).astype(np.complex128)
                      for _ in range(n_b)])
    # The batch-max 1-norm on the card (chunked): 10^5 generators are too
    # many for a host einsum.
    norm = float(chain._norm_max(
        torch.as_tensor(w, dtype=torch.float64, device=dev),
        torch.view_as_real(torch.as_tensor(basis, device=dev)).reshape(
            n_b, 2 * d * d), d)[0])
    basis = basis * (target_norm / norm)
    ops = [chain.ChainExpmPropagate(basis, dev, torch.float32, plain=plain,
                                    return_prefixes=True)
           for plain in (False, True)]
    return ops[0], ops[1], torch.as_tensor(w, device=dev)


def _member_outputs(op, w, g_total, g_pref):
    """(totals, prefixes, weight gradient in the last-step mode, in the
    per-step mode) of the trajectory op on weights ``w``."""
    x = w.clone().requires_grad_(True)
    total, prefixes = op(x)
    grad_last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
    grad_step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
    return total.detach(), prefixes.detach(), grad_last, grad_step


def _member_padding(op, w):
    """True when K1's prefixes of the member-batched rows are exactly the
    identity outside d = ``op.d`` and unchanged over the padded steps."""
    from qoc_tpu_torch.ops import chain
    n_members, n_steps = w.shape[:2]
    s_count, length = chain.segment_plan(n_steps, n_members)
    w_seg = torch.zeros((n_members, s_count * length, op.n_b),
                        device=w.device)
    w_seg[:, :n_steps] = w
    pref = chain.chain_fwd(w_seg.reshape(-1, length, op.n_b), op.basis,
                           chain._norm_max(w, op.basis_ri, op.d)[0])
    pref = pref.reshape(n_members, s_count, length + 1, D, D)
    last = n_steps - (s_count - 1) * length
    eye = torch.eye(D, dtype=pref.dtype, device=pref.device)
    d = op.d
    return (torch.equal(pref[:, -1, last + 1:],
                        pref[:, -1, last:last + 1].expand_as(
                            pref[:, -1, last + 1:]))
            and torch.equal(pref[..., d:, d:],
                            eye[d:, d:].expand_as(pref[..., d:, d:]))
            and not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any()))


def phase_member_kernels(dev):
    """K1/K2's member axis against the plain versions on every ladder
    level and in both seed modes, each member against itself run alone,
    the padding exact, and the totals against float64 matrix_exp."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(26)
    gen = torch.Generator(device=dev).manual_seed(26)
    worst = {"K1 member": 0.0, "K2 member": 0.0, "K2 member step": 0.0}
    for n_members, n_steps in MEMBER_CASES:
        s_count = chain.segment_plan(n_steps, n_members)[0]
        rows = []
        for target in LEVEL_NORMS:
            op_k, op_p, w = _member_case(rng, n_members, n_steps, target,
                                         dev)
            g_total = torch.randn((n_members, D, D), dtype=torch.complex64,
                                  device=dev, generator=gen)
            g_pref = torch.randn((n_members, n_steps, D, D),
                                 dtype=torch.complex64, device=dev,
                                 generator=gen)
            reset_launches()
            got = _member_outputs(op_k, w, g_total, g_pref)
            launches = read_launches()
            want = _member_outputs(op_p, w, g_total, g_pref)
            torch.cuda.synchronize()
            if (launches["K1"], launches["K2"], launches["K2 step"]) != \
                    (1, 2, 1):
                raise RuntimeError("the member-batched op did not launch K1 "
                                   "once and K2 once a backward: {}".format(
                                       launches))
            rels = [_rel(x, y) for x, y in zip(got, want)]
            # Each member run alone through the single-chain op: the
            # first, a middle and the last.
            for m in sorted({0, n_members // 2, n_members - 1}):
                alone = _member_outputs(op_k, w[m], g_total[m], g_pref[m])
                rels += [_rel(x[m], y) for x, y in zip(got, alone)]
            if max(rels[0::4] + rels[1::4]) > FWD_RTOL or \
                    max(rels[2::4] + rels[3::4]) > GRAD_RTOL:
                raise RuntimeError("the member-batched chain disagrees: {} "
                                   "members, {} steps, level {}: {}".format(
                                       n_members, n_steps,
                                       LEVEL_NORMS.index(target), rels))
            if not _member_padding(op_k, w):
                raise RuntimeError("padded steps of a member-batched chain "
                                   "moved its prefixes")
            for key, x, y in (("K1 member", got[1], want[1]),
                              ("K2 member", got[2], want[2]),
                              ("K2 member step", got[3], want[3])):
                worst[key] = max(worst[key], float((x - y).abs().max()))
            rows.append("{} {:.1e}/{:.1e}/{:.1e}/{:.1e}".format(
                LEVEL_NORMS.index(target), *rels[:4]))
        print("phase 26 member-batched K1/K2 ({} members x {} steps, S_m = "
              "{}): level total/prefixes/grad last-step/grad per-step rel "
              "vs plain: {}".format(n_members, n_steps, s_count,
                                    "; ".join(rows)), flush=True)
    # An independent reference on a small input at d = 16 (zero-padded to
    # 64): float64 matrix_exp.
    d = 16
    op_k, _, w = _member_case(rng, 3, 37, 1.0, dev, d)
    if not _member_padding(op_k, w):
        raise RuntimeError("the padded rows of a member-batched chain are "
                           "not the identity")
    total = op_k(w)[0].to(torch.complex128)
    a = torch.einsum("mjk,kab->mjab", w.double().to(torch.complex128),
                     op_k.basis[:, :d, :d].to(torch.complex128))
    want = torch.eye(d, dtype=torch.complex128, device=dev).expand(
        3, d, d)
    for t in range(a.shape[1]):
        want = torch.linalg.matrix_exp(a[:, t]) @ want
    rel = _rel(total, want)
    print("phase 26 member-batched K1/K2: 3 members x 37 steps at d = 16 vs "
          "float64 matrix_exp products rel {:.2e}; padded rows and steps "
          "exact; max|err| {}".format(
              rel, worst), flush=True)
    if rel > FWD_RTOL:
        raise RuntimeError("the member-batched op disagrees with matrix_exp")
    return worst


def ensemble_problem(n_members, magnus="M2", step_costs=()):
    """Phase 27's ensemble: bench_m4's widths (d = 64, 10 complex controls,
    2001 points, T = 20) under ``magnus``, the drift an
    EnsembleLinearHamiltonian with param_operators = [h0] (the (1 + δ)·H0
    miscalibration), δ = linspace(-0.05, 0.05, M): (pstate, hamiltonian,
    params, costs)."""
    from qoc_tpu_torch import EnsembleLinearHamiltonian
    pstate, linear, costs = bench_problem(
        D, CONTROL_COUNT, M4_STEPS, M4_STEPS, M4_EVOLUTION_TIME, magnus,
        step_costs=step_costs)
    hamiltonian = EnsembleLinearHamiltonian(linear.h0, linear.operators,
                                            linear.h0[None])
    params = np.linspace(-ENSEMBLE_DELTA, ENSEMBLE_DELTA, n_members)[:, None]
    pstate.hamiltonian = None
    pstate.set_ensemble(params)
    return pstate, hamiltonian, params, costs


def chain_reference(pstate, hamiltonian, params, dev):
    """controls (N, E, C) -> (errors (N, M), final states) of N candidates
    over M members (``params``, or one member when None) in float64 on the
    card: the fused route over the plain versions of K1/K2 (the
    member-batched chain op with plain=True, one time block), each chain's
    step costs at its cost steps and its final costs."""
    from qoc_tpu_torch.core.schroedinger import fused_weights, step_cost_sum
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    times = torch.arange(n_steps, dtype=torch.float64, device=dev) * dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float64,
                          device=dev)
    initial = torch.as_tensor(pstate.initial_states, dtype=torch.complex128,
                              device=dev)
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    op = ChainExpmPropagate(hamiltonian.generator_basis(dt), dev,
                            torch.float64, plain=True,
                            return_prefixes=bool(step_costs))
    deltas = (None if params is None
              else torch.as_tensor(params, dtype=torch.float64, device=dev))
    n_members = 1 if params is None else len(params)

    def loss(controls):
        w = fused_weights(controls, times, cet, dt)
        if deltas is not None:
            w = torch.stack([torch.cat((
                w[..., :1], delta.expand(w.shape[:-1] + delta.shape),
                w[..., 1:]), dim=-1) for delta in deltas], dim=1).flatten(
                    0, 1)
        total, prefixes = op(w) if step_costs else (op(w), None)
        states = total[:, None] @ initial
        errors = []
        for r in range(states.shape[0]):
            c = controls[r // n_members]
            error = 0.0
            if step_costs:
                error = step_cost_sum(
                    step_costs, c, lambda sel: prefixes[r, sel, None]
                    @ initial, 0, n_steps, pstate.cost_eval_step, dev)
            for cost in final_costs:
                error = error + cost.cost(c, states[r], n_steps)
            errors.append(error)
        return (torch.stack(errors).reshape(-1, n_members),
                states.reshape((-1, n_members) + states.shape[1:]))

    return loss


def _member_launches(label, launches, kernels, counts):
    """Raise unless each of ``kernels`` (read_launches keys) was launched as
    ``counts`` says and nothing else was."""
    want = {key: counts.get(key, 0) if key in kernels else 0
            for key in launches}
    if launches != want:
        raise RuntimeError("{} launched {}, expected {}".format(
            label, launches, want))


def phase_ensemble(dev):
    """grape_schroedinger_ensemble at full width: phase 27's ensemble at 4
    and 16 members, 2 warm-up + 10 timed iterations, counters read around
    each run (K1 and K2 once a time block for all members, K3-K6 never);
    then with ForbidStates of |1> (0.1) every step (K2 per step); each
    loss and gradient against float64 over the plain versions."""
    from qoc_tpu_torch import grape_schroedinger_ensemble
    from qoc_tpu_torch.parallel import build_ensemble_loss
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    rates, step_launches = {}, None
    for step in (False, True):
        for n_members in ENSEMBLE_MEMBERS:
            costs = [forbid_level(D, M4_STEPS)] if step else ()
            pstate, ham, params, costs = ensemble_problem(
                n_members, step_costs=costs)
            loss = build_ensemble_loss(pstate, ham, params, device=dev)
            blocks = -(-(M4_STEPS - 1) // loss.block)
            reset_launches()
            result = grape_schroedinger_ensemble(
                CONTROL_COUNT, M4_STEPS, costs, M4_EVOLUTION_TIME, ham,
                params, pstate.initial_states, M4_STEPS,
                complex_controls=True,
                initial_controls=pstate.initial_controls,
                iteration_count=iterations, log_iteration_step=0,
                max_control_norms=pstate.max_control_norms,
                fused_chunk=WARMUP_ITERATIONS, device=dev)
            launches = read_launches()
            n = blocks * iterations
            _member_launches("the {}-member ensemble".format(n_members),
                             launches, ("K1", "K2", "K2 step") if step
                             else ("K1", "K2"),
                             {"K1": n, "K2": n, "K2 step": n})
            errors = np.asarray(result.errors)
            if not (result.iteration_count_ran == iterations
                    and np.all(np.isfinite(errors))
                    and np.all(np.isfinite(result.best_final_states))
                    and result.best_final_states.shape
                    == (n_members, 1, D, 1) and errors[-1] < errors[0]):
                raise RuntimeError("the {}-member ensemble GRAPE failed its "
                                   "checks".format(n_members))
            check = _against_float64(
                "loss", loss, _ensemble_reference(pstate, ham, params, dev),
                pstate, dev)
            print("phase 27 ensemble ({} members x {} steps{}, {} block(s) "
                  "of {}): {} iterations, {:.2f} it/s steady ({:.1f} "
                  "member-it/s), error {:.6f} -> {:.6f}, launches {}; vs "
                  "float64 plain route: {}".format(
                      n_members, M4_STEPS - 1,
                      ", ForbidStates |1> x 0.1" if step else "", blocks,
                      loss.block, iterations, result.iterations_per_s,
                      n_members * result.iterations_per_s, errors[0],
                      errors[-1], launches, check), flush=True)
            rates[(n_members, step)] = result.iterations_per_s
            if step and n_members == ENSEMBLE_MEMBERS[0]:
                step_launches = launches["K2 step"]
    return rates, step_launches


def _ensemble_reference(pstate, ham, params, dev):
    chain_loss = chain_reference(pstate, ham, params, dev)

    def loss(controls):
        errors, states = chain_loss(controls[None])
        return errors[0].mean(), states[0]
    return loss


def phase_ensemble_blocked(dev):
    """The generic member route: phase 27's 4-member ensemble under
    Magnus-M4 takes the blocked route (all members' planes in one K3/K4
    batch a time block): 12 GRAPE iterations with counters (K3/K4 only),
    then loss and gradient against float64 (each member's planes through
    the plain plane op)."""
    from qoc_tpu_torch import grape_schroedinger_ensemble
    from qoc_tpu_torch.parallel import build_ensemble_loss
    n_members = ENSEMBLE_MEMBERS[0]
    pstate, ham, params, costs = ensemble_problem(n_members, "M4")
    loss = build_ensemble_loss(pstate, ham, params, device=dev)
    blocks = -(-(M4_STEPS - 1) // loss.block)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    reset_launches()
    result = grape_schroedinger_ensemble(
        CONTROL_COUNT, M4_STEPS, costs, M4_EVOLUTION_TIME, ham, params,
        pstate.initial_states, M4_STEPS, complex_controls=True,
        initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms,
        magnus_policy=pstate.magnus_policy,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = read_launches()
    n = blocks * iterations
    _member_launches("the M4 ensemble", launches, ("K3", "K4"),
                     {"K3": n, "K4": n})
    errors = np.asarray(result.errors)
    if loss.uses_fused_chain or not (
            np.all(np.isfinite(errors)) and errors[-1] < errors[0]):
        raise RuntimeError("the M4 ensemble GRAPE failed its checks")
    members = [schroedinger_reference(pstate, dev, float64_planes(
        pstate, ham.member(torch.as_tensor(row, device=dev)), dev))
        for row in params]

    def reference(controls):
        outs = [member(controls) for member in members]
        return (torch.stack([o[0] for o in outs]).mean(),
                torch.stack([o[1] for o in outs]))

    check = _against_float64("loss", loss, reference, pstate, dev)
    print("phase 28 ensemble blocked route (M4, {} members x {} steps, {} "
          "block(s)): {} iterations, {:.2f} it/s steady, error {:.6f} -> "
          "{:.6f}, launches {}; vs float64 (plain plane op a member): {}"
          "".format(n_members, M4_STEPS - 1, blocks, iterations,
                    result.iterations_per_s, errors[0], errors[-1], launches,
                    check), flush=True)
    return result.iterations_per_s


def multistart_problem():
    """bench.py's bench_multistart problem (:352-375 of the JAX package):
    bench_problem at d = 64, 10 complex controls, 201 points, T = 2."""
    return bench_problem(D, CONTROL_COUNT, MULTISTART_POINTS,
                         MULTISTART_POINTS, MULTISTART_TIME)


def _multistart_run(label, n_starts, iterations, chunk, dev, problem,
                    params=None, mode=False):
    """One grape_schroedinger_multistart run with counters and peak memory:
    (result, launches, blocks, peak GB); ``mode``: every launch in the
    bf16_3x mode's forms."""
    from qoc_tpu_torch import Adam, grape_schroedinger_multistart
    from qoc_tpu_torch.ops.chain import chain_block_plan
    pstate, ham, costs = problem
    n_chains = n_starts * (1 if params is None else len(params))
    n_steps = pstate.system_eval_count - 1
    blocks = -(-n_steps // chain_block_plan(D, n_steps, 8, 2, n_chains))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    result = grape_schroedinger_multistart(
        CONTROL_COUNT, pstate.control_eval_count, costs,
        pstate.evolution_time, ham, pstate.initial_states,
        pstate.system_eval_count, n_starts=n_starts, complex_controls=True,
        hamiltonian_params=params, iteration_count=iterations,
        log_iteration_step=0, optimizer=Adam(), fused_chunk=chunk,
        device=dev)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # K2 once a block an iteration; K1 also once a block for the winner's
    # final states.
    counts = {"K1": blocks * (iterations + 1), "K2": blocks * iterations}
    if mode:
        counts.update({key + " mode": n for key, n in list(counts.items())})
    _member_launches(label, launches, tuple(counts), counts)
    errors = np.asarray(result.errors)
    if not (result.iteration_count_ran == iterations
            and np.all(np.isfinite(errors))
            and np.isfinite(result.best_error)
            and result.best_error <= errors[0]
            and np.all(np.isfinite(result.best_final_states))):
        raise RuntimeError(label + " failed its checks")
    print("phase {} {}: {} iterations (chunks of {}), {:.1f} "
          "candidate-it/s steady ({:.1f} mean), {} block(s) and {} K1 + {} "
          "K2 launches an iteration, peak {:.2f} GB, best error {:.6f} "
          "(candidate 0 {:.6f}, median {:.6f})".format(
              37 if mode else 29, label, iterations, chunk,
              result.iterations_per_s,
              result.iterations_per_s_mean, blocks, blocks, blocks, peak,
              result.best_error, errors[0], float(np.median(errors))),
          flush=True)
    return result, launches


def phase_multistart(dev):
    """grape_schroedinger_multistart at full width: bench_multistart's
    problem with Adam and fused_chunk 12 at 512, 1024 and 2048 candidates,
    counters and peak memory around each run; the 512 candidates' losses
    and gradients at their seeds against float64 over the plain versions;
    then a robust multistart of 64 candidates x phase 27's 4 members."""
    from qoc_tpu_torch.core.common import slap_controls_torch
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    problem = multistart_problem()
    rates, launches = {}, None
    for n_starts, iterations in MULTISTART_RUNS:
        result, run_launches = _multistart_run(
            "multistart {} candidates".format(n_starts), n_starts,
            iterations, MULTISTART_CHUNK, dev, problem)
        rates[n_starts] = result.iterations_per_s
        if launches is None:
            launches = run_launches
    pstate, ham, _ = problem
    n_starts = MULTISTART_RUNS[0][0]
    seeds = candidate_seeds(pstate, n_starts, 0)
    shape = pstate.controls_shape
    outs = []
    for dtype, loss in ((torch.float32, build_chain_loss(
            pstate, ham, None, dev, torch.float32, n_candidates=n_starts)),
                        (torch.float64, chain_reference(pstate, ham, None,
                                                        dev))):
        flat = torch.as_tensor(seeds, dtype=dtype, device=dev)
        flat.requires_grad_(True)
        errors = loss(torch.func.vmap(
            lambda p: slap_controls_torch(True, p, shape))(flat))[0][:, 0]
        grad, = torch.autograd.grad(errors.sum(), flat)
        outs.append((errors.detach().double(), grad.double()))
    torch.cuda.synchronize()
    rel_err, rel_grad = _rel(outs[0][0], outs[1][0]), _rel(outs[0][1],
                                                           outs[1][1])
    print("phase 29 multistart {} candidates at their seeds, float32 kernel "
          "route vs float64 plain route: errors rel {:.2e}, gradients rel "
          "{:.2e}".format(n_starts, rel_err, rel_grad), flush=True)
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("the multistart kernel route disagrees with "
                           "float64")
    pstate, ham, params, costs = ensemble_problem(ENSEMBLE_MEMBERS[0])
    robust, _ = _multistart_run(
        "robust multistart {} candidates x {} members".format(
            ROBUST_CANDIDATES, len(params)), ROBUST_CANDIDATES,
        ROBUST_ITERATIONS, ROBUST_CHUNK, dev, (pstate, ham, costs), params)
    rates["robust"] = robust.iterations_per_s
    return rates, launches


def phase_member_timing(dev):
    """K1/K2 at the 512-candidate multistart's shapes (512 chains x 200
    steps, one segment a chain) in both seed modes, beside their plain
    versions, bounds and design; and the device time of the member merge,
    seeds and prefix composition at phase 27's 4 and 16 members."""
    from qoc_tpu_torch.core.common import slap_controls_torch
    from qoc_tpu_torch.core.schroedinger import fused_weights
    from qoc_tpu_torch.ops import chain
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    gen = torch.Generator(device=dev).manual_seed(30)
    pstate, ham, _ = multistart_problem()
    n_starts, n_steps = MULTISTART_RUNS[0][0], MULTISTART_POINTS - 1
    dt = float(pstate.dt)
    controls = torch.func.vmap(lambda p: slap_controls_torch(
        True, p, pstate.controls_shape))(torch.as_tensor(
            candidate_seeds(pstate, n_starts, 0), dtype=torch.float32,
            device=dev))
    w = fused_weights(controls, torch.arange(
        n_steps, dtype=torch.float32, device=dev) * dt, torch.as_tensor(
            pstate.control_eval_times, dtype=torch.float32, device=dev), dt)
    op = chain.ChainExpmPropagate(ham.generator_basis(dt), dev,
                                  torch.float32)
    s_count, length = chain.segment_plan(n_steps, n_starts)
    w_seg = w.reshape(n_starts * s_count, length, op.n_b).contiguous()
    n1, ninf = chain._norm_max(w, op.basis_ri, op.d)
    pref = chain.chain_fwd(w_seg, op.basis, n1)
    pref_plain = chain.chain_fwd_plain(w_seg, op.basis, n1)
    seeds = torch.randn((n_starts, D, D), dtype=torch.complex64, device=dev,
                        generator=gen)
    step_seeds = torch.randn((n_starts, length, D, D),
                             dtype=torch.complex64, device=dev,
                             generator=gen)
    args = (w_seg, op.basis_h, ninf, pref)
    err = {"K1 member": float((pref - pref_plain).abs().max())}
    for key, s in (("K2 member", seeds), ("K2 member step", step_seeds)):
        got = chain.chain_bwd(*args, s)
        err[key] = float((got - chain.chain_bwd_plain(*args, s)).abs().max())
        if not bool(torch.isfinite(torch.view_as_real(got)).all()):
            raise RuntimeError(key + " produced non-finite values")
    ms = {
        "K1 member": cuda_ms(lambda: chain.chain_fwd(w_seg, op.basis, n1),
                             5),
        "K1 member plain": cuda_ms(
            lambda: chain.chain_fwd_plain(w_seg, op.basis, n1), 2),
        "K2 member": cuda_ms(lambda: chain.chain_bwd(*args, seeds), 5),
        "K2 member plain": cuda_ms(
            lambda: chain.chain_bwd_plain(*args, seeds), 2),
        "K2 member step": cuda_ms(lambda: chain.chain_bwd(*args, step_seeds),
                                  5),
        "K2 member step plain": cuda_ms(
            lambda: chain.chain_bwd_plain(*args, step_seeds), 2),
    }
    a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, op.n_b).to(
        torch.complex64), op.basis)
    absa = a.abs()
    del a
    bounds = {
        "K1 member": kernel_bound(absa.sum(-2).amax(-1),
                                  chain.ladder_level(n1), False,
                                  [w_seg, op.basis, n1, pref]),
        "K2 member": kernel_bound(absa.sum(-1).amax(-1),
                                  chain.ladder_level(ninf), True,
                                  [w_seg, op.basis_h, ninf, pref, seeds,
                                   pref[:, 1:]]),
        "K2 member step": kernel_bound(absa.sum(-1).amax(-1),
                                       chain.ladder_level(ninf), True,
                                       [w_seg, op.basis_h, ninf, pref,
                                        step_seeds, pref[:, 1:]]),
    }
    del absa
    print("phase 30 member-batched timing ({} chains x {} steps, S x L = {} "
          "x {}, levels {}/{}): ".format(
              n_starts, n_steps, n_starts * s_count, length,
              chain.ladder_level(n1), chain.ladder_level(ninf))
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time, "
              "max|err| {:.2e}".format(k, b[0], b[1], b[2], b[0] / ms[k],
                                       err[k])
              for k, b in bounds.items()), flush=True)
    for key, base in (("K1 member", "K1"), ("K2 member", "K2"),
                      ("K2 member step", "K2")):
        print("phase 30 design: " + resident_design_line(
            base, n_starts * s_count, bounds[key][0], ms[key]).replace(
                base + ":", key + ":", 1), flush=True)
    del pref, pref_plain, step_seeds, args
    glue = []
    for n_members in ENSEMBLE_MEMBERS:
        pstate, ham, params, _ = ensemble_problem(n_members)
        dt = float(pstate.dt)
        steps = pstate.system_eval_count - 1
        cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                              device=dev)
        controls = torch.as_tensor(pstate.initial_controls,
                                   dtype=torch.complex64, device=dev)
        w = fused_weights(controls, torch.arange(
            steps, dtype=torch.float32, device=dev) * dt, cet, dt)
        delta = torch.as_tensor(params, dtype=torch.float32, device=dev)
        w = torch.cat((w[None, :, :1].expand(n_members, steps, 1),
                       delta[:, None, :].expand(n_members, steps, 1),
                       w[None, :, 1:].expand(n_members, steps,
                                             w.shape[-1] - 1)), dim=-1)
        op = chain.ChainExpmPropagate(ham.generator_basis(dt), dev,
                                      torch.float32, return_prefixes=True)
        _, (w_seg, prefpad, cums, prods, _) = op._forward(w)
        g_total = torch.randn((n_members, D, D), dtype=torch.complex64,
                              device=dev, generator=gen)
        g_pref = torch.randn((n_members, steps, D, D), dtype=torch.complex64,
                             device=dev, generator=gen)
        glue.append("{} members (S x L = {} x {}): merge {:.3f} ms, seeds "
                    "last-step {:.3f} ms, seeds per-step {:.3f} ms, compose "
                    "prefixes {:.3f} ms".format(
                        n_members, w_seg.shape[0], w_seg.shape[1],
                        cuda_ms(lambda: chain._merge(prefpad, D), 5),
                        cuda_ms(lambda: chain._segment_seeds(
                            prefpad, cums, prods, D, g_total), 5),
                        cuda_ms(lambda: chain._segment_seeds(
                            prefpad, cums, prods, D, g_total, g_pref), 5),
                        cuda_ms(lambda: chain._compose_prefixes(
                            prefpad, cums, steps), 5)))
    print("phase 30 member glue at phase 27's ensembles: " + "; ".join(glue),
          flush=True)
    return ms, bounds, err


def _plane_member_outputs(a, plain, g_total, g_pref):
    """(totals, prefixes, plane gradient in the last-step mode, in the
    per-step mode) of the plane op's trajectory form on planes ``a``."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate_prefixes
    x = a.clone().requires_grad_(True)
    total, prefixes = plane_chain_propagate_prefixes(x, plain)
    last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
    step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
    return total.detach(), prefixes.detach(), last, step


def _plane_member_padding(a, n1):
    """The forward kernel on the member rows of planes ``a`` (M, B, d, d):
    every chain's padded rows, columns and steps exactly the identity's."""
    from qoc_tpu_torch.ops import chain
    n_chains, n_steps, d = a.shape[0], a.shape[1], a.shape[-1]
    dp, plan, fwd, _ = chain._plane_route(d, a.device, False)
    s_count, length = plan(n_steps, n_chains)
    a_seg = torch.zeros((n_chains, s_count * length, dp, dp),
                        dtype=a.dtype, device=a.device)
    a_seg[:, :n_steps, :d, :d] = a
    pref = fwd(a_seg.reshape(n_chains * s_count, length, dp, dp), n1)
    for m, rows in enumerate(pref.reshape(n_chains, s_count, length + 1, dp,
                                          dp)):
        _check_padding(rows, d, n_steps)


def phase_plane_member_kernels(dev):
    """The plane op's member axis, K6 and K5, against the plain versions on
    every ladder level and in both seed modes (PLANE_MEMBER_CASES): totals,
    prefixes and the plane gradient, one forward and one adjoint launch a
    backward, each chain against itself run alone through the single-chain
    op, the padding exact; the totals against float64 matrix_exp
    products."""
    from qoc_tpu_torch.ops import chain
    gen = torch.Generator(device=dev).manual_seed(31)
    worst = {key: 0.0 for key in ("K6 member fwd", "K6 member bwd",
                                  "K6 member bwd step", "K5 member fwd",
                                  "K5 member bwd")}
    for d, n_chains, n_steps in PLANE_MEMBER_CASES:
        kernel = "K6" if chain.uses_stream(d) else "K5"
        plan = (chain.stream_segment_plan if kernel == "K6"
                else chain.segment_plan)
        s_count = plan(n_steps, n_chains)[0]
        rows = []
        for target in LEVEL_NORMS:
            a = _stream_planes(gen, n_chains * n_steps, d, target,
                               dev).reshape(n_chains, n_steps, d, d)
            g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                                  device=dev, generator=gen)
            g_pref = torch.randn((n_chains, n_steps, d, d),
                                 dtype=torch.complex64, device=dev,
                                 generator=gen)
            reset_launches()
            got = _plane_member_outputs(a, False, g_total, g_pref)
            launches = read_launches()
            want = _plane_member_outputs(a, True, g_total, g_pref)
            torch.cuda.synchronize()
            if (launches[kernel + " fwd"], launches[kernel + " bwd"],
                    launches[kernel + " bwd step"]) != (1, 2, 1):
                raise RuntimeError("the member-batched plane op did not "
                                   "launch {} once a pass: {}".format(
                                       kernel, launches))
            rels = [_rel(x, y) for x, y in zip(got, want)]
            for m in sorted({0, n_chains // 2, n_chains - 1}):
                alone = _plane_member_outputs(a[m], False, g_total[m],
                                              g_pref[m])
                rels += [_rel(x[m], y) for x, y in zip(got, alone)]
            if max(rels[0::4] + rels[1::4]) > FWD_RTOL or \
                    max(rels[2::4] + rels[3::4]) > GRAD_RTOL:
                raise RuntimeError("the member-batched plane op disagrees: "
                                   "{} at d = {}, {} chains x {} steps, "
                                   "level {}: {}".format(
                                       kernel, d, n_chains, n_steps,
                                       LEVEL_NORMS.index(target), rels))
            _plane_member_padding(a, chain._plane_norm_max(a)[0])
            errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
            keys = ((kernel + " member fwd", max(errs[:2])),
                    (kernel + " member bwd", errs[2]),
                    ("K6 member bwd step" if kernel == "K6"
                     else "K5 member bwd", errs[3]))
            for key, err in keys:
                worst[key] = max(worst[key], err)
            rows.append("{} {:.1e}/{:.1e}/{:.1e}/{:.1e}".format(
                LEVEL_NORMS.index(target), *rels[:4]))
        print("phase 31 member-batched {} (d={}, padded {}, {} chains x {} "
              "steps, S_m = {}): level total/prefixes/grad last-step/grad "
              "per-step rel vs plain: {}; each chain = itself alone, "
              "padding exact".format(
                  kernel, d, chain.kernel_dp(d), n_chains, n_steps, s_count,
                  "; ".join(rows)), flush=True)
    # An independent reference: float64 matrix_exp products at d = 260.
    a = _stream_planes(gen, 3 * 7, STREAM_DIMS[0], 1.0, dev).reshape(
        3, 7, STREAM_DIMS[0], STREAM_DIMS[0])
    total = chain.plane_chain_propagate(a).to(torch.complex128)
    want = torch.eye(a.shape[-1], dtype=torch.complex128,
                     device=dev).expand(3, -1, -1)
    for t in range(a.shape[1]):
        want = torch.linalg.matrix_exp(a[:, t].to(torch.complex128)) @ want
    rel = _rel(total, want)
    print("phase 31 member-batched K6: 3 members x 7 steps at d = 260 vs "
          "float64 matrix_exp products rel {:.2e}; worst max|err| {}".format(
              rel, {k: "{:.2e}".format(v) for k, v in worst.items()}),
          flush=True)
    if rel > FWD_RTOL:
        raise RuntimeError("the member-batched K6 op disagrees with "
                           "matrix_exp")
    return worst


def lindblad_pstate(kw):
    """A GrapeLindbladDiscreteState (MAGNUS_EXPM, Adam) of the keyword
    arguments ``kw`` of a Lindblad entry point, marked as the ensemble's
    where ``kw`` holds member rows."""
    from qoc_tpu_torch import Adam
    from qoc_tpu_torch.models import (GrapeLindbladDiscreteState,
                                      InterpolationPolicy)
    pstate = GrapeLindbladDiscreteState(
        True, kw["control_count"], kw["control_eval_count"], 1, kw["costs"],
        kw["evolution_time"], kw["hamiltonian"], None,
        kw["initial_controls"], kw["initial_densities"],
        InterpolationPolicy.LINEAR, 1, kw["lindblad_data"], 0,
        kw["max_control_norms"], 0, Adam(), None, False, 0,
        kw["system_eval_count"])
    pstate.method_ = kw["method"]
    if kw.get("hamiltonian_params") is not None:
        pstate.hamiltonian = None
        pstate.set_ensemble(kw["hamiltonian_params"])
    return pstate


def lindblad_ensemble_problem(n_members, step_costs=(), d=D20,
                              delta=ENSEMBLE_DELTA):
    """Phase 32's cell: the d = 20 cell (or ``lindblad_problem`` at Hilbert
    d) with the drift an EnsembleLinearHamiltonian(0.1 n̂, [a], [0.1 n̂]), so
    member m's drift is (1 + δ_m)·0.1 n̂, δ = linspace(-delta, delta, M): the
    keyword arguments of grape_lindblad_ensemble."""
    from qoc_tpu_torch import EnsembleLinearHamiltonian
    kw = (lindblad_d20_problem(step_costs) if d == D20
          else lindblad_problem(d, 21, 21, 2.0, step_costs))
    linear = kw["hamiltonian"]
    kw.update(hamiltonian=EnsembleLinearHamiltonian(
        linear.h0, linear.operators, linear.h0[None]),
        hamiltonian_params=np.linspace(-delta, delta, n_members)[:, None])
    return kw


def member_reference(pstate, hamiltonian, params, dev):
    """controls (N, E, C) -> (errors (N, M), final states or densities) of
    N candidates over M members (``params``, or one member when None) in
    float64 on the card, apart from the kernels and the member packing:
    each chain's generators from its weight rows [1, δ_m, Re c, Im c] times
    the generator basis (Schrödinger) or the superoperator basis (Lindblad),
    all chains in one time block through the plain plane op's member axis
    (K5's or K6's plain versions) or, at 64 < padded n <= 256,
    torch.linalg.matrix_exp and a prefix scan; step costs at their cost
    steps, final costs after the last step."""
    from qoc_tpu_torch.core.schroedinger import fused_weights
    from qoc_tpu_torch.models import GrapeLindbladDiscreteState
    from qoc_tpu_torch.ops import chain
    c128 = torch.complex128
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    times = torch.arange(n_steps, dtype=torch.float64, device=dev) * dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float64,
                          device=dev)
    if isinstance(pstate, GrapeLindbladDiscreteState):
        initial = np.asarray(pstate.initial_densities)
        rates, ops = pstate.lindblad_data(0.0)
        basis = hamiltonian.superoperator_basis(dt, rates, ops)
    else:
        initial = np.asarray(pstate.initial_states)
        basis = hamiltonian.generator_basis(dt)
    basis = torch.as_tensor(basis, dtype=c128, device=dev)
    initial = torch.as_tensor(initial, dtype=c128, device=dev)
    shape, n = tuple(initial.shape), basis.shape[-1]
    x0 = initial.reshape(shape[0], n)
    deltas = (None if params is None
              else torch.as_tensor(params, dtype=torch.float64, device=dev))
    n_members = 1 if params is None else len(params)
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]

    def loss(controls):
        w = fused_weights(controls, times, cet, dt)
        if deltas is not None:
            w = torch.stack([torch.cat((
                w[..., :1], delta.expand(w.shape[:-1] + delta.shape),
                w[..., 1:]), dim=-1) for delta in deltas], dim=1).flatten(
                    0, 1)
        a = torch.einsum("rjk,kab->rjab", w.to(c128), basis)
        if n <= chain.KERNEL_DP or chain.uses_stream(n):
            total, prefixes = chain.plane_chain_propagate_prefixes(a, True)
        else:
            prefixes = chain._prefix_products(torch.linalg.matrix_exp(a))
            total = prefixes[:, -1]
        errors = []
        for r in range(a.shape[0]):
            c = controls[r // n_members]
            error = 0.0
            for k in range(pstate.cost_eval_step, n_steps + 1,
                           pstate.cost_eval_step):
                y = (x0 @ prefixes[r, k - 1].mT).reshape(shape)
                for cost in step_costs:
                    error = error + cost.cost(c, y, k)
            y = (x0 @ total[r].mT).reshape(shape)
            for cost in final_costs:
                error = error + cost.cost(c, y, n_steps)
            errors.append(error)
        final = (x0 @ total.mT).reshape((-1, n_members) + shape)
        return torch.stack(errors).reshape(-1, n_members), final

    return loss


def _ensemble_mean(member_loss):
    """The ensemble loss controls (E, C) -> (mean error, final states) of a
    candidates x members loss."""
    def loss(controls):
        errors, final = member_loss(controls[None])
        return errors[0].mean(), final[0]
    return loss


def _lindblad_ensemble_run(label, kw, dev, iterations, chunk):
    """grape_lindblad_ensemble on ``kw`` with counters, peak memory and the
    checks of a run: (result, launches, blocks, peak GB)."""
    from qoc_tpu_torch import grape_lindblad_ensemble
    from qoc_tpu_torch.parallel import build_lindblad_ensemble_loss
    pstate = lindblad_pstate(kw)
    loss = build_lindblad_ensemble_loss(pstate, kw["hamiltonian"],
                                        kw["hamiltonian_params"], device=dev)
    blocks = -(-(kw["system_eval_count"] - 1) // loss.block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    result = grape_lindblad_ensemble(iteration_count=iterations,
                                     log_iteration_step=0, fused_chunk=chunk,
                                     device=dev, **kw)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    errors = np.asarray(result.errors)
    d = np.asarray(kw["initial_densities"]).shape[-1]
    n_members = len(kw["hamiltonian_params"])
    if not (result.iteration_count_ran == iterations
            and np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_densities))
            and result.best_final_densities.shape == (n_members, 1, d, d)
            and errors[-1] < errors[0]):
        raise RuntimeError(label + " failed its checks")
    return result, launches, blocks, peak, pstate, loss


def phase_lindblad_ensemble(dev):
    """The slice at full width: grape_lindblad_ensemble on the d = 20 cell
    (superoperator 400, padded 448, 100 steps, MAGNUS_EXPM) with 4 and 16
    members (stream_segment_plan's rows a launch), 2 warm-up + 5 timed
    iterations, counters read around each run (K6 forward and adjoint once
    a time block, K1-K5 never), peak memory; the 4-member loss and gradient
    against float64 over the plain versions; then the 4 members with phase
    24's density step costs (K6's adjoint in its per-step mode), against
    float64 too."""
    from qoc_tpu_torch.ops.chain import stream_segment_plan
    iterations = WARMUP_ITERATIONS + LINDBLAD_TIMED
    rates, run_launches = {}, {}
    few, many = LINDBLAD_MEMBERS
    for n_members, step in ((few, False), (many, False), (few, True)):
        kw = lindblad_ensemble_problem(
            n_members, d20_step_costs() if step else ())
        label = "the {}-member d = 20 Lindblad ensemble{}".format(
            n_members, " with step costs" if step else "")
        result, launches, blocks, peak, pstate, loss = \
            _lindblad_ensemble_run(label, kw, dev, iterations,
                                   WARMUP_ITERATIONS)
        n = blocks * iterations
        _member_launches(label, launches,
                         ("K6 fwd", "K6 bwd", "K6 bwd step") if step
                         else ("K6 fwd", "K6 bwd"),
                         {"K6 fwd": n, "K6 bwd": n, "K6 bwd step": n})
        check = "not checked ({} members)".format(n_members)
        if n_members == few:
            check = _against_float64(
                "loss", loss, _ensemble_mean(member_reference(
                    pstate, kw["hamiltonian"], kw["hamiltonian_params"],
                    dev)), pstate, dev)
        s_count, length = stream_segment_plan(loss.block, n_members)
        errors = np.asarray(result.errors)
        print("phase 32 Lindblad ensemble d=20 ({} members x {} steps{}, "
              "{} block(s) of {}, S x L = {} x {} rows a launch): {} "
              "iterations, {:.2f} it/s steady ({:.1f} member-it/s), error "
              "{:.6f} -> {:.6f}, launches {}, peak {:.2f} GB; vs float64 "
              "plain route: {}".format(
                  n_members, D20_POINTS - 1,
                  ", density step costs" if step else "", blocks,
                  loss.block, n_members * s_count, length, iterations,
                  result.iterations_per_s,
                  n_members * result.iterations_per_s, errors[0], errors[-1],
                  {k: v for k, v in launches.items() if v}, peak, check),
              flush=True)
        rates[(n_members, step)] = result.iterations_per_s
        run_launches[(n_members, step)] = launches
    return rates, run_launches


def _lindblad_multistart_run(phase, label, kw, n_starts, iterations, chunk,
                             dev):
    """grape_lindblad_multistart on ``kw`` (member rows where it holds
    them) with counters and peak memory: (result, launches, blocks, peak
    GB)."""
    from qoc_tpu_torch import Adam, grape_lindblad_multistart
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    kw = dict(kw)
    params = kw.pop("hamiltonian_params", None)
    pstate = lindblad_pstate(dict(kw, hamiltonian_params=params))
    loss = build_chain_loss(pstate, kw["hamiltonian"], params, dev,
                            torch.float32, n_candidates=n_starts)
    blocks = -(-(kw["system_eval_count"] - 1) // loss.block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    result = grape_lindblad_multistart(
        n_starts=n_starts, hamiltonian_params=params,
        iteration_count=iterations, log_iteration_step=0, optimizer=Adam(),
        fused_chunk=chunk, device=dev, **kw)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    kernels = (("K1", "K2") if loss.route == "fused"
               else ("K6 fwd", "K6 bwd"))
    # The adjoint once a block an iteration; the forward also once a block
    # for the winner's final densities.
    _member_launches(label, launches, kernels,
                     {kernels[0]: blocks * (iterations + 1),
                      kernels[1]: blocks * iterations})
    errors = np.asarray(result.errors)
    if not (result.iteration_count_ran == iterations
            and np.all(np.isfinite(errors))
            and np.isfinite(result.best_error)
            and result.best_error <= errors[0]
            and np.all(np.isfinite(result.best_final_densities))):
        raise RuntimeError(label + " failed its checks")
    print("phase {} {}: {} iterations (chunks of {}), {:.1f} "
          "candidate-it/s steady ({:.1f} mean), {} block(s) of {} and {} "
          "launches, peak {:.2f} GB, best error {:.6f} (candidate 0 {:.6f}, "
          "median {:.6f})".format(
              phase, label, iterations, chunk,
              result.iterations_per_s, result.iterations_per_s_mean, blocks,
              loss.block, {k: v for k, v in launches.items() if v}, peak,
              result.best_error, errors[0], float(np.median(errors))),
          flush=True)
    return result, launches, pstate, loss


def _candidates_against_float64(label, pstate, hamiltonian, params,
                                n_starts, dev):
    """The candidates' errors and gradients at their seeds (candidate_seeds)
    through the float32 kernel route against the float64 member
    reference."""
    from qoc_tpu_torch.core.common import slap_controls_torch
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    seeds = candidate_seeds(pstate, n_starts, 0)
    shape = pstate.controls_shape
    outs = []
    for dtype, loss in (
            (torch.float32, build_chain_loss(pstate, hamiltonian, params,
                                             dev, torch.float32,
                                             n_candidates=n_starts)),
            (torch.float64, member_reference(pstate, hamiltonian, params,
                                             dev))):
        flat = torch.as_tensor(seeds, dtype=dtype, device=dev)
        flat.requires_grad_(True)
        errors = loss(torch.func.vmap(
            lambda p: slap_controls_torch(True, p, shape))(flat))[0].mean(
                dim=1)
        grad, = torch.autograd.grad(errors.sum(), flat)
        outs.append((errors.detach().double(), grad.double()))
    torch.cuda.synchronize()
    rel_err, rel_grad = _rel(outs[0][0], outs[1][0]), _rel(outs[0][1],
                                                           outs[1][1])
    if rel_err > FWD_RTOL or rel_grad > GRAD_RTOL:
        raise RuntimeError("{}: the kernel route disagrees with float64 "
                           "(errors rel {:.2e}, gradients rel {:.2e})".format(
                               label, rel_err, rel_grad))
    return "{} candidates at their seeds vs float64: errors rel {:.2e}, " \
        "gradients rel {:.2e}".format(n_starts, rel_err, rel_grad)


def phase_lindblad_multistart(dev):
    """grape_lindblad_multistart on the d = 20 cell: 16 candidates, 2
    warm-up + 5 timed iterations,
    candidate-iterations/s, time blocks, launches, peak memory and the best
    error; the 4 first candidates' losses and gradients at their seeds
    against float64; then a robust multistart of 4 candidates x phase 32's
    4 members."""
    iterations = WARMUP_ITERATIONS + LINDBLAD_TIMED
    kw = lindblad_d20_problem()
    result, launches, pstate, _ = _lindblad_multistart_run(
        33, "Lindblad multistart d=20, {} candidates".format(
            LINDBLAD_CANDIDATES), kw, LINDBLAD_CANDIDATES, iterations,
        WARMUP_ITERATIONS, dev)
    rates = {LINDBLAD_CANDIDATES: result.iterations_per_s}
    print("phase 33 Lindblad multistart d=20: " + _candidates_against_float64(
        "the d = 20 multistart", pstate, kw["hamiltonian"], None,
        LINDBLAD_ROBUST_CANDIDATES, dev), flush=True)
    kw = lindblad_ensemble_problem(LINDBLAD_MEMBERS[0])
    robust, _, _, _ = _lindblad_multistart_run(
        33, "robust Lindblad multistart d=20, {} candidates x {} members"
        "".format(LINDBLAD_ROBUST_CANDIDATES, LINDBLAD_MEMBERS[0]), kw,
        LINDBLAD_ROBUST_CANDIDATES, iterations, WARMUP_ITERATIONS, dev)
    rates["robust"] = robust.iterations_per_s
    return rates, launches


def example6_problem():
    """examples/6_lindblad_ensemble_robust.py at its own widths, written
    against the port: H(δ, c) = (1 + δ)·σz/2 + c a + conj(c) a^H (d = 2),
    8 detuning members, T1 = 1000, |0><0| to |1><1|, 11 control points, 21
    points, T = 10: the keyword arguments of grape_lindblad_ensemble."""
    from qoc_tpu_torch import ConstantLindblad, EnsembleLinearHamiltonian
    kw = lindblad_problem(2, 11, 21, 10.0)
    h0 = np.diag([0.5, -0.5]).astype(complex)
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    kw.update(hamiltonian=EnsembleLinearHamiltonian(h0, a[None], h0[None]),
              hamiltonian_params=np.linspace(
                  -EXAMPLE6_DELTA, EXAMPLE6_DELTA,
                  EXAMPLE6_MEMBERS).reshape(-1, 1),
              lindblad_data=ConstantLindblad(np.array([1e-3]), a[None]))
    return kw


def phase_member_routes(dev):
    """The other member routes, each with counters and against float64:
    example 6 (d = 2, 8 members) through K1/K2's member axis, its GRAPE and
    its 8 x 8 robust multistart; a d = 12 Lindblad ensemble of 4 members
    through the blocked route (K3/K4); a Schrödinger ensemble of 4 members
    at d = 300 (phase 17's problem, 21 steps) through K6's member axis."""
    from qoc_tpu_torch import (Adam, EnsembleLinearHamiltonian,
                               grape_schroedinger_ensemble)
    from qoc_tpu_torch.parallel import build_ensemble_loss
    iterations = EXAMPLE6_ITERATIONS
    for label, kw, kernels in (
            ("example 6 (d=2, 8 members)", example6_problem(), ("K1", "K2")),
            ("d=12, 4 members", lindblad_ensemble_problem(
                4, d=D12), ("K3", "K4"))):
        result, launches, blocks, _, pstate, loss = _lindblad_ensemble_run(
            "the " + label + " Lindblad ensemble", kw, dev, iterations,
            iterations)
        _member_launches(label, launches, kernels,
                         {k: blocks * iterations for k in kernels})
        check = _against_float64(
            "loss", loss, _ensemble_mean(member_reference(
                pstate, kw["hamiltonian"], kw["hamiltonian_params"], dev)),
            pstate, dev)
        errors = np.asarray(result.errors)
        print("phase 34 Lindblad ensemble {} ({} route): {} iterations, "
              "error {:.6f} -> {:.6f}, launches {}; vs float64: {}".format(
                  label, loss.route, iterations, errors[0], errors[-1],
                  {k: v for k, v in launches.items() if v}, check),
              flush=True)
    kw = example6_problem()
    result, _, pstate, _ = _lindblad_multistart_run(
        34, "example 6 robust multistart, {} candidates x {} members".format(
            EXAMPLE6_MEMBERS, EXAMPLE6_MEMBERS), kw, EXAMPLE6_MEMBERS,
        iterations, iterations, dev)
    print("phase 34 example 6 multistart: " + _candidates_against_float64(
        "example 6's multistart", pstate, kw["hamiltonian"],
        kw["hamiltonian_params"], EXAMPLE6_MEMBERS, dev), flush=True)
    # Schrödinger at d = 300: the streamed route's member axis.
    pstate, linear, costs = bench_problem(D300, 2, D300_STEPS + 1,
                                          D300_STEPS + 1, 1.0)
    ham = EnsembleLinearHamiltonian(linear.h0, linear.operators,
                                    linear.h0[None])
    params = np.linspace(-ENSEMBLE_DELTA, ENSEMBLE_DELTA, 4)[:, None]
    pstate.hamiltonian = None
    pstate.set_ensemble(params)
    loss = build_ensemble_loss(pstate, ham, params, device=dev)
    blocks = -(-D300_STEPS // loss.block)
    iterations = 5
    reset_launches()
    result = grape_schroedinger_ensemble(
        2, D300_STEPS + 1, costs, 1.0, ham, params, pstate.initial_states,
        D300_STEPS + 1, complex_controls=True,
        initial_controls=pstate.initial_controls,
        max_control_norms=pstate.max_control_norms,
        iteration_count=iterations, log_iteration_step=0, optimizer=Adam(),
        device=dev)
    launches = read_launches()
    _member_launches("the d = 300 Schroedinger ensemble", launches,
                     ("K6 fwd", "K6 bwd"),
                     {"K6 fwd": blocks * iterations,
                      "K6 bwd": blocks * iterations})
    errors = np.asarray(result.errors)
    if loss.route != "stream" or not (np.all(np.isfinite(errors))
                                      and errors[-1] < errors[0]):
        raise RuntimeError("the d = 300 Schroedinger ensemble failed its "
                           "checks")
    check = _against_float64("loss", loss, _ensemble_mean(member_reference(
        pstate, ham, params, dev)), pstate, dev)
    print("phase 34 Schroedinger ensemble d=300 (4 members x {} steps, "
          "streamed route): {} iterations, error {:.6f} -> {:.6f}, launches "
          "{}; vs float64: {}".format(
              D300_STEPS, iterations, errors[0], errors[-1],
              {k: v for k, v in launches.items() if v}, check), flush=True)


def _member_stream_inputs(a):
    """The plane op's kernel inputs for member planes ``a`` (M, B, d, d):
    a_seg (M S, L, dp, dp) on the member plan of the kernel that serves d,
    and the batch-max 1- and inf-norms."""
    from qoc_tpu_torch.ops import chain
    n_chains, n_steps, d = a.shape[0], a.shape[1], a.shape[-1]
    dp, plan, _, _ = chain._plane_route(d, a.device, False)
    s_count, length = plan(n_steps, n_chains)
    a_seg = torch.zeros((n_chains, s_count * length, dp, dp),
                        dtype=torch.complex64, device=a.device)
    a_seg[:, :n_steps, :d, :d] = a
    n1, ninf = chain._plane_norm_max(a)
    return a_seg.reshape(n_chains * s_count, length, dp, dp), n1, ninf


def _time_member_kernels(prefix, a, fwd, bwd, fwd_plain, bwd_plain, gen):
    """The forward and the adjoint (last-step and per-step seeds) of a
    member-batched launch on planes ``a``: ms, plain ms, bounds and max
    |err| against the plain versions, keyed "<prefix> fwd", "<prefix> bwd"
    and "<prefix> bwd step"."""
    from qoc_tpu_torch.ops import chain
    a_seg, n1, ninf = _member_stream_inputs(a)
    rows, length, dp = a_seg.shape[:3]
    pref = fwd(a_seg, n1)
    pref_plain = fwd_plain(a_seg, n1)
    seeds = torch.randn((rows, dp, dp), dtype=torch.complex64,
                        device=a.device, generator=gen)
    step_seeds = torch.randn((rows, length, dp, dp), dtype=torch.complex64,
                             device=a.device, generator=gen)
    err = {prefix + " fwd": float((pref - pref_plain).abs().max())}
    del pref_plain
    for key, s in ((prefix + " bwd", seeds), (prefix + " bwd step",
                                              step_seeds)):
        got = bwd(a_seg, ninf, pref, s)
        err[key] = float((got - bwd_plain(a_seg, ninf, pref, s)).abs().max())
        if not bool(torch.isfinite(torch.view_as_real(got)).all()):
            raise RuntimeError(key + " produced non-finite values")
    ms = {prefix + " fwd": cuda_ms(lambda: fwd(a_seg, n1), 5),
          prefix + " fwd plain": cuda_ms(lambda: fwd_plain(a_seg, n1), 2),
          prefix + " bwd": cuda_ms(lambda: bwd(a_seg, ninf, pref, seeds), 5),
          prefix + " bwd plain": cuda_ms(
              lambda: bwd_plain(a_seg, ninf, pref, seeds), 2),
          prefix + " bwd step": cuda_ms(
              lambda: bwd(a_seg, ninf, pref, step_seeds), 5),
          prefix + " bwd step plain": cuda_ms(
              lambda: bwd_plain(a_seg, ninf, pref, step_seeds), 2)}
    absa = a.reshape(-1, *a.shape[-2:]).abs()
    levels = chain.ladder_level(n1), chain.ladder_level(ninf)
    bounds = {
        prefix + " fwd": kernel_bound(absa.sum(-2).amax(-1), levels[0],
                                      False, [a_seg, n1, pref], dp),
        prefix + " bwd": kernel_bound(absa.sum(-1).amax(-1), levels[1], True,
                                      [a_seg, ninf, pref, seeds,
                                       pref[:, 1:]], dp),
        prefix + " bwd step": kernel_bound(
            absa.sum(-1).amax(-1), levels[1], True,
            [a_seg, ninf, pref, step_seeds, pref[:, 1:]], dp)}
    return ms, bounds, err, (rows, length, dp, levels)


def lindblad_member_planes(kw, pstate, dev):
    """(params, steps) -> the planes (M, steps, d^2, d^2) of the members
    ``params`` of the Lindblad ensemble ``kw`` over its first ``steps``
    steps, at the initial controls, as the streamed route builds them."""
    from qoc_tpu_torch.core.schroedinger import fused_weights
    dt = float(pstate.dt)
    rates, ops = kw["lindblad_data"](0.0)
    basis = torch.as_tensor(kw["hamiltonian"].superoperator_basis(
        dt, rates, ops), dtype=torch.complex64, device=dev)
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    controls = torch.as_tensor(pstate.initial_controls,
                               dtype=torch.complex64, device=dev)

    def member_planes(params, steps):
        delta = torch.as_tensor(params, dtype=torch.float32, device=dev)
        n_chains = len(params)
        w = fused_weights(controls, torch.arange(
            steps, dtype=torch.float32, device=dev) * dt, cet, dt)
        w = torch.cat((w[None, :, :1].expand(n_chains, steps, 1),
                       delta[:, None, :].expand(n_chains, steps, 1),
                       w[None, :, 1:].expand(n_chains, steps,
                                             w.shape[-1] - 1)), dim=-1)
        return torch.einsum("mjk,kab->mjab", w.to(torch.complex64), basis)
    return member_planes


def phase_plane_member_timing(dev):
    """K6's member-batched forward and adjoint (both seed modes) at phase
    32's 16-member shapes (one time block's launch: 16 chains x 20 steps,
    5 segments a chain) and K5's at the M4 ensemble's planes (4 members x
    2000 steps of d = 64, S_m = 32), beside their plain versions, bounds
    (kernel_bound), grid and design line; the launches of one pass of the
    member-batched plane op (K5's member axis is run by no entry point, as
    in qoc_tpu); and the member merge and seed glue's device time at phase
    32's 4 members."""
    from qoc_tpu_torch.ops import chain
    from qoc_tpu_torch.parallel import build_lindblad_ensemble_loss
    gen = torch.Generator(device=dev).manual_seed(35)
    n_members = LINDBLAD_MEMBERS[1]
    kw = lindblad_ensemble_problem(n_members)
    pstate = lindblad_pstate(kw)
    block = build_lindblad_ensemble_loss(pstate, kw["hamiltonian"],
                                         kw["hamiltonian_params"],
                                         device=dev).block
    member_planes = lindblad_member_planes(kw, pstate, dev)
    with torch.no_grad():
        a = member_planes(kw["hamiltonian_params"], block)
    ms, bounds, err, (rows, length, dp, levels) = _time_member_kernels(
        "K6 member", a, chain.stream_fwd, chain.stream_bwd,
        chain.stream_fwd_plain, chain.stream_bwd_plain, gen)
    resident = chain._stream_plan(False, dp, dev.index)[:2]
    for key, dual in (("K6 member fwd", False), ("K6 member bwd", True),
                      ("K6 member bwd step", True)):
        clusters = chain.stream_grid(dual, dp, rows, dev)[0]
        _, blocks_a_cluster, _, smem = chain._stream_plan(dual, dp,
                                                          dev.index)
        entry = tiled_entry(key, dp, False)
        print("phase 35 design: " + design_line(
            key, entry, clusters, blocks_a_cluster, smem, bounds[key][0],
            ms[key]), flush=True)
    print("phase 35 K6 member-batched timing ({} members x {} steps, a time "
          "block of the {}-member d = 20 ensemble, S x L = {} x {}, padded "
          "{}, levels {}/{}; {} resident clusters of {} blocks): ".format(
              n_members, block, n_members, rows, length, dp, *levels,
              *resident)
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time, "
              "max|err| {:.2e}".format(k, b[0], b[1], b[2], b[0] / ms[k],
                                       err[k])
              for k, b in bounds.items()), flush=True)
    del a
    # K5's member axis at the M4 ensemble's planes (phase 28's problem).
    m4_pstate, m4_ham, m4_params, _ = ensemble_problem(ENSEMBLE_MEMBERS[0],
                                                       "M4")
    a5 = torch.stack([initial_planes(m4_pstate, m4_ham.member(
        torch.as_tensor(row, device=dev)), dev) for row in m4_params])
    ms5, bounds5, err5, (rows5, length5, _, levels5) = _time_member_kernels(
        "K5 member", a5, chain.plane_fwd, chain.plane_bwd,
        chain.plane_fwd_plain, chain.plane_bwd_plain, gen)
    for key in ("K5 member fwd", "K5 member bwd", "K5 member bwd step"):
        print("phase 35 design: " + resident_design_line(
            "K5 bwd" if "bwd" in key else "K5 fwd", rows5, bounds5[key][0],
            ms5[key]).replace("K5 bwd:" if "bwd" in key else "K5 fwd:",
                              key + ":", 1), flush=True)
    x = a5.clone().requires_grad_(True)
    reset_launches()
    total = chain.plane_chain_propagate(x)
    torch.autograd.grad(total, x, torch.ones_like(total))
    k5_launches = read_launches()
    print("phase 35 K5 member-batched timing ({} members x {} steps of the "
          "M4 ensemble, S x L = {} x {}, levels {}/{}): ".format(
              len(m4_params), a5.shape[1], rows5, length5, *levels5)
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms5.items())
          + "; " + ", ".join(
              "{} bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time, "
              "max|err| {:.2e}".format(k, b[0], b[1], b[2], b[0] / ms5[k],
                                       err5[k])
              for k, b in bounds5.items())
          + "; one pass of the member-batched plane op launched {}".format(
              {k: v for k, v in k5_launches.items() if v}), flush=True)
    ms.update(ms5)
    bounds.update(bounds5)
    err.update(err5)
    del a5, x
    # The member glue at 4 members: one time block of phase 32's loss.
    n_glue = LINDBLAD_MEMBERS[0]
    kw = lindblad_ensemble_problem(n_glue)
    glue_block = build_lindblad_ensemble_loss(
        lindblad_pstate(kw), kw["hamiltonian"], kw["hamiltonian_params"],
        device=dev).block
    with torch.no_grad():
        a = member_planes(kw["hamiltonian_params"], glue_block)
    a_seg, n1, _ = _member_stream_inputs(a)
    s_count, length = chain.stream_segment_plan(glue_block, n_glue)
    prefpad = chain.stream_fwd(a_seg, n1).reshape(n_glue, s_count,
                                                  length + 1, dp, dp)
    d = a.shape[-1]
    cums, prods = chain._merge(prefpad, d)
    g_total = torch.randn((n_glue, d, d), dtype=torch.complex64, device=dev,
                          generator=gen)
    g_pref = torch.randn((n_glue, glue_block, d, d), dtype=torch.complex64,
                         device=dev, generator=gen)
    print("phase 35 member glue at {} members (S x L = {} x {}, padded {}): "
          "merge {:.3f} ms, seeds last-step {:.3f} ms, seeds per-step {:.3f} "
          "ms, compose prefixes {:.3f} ms".format(
              n_glue, n_glue * s_count, length, dp,
              cuda_ms(lambda: chain._merge(prefpad, d), 5),
              cuda_ms(lambda: chain._segment_seeds(
                  prefpad, cums, prods, dp, g_total), 5),
              cuda_ms(lambda: chain._segment_seeds(
                  prefpad, cums, prods, dp, g_total, g_pref), 5),
              cuda_ms(lambda: chain._compose_prefixes(
                  prefpad, cums, glue_block), 5)), flush=True)
    return ms, bounds, err, {"K5 member fwd": k5_launches["K5 fwd"],
                             "K5 member bwd": k5_launches["K5 bwd"]}


# ---------------------------------------------------------------------------
# The bf16_3x precision mode (phases 36-41)
# ---------------------------------------------------------------------------


def _mode_check(label, rels, env):
    """Raise where the mode's kernel route is further from its plain
    version in the mode (``rels``) or from the exact kernels or float64
    (``env``, the mode's envelope) than FWD_RTOL / GRAD_RTOL: rels and env
    are (totals and prefixes, gradients) pairs of lists."""
    for name, (fwd, grad) in (("its plain version in the mode", rels),
                              ("the exact kernels or float64", env)):
        if max(fwd, default=0.0) > FWD_RTOL or \
                max(grad, default=0.0) > GRAD_RTOL:
            raise RuntimeError("{}: the bf16_3x kernels disagree with {}: "
                               "{} / {}".format(label, name, fwd, grad))


def _resident_check(worst, kernel, label, rels):
    """Raise where a resident kernel's bf16_3x form (``kernel``: K1, K5's
    forward, K3 at padded 64 (FwdTC); K2, K5's adjoint, K4 at padded 64
    (AdjointTC)) is further than MODE_RTOL (relative) from its plain version
    in the mode on the case ``label``; worst[kernel] keeps the worst (rel,
    label)."""
    worst[kernel] = max(worst.get(kernel, (0.0, "")), (max(rels), label))
    if max(rels) > MODE_RTOL:
        raise RuntimeError("{}: the bf16_3x {} is {} from its plain version "
                           "in the mode, above {}".format(
                               label, kernel, max(rels), MODE_RTOL))


def _mode_member_kernels(dev, rng, gen, worst, adjoint, forward):
    """Phase 36's K1/K2: the trajectory op on MODE_MEMBER_CASES and at
    d = 16 against float64 matrix_exp products."""
    from qoc_tpu_torch.ops import chain
    for n_members, n_steps in MODE_MEMBER_CASES:
        tag = "" if n_members == 1 else " member"
        rows = []
        for target in LEVEL_NORMS:
            op_k, op_p, w = _member_case(rng, n_members, n_steps, target,
                                         dev)
            g_total = torch.randn((n_members, D, D), dtype=torch.complex64,
                                  device=dev, generator=gen)
            g_pref = torch.randn((n_members, n_steps, D, D),
                                 dtype=torch.complex64, device=dev,
                                 generator=gen)
            with precision(MODE):
                reset_launches()
                got = _member_outputs(op_k, w, g_total, g_pref)
                launches = read_launches()
                want = _member_outputs(op_p, w, g_total, g_pref)
                if not _member_padding(op_k, w):
                    raise RuntimeError("padded steps or rows of a bf16_3x "
                                       "chain are not exact")
            exact = _member_outputs(op_k, w, g_total, g_pref)
            torch.cuda.synchronize()
            if (launches["K1"], launches["K1 mode"], launches["K2"],
                    launches["K2 mode"], launches["K2 step"]) != \
                    (1, 1, 2, 2, 1):
                raise RuntimeError("the op in the mode did not launch the "
                                   "mode's K1 once and K2 once a backward: "
                                   "{}".format(launches))
            rels = [_rel(x, y) for x, y in zip(got, want)]
            env = [_rel(x, y) for x, y in zip(got, exact)]
            label = "{} members x {} steps, level {}".format(
                n_members, n_steps, LEVEL_NORMS.index(target))
            _mode_check(label, (rels[:2], rels[2:]), (env[:2], env[2:]))
            _resident_check(forward, "K1" + tag, label, rels[:2])
            _resident_check(adjoint, "K2" + tag, label, rels[2:])
            for key, x, y in (("K1" + tag + " mode", got[1], want[1]),
                              ("K2" + tag + " mode", got[2], want[2]),
                              ("K2" + tag + " mode step", got[3], want[3])):
                worst[key] = max(worst.get(key, 0.0),
                                 float((x - y).abs().max()))
            rows.append("{} {:.1e}/{:.1e}/{:.1e}/{:.1e} exact {:.1e}/{:.1e}"
                        "".format(LEVEL_NORMS.index(target), *rels,
                                  env[0], env[2]))
        print("phase 36 bf16_3x K1/K2 ({} chains x {} steps, S_m = {}): "
              "level total/prefixes/grad last-step/grad per-step rel vs plain "
              "in the mode, total/grad rel vs the exact kernels: {}".format(
                  n_members, n_steps,
                  chain.segment_plan(n_steps, n_members)[0],
                  "; ".join(rows)),
              flush=True)
    # Float64 matrix_exp products at d = 16 (zero-padded to 64).
    d = 16
    op_k, _, w = _member_case(rng, 3, 37, 1.0, dev, d)
    with precision(MODE):
        total = op_k(w)[0].to(torch.complex128)
    a = torch.einsum("mjk,kab->mjab", w.double().to(torch.complex128),
                     op_k.basis[:, :d, :d].to(torch.complex128))
    want = torch.eye(d, dtype=torch.complex128, device=dev).expand(3, d, d)
    for t in range(a.shape[1]):
        want = torch.linalg.matrix_exp(a[:, t]) @ want
    rel = _rel(total, want)
    _mode_check("d = 16 vs float64", ([], []), ([rel], []))
    return rel


def _mode_headline(dev, headline_w, worst, adjoint, forward):
    """Phase 36 at the headline's own shapes: K1 and K2 (both seed modes)
    against their plain versions in the mode and the exact kernels."""
    from qoc_tpu_torch.ops import chain
    op = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32)
    n_steps = headline_w.shape[0]
    s_count, length = chain.segment_plan(n_steps)
    w_seg = torch.zeros((s_count * length, op.n_b), device=dev)
    w_seg[:n_steps] = headline_w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(headline_w, op.basis_ri, op.d)
    gen = torch.Generator(device=dev).manual_seed(36)
    seeds = torch.randn((s_count, D, D), dtype=torch.complex64, device=dev,
                        generator=gen)
    step_seeds = torch.randn((s_count, length, D, D), dtype=torch.complex64,
                             device=dev, generator=gen)
    pref = chain.chain_fwd(w_seg, op.basis, n1, MODE)
    pref_p = chain.chain_fwd_plain(w_seg, op.basis, n1, MODE)
    pref_x = chain.chain_fwd(w_seg, op.basis, n1, "highest")
    out = {"K1 mode": (pref, pref_p, pref_x)}
    for key, s in (("K2 mode", seeds), ("K2 mode step", step_seeds)):
        args = (w_seg, op.basis_h, ninf, pref_p, s)
        out[key] = (chain.chain_bwd(*args, MODE),
                    chain.chain_bwd_plain(*args, MODE),
                    chain.chain_bwd(*args, "highest"))
    torch.cuda.synchronize()
    rows = []
    for key, (k, p, x) in out.items():
        if not bool(torch.isfinite(torch.view_as_real(k)).all()):
            raise RuntimeError(key + " produced non-finite values")
        rel, env = _rel(k, p), _rel(k, x)
        grad = key != "K1 mode"
        _mode_check("headline shapes, " + key,
                    ([], [rel]) if grad else ([rel], []),
                    ([], [env]) if grad else ([env], []))
        _resident_check(adjoint if grad else forward, key[:2],
                        "headline shapes, " + key, [rel])
        worst[key] = max(worst.get(key, 0.0), float((k - p).abs().max()))
        rows.append("{} max|err| {:.3e} (rel {:.2e}), rel vs exact {:.2e}"
                    "".format(key, float((k - p).abs().max()), rel, env))
    print("phase 36 bf16_3x headline shapes (S x L = {} x {}, levels {}/{}): "
          "{}".format(s_count, length, chain.ladder_level(n1),
                      chain.ladder_level(ninf), "; ".join(rows)), flush=True)


def _f64_plane_outputs(a, g_total, g_pref):
    """The outputs of :func:`_plane_member_outputs` for planes ``a`` from a
    float64 chain: torch.linalg.matrix_exp of each plane in complex128,
    the prefixes P_t = U_t ... U_0 by products in order, and both
    gradients by autograd through them."""
    c128 = torch.complex128
    x = a.to(c128).requires_grad_(True)
    u = torch.linalg.matrix_exp(x)
    prefix = u[:, 0]
    prefixes = [prefix]
    for t in range(1, u.shape[1]):
        prefix = u[:, t] @ prefix
        prefixes.append(prefix)
    prefixes = torch.stack(prefixes, dim=1)
    total = prefixes[:, -1]
    last, = torch.autograd.grad(total, x, g_total.to(c128),
                                retain_graph=True)
    step, = torch.autograd.grad((total, prefixes), x,
                                (g_total.to(c128), g_pref.to(c128)))
    return total.detach(), prefixes.detach(), last, step


def _f64_distances(sides, f64):
    """{side: (forward, adjoint)}: each side's largest relative distance
    from the float64 outputs ``f64``, over the total and the prefixes
    (forward) and both seed modes' gradients (adjoint)."""
    out = {}
    for side, outputs in sides.items():
        rels = [_rel(x.to(torch.complex128), y)
                for x, y in zip(outputs, f64)]
        out[side] = (max(rels[:2]), max(rels[2:]))
    return out


def _mode_plane_kernels(dev, rng, gen, worst, adjoint, forward):
    """Phase 36's K5: the plane op's trajectory form on MODE_PLANE_CASES
    and against float64 matrix_exp products; on MODE_F64_CASE's last
    level, the mode kernel, its plain version in the mode and the exact
    kernel each against a float64 chain of the same planes."""
    from qoc_tpu_torch.ops import chain
    f64_line = None
    for d, n_chains, n_steps in MODE_PLANE_CASES:
        rows = []
        for target in LEVEL_NORMS:
            a = torch.stack([torch.as_tensor(
                _unit_planes(rng, n_steps, d) * target,
                dtype=torch.complex64, device=dev) for _ in range(n_chains)])
            g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                                  device=dev, generator=gen)
            g_pref = torch.randn((n_chains, n_steps, d, d),
                                 dtype=torch.complex64, device=dev,
                                 generator=gen)
            n1 = chain._plane_norm_max(a)[0]
            with precision(MODE):
                reset_launches()
                got = _plane_member_outputs(a, False, g_total, g_pref)
                launches = read_launches()
                want = _plane_member_outputs(a, True, g_total, g_pref)
                _plane_member_padding(a, n1)
            exact = _plane_member_outputs(a, False, g_total, g_pref)
            torch.cuda.synchronize()
            if (launches["K5 fwd"], launches["K5 fwd mode"],
                    launches["K5 bwd"], launches["K5 bwd mode"],
                    launches["K5 bwd step"]) != (1, 1, 2, 2, 1):
                raise RuntimeError("the plane op in the mode did not launch "
                                   "the mode's K5: {}".format(launches))
            rels = [_rel(x, y) for x, y in zip(got, want)]
            env = [_rel(x, y) for x, y in zip(got, exact)]
            label = "K5 d = {}, {} chains x {} steps, level {}".format(
                d, n_chains, n_steps, LEVEL_NORMS.index(target))
            _mode_check(label, (rels[:2], rels[2:]), (env[:2], env[2:]))
            _resident_check(forward, "K5 fwd", label, rels[:2])
            _resident_check(adjoint, "K5 bwd", label, rels[2:])
            for key, x, y in (("K5 fwd mode", got[1], want[1]),
                              ("K5 bwd mode", got[2], want[2]),
                              ("K5 bwd mode step", got[3], want[3])):
                worst[key] = max(worst.get(key, 0.0),
                                 float((x - y).abs().max()))
            rows.append("{} {:.1e}/{:.1e}/{:.1e}/{:.1e} exact {:.1e}/{:.1e}"
                        "".format(LEVEL_NORMS.index(target), *rels, env[0],
                                  env[2]))
            if ((d, n_chains, n_steps) == MODE_F64_CASE
                    and target == LEVEL_NORMS[-1]):
                dist = _f64_distances(
                    {"mode kernel": got, "plain in the mode": want,
                     "exact kernel": exact},
                    _f64_plane_outputs(a, g_total, g_pref))
                f64_line = (
                    "phase 36 bf16_3x K5 ({}) vs a float64 matrix_exp "
                    "chain of the same planes, rel forward (total, "
                    "prefixes) / adjoint (both seed modes): {}; the mode "
                    "kernel vs its plain version {:.6e} / {:.6e}".format(
                        label, "; ".join(
                            "{} {:.6e} / {:.6e}".format(side, *v)
                            for side, v in dist.items()),
                        max(rels[:2]), max(rels[2:])))
        print("phase 36 bf16_3x K5 (d = {}, {} chains x {} steps): level "
              "total/prefixes/grad last-step/grad per-step rel vs plain in "
              "the mode, total/grad rel vs the exact kernels: {}; padding "
              "exact".format(d, n_chains, n_steps, "; ".join(rows)),
              flush=True)
    print(f64_line, flush=True)
    d = 16
    a = torch.as_tensor(_unit_planes(rng, 37, d), dtype=torch.complex64,
                        device=dev)
    with precision(MODE):
        total = chain.plane_chain_propagate(a).to(torch.complex128)
    want = torch.eye(d, dtype=torch.complex128, device=dev)
    for u in torch.linalg.matrix_exp(a.to(torch.complex128)):
        want = u @ want
    rel = _rel(total, want)
    _mode_check("K5 d = 16 vs float64", ([], []), ([rel], []))
    return rel


def _mode_expm_kernels(dev, gen, worst, adjoint, forward):
    """Phase 36's K3/K4 at padded 64 on MODE_EXPM_CASES, every level:
    against their plain versions in the mode and the exact kernels, the
    padding exact, and at batch 37 against float64 matrix_exp and its
    autograd."""
    from qoc_tpu_torch.ops import expm_cuda
    for d, batch in MODE_EXPM_CASES:
        g = torch.randn((batch, d, d), dtype=torch.complex64, device=dev,
                        generator=gen)
        rows = []
        for target in LEVEL_NORMS:
            a = _random_planes(gen, batch, d, target, dev)
            with precision(MODE):
                reset_launches()
                rel3, rel4, err3, err4, (level, _) = _compare_expm_kernels(
                    a, a, g)
                launches = read_launches()
                _check_expm_padding(a, tf32=1)
                k3 = expm_cuda.expm_fwd(a)
                k4 = expm_cuda.expm_frechet_fwd(a.mH, g)
            if (launches["K3 mode"], launches["K4 mode"]) != (1, 1):
                raise RuntimeError("K3/K4 in the mode did not launch their "
                                   "mode forms: {}".format(launches))
            env3 = _rel(k3, expm_cuda.expm_fwd(a))
            env4 = _rel(k4, expm_cuda.expm_frechet_fwd(a.mH, g))
            rows.append("{} {:.1e} {:.1e} exact {:.1e} {:.1e}".format(
                level, rel3, rel4, env3, env4))
            if batch == 37:
                a64 = a.to(torch.complex128).requires_grad_(True)
                u64 = torch.linalg.matrix_exp(a64)
                grad64, = torch.autograd.grad(u64, a64,
                                              g.to(torch.complex128))
                f64 = (_rel(k3.to(torch.complex128), u64.detach()),
                       _rel(k4.to(torch.complex128), grad64))
                rows[-1] += " f64 {:.1e} {:.1e}".format(*f64)
                env3, env4 = max(env3, f64[0]), max(env4, f64[1])
            _mode_check("K3/K4 d = {}, batch {}, level {}".format(
                d, batch, level), ([rel3], [rel4]), ([env3], [env4]))
            label = "d = {}, batch {}, level {}".format(d, batch, level)
            _resident_check(forward, "K3", label, [rel3])
            _resident_check(adjoint, "K4", label, [rel4])
            worst["K3 mode"] = max(worst.get("K3 mode", 0.0), err3)
            worst["K4 mode"] = max(worst.get("K4 mode", 0.0), err4)
        print("phase 36 bf16_3x K3/K4: d={} (padded 64) batch={} (level, rel "
              "K3, K4 vs plain in the mode, vs the exact kernels[, vs float64 "
              "matrix_exp]): {}; padding exact".format(d, batch,
                                                       "; ".join(rows)),
              flush=True)


def phase_mode_kernels(dev, headline_w=None):
    """Phase 36: the bf16_3x mode's kernels against their plain versions in
    the mode on every ladder level and in both seed modes, the exact kernels
    and float64 (the mode's envelope), padding exact. Returns the worst
    max |err| against plain of each mode row."""
    if headline_w is None:
        headline_w = headline_weights(table3_problem(1)[0], dev)
    rng = np.random.default_rng(36)
    gen = torch.Generator(device=dev).manual_seed(36)
    worst, adjoint, forward = {}, {}, {}
    f64_chain = _mode_member_kernels(dev, rng, gen, worst, adjoint, forward)
    _mode_headline(dev, headline_w, worst, adjoint, forward)
    f64_plane = _mode_plane_kernels(dev, rng, gen, worst, adjoint, forward)
    _mode_expm_kernels(dev, gen, worst, adjoint, forward)
    print("phase 36 bf16_3x: chain op 3 members x 37 steps and plane op 37 "
          "steps at d = 16 vs float64 matrix_exp products rel {:.2e} / "
          "{:.2e}; max|err| vs plain {}".format(f64_chain, f64_plane, worst),
          flush=True)
    for what, table in (("forwards (FwdTC; K1, K5 fwd: total and "
                         "prefixes)", forward),
                        ("adjoints (AdjointTC)", adjoint)):
        print("phase 36 bf16_3x resident {}, worst rel vs plain in the mode "
              "(MODE_RTOL {:.1e}): {}".format(what, MODE_RTOL, "; ".join(
                  "{} {:.6e} ({}; margin {:.1%})".format(
                      kernel, rel, label, 1 - rel / MODE_RTOL)
                  for kernel, (rel, label) in table.items())), flush=True)
    return worst


def _mode_grape(label, kernels, **kw):
    """A GRAPE of grape_schroedinger_discrete in the mode, counters read
    around it: every launch of ``kernels`` in the mode's form, once an
    iteration, nothing else. Returns (launches, it/s)."""
    from qoc_tpu_torch import grape_schroedinger_discrete
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    with precision(MODE):
        reset_launches()
        result = grape_schroedinger_discrete(
            complex_controls=True, iteration_count=iterations,
            log_iteration_step=0, fused_chunk=WARMUP_ITERATIONS, **kw)
        launches = read_launches()
    modes = tuple(k + " mode" for k in kernels if k in PRECISION_MODES)
    errors = _grape_launches(label, result, launches, kernels + modes,
                             iterations)
    print("phase 37 bf16_3x {} grape: {} iterations, {:.2f} it/s steady, "
          "error {:.6f} -> {:.6f}, launches {}".format(
              label, result.iteration_count_ran, result.iterations_per_s,
              errors[0], errors[-1], launches), flush=True)
    return launches, result.iterations_per_s


def _problem_kw(pstate, hamiltonian, costs, dev):
    return dict(control_count=CONTROL_COUNT,
                control_eval_count=pstate.control_eval_count, costs=costs,
                evolution_time=pstate.evolution_time, hamiltonian=hamiltonian,
                initial_states=pstate.initial_states,
                system_eval_count=pstate.system_eval_count,
                initial_controls=pstate.initial_controls,
                max_control_norms=pstate.max_control_norms, device=dev)


def phase_mode_grape(dev, exact_it_s=None):
    """Phase 37: the slice at full width in the mode (see the module
    docstring). Returns ({row key: launches}, {cell: it/s})."""
    from qoc_tpu_torch import (TargetStateInfidelityTime,
                               grape_schroedinger_ensemble)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    from qoc_tpu_torch.models import MagnusPolicy
    from qoc_tpu_torch.parallel import build_ensemble_loss
    launches, rates = {}, {}
    pstate, hamiltonian, costs = table3_problem(1)
    run, rates["headline"] = _mode_grape(
        "headline", ("K1", "K2"),
        **_problem_kw(pstate, hamiltonian, costs, dev))
    launches.update({"K1 mode": run["K1 mode"], "K2 mode": run["K2 mode"]})
    with precision(MODE):
        check = _against_float64(
            "loss", build_schroedinger_loss(pstate, dev, torch.float32),
            schroedinger_reference(pstate, dev, float64_planes(
                pstate, hamiltonian, dev)), pstate, dev)
        loss = build_schroedinger_loss(pstate, dev, torch.float32)
        e_mode = _loss_grad(loss, pstate, dev)[0]
    e_exact = _loss_grad(loss, pstate, dev)[0]
    gap = float(abs(e_mode.double() - e_exact.double()))
    print("phase 37 bf16_3x headline: {:.2f} it/s against {} it/s exact "
          "(phase 5, same call); vs float64 plain route: {}; loss gap to the "
          "exact kernels {:.3e} (rel {:.2e}; 6.557e-7 with the forward form "
          "before FwdTC, PERF.md)".format(
              rates["headline"], "{:.2f}".format(exact_it_s)
              if exact_it_s is not None else "(not run)", check, gap,
              gap / abs(float(e_exact))), flush=True)
    pstate, hamiltonian, costs = stepcost_problem(1)
    run, rates["step-cost headline"] = _mode_grape(
        "step-cost headline", ("K1", "K2", "K2 step"),
        **_problem_kw(pstate, hamiltonian, costs, dev))
    launches["K2 mode step"] = run["K2 mode"]
    pstate, hamiltonian, costs = m4_problem(1)
    run, rates["M4"] = _mode_grape(
        "M4 (plane route)", ("K5 fwd", "K5 bwd"),
        magnus_policy=MagnusPolicy.M4,
        **_problem_kw(pstate, hamiltonian, costs, dev))
    launches.update({"K5 fwd mode": run["K5 fwd mode"],
                     "K5 bwd mode": run["K5 bwd mode"]})
    # The M4 loss with a step cost (K5 per step) and through the blocked
    # route (K3/K4 at padded 64), once each.
    step_state, _, _ = bench_problem(
        D, CONTROL_COUNT, M4_STEPS, M4_STEPS, M4_EVOLUTION_TIME, "M4",
        step_costs=[TargetStateInfidelityTime(M4_STEPS, _last_level(D))])
    lines = []
    for label, state, allow, keys in (
            ("M4 step-cost loss, plane route", step_state, True,
             ("K5 fwd", "K5 bwd", "K5 bwd step")),
            ("M4 loss, blocked route", pstate, False, ("K3", "K4"))):
        with precision(MODE):
            loss = build_schroedinger_loss(state, dev, torch.float32,
                                           allow_plane_chain=allow)
            reset_launches()
            _loss_grad(loss, state, dev)
            torch.cuda.synchronize()
            run = read_launches()
            check = _against_float64(
                "loss", loss, schroedinger_reference(state, dev,
                                                     float64_planes(
                                                         state, hamiltonian,
                                                         dev)), state, dev)
        want = {k: 1 for k in keys}
        want.update({k + " mode": 1 for k in keys if k in PRECISION_MODES})
        _member_launches(label, run, tuple(want), want)
        lines.append("{}: launches {}; vs float64: {}".format(label, run,
                                                            check))
    # K5's per-step form from the first, K3/K4's mode forms from the
    # second (each checked to be the only launches).
    launches.update({"K5 bwd mode step": 1, "K3 mode": 1, "K4 mode": 1})
    print("phase 37 bf16_3x " + "; ".join(lines), flush=True)
    pstate, ham, params, costs = ensemble_problem(ENSEMBLE_MEMBERS[0])
    loss = build_ensemble_loss(pstate, ham, params, device=dev)
    blocks = -(-(M4_STEPS - 1) // loss.block)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    with precision(MODE):
        reset_launches()
        result = grape_schroedinger_ensemble(
            CONTROL_COUNT, M4_STEPS, costs, M4_EVOLUTION_TIME, ham, params,
            pstate.initial_states, M4_STEPS, complex_controls=True,
            initial_controls=pstate.initial_controls,
            iteration_count=iterations, log_iteration_step=0,
            max_control_norms=pstate.max_control_norms,
            fused_chunk=WARMUP_ITERATIONS, device=dev)
        run = read_launches()
        check = _against_float64(
            "loss", loss, _ensemble_reference(pstate, ham, params, dev),
            pstate, dev)
    n = blocks * iterations
    _member_launches("the bf16_3x 4-member ensemble", run,
                     ("K1", "K2", "K1 mode", "K2 mode"),
                     {"K1": n, "K2": n, "K1 mode": n, "K2 mode": n})
    errors = np.asarray(result.errors)
    if not (result.iteration_count_ran == iterations
            and np.all(np.isfinite(errors)) and errors[-1] < errors[0]):
        raise RuntimeError("the bf16_3x ensemble GRAPE failed its checks")
    rates["4-member ensemble"] = result.iterations_per_s
    print("phase 37 bf16_3x ensemble ({} members x {} steps): {:.2f} it/s "
          "steady, error {:.6f} -> {:.6f}, launches {}; vs float64 plain "
          "route: {}".format(ENSEMBLE_MEMBERS[0], M4_STEPS - 1,
                             result.iterations_per_s, errors[0], errors[-1],
                             run, check), flush=True)
    n_starts, ms_iterations = MULTISTART_RUNS[0]
    with precision(MODE):
        result, run = _multistart_run(
            "bf16_3x multistart {} candidates".format(n_starts), n_starts,
            ms_iterations, MULTISTART_CHUNK, dev, multistart_problem(),
            mode=True)
    rates["multistart {}".format(n_starts)] = result.iterations_per_s
    launches.update({"K1 member mode": run["K1 mode"],
                     "K2 member mode": run["K2 mode"]})
    return launches, rates


def _mode_times(prefix, fwd, bwd, fwd_plain, bwd_plain, fwd_args, bwd_args,
                seeds):
    """ms of the forward and adjoint wrappers in the mode and exact, and of
    their plain versions in the mode, at one shape; ``seeds``: {suffix:
    seeds} of the adjoint's seed modes."""
    ms = {
        prefix[0] + " mode": cuda_ms(lambda: fwd(*fwd_args, MODE), 10),
        prefix[0] + " exact": cuda_ms(lambda: fwd(*fwd_args, "highest"),
                                      10),
        prefix[0] + " mode plain": cuda_ms(
            lambda: fwd_plain(*fwd_args, MODE), 2),
    }
    for suffix, s in seeds.items():
        key = prefix[1] + " mode" + suffix
        ms[key] = cuda_ms(lambda: bwd(*bwd_args, s, MODE), 10)
        ms[key.replace(" mode", " exact")] = cuda_ms(
            lambda: bwd(*bwd_args, s, "highest"), 10)
        ms[key + " plain"] = cuda_ms(lambda: bwd_plain(*bwd_args, s, MODE),
                                     2)
    return ms


def chain_rows(w, n_chains):
    """(w_seg, L): weights w ((n_chains,) n_steps, n_b) as the chain op's
    kernel rows (n_chains S_m, L, n_b), each chain's steps zero-padded to
    its S_m segments of L."""
    from qoc_tpu_torch.ops import chain
    n_steps = w.shape[-2]
    s_count, length = chain.segment_plan(n_steps, n_chains)
    w_seg = torch.zeros((n_chains, s_count * length, w.shape[-1]),
                        device=w.device)
    w_seg[:, :n_steps] = w.reshape(n_chains, n_steps, -1)
    return w_seg.reshape(n_chains * s_count, length, -1), length


def multistart_weights(dev):
    """(chain op, weights (512, 200, n_b)): the 512-candidate multistart's
    chains at its seeds (phase 30's), the K1/K2 member rows of phase 38."""
    from qoc_tpu_torch.core.common import slap_controls_torch
    from qoc_tpu_torch.core.schroedinger import fused_weights
    from qoc_tpu_torch.ops import chain
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    pstate, ham, _ = multistart_problem()
    n_starts, n_ms = MULTISTART_RUNS[0][0], MULTISTART_POINTS - 1
    dt = float(pstate.dt)
    controls = torch.func.vmap(lambda p: slap_controls_torch(
        True, p, pstate.controls_shape))(torch.as_tensor(
            candidate_seeds(pstate, n_starts, 0), dtype=torch.float32,
            device=dev))
    w_ms = fused_weights(controls, torch.arange(
        n_ms, dtype=torch.float32, device=dev) * dt, torch.as_tensor(
            pstate.control_eval_times, dtype=torch.float32, device=dev), dt)
    return chain.ChainExpmPropagate(ham.generator_basis(dt), dev,
                                    torch.float32), w_ms


def phase_mode_timing(dev, headline_w=None):
    """Phase 38: the mode's kernels timed at the headline shapes (K1, K2 in
    both seed modes), the M4 planes (K5, K3/K4 at padded 64) and the
    512-candidate shapes (K1/K2's member rows), beside the exact kernels in
    the same call, the plain versions in the mode, the mode's bounds and
    each kernel's design. Returns (ms, bounds): row keys "<key> mode", with
    "<key> mode plain" and "<key> mode library" beside."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    if headline_w is None:
        headline_w = headline_weights(table3_problem(1)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(38)
    ms, bounds, lines = {}, {}, []
    op = chain.ChainExpmPropagate(table3_basis(), dev, torch.float32)
    ms_op, w_ms = multistart_weights(dev)
    n_starts = w_ms.shape[0]
    for label, the_op, w, n_chains, keys in (
            ("headline", op, headline_w, 1, ("K1", "K2")),
            ("512 candidates", ms_op, w_ms, n_starts,
             ("K1 member", "K2 member"))):
        w_seg, length = chain_rows(w, n_chains)
        n1, ninf = chain._norm_max(w.reshape(-1, w.shape[-1]),
                                   the_op.basis_ri, the_op.d)
        pref = chain.chain_fwd(w_seg, the_op.basis, n1, MODE)
        seeds = {"": torch.randn((w_seg.shape[0], D, D),
                                 dtype=torch.complex64, device=dev,
                                 generator=gen)}
        if n_chains == 1:
            seeds[" step"] = torch.randn((w_seg.shape[0], length, D, D),
                                         dtype=torch.complex64, device=dev,
                                         generator=gen)
        ms.update(_mode_times(
            keys, chain.chain_fwd, chain.chain_bwd, chain.chain_fwd_plain,
            chain.chain_bwd_plain, (w_seg, the_op.basis, n1),
            (w_seg, the_op.basis_h, ninf, pref), seeds))
        a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, the_op.n_b).to(
            torch.complex64), the_op.basis)
        absa = a.abs()
        for mode in (MODE, "highest"):
            tag = " mode" if mode == MODE else " exact"
            bounds[keys[0] + tag] = kernel_bound(
                absa.sum(-2).amax(-1), chain.ladder_level(n1), False,
                [w_seg, the_op.basis, n1, pref], mode=mode)
            for suffix, s in seeds.items():
                bounds[keys[1] + tag + suffix] = kernel_bound(
                    absa.sum(-1).amax(-1), chain.ladder_level(ninf), True,
                    [w_seg, the_op.basis_h, ninf, pref, s, pref[:, 1:]],
                    mode=mode)
        lines.append((label, w_seg.shape[0], chain.ladder_level(n1),
                      chain.ladder_level(ninf)))
        del a, absa, pref
    a = m4_planes(dev)
    a_seg, n1, ninf = _segment_planes(a)
    pref = chain.plane_fwd(a_seg, n1, MODE)
    seeds = {"": torch.randn((a_seg.shape[0],) + a_seg.shape[-2:],
                             dtype=torch.complex64, device=dev,
                             generator=gen),
             " step": torch.randn(a_seg.shape, dtype=torch.complex64,
                                  device=dev, generator=gen)}
    ms.update(_mode_times(
        ("K5 fwd", "K5 bwd"), chain.plane_fwd, chain.plane_bwd,
        chain.plane_fwd_plain, chain.plane_bwd_plain, (a_seg, n1),
        (a_seg, ninf, pref), seeds))
    step_norms = a_seg.reshape(-1, D, D).abs()
    for mode in (MODE, "highest"):
        tag = " mode" if mode == MODE else " exact"
        bounds["K5 fwd" + tag] = kernel_bound(
            step_norms.sum(-2).amax(-1), chain.ladder_level(n1), False,
            [a_seg, n1, pref], mode=mode)
        for suffix, s in seeds.items():
            bounds["K5 bwd" + tag + suffix] = kernel_bound(
                step_norms.sum(-1).amax(-1), chain.ladder_level(ninf), True,
                [a_seg, ninf, pref, s, a_seg], mode=mode)
    lines.append(("M4 planes", a_seg.shape[0], chain.ladder_level(n1),
                  chain.ladder_level(ninf)))
    # K3/K4 at padded 64 as the blocked route calls them: K3 at A, K4 at
    # (A^H, G).
    g = torch.randn(a.shape, dtype=torch.complex64, device=dev,
                    generator=gen)
    ah = a.mH.contiguous()
    ms.update({
        "K3 mode": cuda_ms(lambda: expm_cuda.expm_fwd(a, MODE), 10),
        "K3 exact": cuda_ms(lambda: expm_cuda.expm_fwd(a, "highest"), 10),
        "K3 mode plain": cuda_ms(lambda: expm_cuda.expm_fwd_plain(a, MODE),
                                 2),
        "K3 mode library": cuda_ms(lambda: torch.linalg.matrix_exp(a), 5),
        "K4 mode": cuda_ms(lambda: expm_cuda.expm_frechet_fwd(ah, g, MODE),
                           10),
        "K4 exact": cuda_ms(
            lambda: expm_cuda.expm_frechet_fwd(ah, g, "highest"), 10),
        "K4 mode plain": cuda_ms(
            lambda: expm_cuda.expm_frechet_plain(ah, g, MODE), 2),
    })
    a_req = a.clone().requires_grad_(True)
    u = torch.linalg.matrix_exp(a_req)
    ms["K4 mode library"] = cuda_ms(lambda: torch.autograd.grad(
        u, a_req, g, retain_graph=True), 3)
    lv3 = chain.ladder_level(expm_cuda._norm_max(a))
    lv4 = chain.ladder_level(expm_cuda._norm_max(ah))
    for mode in (MODE, "highest"):
        tag = " mode" if mode == MODE else " exact"
        bounds["K3" + tag] = kernel_bound(a.abs().sum(-2).amax(-1), lv3,
                                          False, [a, a], chain=False,
                                          mode=mode)
        bounds["K4" + tag] = kernel_bound(ah.abs().sum(-2).amax(-1), lv4,
                                          True, [ah, g, g], chain=False,
                                          mode=mode)
    lines.append(("M4 planes, K3/K4", a.shape[0], lv3, lv4))
    torch.cuda.synchronize()
    print("phase 38 bf16_3x timing (rows, levels fwd/bwd: {}): ".format(
        "; ".join("{} {} rows {}/{}".format(*x) for x in lines))
        + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items()),
        flush=True)
    for key in sorted(k for k in bounds if " mode" in k):
        exact = key.replace(" mode", " exact")
        print("phase 38 bf16_3x {}: {:.3f} ms (exact {:.3f} ms), TF32 bound "
              "{:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time; exact "
              "kernel's FP32 bound {:.3f} ms = {:.0%}".format(
                  key, ms[key], ms[exact], bounds[key][0], bounds[key][1],
                  bounds[key][2], bounds[key][0] / ms[key], bounds[exact][0],
                  bounds[exact][0] / ms[exact]), flush=True)
    for key, s_count in (("K1 mode", lines[0][1]), ("K2 mode", lines[0][1]),
                         ("K5 fwd mode", lines[2][1]),
                         ("K5 bwd mode", lines[2][1])):
        print("phase 38 design: " + resident_design_line(
            key, s_count, bounds[key][0], ms[key]), flush=True)
    shape = (ctypes.c_int * 4)()
    chain.load_kernels().qoc_forward_form(shape)
    ku, passes, early, pair = shape
    print("phase 38 design: the mode's resident forward form (K1, K5 fwd, K3 "
          "at padded 64): FwdTC, 3 x TF32 mma.sync products (mm_acc_3x); "
          "K1's generator build {} basis terms in flight in {} pass(es), {}, "
          "{}; elementwise passes fused into the epilogues in 16-byte "
          "accesses, the ladder leaving U - I; a degree-12 step 4 + 1 "
          "products and 4 + 1 barriers (chain step, prefix write and next "
          "generator in one phase)".format(
              ku, passes,
              "half the warps building before the step's product" if early
              else "every warp building after the step's product",
              "two steps' generators a build every other step (a seventh "
              "slot)" if pair else "one generator a step"), flush=True)
    for key, dual in (("K3 mode", False), ("K4 mode", True)):
        blocks = expm_cuda.launch_grid(dual, D, a.shape[0], dev.index)[0]
        smem = expm_cuda._plan(dual, D, dev.index)[2]
        threads, entry = ((chain.resident_block("K4", 1)[0],
                           adjoint_entry("K4", 1)) if dual else
                          (256, RESIDENT_ENTRY[True]["K3"]))
        print("phase 38 design: " + design_line(
            key, entry, blocks, 1, smem, bounds[key][0], ms[key], threads),
            flush=True)
    return ms, bounds


def _mode_tiled_expm(dev, gen, worst):
    """Phase 40's K3/K4 at padded 128-256 (MODE_TILED_EXPM_DIMS) in the
    mode, every level: against their plain versions in the mode within
    MODE_RTOL, launched in their mode forms, the padding exact, and
    against the exact kernels and float64 matrix_exp (the envelope)."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    for d in MODE_TILED_EXPM_DIMS:
        for batch in MODE_TILED_BATCHES[:2 if d == MODE_TILED_EXPM_DIMS[0]
                                         else 1]:
            g = torch.randn((batch, d, d), dtype=torch.complex64, device=dev,
                            generator=gen)
            rows = []
            for target in LEVEL_NORMS:
                a = _random_planes(gen, batch, d, target, dev)
                ah = a.mH.contiguous()
                with precision(MODE):
                    reset_launches()
                    k3, k4 = expm_cuda.expm_fwd(a), expm_cuda.expm_frechet_fwd(
                        ah, g)
                    launches = read_launches()
                    p3 = expm_cuda.expm_fwd_plain(a)
                    p4 = expm_cuda.expm_frechet_plain(ah, g)
                    if d < expm_cuda.kernel_dp(d):
                        _check_expm_padding(a, tf32=1)
                x3, x4 = expm_cuda.expm_fwd(a), expm_cuda.expm_frechet_fwd(
                    ah, g)
                torch.cuda.synchronize()
                if (launches["K3 mode"], launches["K4 mode"]) != (1, 1):
                    raise RuntimeError("K3/K4 in the mode did not launch their "
                                       "mode forms: {}".format(launches))
                for name, x in (("K3", k3), ("K4", k4)):
                    if not bool(torch.isfinite(torch.view_as_real(x)).all()):
                        raise RuntimeError(name + " (bf16_3x) produced "
                                           "non-finite values")
                rel = (_rel(k3, p3), _rel(k4, p4))
                env = (_rel(k3, x3), _rel(k4, x4))
                level = chain.ladder_level(expm_cuda._norm_max(a))
                rows.append("{} {:.1e} {:.1e} exact {:.1e} {:.1e}".format(
                    level, *rel, *env))
                if max(rel) > MODE_RTOL or env[0] > FWD_RTOL or \
                        env[1] > GRAD_RTOL:
                    raise RuntimeError(
                        "K3/K4 tiled (bf16_3x) disagree with their plain "
                        "versions in the mode or the exact kernels (d = {}, "
                        "batch {}, level {}): {}".format(d, batch, level,
                                                         rows[-1]))
                worst["K3 tiled mode"] = max(worst.get("K3 tiled mode", 0.0),
                                             float((k3 - p3).abs().max()))
                worst["K4 tiled mode"] = max(worst.get("K4 tiled mode", 0.0),
                                             float((k4 - p4).abs().max()))
                if target == LEVEL_NORMS[2] and batch == MODE_TILED_BATCHES[0]:
                    a64 = a.to(torch.complex128).requires_grad_(True)
                    u64 = torch.linalg.matrix_exp(a64)
                    grad64, = torch.autograd.grad(u64, a64,
                                                  g.to(torch.complex128))
                    f64 = (_rel(k3.to(torch.complex128), u64.detach()),
                           _rel(k4.to(torch.complex128), grad64))
                    rows[-1] += " f64 {:.1e} {:.1e}".format(*f64)
                    if f64[0] > FWD_RTOL or f64[1] > GRAD_RTOL:
                        raise RuntimeError("K3/K4 tiled (bf16_3x) disagree "
                                           "with float64 matrix_exp")
            print("phase 40 bf16_3x K3/K4 tiled: d={} (padded {}) batch={} "
                  "(level, rel K3, K4 vs plain in the mode, vs the exact "
                  "kernels[, vs float64 matrix_exp]): {}{}".format(
                      d, expm_cuda.kernel_dp(d), batch, "; ".join(rows),
                      "; padding exact" if d < expm_cuda.kernel_dp(d)
                      else ""), flush=True)


def _mode_stream_chain(dev, gen, d, n_steps, target, worst):
    """K6 in the mode on one chain of random planes at d (see
    _mode_stream_check). Returns (levels, rels)."""
    a = _stream_planes(gen, n_steps, d, target, dev)
    return _mode_stream_check(*_stream_inputs(a), d, n_steps, gen, worst)


def _mode_stream_check(a_seg, n1, ninf, d, n_steps, gen, worst,
                       prefix="K6", n_chains=1):
    """K6 in the mode on a_seg (n_chains chains of n_steps steps at d, as
    rows): forward and adjoint (both seed modes) against their plain
    versions in the mode, launched in their mode forms, every chain's padded
    rows and steps exact; the worst max |err| folded into ``worst`` under
    "<prefix> fwd mode", "<prefix> bwd mode" and "<prefix> bwd mode step".
    Returns (levels, rels)."""
    from qoc_tpu_torch.ops import chain
    s_count, length, dp = a_seg.shape[:3]
    seeds = {"": torch.randn((s_count, dp, dp), dtype=torch.complex64,
                             device=a_seg.device, generator=gen),
             " step": torch.randn((s_count, length, dp, dp),
                                  dtype=torch.complex64, device=a_seg.device,
                                  generator=gen)}
    with precision(MODE):
        reset_launches()
        pref = chain.stream_fwd(a_seg, n1)
        got = {k: chain.stream_bwd(a_seg, ninf, pref, s)
               for k, s in seeds.items()}
        launches = read_launches()
        pref_p = chain.stream_fwd_plain(a_seg, n1)
        want = {k: chain.stream_bwd_plain(a_seg, ninf, pref, s)
                for k, s in seeds.items()}
    torch.cuda.synchronize()
    if (launches["K6 fwd mode"], launches["K6 bwd mode"],
            launches["K6 bwd step"]) != (1, 2, 1):
        raise RuntimeError("K6 in the mode did not launch its mode forms: "
                           "{}".format(launches))
    if d < dp or n_steps * n_chains < s_count * length:
        for p in pref.reshape(n_chains, -1, *pref.shape[1:]):
            _check_padding(p, d, n_steps)
    rels = [_rel(pref, pref_p)] + [_rel(got[k], want[k]) for k in seeds]
    for key, x, y in ((prefix + " fwd mode", pref, pref_p),
                      (prefix + " bwd mode", got[""], want[""]),
                      (prefix + " bwd mode step", got[" step"],
                       want[" step"])):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(key + " produced non-finite values")
        worst[key] = max(worst.get(key, 0.0), float((x - y).abs().max()))
    return (chain.ladder_level(n1), chain.ladder_level(ninf)), rels


def _mode_stream_members(dev, gen, d, n_chains, n_steps, target, worst):
    """The plane op's member axis on K6 in the mode: totals, prefixes and
    the plane gradient (both seed modes) against the plain op in the mode,
    and every chain's padding exact. Returns the rels."""
    from qoc_tpu_torch.ops import chain
    a = torch.stack([_stream_planes(gen, n_steps, d, target, dev)
                     for _ in range(n_chains)])
    g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                          device=dev, generator=gen)
    g_pref = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                         device=dev, generator=gen)
    with precision(MODE):
        reset_launches()
        got = _plane_member_outputs(a, False, g_total, g_pref)
        launches = read_launches()
        want = _plane_member_outputs(a, True, g_total, g_pref)
        _plane_member_padding(a, chain._plane_norm_max(a)[0])
    torch.cuda.synchronize()
    if (launches["K6 fwd mode"], launches["K6 bwd mode"],
            launches["K6 bwd step"]) != (1, 2, 1):
        raise RuntimeError("the plane op's member axis in the mode did not "
                           "launch K6's mode forms: {}".format(launches))
    for key, x, y in (("K6 member fwd mode", got[1], want[1]),
                      ("K6 member bwd mode", got[2], want[2]),
                      ("K6 member bwd mode step", got[3], want[3])):
        worst[key] = max(worst.get(key, 0.0), float((x - y).abs().max()))
    return [_rel(x, y) for x, y in zip(got, want)]


def mode_path_inputs(dev):
    """The tiled mode kernels' inputs on the slice's main path: the d = 2^7
    GRAPE's planes at its initial controls (2000 x 128^2, as the blocked
    route hands them to K3, their adjoints to K4) with a random cotangent;
    K6's segments of the Lindblad d = 20 planes (15 x 7 at padded 448) and
    of a time block of the 4-member d = 20 ensemble (member rows), with
    their norms. Returns {"d128": (a, ah, g), "d20": (a_seg, n1, ninf, d,
    steps, |a|), "member": (a_seg, n1, ninf, d, steps, |a|, chains)}."""
    from qoc_tpu_torch.parallel import build_lindblad_ensemble_loss
    gen = torch.Generator(device=dev).manual_seed(41)
    a = initial_planes(*d128_problem()[:2], dev)
    g = torch.randn(a.shape, dtype=torch.complex64, device=dev, generator=gen)
    a20, _ = lindblad_d20_planes(dev)
    kw = lindblad_ensemble_problem(LINDBLAD_MEMBERS[0])
    pstate = lindblad_pstate(kw)
    block = build_lindblad_ensemble_loss(pstate, kw["hamiltonian"],
                                         kw["hamiltonian_params"],
                                         device=dev).block
    with torch.no_grad():
        am = lindblad_member_planes(kw, pstate, dev)(
            kw["hamiltonian_params"], block)
    return {"d128": (a, a.mH.contiguous(), g),
            "d20": _stream_inputs(a20) + (a20.shape[-1], a20.shape[0],
                                          a20.abs()),
            "member": _member_stream_inputs(am) + (
                am.shape[-1], am.shape[1],
                am.reshape(-1, *am.shape[-2:]).abs(), am.shape[0])}


def _mode_main_path(dev, gen, worst):
    """Phase 40 on the main path's inputs (mode_path_inputs): K3/K4's mode
    forms on the d = 2^7 planes, K6's on the d = 20 planes and the
    ensemble's member time block (both seed modes, padded steps exact),
    each against its plain version in the mode within MODE_RTOL."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    inputs = mode_path_inputs(dev)
    a, ah, g = inputs.pop("d128")
    with precision(MODE):
        reset_launches()
        k3, k4 = expm_cuda.expm_fwd(a), expm_cuda.expm_frechet_fwd(ah, g)
        launches = read_launches()
        p3, p4 = expm_cuda.expm_fwd_plain(a), expm_cuda.expm_frechet_plain(
            ah, g)
    torch.cuda.synchronize()
    if (launches["K3 mode"], launches["K4 mode"]) != (1, 1):
        raise RuntimeError("K3/K4 on the d = 2^7 planes did not launch their "
                           "mode forms: {}".format(launches))
    rels = {}
    for key, x, y in (("K3 tiled mode", k3, p3), ("K4 tiled mode", k4, p4)):
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(key + " produced non-finite values")
        rels[key] = _rel(x, y)
        worst[key] = max(worst.get(key, 0.0), float((x - y).abs().max()))
    lines = ["d=2^7 planes {} levels {}/{}: K3 {:.1e}, K4 {:.1e}".format(
        tuple(a.shape), chain.ladder_level(expm_cuda._norm_max(a)),
        chain.ladder_level(expm_cuda._norm_max(ah)), rels["K3 tiled mode"],
        rels["K4 tiled mode"])]
    del a, ah, g, k3, k4, p3, p4
    for name, prefix in (("d20", "K6"), ("member", "K6 member")):
        a_seg, n1, ninf, d, n_steps = inputs[name][:5]
        n_chains = inputs[name][6] if name == "member" else 1
        levels, got = _mode_stream_check(a_seg, n1, ninf, d, n_steps, gen,
                                         worst, prefix, n_chains)
        rels.update({prefix + k: r for k, r in zip(
            (" fwd mode", " bwd mode", " bwd mode step"), got)})
        lines.append("{} {} x {} steps on {} levels {}/{}: prefixes {:.1e}, "
                     "grad last-step {:.1e}, per-step {:.1e}".format(
                         prefix, n_chains, n_steps, tuple(a_seg.shape),
                         *levels, *got))
    print("phase 40 bf16_3x tiled kernels on the main path's inputs (rel vs "
          "plain in the mode): {}; padded steps exact".format(
              "; ".join(lines)), flush=True)
    bad = {k: r for k, r in rels.items() if r > MODE_RTOL}
    if bad:
        raise RuntimeError("the tiled mode kernels disagree with their plain "
                           "versions in the mode on the main path's inputs: "
                           "{}".format(bad))


def phase_mode_tiled_kernels(dev):
    """Phase 40: the tiled kernels' bf16_3x forms against their plain
    versions in the mode within MODE_RTOL, on the main path's inputs (the
    d = 2^7 planes, the d = 20 planes, the ensemble's member time block) and
    on every ladder level (K3/K4 at padded 128-256, K6 at padded 320-512,
    one chain and the member axis, both seed modes); padding and padded
    steps exact. Returns the worst max |err|
    against plain of each row."""
    gen = torch.Generator(device=dev).manual_seed(40)
    worst = {}
    _mode_main_path(dev, gen, worst)
    _mode_tiled_expm(dev, gen, worst)
    for d in MODE_STREAM_DIMS:
        for n_chains, n_steps in MODE_STREAM_CASES:
            line = []
            for target in LEVEL_NORMS:
                if n_chains == 1:
                    levels, rels = _mode_stream_chain(dev, gen, d, n_steps,
                                                      target, worst)
                    tag = "{}/{}".format(*levels)
                else:
                    rels = _mode_stream_members(dev, gen, d, n_chains,
                                                n_steps, target, worst)
                    tag = str(LEVEL_NORMS.index(target))
                line.append("{} ".format(tag) + "/".join(
                    "{:.1e}".format(r) for r in rels))
                if max(rels) > MODE_RTOL:
                    raise RuntimeError(
                        "K6 (bf16_3x) disagrees with its plain version in the "
                        "mode (d = {}, {} chains x {} steps, level {}): {}"
                        "".format(d, n_chains, n_steps, tag, line[-1]))
            print("phase 40 bf16_3x K6: d={} {} chain{} x {} steps (levels, "
                  "rel vs plain in the mode: {}): {}; padding exact".format(
                      d, n_chains, "s" if n_chains > 1 else "", n_steps,
                      "prefixes/grad last-step/grad per-step" if n_chains == 1
                      else "totals/prefixes/grad last-step/grad per-step",
                      "; ".join(line)), flush=True)
    print("phase 40 bf16_3x tiled kernels: max|err| vs plain in the mode {}; "
          "all within {:.1e}".format(worst, MODE_RTOL), flush=True)
    return worst


def phase_mode_cells(dev, exact=None):
    """Phase 39: the d = 2^7 GRAPE (K3/K4 tiled), the Lindblad d = 20 GRAPE
    (K6) and the 4-member d = 20 Lindblad ensemble GRAPE (K6's member axis)
    in the mode, 2 warm-up + 10 (ensemble 5) timed iterations with counters
    (each kernel's mode form launched every iteration or time block, the
    exact forms never), the error falling, and the mode's loss at the
    initial controls within MODE_LOSS_RTOL (relative) of the exact
    kernels'; then the d = 20 step-cost loss (K6 per step) in the mode.
    ``exact``: {cell: exact it/s} of the earlier phases, printed beside.
    Returns ({row: launches}, {cell: it/s})."""
    from qoc_tpu_torch import (grape_lindblad_discrete,
                               grape_schroedinger_discrete)
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    exact = exact or {}
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    launches, rates = {}, {}

    def check(label, keys, n_launch, got, result, loss_fn):
        want = {k: n_launch for k in keys}
        want.update({k + " mode": n_launch for k in keys})
        _member_launches("the bf16_3x " + label, got, tuple(want), want)
        errors = np.asarray(result.errors)
        if not (np.all(np.isfinite(errors)) and errors[-1] < errors[0]):
            raise RuntimeError("the bf16_3x {} GRAPE failed its checks: "
                               "errors {}".format(label, errors))
        with precision(MODE):
            e_mode, g_mode = loss_fn()
        e_exact, g_exact = loss_fn()
        e_mode, e_exact = float(e_mode), float(e_exact)
        gap = abs(e_mode - e_exact) / abs(e_exact)
        grad_gap = _rel(g_mode, g_exact)
        if gap > MODE_LOSS_RTOL or grad_gap > GRAD_RTOL:
            raise RuntimeError("the bf16_3x {} loss is {:.2e} (relative) from "
                               "the exact kernels', its gradient {:.2e}"
                               "".format(label, gap, grad_gap))
        rates[label] = result.iterations_per_s
        print("phase 39 bf16_3x {}: {} iterations, {:.2f} it/s steady "
              "against {} exact, error {:.6f} -> {:.6f}, loss at the initial "
              "controls {:.9f} against {:.9f} exact (rel {:.2e}; gradient "
              "rel {:.2e}), launches {}".format(
                  label, result.iteration_count_ran, result.iterations_per_s,
                  "{:.2f}".format(exact[label]) if label in exact
                  else "(not run)", errors[0], errors[-1], e_mode, e_exact,
                  gap, grad_gap, {k: v for k, v in got.items() if v}),
              flush=True)

    pstate, hamiltonian, costs = d128_problem()
    with precision(MODE):
        reset_launches()
        result = grape_schroedinger_discrete(
            complex_controls=True, iteration_count=iterations,
            log_iteration_step=0, fused_chunk=WARMUP_ITERATIONS,
            **_problem_kw(pstate, hamiltonian, costs, dev))
        got = read_launches()
    check("d=2^7", ("K3", "K4"), iterations, got, result,
          lambda: _loss_grad(build_schroedinger_loss(
              pstate, dev, torch.float32), pstate, dev))
    launches.update({"K3 tiled mode": got["K3 mode"],
                     "K4 tiled mode": got["K4 mode"]})

    d20_state = lindblad_d20_pstate()
    with precision(MODE):
        reset_launches()
        result = grape_lindblad_discrete(
            iteration_count=iterations, log_iteration_step=0,
            fused_chunk=WARMUP_ITERATIONS, device=dev,
            **lindblad_d20_problem())
        got = read_launches()
    check("Lindblad d=20", ("K6 fwd", "K6 bwd"), iterations, got, result,
          lambda: _loss_grad(build_lindblad_loss(
              d20_state, dev, torch.float32), d20_state, dev))
    launches.update({"K6 fwd mode": got["K6 fwd mode"],
                     "K6 bwd mode": got["K6 bwd mode"]})

    n_members = LINDBLAD_MEMBERS[0]
    kw = lindblad_ensemble_problem(n_members)
    label = "{}-member Lindblad d=20 ensemble".format(n_members)
    with precision(MODE):
        result, got, blocks, _, ens_state, ens_loss = _lindblad_ensemble_run(
            "the bf16_3x " + label, kw, dev,
            WARMUP_ITERATIONS + LINDBLAD_TIMED, WARMUP_ITERATIONS)
    check(label, ("K6 fwd", "K6 bwd"),
          blocks * (WARMUP_ITERATIONS + LINDBLAD_TIMED), got, result,
          lambda: _loss_grad(ens_loss, ens_state, dev))
    launches.update({"K6 member fwd mode": got["K6 fwd mode"],
                     "K6 member bwd mode": got["K6 bwd mode"]})

    # The d = 20 step-cost loss (K6's adjoint per step), once.
    step_state = lindblad_d20_pstate(d20_step_costs())
    with precision(MODE):
        loss = build_lindblad_loss(step_state, dev, torch.float32)
        reset_launches()
        _loss_grad(loss, step_state, dev)
        torch.cuda.synchronize()
        got = read_launches()
    want = {"K6 fwd": 1, "K6 bwd": 1, "K6 bwd step": 1, "K6 fwd mode": 1,
            "K6 bwd mode": 1}
    _member_launches("the bf16_3x d = 20 step-cost loss", got, tuple(want),
                     want)
    launches["K6 bwd mode step"] = got["K6 bwd mode"]
    print("phase 39 bf16_3x d = 20 step-cost loss: launches {}".format(
        {k: v for k, v in got.items() if v}), flush=True)
    return launches, rates


# ptxas entry strings of the tiled kernels (K3/K4 above padded 64, K6) at
# dp, exact or (tc) in the bf16_3x mode (K3/K4's form 2, K6's form 1).
def tiled_entry(key, dp, tc):
    if key.startswith("K6"):
        return ("stream_{}_kernelILi{}ELi{}E".format(
            "bwd" if " bwd" in key else "fwd", dp // 64, int(tc)),)
    return ("expm_tiled_kernel", "TiledILi{}ELb{}E".format(
        dp // 64, int(key.startswith("K4"))), "ELi{}EE".format(2 * int(tc)))


def tc_design(key, dp):
    """(shared-memory bytes a block, the product's design) of a tiled
    kernel's bf16_3x form, from the kernels' own layout
    (expm_cuda.tc_layout)."""
    from qoc_tpu_torch.ops import expm_cuda
    kernel = {"K3": 3, "K4": 4}.get(key[:2], 7 if " bwd" in key else 6)
    rows, stages, raw, split, smem, ring = expm_cuda.tc_layout(kernel, dp)
    if not stages:
        return smem, (
            "PR 11's form, 3 x TF32 mma.sync m16n8k8 on the {} x 64 panels "
            "transposed, fragments split at every read, a {}-stage raw "
            "cp.async ring ({} B a stage); the wgmma form measured slower at "
            "these shapes (profiling/tiled_variants.py)".format(rows, ring,
                                                                raw))
    return smem, (
        "wgmma m64n{}k8 TF32 (A and B from shared memory, the panel "
        "transposed), warpgroup 0 the real part and 1 the imaginary; each "
        "k-slice ({} B raw) loaded by all 256 threads into registers and "
        "split once into one of {} split stages ({} B: TF32 hi/lo planes, "
        "K-major, 128-byte swizzle) while the last slice's wgmma run"
        "".format(rows, raw, stages, split))


def _stream_mode_times(prefix, a_seg, n1, ninf, absa, gen):
    """ms of K6's forward and adjoint (both seed modes) on a_seg in the mode
    and exact, of the plain versions in the mode, and the bounds in both
    modes ("<prefix> fwd mode", "<prefix> bwd exact step", ...)."""
    from qoc_tpu_torch.ops import chain
    rows, length, dp = a_seg.shape[:3]
    pref = chain.stream_fwd(a_seg, n1, MODE)
    seeds = {"": torch.randn((rows, dp, dp), dtype=torch.complex64,
                             device=a_seg.device, generator=gen),
             " step": torch.randn((rows, length, dp, dp),
                                  dtype=torch.complex64, device=a_seg.device,
                                  generator=gen)}
    ms = _mode_times((prefix + " fwd", prefix + " bwd"), chain.stream_fwd,
                     chain.stream_bwd, chain.stream_fwd_plain,
                     chain.stream_bwd_plain, (a_seg, n1), (a_seg, ninf, pref),
                     seeds)
    bounds = {}
    for mode in (MODE, "highest"):
        tag = " mode" if mode == MODE else " exact"
        bounds[prefix + " fwd" + tag] = kernel_bound(
            absa.sum(-2).amax(-1), chain.ladder_level(n1), False,
            [a_seg, n1, pref], dp, mode=mode)
        for suffix, x in seeds.items():
            bounds[prefix + " bwd" + tag + suffix] = kernel_bound(
                absa.sum(-1).amax(-1), chain.ladder_level(ninf), True,
                [a_seg, ninf, pref, x, pref[:, 1:]], dp, mode=mode)
    return ms, bounds


def phase_mode_tiled_timing(dev):
    """Phase 41: the tiled kernels' bf16_3x forms timed beside their exact
    forms in the same call: K3/K4 at the d = 2^7 GRAPE's planes (as the
    blocked route calls them), K6 at the d = 20 cell's planes (both seed
    modes) and at a time block of the 4-member d = 20 ensemble (member
    rows); with the plain versions in the mode, torch.linalg.matrix_exp
    (K3/K4's library yardstick), the bounds of both modes, each kernel's
    design line and every tiled TC instantiation's ptxas registers and
    spills. Returns (ms, bounds) keyed as the kernels line reads them."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    gen = torch.Generator(device=dev).manual_seed(41)
    ms, bounds = {}, {}
    inputs = mode_path_inputs(dev)
    a, ah, g = inputs.pop("d128")
    dp = expm_cuda.kernel_dp(a.shape[-1])
    ms.update({
        "K3 tiled mode": cuda_ms(lambda: expm_cuda.expm_fwd(a, MODE), 10),
        "K3 tiled exact": cuda_ms(lambda: expm_cuda.expm_fwd(a, "highest"),
                                  10),
        "K3 tiled mode plain": cuda_ms(
            lambda: expm_cuda.expm_fwd_plain(a, MODE), 2),
        "K3 tiled mode library": cuda_ms(lambda: torch.linalg.matrix_exp(a),
                                         5),
        "K4 tiled mode": cuda_ms(
            lambda: expm_cuda.expm_frechet_fwd(ah, g, MODE), 10),
        "K4 tiled exact": cuda_ms(
            lambda: expm_cuda.expm_frechet_fwd(ah, g, "highest"), 10),
        "K4 tiled mode plain": cuda_ms(
            lambda: expm_cuda.expm_frechet_plain(ah, g, MODE), 2),
    })
    a_req = a.clone().requires_grad_(True)
    u = torch.linalg.matrix_exp(a_req)
    ms["K4 tiled mode library"] = cuda_ms(lambda: torch.autograd.grad(
        u, a_req, g, retain_graph=True), 3)
    del u, a_req
    lv3 = chain.ladder_level(expm_cuda._norm_max(a))
    lv4 = chain.ladder_level(expm_cuda._norm_max(ah))
    for mode in (MODE, "highest"):
        tag = " mode" if mode == MODE else " exact"
        bounds["K3 tiled" + tag] = kernel_bound(
            a.abs().sum(-2).amax(-1), lv3, False, [a, a], dp, chain=False,
            mode=mode)
        bounds["K4 tiled" + tag] = kernel_bound(
            ah.abs().sum(-2).amax(-1), lv4, True, [ah, g, g], dp,
            chain=False, mode=mode)
    lines = [("d=2^7 planes, K3/K4", tuple(a.shape), lv3, lv4)]
    designs = []
    for key, dual in (("K3 tiled mode", False), ("K4 tiled mode", True)):
        blocks = expm_cuda.launch_grid(dual, dp, a.shape[0], dev.index)[0]
        smem, product = tc_design(key, dp)
        designs.append(design_line(key, tiled_entry(key, dp, True), blocks, 1,
                                   smem, bounds[key][0], ms[key])
                       + "; " + product)
    del a, ah, g
    a_seg, n1, ninf, _, _, absa = inputs["d20"]
    out = _stream_mode_times("K6", a_seg, n1, ninf, absa, gen)
    ms.update(out[0])
    bounds.update(out[1])
    lines.append(("d=20 planes, K6", tuple(a_seg.shape),
                  chain.ladder_level(n1), chain.ladder_level(ninf)))
    m_seg, m1, minf, _, _, absm, n_members = inputs["member"]
    out = _stream_mode_times("K6 member", m_seg, m1, minf, absm, gen)
    ms.update(out[0])
    bounds.update(out[1])
    lines.append(("{}-member d=20 time block, K6 member".format(n_members),
                  tuple(m_seg.shape), chain.ladder_level(m1),
                  chain.ladder_level(minf)))
    dp = a_seg.shape[-1]
    for key, rows in (("K6 fwd mode", a_seg.shape[0]),
                      ("K6 bwd mode", a_seg.shape[0]),
                      ("K6 member fwd mode", m_seg.shape[0]),
                      ("K6 member bwd mode", m_seg.shape[0])):
        dual = " bwd" in key
        clusters = chain.stream_grid(dual, dp, rows, dev)[0]
        per_cluster = chain._stream_plan(dual, dp, dev.index)[1]
        smem, product = tc_design(key, dp)
        designs.append(design_line(key, tiled_entry(key, dp, True), clusters,
                                   per_cluster, smem, bounds[key][0],
                                   ms[key]) + "; " + product)
    torch.cuda.synchronize()
    print("phase 41 bf16_3x tiled timing ({}): ".format("; ".join(
        "{} {} levels {}/{}".format(*x) for x in lines))
        + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items()),
        flush=True)
    for key in sorted(k for k in bounds if " mode" in k):
        exact = key.replace(" mode", " exact")
        print("phase 41 bf16_3x {}: {:.3f} ms (exact {:.3f} ms, {:.2f}x), "
              "TF32 bound {:.3f} ms ({}, {:.1f} GFLOP) = {:.0%} of its time; "
              "exact kernel's FP32 bound {:.3f} ms = {:.0%}".format(
                  key, ms[key], ms[exact], ms[exact] / ms[key],
                  bounds[key][0], bounds[key][1], bounds[key][2],
                  bounds[key][0] / ms[key], bounds[exact][0],
                  bounds[exact][0] / ms[exact]), flush=True)
    for line in designs:
        print("phase 41 design: " + line, flush=True)
    print("phase 41 ptxas (registers / spill bytes) of the tiled kernels, "
          "exact -> bf16_3x: " + ", ".join(
              "{} dp {} {} -> {}".format(key, dp, "/".join(map(str, ptxas_report(
                  *tiled_entry(key, dp, False)))), "/".join(map(
                      str, ptxas_report(*tiled_entry(key, dp, True)))))
              for key, dps in (("K3", (128, 192, 256)), ("K4", (128, 192, 256)),
                               ("K6 fwd", (320, 384, 448, 512)),
                               ("K6 bwd", (320, 384, 448, 512)))
              for dp in dps), flush=True)
    return ms, bounds


def example1_problem():
    """examples/1_transmon_pi_decoherence.py's problem against the port: d
    = 2, H = σz/2 + c a + conj(c) a^H, T1 = 1000 on a, |0><0| to |1><1|,
    11 control points, one interval (2 system points), T = 10, maximum
    norm 5 and the flat initial controls the example's call makes; the
    keyword arguments of grape_lindblad_discrete, without ``method``
    (RKDP5, the default)."""
    from qoc_tpu_torch import ConstantLindblad, LinearHamiltonian
    from qoc_tpu_torch.core.common import initialize_controls
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    kw = lindblad_problem(2, 11, 2, 10.0)
    del kw["method"]
    controls, norms = initialize_controls(True, 1, 11, 10.0, None,
                                          np.array([5.0]))
    kw.update(hamiltonian=LinearHamiltonian(np.diag([0.5, -0.5]) + 0j,
                                            a[None]),
              lindblad_data=ConstantLindblad(np.array([1e-3]), a[None]),
              initial_controls=controls, max_control_norms=norms)
    return kw


def _rkdp5_counted(run, evaluations):
    """(run's result, its line of counts): the integrator's attempts and
    busy attempts an interval and host reads a loss (and gradient), from
    ``ops/rkdp5.py``'s counters around ``run()`` (``evaluations`` losses),
    and its wall time."""
    from qoc_tpu_torch.ops import rkdp5
    rkdp5.reset_counts()
    start = time.perf_counter()
    result = run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(rkdp5.counts)
    line = ("{:.1f} attempts an interval ({:.1f} busy), {:.1f} host reads "
            "a loss, {:.1f} s".format(
                counts["attempts"] / counts["integrations"],
                counts["busy"] / counts["integrations"],
                counts["host_reads"] / evaluations, seconds))
    return result, line


def _example1_grape(device, dtype, atol, iterations):
    """(result, counts line) of example 1's RKDP5 GRAPE (no ``method``)."""
    from qoc_tpu_torch import grape_lindblad_discrete
    return _rkdp5_counted(lambda: grape_lindblad_discrete(
        iteration_count=iterations, log_iteration_step=0, fused_chunk=1,
        atol=atol, rkdp5_max_steps=RKDP5_MAX_STEPS, device=device,
        dtype=dtype, **example1_problem()), iterations)


def _d20_evolve(device, method=None):
    """(result, counts line) of evolve_lindblad_discrete on the d = 20
    cell at its initial controls: RKDP5 in float64, or ``method``."""
    from qoc_tpu_torch import evolve_lindblad_discrete
    d20 = lindblad_d20_problem()
    kw = {k: d20[k] for k in ("evolution_time", "initial_densities",
                              "system_eval_count", "costs", "hamiltonian",
                              "lindblad_data")}
    if method is not None:
        return evolve_lindblad_discrete(controls=d20["initial_controls"],
                                        device=device, method=method, **kw)
    return _rkdp5_counted(lambda: evolve_lindblad_discrete(
        controls=d20["initial_controls"], device=device,
        dtype=torch.float64, **kw), 1)


def _rkdp5_cpu_references():
    """Phase 42's CPU runs, in a process of their own beside the card's:
    example 1's float64 GRAPE and the d = 20 evolve, as
    ((errors, it/s, line), (error, final densities, line))."""
    torch.set_num_threads(1)
    grape, grape_line = _example1_grape("cpu", torch.float64, 1e-12,
                                        RKDP5_ITERATIONS)
    evolved, evolve_line = _d20_evolve("cpu")
    return ((np.asarray(grape.errors), grape.iterations_per_s, grape_line),
            (evolved.error, evolved.final_densities, evolve_line))


def phase_rkdp5(dev, card=None):
    """Phase 42: the adaptive RKDP5 integrator, qoc_tpu's default Lindblad
    method, through the public entry points called without ``method``
    (plain torch on the card; no kernel of csrc/ runs). (a) example 1 in
    float64 at the reference's atol 1e-12 and rkdp5_max_steps 16384, 3
    Adam iterations, the errors finite, falling and within RKDP5_CPU_TOL of
    the same run on the CPU; (b) the same at atol 1e-8 in float32, its
    first error within RKDP5_F32_TOL of (a)'s; (c) evolve_lindblad_discrete
    on the d = 20 cell in float64 against the CPU, with the gap to the
    MAGNUS_EXPM route (K6, float32); (d) a 4-member ensemble at d = 2 in
    float64, each member's error equal to its single-member run within
    RKDP5_LANE_TOL (the lanes independent), then a 16-candidate multistart
    in float32 at atol 1e-8 for 2 iterations. The CPU runs go in a spawned
    process beside the card's. Every line has the integrator's attempts an
    interval, host reads a loss, it/s and the card. Returns the it/s of
    the summary."""
    import concurrent.futures
    import multiprocessing
    from qoc_tpu_torch import (EnsembleLinearHamiltonian,
                               grape_lindblad_multistart)
    from qoc_tpu_torch.models import LindbladMethod
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    card = _card(card)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(_rkdp5_cpu_references)
        card_runs = {}
        for label, dtype, atol, iterations in (
                ("float64", torch.float64, 1e-12, RKDP5_ITERATIONS),
                ("float32", torch.float32, RKDP5_F32_ATOL,
                 RKDP5_F32_ITERATIONS)):
            result, line = _example1_grape(dev, dtype, atol, iterations)
            card_runs[label] = result
            errors = np.asarray(result.errors)
            print("phase 42 example 1 RKDP5 GRAPE, card {} (atol {:g}): {} "
                  "iterations, {:.2f} it/s steady, errors {}; {} | {}".format(
                      label, atol, iterations, result.iterations_per_s,
                      np.array2string(errors, precision=12), line, card),
                  flush=True)
            if not (result.iteration_count_ran == iterations
                    and np.all(np.isfinite(errors))
                    and np.all(np.diff(errors) < 0)):
                raise RuntimeError("example 1 RKDP5 GRAPE ({}) did not run "
                                   "finite and falling".format(label))
        evolved, line = _d20_evolve(dev)
        print("phase 42 d=20 RKDP5 evolve, card float64 ({} intervals): "
              "error {:.12f}; {} | {}".format(
                  D20_POINTS - 1, evolved.error, line, card), flush=True)
        magnus = _d20_evolve(dev, LindbladMethod.MAGNUS_EXPM)
        (cpu_errors, cpu_it_s, grape_line), (cpu_error, cpu_densities,
                                             evolve_line) = cpu_future.result()
    print("phase 42 example 1 RKDP5 GRAPE, cpu float64 (atol 1e-12): {} "
          "iterations, {:.2f} it/s steady, errors {}; {}".format(
              RKDP5_ITERATIONS, cpu_it_s,
              np.array2string(cpu_errors, precision=12), grape_line),
          flush=True)
    gap_cpu = float(np.abs(card_runs["float64"].errors - cpu_errors).max())
    gap_f32 = abs(float(card_runs["float32"].errors[0])
                  - float(card_runs["float64"].errors[0]))
    print("phase 42 example 1: card vs cpu float64 errors max|diff| {:.3e} "
          "(limit {:g}); float32 atol {:g} vs float64 first error |diff| "
          "{:.3e} (limit {:g})".format(gap_cpu, RKDP5_CPU_TOL,
                                       RKDP5_F32_ATOL, gap_f32,
                                       RKDP5_F32_TOL), flush=True)
    if gap_cpu > RKDP5_CPU_TOL or gap_f32 > RKDP5_F32_TOL:
        raise RuntimeError("example 1 RKDP5 disagrees across devices or "
                           "dtypes")
    gap = float(np.abs(evolved.final_densities - cpu_densities).max())
    gap_magnus = float(np.abs(evolved.final_densities
                              - magnus.final_densities).max())
    print("phase 42 d=20 RKDP5 evolve, cpu float64: error {:.12f}; {}; card "
          "vs cpu densities max|diff| {:.3e} (limit {:g}); vs MAGNUS_EXPM "
          "(K6, float32) max|diff| {:.3e}, error {:.3e}".format(
              cpu_error, evolve_line, gap, RKDP5_CPU_TOL, gap_magnus,
              abs(magnus.error - evolved.error)), flush=True)
    if not (np.all(np.isfinite(evolved.final_densities))
            and gap <= RKDP5_CPU_TOL and gap_magnus < 1e-3):
        raise RuntimeError("the d = 20 RKDP5 evolve disagrees")
    # (d) Lanes: members, then candidates.
    kw = example1_problem()
    h0 = np.diag([0.5, -0.5]).astype(complex)
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    members = dict(kw, method=LindbladMethod.RKDP5,
                   hamiltonian=EnsembleLinearHamiltonian(h0, a[None],
                                                         h0[None]),
                   hamiltonian_params=np.linspace(
                       -EXAMPLE6_DELTA, EXAMPLE6_DELTA,
                       RKDP5_MEMBERS).reshape(-1, 1))
    pstate = lindblad_pstate(members)
    pstate.atol = RKDP5_LANE_ATOL
    controls = torch.as_tensor(members["initial_controls"],
                               dtype=torch.complex128, device=dev)[None]
    params = members["hamiltonian_params"]
    with torch.no_grad():
        together, line = _rkdp5_counted(lambda: build_chain_loss(
            pstate, members["hamiltonian"], params, dev, torch.float64)(
                controls)[0][0].cpu().numpy(), 1)
        alone = np.array([float(build_chain_loss(
            pstate, members["hamiltonian"], params[m:m + 1], dev,
            torch.float64)(controls)[0][0, 0]) for m in range(RKDP5_MEMBERS)])
    lane_gap = float(np.abs(together - alone).max())
    print("phase 42 {}-member RKDP5 ensemble loss (d=2, float64, atol {:g}): "
          "errors {}, each against its member alone max|diff| {:.3e} (limit "
          "{:g}); {} | {}".format(
              RKDP5_MEMBERS, RKDP5_LANE_ATOL,
              np.array2string(together, precision=12), lane_gap,
              RKDP5_LANE_TOL, line, card), flush=True)
    if lane_gap > RKDP5_LANE_TOL or len(set(together.tolist())) < 2:
        raise RuntimeError("the RKDP5 lanes are not independent on the card")
    result, line = _rkdp5_counted(lambda: grape_lindblad_multistart(
        n_starts=RKDP5_CANDIDATES, iteration_count=RKDP5_MS_ITERATIONS,
        log_iteration_step=0, fused_chunk=1, atol=RKDP5_F32_ATOL,
        device=dev, **kw), RKDP5_MS_ITERATIONS)
    print("phase 42 {}-candidate RKDP5 multistart (d=2, float32, atol {:g}):"
          " {} iterations, {:.2f} cand-it/s steady, best error {:.8f}; {} | "
          "{}".format(RKDP5_CANDIDATES, RKDP5_F32_ATOL, RKDP5_MS_ITERATIONS,
                      result.iterations_per_s, result.best_error, line, card),
          flush=True)
    if not (np.all(np.isfinite(result.errors))
            and result.iteration_count_ran == RKDP5_MS_ITERATIONS):
        raise RuntimeError("the RKDP5 multistart failed its checks")
    return {"example 1 float64": card_runs["float64"].iterations_per_s,
            "example 1 float32": card_runs["float32"].iterations_per_s,
            "{}-candidate multistart".format(RKDP5_CANDIDATES):
            result.iterations_per_s}


def _example1_lbfgsb(device):
    """Example 1's RKDP5 GRAPE (float64, the reference's atol 1e-12) with
    LBFGSB() on the host loop."""
    from qoc_tpu_torch import LBFGSB, grape_lindblad_discrete
    return grape_lindblad_discrete(
        iteration_count=EXAMPLE1_LBFGSB_ITERATIONS, log_iteration_step=0,
        optimizer=LBFGSB(), atol=1e-12, rkdp5_max_steps=RKDP5_MAX_STEPS,
        device=device, dtype=torch.float64, **example1_problem())


def _example1_lbfgsb_cpu():
    """Phase 43's CPU run, in a process of its own: (errors, it/s)."""
    torch.set_num_threads(1)
    result = _example1_lbfgsb("cpu")
    return np.asarray(result.errors), result.iterations_per_s


def _counted_lbfgsb():
    """An LBFGSB that keeps scipy's result (its iterations and
    evaluations)."""
    from qoc_tpu_torch import LBFGSB

    class CountedLBFGSB(LBFGSB):
        def run(self, *args, **kwargs):
            self.result = super().run(*args, **kwargs)
            return self.result

    return CountedLBFGSB()


def _headline_lbfgs(kw, mode, hook=None):
    """The headline GRAPE with LBFGS() for LBFGS_ITERATIONS in ``mode``,
    counters read around it: (result, launches)."""
    from qoc_tpu_torch import LBFGS, grape_schroedinger_discrete
    with precision(mode):
        reset_launches()
        result = grape_schroedinger_discrete(
            complex_controls=True, iteration_count=LBFGS_ITERATIONS,
            log_iteration_step=0, optimizer=LBFGS(), fused_chunk=1,
            impose_control_conditions=hook, **kw)
        launches = read_launches()
    return result, launches


def phase_host_loop(dev, card=None):
    """Phase 43: the optimizers and the host loop at full width (module
    docstring). Returns the it/s of the summary."""
    import concurrent.futures
    import multiprocessing
    from qoc_tpu_torch import (LBFGS, grape_schroedinger_discrete,
                               grape_schroedinger_multistart)
    from qoc_tpu_torch.ops.chain import chain_block_plan
    card = _card(card)
    rates = {}
    ls_steps = LBFGS().ls_steps
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(_example1_lbfgsb_cpu)
        pstate, ham, costs = table3_problem(1)
        kw = _problem_kw(pstate, ham, costs, dev)
        fused = {}
        for mode in ("highest", MODE):
            result, launches = _headline_lbfgs(kw, mode)
            fused[mode] = result
            errors = np.asarray(result.errors)
            want = {"K1": LBFGS_ITERATIONS * (ls_steps + 2),
                    "K2": LBFGS_ITERATIONS}
            if mode != "highest":
                want.update({key + " mode": n for key, n in
                             list(want.items())})
            print("phase 43 headline LBFGS ({}): {} iterations, {:.2f} it/s "
                  "steady, errors {}, best {:.6f}, launches {} | {}".format(
                      mode, result.iteration_count_ran,
                      result.iterations_per_s,
                      np.array2string(errors, precision=8),
                      result.best_error, launches, card), flush=True)
            if any(n != want.get(key, 0) for key, n in launches.items()):
                raise RuntimeError(
                    "the headline LBFGS ({}) did not launch K1 {} and K2 {} "
                    "times an iteration and nothing else".format(
                        mode, ls_steps + 2, 1))
            if not (result.iteration_count_ran == LBFGS_ITERATIONS
                    and np.all(np.isfinite(errors))
                    and result.best_error < errors[0]):
                raise RuntimeError("the headline LBFGS ({}) did not run "
                                   "finite and improving".format(mode))
            rates["headline LBFGS " + mode] = result.iterations_per_s
        host, _ = _headline_lbfgs(kw, "highest", hook=lambda c: c)
        twin = np.asarray(fused["highest"].errors[:2])
        host_errors = np.asarray(host.errors[:2])
        gap = float(np.max(np.abs(host_errors - twin) / np.abs(twin)))
        print("phase 43 headline LBFGS through an identity hook (host loop): "
              "{} evaluations, {:.2f} evaluations/s, errors {}; iterations 0 "
              "and 1 against the fused run's relative {:.3e} (limit {:g}) | "
              "{}".format(host.iteration_count_ran, host.iterations_per_s,
                          np.array2string(np.asarray(host.errors),
                                          precision=8),
                          gap, HOST_TWIN_RTOL, card), flush=True)
        if not gap <= HOST_TWIN_RTOL:
            raise RuntimeError("the host L-BFGS disagrees with the fused one")
        rates["headline LBFGS host loop"] = host.iterations_per_s
        optimizer = _counted_lbfgsb()
        reset_launches()
        start = time.perf_counter()
        result = grape_schroedinger_discrete(
            complex_controls=True, iteration_count=LBFGSB_ITERATIONS,
            log_iteration_step=0, optimizer=optimizer, **kw)
        seconds = time.perf_counter() - start
        launches = read_launches()
        errors = np.asarray(result.errors)
        nit = optimizer.result.nit
        print("phase 43 headline LBFGSB: {} scipy iterations in {:.2f} s "
              "({:.2f} it/s), {} loss evaluations ({:.2f} an iteration; "
              "scipy's nfev {}), error {:.6f} -> best {:.6f}, launches K1 {} "
              "K2 {} | {}".format(
                  nit, seconds, nit / seconds, result.iteration_count_ran,
                  result.iteration_count_ran / max(nit, 1),
                  optimizer.result.nfev, errors[0], result.best_error,
                  launches["K1"], launches["K2"], card), flush=True)
        if not (nit >= 1 and np.all(np.isfinite(errors))
                and result.best_error < errors[0]
                and launches["K2"] == result.iteration_count_ran):
            raise RuntimeError("the headline LBFGSB did not run finite and "
                               "falling")
        rates["headline LBFGSB"] = nit / seconds
        card_run = _example1_lbfgsb(dev)
        cpu_errors, cpu_it_s = cpu_future.result()
    card_errors = np.asarray(card_run.errors)
    gap = (float(np.abs(card_errors - cpu_errors).max())
           if card_errors.shape == cpu_errors.shape else float("inf"))
    print("phase 43 example 1 RKDP5 LBFGSB (float64, atol 1e-12, {} "
          "iterations): card {} evaluations {:.3f} evaluations/s, errors {}; "
          "cpu {} evaluations {:.3f}/s, errors {}; max|diff| {:.3e} (limit "
          "{:g}) | {}".format(
              EXAMPLE1_LBFGSB_ITERATIONS, card_errors.size,
              card_run.iterations_per_s,
              np.array2string(card_errors, precision=12), cpu_errors.size,
              cpu_it_s, np.array2string(cpu_errors, precision=12), gap,
              RKDP5_CPU_TOL, card), flush=True)
    if not (np.all(np.isfinite(card_errors)) and gap <= RKDP5_CPU_TOL
            and card_run.best_error < card_errors[0]):
        raise RuntimeError("example 1 with LBFGSB disagrees across devices "
                           "or did not fall")
    rates["example 1 RKDP5 LBFGSB"] = card_run.iterations_per_s
    problem = multistart_problem()
    pstate, ham, costs = problem
    n_steps = pstate.system_eval_count - 1
    blocks = -(-n_steps // chain_block_plan(D, n_steps, 8, 2,
                                            LBFGS_CANDIDATES))
    initial = grape_schroedinger_discrete(
        complex_controls=True, iteration_count=0, log_iteration_step=0,
        **_problem_kw(pstate, ham, costs, dev))
    reset_launches()
    result = grape_schroedinger_multistart(
        CONTROL_COUNT, pstate.control_eval_count, costs,
        pstate.evolution_time, ham, pstate.initial_states,
        pstate.system_eval_count, n_starts=LBFGS_CANDIDATES,
        complex_controls=True, iteration_count=LBFGS_MS_ITERATIONS,
        log_iteration_step=0, optimizer=LBFGS(), fused_chunk=1, device=dev)
    launches = read_launches()
    errors = np.asarray(result.errors)
    want = {"K1": blocks * (LBFGS_MS_ITERATIONS * (ls_steps + 2) + 1),
            "K2": blocks * LBFGS_MS_ITERATIONS}
    print("phase 43 {}-candidate multistart LBFGS: {} iterations, {:.1f} "
          "candidate-it/s steady, best error {:.6f} (candidate 0's initial "
          "{:.6f}, median best {:.6f}), launches K1 {} K2 {} (want {}) | "
          "{}".format(LBFGS_CANDIDATES, result.iteration_count_ran,
                      result.iterations_per_s, result.best_error,
                      initial.best_error, float(np.median(errors)),
                      launches["K1"], launches["K2"], want, card),
          flush=True)
    if not (result.iteration_count_ran == LBFGS_MS_ITERATIONS
            and errors.shape == (LBFGS_CANDIDATES,)
            and np.all(np.isfinite(errors))
            and result.best_error < initial.best_error
            and all(launches[key] == n for key, n in want.items())):
        raise RuntimeError("the LBFGS multistart failed its checks")
    rates["{}-candidate multistart LBFGS".format(LBFGS_CANDIDATES)] = \
        result.iterations_per_s
    return rates


class _MemoryFile(dict):
    """An in-memory stand-in for an open h5py.File: datasets as numpy
    arrays (written in place by row), groups as nested _MemoryFiles."""

    def __setitem__(self, key, value):
        super().__setitem__(key, np.array(value))

    def require_group(self, name):
        if name not in self:
            dict.__setitem__(self, name, _MemoryFile())
        return self[name]


def _memory_checkpointer():
    """H5Checkpointer's writer over _MemoryFiles (``files``, by path), for
    a machine without h5py: the writes and reads of qoc_tpu_torch.io.h5
    run as they are, on memory instead of a file."""
    from qoc_tpu_torch.io.h5 import H5Checkpointer

    class MemoryCheckpointer(H5Checkpointer):
        files = {}

        def __init__(self, save_file_path):
            self.save_file_path = save_file_path
            self.lock_path = save_file_path + ".lock"
            self._writes_enabled = True

        def _locked_write(self, fn, mode="a", what="save"):
            if mode == "w" or self.save_file_path not in self.files:
                self.files[self.save_file_path] = _MemoryFile()
            fn(self.files[self.save_file_path])

        def load_optimizer_state(self):
            f = self.files.get(self.save_file_path, {})
            if "optimizer_state" not in f:
                return None
            return {key: np.array(value)
                    for key, value in f["optimizer_state"].items()}

    return MemoryCheckpointer


@contextlib.contextmanager
def _save_files(card):
    """(path(name), read(path) -> {dataset: array}) for phase 44: H5 files
    in a temporary directory where h5py imports, else (printed on a line
    of its own) qoc_tpu_torch.io.h5's writer on memory."""
    import tempfile
    from qoc_tpu_torch.io import h5
    try:
        import h5py
    except ImportError:
        h5py = None
    with tempfile.TemporaryDirectory(prefix="qoc_save_") as root:
        def path(name):
            return str(Path(root) / name)
        if h5py is not None:
            def read(file_path):
                out = {}
                with h5py.File(file_path, "r") as f:
                    f.visititems(lambda key, obj: out.__setitem__(
                        key, obj[()]) if isinstance(obj, h5py.Dataset)
                        else None)
                return out
            print("phase 44 h5py {}: save files written to disk | {}".format(
                h5py.__version__, card), flush=True)
            yield path, read
            return
        print("phase 44 h5py is not installed on this machine: the save "
              "files go through qoc_tpu_torch.io.h5's writer on memory "
              "(the file schema is held by the CPU tests) | {}".format(card),
              flush=True)
        memory = _memory_checkpointer()
        real = h5.H5Checkpointer

        def read(file_path):
            out = {}

            def walk(group, prefix):
                for key, value in group.items():
                    if isinstance(value, _MemoryFile):
                        walk(value, prefix + key + "/")
                    else:
                        out[prefix + key] = value
            walk(memory.files[file_path], "")
            return out
        h5.H5Checkpointer = memory
        try:
            yield path, read
        finally:
            h5.H5Checkpointer = real
            memory.files.clear()


def _saved_rows_rel(got, want, keys, rows=slice(None)):
    """The largest relative distance over ``keys`` (their ``rows``) of two
    saved files."""
    return max(_rel(torch.as_tensor(np.asarray(got[key])[rows]),
                    torch.as_tensor(np.asarray(want[key])[rows]))
               for key in keys)


def phase_save_resume(dev, card=None):
    """Phase 44: save files and resume at full width (module docstring).
    Returns the headline's it/s by save_iteration_step."""
    from qoc_tpu_torch import (LBFGSB, grape_schroedinger_discrete,
                               grape_schroedinger_multistart)
    card = _card(card)
    pstate, ham, costs = table3_problem(1)
    kw = dict(_problem_kw(pstate, ham, costs, dev), complex_controls=True,
              log_iteration_step=0)
    rows = ("controls", "error", "grads", "final_states",
            "intermediate_states")
    with _save_files(card) as (path, read):
        def headline(file_path, iterations, **extra):
            reset_launches()
            result = grape_schroedinger_discrete(
                iteration_count=iterations, fused_chunk=SAVE_CHUNK,
                save_iteration_step=SAVE_STEP, save_file_path=file_path,
                save_intermediate_states=True, **kw, **extra)
            return result, read_launches()

        def check_launches(label, launches, iterations, save_rows):
            want = {"K1": iterations + save_rows, "K2": iterations}
            print("phase 44 {}: launches {} (K1 once an iteration and once "
                  "a save row for its trajectory, K2 once an iteration: "
                  "{})".format(label, {k: n for k, n in launches.items()
                                       if n}, want), flush=True)
            if any(n != want.get(key, 0) for key, n in launches.items()):
                raise RuntimeError("phase 44 {} launched {}, not {}".format(
                    label, launches, want))

        start = time.perf_counter()
        full, launches = headline(path("a.h5"), SAVE_ITERATIONS)
        def save_iterations(first, stop):
            return sum(1 for i in range(first, stop)
                       if i % SAVE_STEP == 0 or i == stop - 1)

        check_launches("run A ({} iterations)".format(SAVE_ITERATIONS),
                       launches, SAVE_ITERATIONS,
                       save_iterations(0, SAVE_ITERATIONS))
        first, _ = headline(path("b.h5"), SAVE_STOP)
        resumed, launches = headline(path("b.h5"), SAVE_ITERATIONS,
                                     resume_from=path("b.h5"))
        check_launches("run B resumed at iteration {}".format(SAVE_STOP),
                       launches, SAVE_ITERATIONS - SAVE_STOP,
                       save_iterations(SAVE_STOP, SAVE_ITERATIONS))
        a, b = read(path("a.h5")), read(path("b.h5"))
        errors = np.concatenate((first.errors, resumed.errors))
        # The stopped run's final iteration (3) wrote its row (1) over
        # iteration 2's, as the reference's final-iteration save does;
        # that row holds A's iteration 3.
        overwritten = (SAVE_STOP - 1) // SAVE_STEP
        same = [r for r in range(a["error"].shape[0]) if r != overwritten]
        rel_rows = max(_saved_rows_rel(b, a, rows, same), abs(
            b["error"][overwritten] - full.errors[SAVE_STOP - 1])
            / abs(full.errors[SAVE_STOP - 1]))
        rel_errors = float(np.max(np.abs(errors - full.errors)
                                  / np.abs(full.errors)))
        rel_params = _saved_rows_rel(b, a, ("optimizer_state/__params__",))
        print("phase 44 headline save and resume (save_iteration_step {}, "
              "chunk {}, intermediate states): run A {} iterations, run B "
              "{} then resumed into its file to {}; B against A rel rows "
              "{:.3e}, errors {:.3e}, final params {:.3e} (limit {:g}); "
              "rows {} of {} intermediate states each, t {} | {:.1f} s | "
              "{}".format(SAVE_STEP, SAVE_CHUNK, SAVE_ITERATIONS, SAVE_STOP,
                          SAVE_ITERATIONS, rel_rows, rel_errors, rel_params,
                          SAVE_RTOL, a["error"].shape[0],
                          a["intermediate_states"].shape[1],
                          b["optimizer_state/opt['t']"],
                          time.perf_counter() - start, card), flush=True)
        if not (max(rel_rows, rel_errors, rel_params) <= SAVE_RTOL
                and b["error"].shape == a["error"].shape
                and int(b["optimizer_state/opt['t']"]) == SAVE_ITERATIONS):
            raise RuntimeError("the resumed headline run differs from the "
                               "uninterrupted one")
        rates = {}
        for step in SAVE_RATE_STEPS:
            result = grape_schroedinger_discrete(
                iteration_count=SAVE_RATE_ITERATIONS,
                fused_chunk=SAVE_RATE_CHUNK, save_iteration_step=step,
                save_file_path=path("rate.h5") if step else None, **kw)
            rates[step] = result.iterations_per_s
        print("phase 44 headline it/s by save_iteration_step (rows and a "
              "snapshot a chunk of {}, no intermediate states): {} | "
              "{}".format(SAVE_RATE_CHUNK, ", ".join(
                  "{} {:.2f}".format(step, rate)
                  for step, rate in rates.items()), card), flush=True)

        host = dict(kw, save_iteration_step=1, optimizer=None)
        stopped = grape_schroedinger_discrete(
            iteration_count=SAVE_HOST_STOP, save_file_path=path("c.h5"),
            **dict(host, optimizer=LBFGSB()))
        keys = sorted(key for key in read(path("c.h5"))
                      if key.startswith("optimizer_state/"))
        resumed = grape_schroedinger_discrete(
            iteration_count=SAVE_HOST_STOP + 1, resume_from=path("c.h5"),
            save_file_path=path("c2.h5"), **dict(host, optimizer=LBFGSB()))
        # The host loop saves evaluations 0 .. iteration_count - 1 and
        # snapshots each before scipy's next step: the resumed run starts
        # by evaluating the last saved one again.
        want = stopped.errors[SAVE_HOST_STOP - 1]
        gap = abs(resumed.errors[0] - want) / abs(want)
        print("phase 44 headline LBFGSB host loop: {} evaluations, "
              "checkpoint {}; resumed at evaluation {}: its first error "
              "{:.8f} against {:.8f} (rel {:.3e}), {} evaluations | "
              "{}".format(stopped.iteration_count_ran, keys,
                          SAVE_HOST_STOP - 1, resumed.errors[0], want, gap,
                          resumed.iteration_count_ran, card), flush=True)
        if gap > SAVE_RTOL or not np.all(np.isfinite(resumed.errors)):
            raise RuntimeError("the LBFGSB host loop did not resume at its "
                               "checkpoint")

        ms_pstate, ms_ham, ms_costs = multistart_problem()
        ms = dict(_problem_kw(ms_pstate, ms_ham, ms_costs, dev),
                  complex_controls=True, log_iteration_step=0,
                  n_starts=ROBUST_CANDIDATES, fused_chunk=SAVE_CHUNK,
                  save_iteration_step=1)
        uninterrupted = grape_schroedinger_multistart(
            iteration_count=SAVE_MS_ITERATIONS, save_file_path=path("d.h5"),
            **ms)
        grape_schroedinger_multistart(
            iteration_count=SAVE_CHUNK, save_file_path=path("e.h5"), **ms)
        resumed = grape_schroedinger_multistart(
            iteration_count=SAVE_MS_ITERATIONS, save_file_path=path("e.h5"),
            resume_from=path("e.h5"), **ms)
        d, e = read(path("d.h5")), read(path("e.h5"))
        rel = max(_saved_rows_rel(e, d, ("controls", "error",
                                         "final_states")),
                  _rel(torch.as_tensor(resumed.errors),
                       torch.as_tensor(uninterrupted.errors)))
        print("phase 44 {}-candidate multistart: {} iterations, and {} "
              "resumed from its checkpoint to {}: winner rows and every "
              "candidate's best error rel {:.3e} (limit {:g}), winner "
              "{:.6f} / {:.6f} | {}".format(
                  ROBUST_CANDIDATES, SAVE_MS_ITERATIONS, SAVE_CHUNK,
                  SAVE_MS_ITERATIONS, rel, SAVE_RTOL, resumed.best_error,
                  uninterrupted.best_error, card), flush=True)
        if rel > SAVE_RTOL:
            raise RuntimeError("the resumed multistart differs from the "
                               "uninterrupted one")
    return rates


def _expm_impl(impl, mode, a, g):
    """expm of ``a`` and its gradient for the output gradient ``g`` under
    set_expm_forward(impl) in precision ``mode``, the choice restored
    after: (output, gradient, launches)."""
    import importlib
    expm_mod = importlib.import_module("qoc_tpu_torch.ops.expm")
    expm_mod.set_expm_forward(impl)
    try:
        with precision(mode):
            reset_launches()
            x = a.clone().requires_grad_(True)
            out = expm_mod.expm(x)
            grad, = torch.autograd.grad(out, x, g)
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        expm_mod.set_expm_forward("auto")
    return out.detach(), grad, launches


def _approximant_ms(mode, a, g):
    """{impl: (forward ms, forward + gradient ms, slowest forward +
    gradient ms)} of expm under set_expm_forward("taylor") and ("pade")
    in precision ``mode``: each call timed alone with CUDA events, the two
    approximants interleaved (a b b a) over APPROXIMANT_ROUNDS rounds after
    a warm-up, the fastest call of each kept, and the slowest with the
    gradient (its spread)."""
    import importlib
    expm_mod = importlib.import_module("qoc_tpu_torch.ops.expm")
    x = a.clone().requires_grad_(True)
    calls = {"forward": lambda: expm_mod.expm(a),
             "both": lambda: torch.autograd.grad(expm_mod.expm(x), x, g)}
    times = {}

    def timed(impl, what):
        expm_mod.set_expm_forward(impl)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls[what]()
        end.record()
        torch.cuda.synchronize()
        times.setdefault((impl, what), []).append(start.elapsed_time(end))

    try:
        with precision(mode):
            for what in calls:
                for impl in ("taylor", "pade"):
                    timed(impl, what)
            times.clear()
            for what in calls:
                for _ in range(APPROXIMANT_ROUNDS):
                    for impl in ("taylor", "pade", "pade", "taylor"):
                        timed(impl, what)
    finally:
        expm_mod.set_expm_forward("auto")
    return {impl: (min(times[impl, "forward"]), min(times[impl, "both"]),
                   max(times[impl, "both"]))
            for impl in ("taylor", "pade")}


def phase_approximants(dev, card=None):
    """Phase 45: expm's forward choice (set_expm_forward) on the card. Each
    name against float64 matrix_exp and its autograd, with its launches
    (K3/K4 under "auto" and "pallas" at padded <= 256, nothing under
    "taylor" and "pade" or above 256); then Padé-13 against Taylor at
    forward and forward plus gradient, complex64, in both modes, on
    APPROXIMANT_CASES and phase 14's own step, and "auto"'s choice above
    padded 256 against the faster. Returns the table."""
    import importlib
    expm_mod = importlib.import_module("qoc_tpu_torch.ops.expm")
    card = _card(card)
    gen = torch.Generator(device=dev).manual_seed(45)
    for d in APPROXIMANT_CHECK_DIMS:
        a = _random_planes(gen, 3, d, APPROXIMANT_NORM, dev)
        g = torch.randn(a.shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        a64 = a.to(torch.complex128).requires_grad_(True)
        u64 = torch.linalg.matrix_exp(a64)
        grad64, = torch.autograd.grad(u64, a64, g.to(torch.complex128))
        rows = []
        for mode in ("highest", MODE):
            for impl in ("auto", "pallas", "taylor", "pade"):
                out, grad, launches = _expm_impl(impl, mode, a, g)
                fwd = _rel(out.to(torch.complex128), u64.detach())
                bwd = _rel(grad.to(torch.complex128), grad64)
                kernels = d <= 256 and impl in ("auto", "pallas")
                want = {"K3": 1, "K4": 1} if kernels else {}
                if mode == MODE and kernels:
                    want.update({"K3 mode": 1, "K4 mode": 1})
                got = {k: n for k, n in launches.items() if n}
                rows.append("{} {} {:.1e}/{:.1e} {}".format(
                    mode, impl, fwd, bwd, got or "no launch"))
                if got != want:
                    raise RuntimeError(
                        "expm under {!r} ({}) at d = {} launched {}, not "
                        "{}".format(impl, mode, d, got, want))
                if not (fwd <= FWD_RTOL and bwd <= GRAD_RTOL):
                    raise RuntimeError(
                        "expm under {!r} ({}) at d = {} is {:.2e} / {:.2e} "
                        "from float64".format(impl, mode, d, fwd, bwd))
        print("phase 45 set_expm_forward at d = {} (padded {}), batch 3, "
              "norm {}: mode impl rel forward/gradient vs float64, "
              "launches: {}".format(d, expm_mod.kernel_dp(d),
                                    APPROXIMANT_NORM, "; ".join(rows)),
              flush=True)
    pstate, hamiltonian, _ = d1024_problem()
    cases = [(d, batch, APPROXIMANT_NORM) for d, batch in APPROXIMANT_CASES]
    cases.append((D1024, 1, None))
    table, slower = [], []
    for d, batch, norm in cases:
        if norm is None:
            a = initial_planes(pstate, hamiltonian, dev)
            label = "phase 14's step"
        else:
            a = _random_planes(gen, batch, d, norm, dev)
            label = "norm {}".format(norm)
        g = torch.randn(a.shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        for mode in ("highest", MODE):
            times = _approximant_ms(mode, a, g)
            taylor, pade = times["taylor"], times["pade"]
            faster = "pade" if pade[1] < taylor[1] else "taylor"
            auto = expm_mod.approximant(d, dev)
            chosen, other = ((pade, taylor) if auto == "pade"
                             else (taylor, pade))
            # auto loses where it is slower beyond APPROXIMANT_TIE and
            # every call of it was slower than every call of the other;
            # where the two spreads overlap the winner is unresolved.
            resolved = chosen[1] > other[2] or other[1] > chosen[2]
            table.append({"d": d, "batch": batch, "planes": label,
                          "mode": mode, "taylor_ms": taylor,
                          "pade_ms": pade, "faster": faster, "auto": auto,
                          "resolved": resolved})
            print("phase 45 approximants d = {}, batch {}, {} ({}): Taylor "
                  "{:.3f} ms forward, {:.3f} ms with the gradient (slowest "
                  "{:.3f}); Padé-13 {:.3f} / {:.3f} ({:.3f}) ms; faster {}{}, "
                  "auto takes {} | {}".format(
                      d, batch, label, mode, *taylor, *pade, faster,
                      "" if resolved else " (spreads overlap: unresolved)",
                      auto, card), flush=True)
            if (chosen[1] > APPROXIMANT_TIE * other[1]
                    and chosen[1] > other[2]):
                slower.append("d = {}, batch {}, {} ({}): auto takes {}, "
                              "{} is faster".format(d, batch, label, mode,
                                                    auto, faster))
    if slower:
        raise RuntimeError("expm's auto choice is slower than the other "
                           "approximant beyond {:.0%}: {}".format(
                               APPROXIMANT_TIE - 1, "; ".join(slower)))
    return table


def run_phase(phase, *args):
    """Call a phase and print its wall time (host clock)."""
    start = time.perf_counter()
    out = phase(*args)
    print("({} took {:.1f} s)".format(phase.__name__,
                                      time.perf_counter() - start),
          flush=True)
    return out


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
    start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Phases 1-35 check the exact kernels whatever QOC_TPU_MXU_PRECISION
    # says; phases 36-41 set the bf16_3x mode where they run it.
    from qoc_tpu_torch import config
    config.MXU_MODE = "highest"
    dev = torch.device("cuda", 0)
    build_s = phase_build()
    if args.phases:
        for phase in args.phases.split(","):
            run_phase(STANDALONE[int(phase)], dev)
        return
    pstate, _, _ = table3_problem(1)
    headline_w = headline_weights(pstate, dev)
    worst = run_phase(phase_kernels, dev, headline_w)
    run_phase(phase_headline, dev)
    launches, it_s = run_phase(phase_grape, dev)
    ms, bounds = run_phase(phase_timing, dev, headline_w)
    worst.update(run_phase(phase_plane_kernels, dev))
    run_phase(phase_cross_route, dev)
    m4_launches, m4_it_s = run_phase(phase_m4_grape, dev)
    plane_ms, plane_bounds = run_phase(phase_plane_timing, dev)
    launches.update({k: m4_launches[k] for k in ("K5 fwd", "K5 bwd")})
    ms.update(plane_ms)
    bounds.update(plane_bounds)
    run_phase(phase_expm_kernels, dev)
    d128_launches, d128_it_s = run_phase(phase_d128_grape, dev)
    launches.update({k: d128_launches[k] for k in ("K3", "K4")})
    route_ms = run_phase(phase_blocked_vs_plane, dev)
    backprop_ms = run_phase(phase_d1024_backprop, dev)
    expm_ms, expm_bounds, expm_err = run_phase(phase_expm_timing, dev)
    ms.update(expm_ms)
    bounds.update(expm_bounds)
    worst.update(expm_err)
    run_phase(phase_stream_kernels, dev)
    run_phase(phase_stream_schroedinger, dev)
    d20_launches, d20_it_s = run_phase(phase_lindblad_d20, dev)
    launches.update({k: d20_launches[k] for k in ("K6 fwd", "K6 bwd")})
    run_phase(phase_lindblad_routes, dev)
    stream_ms, stream_bounds, stream_err = run_phase(phase_stream_timing,
                                                     dev)
    ms.update(stream_ms)
    bounds.update(stream_bounds)
    worst.update(stream_err)
    run_phase(phase_step_kernels, dev)
    stepcost = run_phase(phase_stepcost_grape, dev)
    launches["K2 step"] = stepcost[1][0]["K2 step"]
    m4_step_launches, m4_step_it_s = run_phase(phase_stepcost_routes, dev)
    launches["K5 bwd step"] = m4_step_launches["K5 bwd step"]
    d20_step_launches, d20_step_it_s = run_phase(phase_stepcost_lindblad,
                                                 dev)
    launches["K6 bwd step"] = d20_step_launches["K6 bwd step"]
    step_ms, step_bounds, step_err = run_phase(phase_step_timing, dev,
                                               headline_w)
    ms.update(step_ms)
    bounds.update(step_bounds)
    worst.update(step_err)
    run_phase(phase_member_kernels, dev)
    ensemble_rates, launches["K2 member step"] = run_phase(phase_ensemble,
                                                           dev)
    blocked_it_s = run_phase(phase_ensemble_blocked, dev)
    ms_rates, ms_launches = run_phase(phase_multistart, dev)
    launches.update({"K1 member": ms_launches["K1"],
                     "K2 member": ms_launches["K2"]})
    member_ms, member_bounds, member_err = run_phase(phase_member_timing,
                                                     dev)
    ms.update(member_ms)
    bounds.update(member_bounds)
    worst.update(member_err)
    worst.update(run_phase(phase_plane_member_kernels, dev))
    lindblad_rates, lindblad_launches = run_phase(phase_lindblad_ensemble,
                                                  dev)
    launches.update({
        "K6 member fwd": lindblad_launches[LINDBLAD_MEMBERS[1], False][
            "K6 fwd"],
        "K6 member bwd": lindblad_launches[LINDBLAD_MEMBERS[1], False][
            "K6 bwd"],
        "K6 member bwd step": lindblad_launches[LINDBLAD_MEMBERS[0], True][
            "K6 bwd step"]})
    lindblad_ms_rates, _ = run_phase(phase_lindblad_multistart, dev)
    run_phase(phase_member_routes, dev)
    plane_member = run_phase(phase_plane_member_timing, dev)
    ms.update(plane_member[0])
    bounds.update(plane_member[1])
    for key, err in plane_member[2].items():
        worst[key] = max(worst.get(key, 0.0), err)
    launches.update(plane_member[3])
    worst.update(run_phase(phase_mode_kernels, dev, headline_w))
    mode_launches, mode_rates = run_phase(phase_mode_grape, dev, it_s)
    launches.update(mode_launches)
    mode_ms, mode_bounds = run_phase(phase_mode_timing, dev, headline_w)
    ms.update(mode_ms)
    bounds.update(mode_bounds)
    cell_launches, cell_rates = run_phase(
        phase_mode_cells, dev, {
            "d=2^7": d128_it_s, "Lindblad d=20": d20_it_s,
            "{}-member Lindblad d=20 ensemble".format(LINDBLAD_MEMBERS[0]):
            lindblad_rates[(LINDBLAD_MEMBERS[0], False)]})
    launches.update(cell_launches)
    mode_rates.update(cell_rates)
    worst.update(run_phase(phase_mode_tiled_kernels, dev))
    tiled_ms, tiled_bounds = run_phase(phase_mode_tiled_timing, dev)
    ms.update(tiled_ms)
    bounds.update(tiled_bounds)
    rkdp5_rates = run_phase(phase_rkdp5, dev, card)
    host_rates = run_phase(phase_host_loop, dev, card)
    save_rates = run_phase(phase_save_resume, dev, card)
    approximants = run_phase(phase_approximants, dev, card)
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
             "chain_pallas.py:463", "K6 bwd step"),
            ("chain_fwd (member-batched)", "chain_fwd.cu",
             "chain_pallas.py:236", "K1 member"),
            ("chain_bwd (member-batched)", "chain_bwd.cu",
             "chain_pallas.py:262", "K2 member"),
            ("chain_bwd (member-batched, per-step seeds)", "chain_bwd.cu",
             "chain_pallas.py:262", "K2 member step"),
            ("stream_fwd (member-batched)", "stream_fwd.cu",
             "chain_pallas.py:442", "K6 member fwd"),
            ("stream_bwd (member-batched)", "stream_bwd.cu",
             "chain_pallas.py:463", "K6 member bwd"),
            ("stream_bwd (member-batched, per-step seeds)", "stream_bwd.cu",
             "chain_pallas.py:463", "K6 member bwd step"),
            ("plane_fwd (member-batched)", "plane_fwd.cu",
             "chain_pallas.py:695", "K5 member fwd"),
            ("plane_bwd (member-batched)", "plane_bwd.cu",
             "chain_pallas.py:718", "K5 member bwd"),
            ("chain_fwd (bf16_3x, FwdTC)", "chain_fwd.cu", "chain_pallas.py:236",
             "K1 mode"),
            ("chain_bwd (bf16_3x)", "chain_bwd.cu", "chain_pallas.py:262",
             "K2 mode"),
            ("chain_bwd (bf16_3x, per-step seeds)", "chain_bwd.cu",
             "chain_pallas.py:262", "K2 mode step"),
            ("plane_fwd (bf16_3x, FwdTC)", "plane_fwd.cu", "chain_pallas.py:695",
             "K5 fwd mode"),
            ("plane_bwd (bf16_3x)", "plane_bwd.cu", "chain_pallas.py:718",
             "K5 bwd mode"),
            ("plane_bwd (bf16_3x, per-step seeds)", "plane_bwd.cu",
             "chain_pallas.py:718", "K5 bwd mode step"),
            ("expm_fwd (bf16_3x, padded 64, FwdTC)", "expm_fwd.cu",
             "expm_pallas.py:264", "K3 mode"),
            ("expm_frechet (bf16_3x, padded 64)", "expm_frechet.cu",
             "expm_pallas.py:397", "K4 mode"),
            ("chain_fwd (bf16_3x, FwdTC, member-batched)", "chain_fwd.cu",
             "chain_pallas.py:236", "K1 member mode"),
            ("chain_bwd (bf16_3x, member-batched)", "chain_bwd.cu",
             "chain_pallas.py:262", "K2 member mode"),
            ("expm_fwd (bf16_3x, tiled, padded 128-256)", "expm_fwd.cu",
             "expm_pallas.py:264", "K3 tiled mode"),
            ("expm_frechet (bf16_3x, tiled, padded 128-256)",
             "expm_frechet.cu", "expm_pallas.py:397", "K4 tiled mode"),
            ("stream_fwd (bf16_3x, wgmma)", "stream_fwd.cu", "chain_pallas.py:442",
             "K6 fwd mode"),
            ("stream_bwd (bf16_3x, wgmma)", "stream_bwd.cu", "chain_pallas.py:463",
             "K6 bwd mode"),
            ("stream_bwd (bf16_3x, wgmma, per-step seeds)", "stream_bwd.cu",
             "chain_pallas.py:463", "K6 bwd mode step"),
            ("stream_fwd (bf16_3x, wgmma, member-batched)", "stream_fwd.cu",
             "chain_pallas.py:442", "K6 member fwd mode"),
            ("stream_bwd (bf16_3x, wgmma, member-batched)", "stream_bwd.cu",
             "chain_pallas.py:463", "K6 member bwd mode"))]
    print("summary: card {} | build {:.1f} s | headline GRAPE {:.2f} it/s | "
          "M4 GRAPE {:.2f} it/s | d=128 GRAPE {:.2f} it/s | M4 loss+gradient "
          "blocked {:.3f} ms, plane {:.3f} ms | d=1024 backprop {:.3f} ms | "
          "Lindblad d=20 GRAPE {:.2f} it/s | step-cost headline GRAPE {:.2f} "
          "it/s (cost_eval_step {}: {:.2f}) | M4 step-cost GRAPE {:.2f} it/s "
          "| Lindblad d=20 step-cost GRAPE {:.2f} it/s | ensemble GRAPE "
          "{} | M4 ensemble GRAPE {:.2f} it/s | multistart {} | Lindblad "
          "d=20 ensemble GRAPE {} | Lindblad d=20 multistart {} | bf16_3x "
          "mode: {} | RKDP5 (plain torch): {} | optimizers and host loop: "
          "{} | headline it/s by save_iteration_step: {} | expm above padded "
          "256, faster with its gradient: {} | total {:.1f} s".format(
              card, build_s, it_s, m4_it_s, d128_it_s, route_ms["blocked"],
              route_ms["plane"], backprop_ms, d20_it_s, stepcost[1][1],
              THINNED_COST_EVAL_STEP, stepcost[THINNED_COST_EVAL_STEP][1],
              m4_step_it_s, d20_step_it_s, ", ".join(
                  "{} members{} {:.2f} it/s".format(
                      m, " with step costs" if step else "", rate)
                  for (m, step), rate in sorted(ensemble_rates.items())),
              blocked_it_s, ", ".join(
                  "{} {:.1f} cand-it/s".format(k, v)
                  for k, v in ms_rates.items()), ", ".join(
                  "{} members{} {:.2f} it/s".format(
                      m, " with step costs" if step else "", rate)
                  for (m, step), rate in sorted(lindblad_rates.items())),
              ", ".join("{} {:.1f} cand-it/s".format(k, v)
                        for k, v in lindblad_ms_rates.items()),
              ", ".join("{} {:.2f} {}".format(
                  k, v, "cand-it/s" if k.startswith("multistart") else
                  "it/s") for k, v in mode_rates.items()),
              ", ".join("{} {:.2f} {}".format(
                  k, v, "cand-it/s" if k.endswith("multistart") else "it/s")
                  for k, v in rkdp5_rates.items()),
              ", ".join("{} {:.2f} {}".format(
                  k, v, "cand-it/s" if "multistart" in k else "it/s")
                  for k, v in host_rates.items()),
              ", ".join("{} {:.2f}".format(k, v)
                        for k, v in save_rates.items()),
              ", ".join("d={} b={} {} {}{}".format(
                  row["d"], row["batch"], row["mode"], row["faster"],
                  "" if row["resolved"] else " (unresolved)")
                  for row in approximants),
              time.perf_counter() - start))
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
              25: phase_step_timing, 26: phase_member_kernels,
              27: phase_ensemble, 28: phase_ensemble_blocked,
              29: phase_multistart, 30: phase_member_timing,
              31: phase_plane_member_kernels, 32: phase_lindblad_ensemble,
              33: phase_lindblad_multistart, 34: phase_member_routes,
              35: phase_plane_member_timing, 36: phase_mode_kernels,
              37: phase_mode_grape, 38: phase_mode_timing,
              39: phase_mode_cells, 40: phase_mode_tiled_kernels,
              41: phase_mode_tiled_timing, 42: phase_rkdp5,
              43: phase_host_loop, 44: phase_save_resume,
              45: phase_approximants}


if __name__ == "__main__":
    main()
