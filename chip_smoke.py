"""Smoke test of qoc_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit
(nvcc) installed:

    python3 chip_smoke.py

Phases, one line each:
1. the device (name and power limit as nvidia-smi reports them);
2. build the chain kernels from qoc_tpu_torch/csrc with nvcc;
3. K1 (forward) and K2 (adjoint) against their plain PyTorch versions in
   float32, at d = 64 and 21 basis terms, at weights scaled onto every
   Taylor ladder level (degree 4/8/12/19 and the squaring branch), at step
   counts that split unevenly into segments, at the headline's own shapes,
   and the op's total against a float64 product of torch.linalg.matrix_exp;
4. the Table-3 headline loss and gradient (d = 64, 10 complex controls,
   10^4 steps, seed 0), kernel route against the plain route;
5. grape_schroedinger_discrete on that problem, 2 warm-up + 10 timed Adam
   iterations, with both kernels' launch counters read around the run;
6. K1 and K2 times beside their plain versions at the headline shapes.

Any failure exits non-zero. The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.
"""

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


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _random_hermitian(rng, d):
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return ((h + h.conj().T) / 2).astype(np.complex64)


def table3_problem(iteration_count):
    """The headline problem, built like the JAX package's bench.py with
    seed 0: (pstate, hamiltonian, costs)."""
    from qoc_tpu_torch.core.common import initialize_controls
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy, LinearHamiltonian,
                                      MagnusPolicy)
    from qoc_tpu_torch import Adam, TargetStateInfidelity

    rng = np.random.default_rng(0)
    h0 = _random_hermitian(rng, D)
    control_ops = np.stack(
        [_random_hermitian(rng, D) for _ in range(CONTROL_COUNT)])
    hamiltonian = LinearHamiltonian(h0, control_ops)
    initial = np.zeros((1, D, 1))
    initial[0, 0] = 1
    target = np.zeros((1, D, 1))
    target[0, -1] = 1
    costs = [TargetStateInfidelity(target)]
    initial_controls, max_norms = initialize_controls(
        True, CONTROL_COUNT, CONTROL_EVAL_COUNT, EVOLUTION_TIME, None, None)
    pstate = GrapeSchroedingerDiscreteState(
        True, CONTROL_COUNT, CONTROL_EVAL_COUNT, 1, costs, EVOLUTION_TIME,
        hamiltonian, None, initial_controls, initial,
        InterpolationPolicy.LINEAR, iteration_count, 0, max_norms,
        MagnusPolicy.M2, 0, Adam(), None, False, 0, SYSTEM_EVAL_COUNT)
    return pstate, hamiltonian, costs


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
    print("phase 2 build: chain kernels ready in {:.1f} s (nvcc sm_90a, "
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
    from qoc_tpu_torch.ops import chain

    pstate, hamiltonian, costs = table3_problem(1)
    iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
    chain.chain_fwd.launches = 0
    chain.chain_bwd.launches = 0
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, CONTROL_EVAL_COUNT, costs, EVOLUTION_TIME,
        hamiltonian, pstate.initial_states, SYSTEM_EVAL_COUNT,
        complex_controls=True, initial_controls=pstate.initial_controls,
        iteration_count=iterations, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms,
        fused_chunk=WARMUP_ITERATIONS, device=dev)
    launches = {"K1": chain.chain_fwd.launches,
                "K2": chain.chain_bwd.launches}
    errors = np.asarray(result.errors)
    print("phase 5 grape: {} iterations, {:.2f} it/s steady ({} timed after "
          "{} warm-up), error {:.6f} -> {:.6f}, launches K1 {} K2 {}".format(
              result.iteration_count_ran, result.iterations_per_s,
              TIMED_ITERATIONS, WARMUP_ITERATIONS, errors[0], errors[-1],
              launches["K1"], launches["K2"]), flush=True)
    if result.iteration_count_ran != iterations:
        raise RuntimeError("GRAPE stopped early")
    if not (np.all(np.isfinite(errors))
            and np.all(np.isfinite(result.best_final_states))):
        raise RuntimeError("non-finite GRAPE result")
    if not errors[-1] < errors[0]:
        raise RuntimeError("GRAPE error did not fall")
    if min(launches.values()) < 1:
        raise RuntimeError("the GRAPE run did not launch both kernels")
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
    print("phase 6 timing (S x L = {} x {}, levels {}/{}): ".format(
        s_count, length, chain.ladder_level(n1), chain.ladder_level(ninf))
        + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items()),
        flush=True)
    return ms


def main():
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_s = phase_build()
    pstate, _, _ = table3_problem(1)
    headline_w = headline_weights(pstate, dev)
    worst = phase_kernels(dev, headline_w)
    phase_headline(dev)
    launches, it_s = phase_grape(dev)
    ms = phase_timing(dev, headline_w)
    kernels = [
        {"name": "chain_fwd", "route": "cuda",
         "source": "qoc_tpu_torch/csrc/chain_fwd.cu",
         "replaces": "qoc_tpu/ops/chain_pallas.py:236",
         "launches": launches["K1"], "max_abs_err": worst["K1"],
         "ms": ms["K1"], "plain_ms": ms["K1 plain"]},
        {"name": "chain_bwd", "route": "cuda",
         "source": "qoc_tpu_torch/csrc/chain_bwd.cu",
         "replaces": "qoc_tpu/ops/chain_pallas.py:262",
         "launches": launches["K2"], "max_abs_err": worst["K2"],
         "ms": ms["K2"], "plain_ms": ms["K2 plain"]},
    ]
    print("summary: card {} | build {:.1f} s | headline GRAPE {:.2f} it/s"
          "".format(card, build_s, it_s))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
