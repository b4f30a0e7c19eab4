"""Shared problem builders for the qoc_tpu <-> qoc_tpu_torch parity tests.

A problem (Schrödinger or Lindblad) is drawn once with numpy from a seed
and handed to both packages:
to ``qoc_tpu`` directly, to the port through ``qoc_tpu_torch.convert``. The
JAX side runs at float64 on the CPU (tests/conftest.py), the port at
float64 on the CPU.

``one_blas_thread`` is an autouse fixture that the parity test files
import: each of their tests runs with the BLAS thread pools of numpy and
scipy (the LAPACK that JAX's CPU linear algebra calls) at one thread,
restored after the test. Under pytest-xdist every worker's 8-thread
OpenBLAS pools otherwise oversubscribe the cores, and the large-d
references (a Padé expm's LU solve at d = 260) ran several times slower in
the suite than in one process. Results do not depend on it beyond
rounding.
"""

import os

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def one_blas_thread():
    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def not_a_grape_file(directory):
    """An H5 file without GRAPE rows in ``directory``: a ``resume_from``
    that both packages refuse with ValueError."""
    import h5py
    path = os.path.join(str(directory), "not_grape.h5")
    with h5py.File(path, "w") as f:
        f["program_type"] = "evolve"
    return path


def saved_errors(path):
    """The ``error`` rows of a save file."""
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f["error"])


def random_hermitian(rng, d):
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return (h + h.conj().T) / 2


def anti_hermitian_basis(rng, n_b, d):
    """-i H_k for random Hermitian H_k: every real combination generates a
    unitary step, so long chains stay bounded at any norm."""
    return np.stack([-1j * random_hermitian(rng, d) for _ in range(n_b)])


def f32_exact(x):
    """Round to float32 and back: qoc_tpu's chain reference casts its
    weights to float32, so inputs that survive the cast compare exactly."""
    return np.asarray(x, dtype=np.float32).astype(np.float64)


class Problem:
    """A Schrödinger GRAPE problem in both packages (the setup of
    tests/test_chain.py::test_fused_loss_matches_generic_path)."""

    def __init__(self, seed=11, d=4, n_c=2, n_steps=25, evolution_time=2.0,
                 max_norm=10.0):
        from qoc_tpu import LinearHamiltonian
        from qoc_tpu.standard import TargetStateInfidelity
        from qoc_tpu_torch import convert

        rng = np.random.default_rng(seed)
        h0 = random_hermitian(rng, d)
        ops = 0.5 * (rng.normal(size=(n_c, d, d))
                     + 1j * rng.normal(size=(n_c, d, d)))
        initial = np.zeros((1, d, 1), dtype=complex)
        initial[0, 0] = 1
        target = np.zeros((1, d, 1), dtype=complex)
        target[0, -1] = 1
        self.h0, self.ops, self.target = h0, ops, target
        self.d, self.n_c, self.n_steps = d, n_c, n_steps
        self.cost_eval_step = 1
        self.evolution_time = evolution_time
        self.controls = 0.3 * (rng.normal(size=(n_steps, n_c))
                               + 1j * rng.normal(size=(n_steps, n_c)))
        self.max_control_norms = np.full(n_c, max_norm)
        self.initial = initial
        self.jax_hamiltonian = LinearHamiltonian(h0, ops)
        self.jax_costs = [TargetStateInfidelity(target)]
        self.torch_hamiltonian = convert.linear_hamiltonian(
            self.jax_hamiltonian)
        self.torch_costs = [convert.target_state_infidelity(c)
                            for c in self.jax_costs]
        self.torch_initial = convert.states(initial)
        self.torch_controls = convert.controls(self.controls)
        self.torch_max_control_norms = convert.max_control_norms(
            self.max_control_norms)

    def use_callables(self):
        """Replace the LinearHamiltonians by one time-dependent Hamiltonian
        written twice, in ``jax.numpy`` and in ``torch``:
        H(c, t) = cos(t) h0 + Σ_i c_i A_i + conj(c_i) A_i^H."""
        import jax.numpy as jnp
        import torch
        h0, ops = self.h0, self.ops

        def jax_hamiltonian(controls, t):
            h = jnp.cos(t) * h0
            if controls is None:
                return h
            drive = jnp.einsum("i,iab->ab", controls, ops)
            return h + drive + jnp.conjugate(drive.T)

        h0_t, ops_t = torch.as_tensor(h0), torch.as_tensor(ops)

        def torch_hamiltonian(controls, t):
            h = torch.cos(t) * h0_t
            if controls is None:
                return h
            drive = torch.einsum("i,iab->ab", controls, ops_t)
            return h + drive + drive.mH

        self.jax_hamiltonian = jax_hamiltonian
        self.torch_hamiltonian = torch_hamiltonian
        return self

    def add_step_costs(self, cost_eval_step=1):
        """Add the step costs, on every ``cost_eval_step``-th step:
        ForbidStates of |1> and a random state (multiplier 0.1, as
        bench.py's step-cost problem) and TargetStateInfidelityTime of the
        target (0.5), in both packages."""
        from qoc_tpu.standard import ForbidStates, TargetStateInfidelityTime
        from qoc_tpu_torch import convert
        rng = np.random.default_rng(self.d)
        forbidden = np.zeros((1, 2, self.d, 1), dtype=complex)
        forbidden[0, 0, 1] = 1
        v = rng.normal(size=self.d) + 1j * rng.normal(size=self.d)
        forbidden[0, 1, :, 0] = v / np.linalg.norm(v)
        self.cost_eval_step = cost_eval_step
        step_costs = [ForbidStates(forbidden, self.n_steps, cost_eval_step,
                                   cost_multiplier=0.1),
                      TargetStateInfidelityTime(self.n_steps, self.target,
                                                cost_eval_step,
                                                cost_multiplier=0.5)]
        self.jax_costs = self.jax_costs + step_costs
        self.torch_costs = self.torch_costs + [
            convert.forbid_states(step_costs[0]),
            convert.target_state_infidelity_time(step_costs[1])]
        return self

    def jax_pstate(self, iteration_count=1, magnus="M2"):
        from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                    InterpolationPolicy, MagnusPolicy)
        from qoc_tpu.optim import Adam
        return GrapeSchroedingerDiscreteState(
            True, self.n_c, self.n_steps, self.cost_eval_step, self.jax_costs,
            self.evolution_time, self.jax_hamiltonian, None, self.controls,
            self.initial, InterpolationPolicy.LINEAR, iteration_count, 0,
            self.max_control_norms, MagnusPolicy[magnus], 0, Adam(), None,
            False, 0, self.n_steps)

    def torch_pstate(self, iteration_count=1, magnus="M2"):
        from qoc_tpu_torch import Adam
        from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                          InterpolationPolicy, MagnusPolicy)
        return GrapeSchroedingerDiscreteState(
            True, self.n_c, self.n_steps, self.cost_eval_step,
            self.torch_costs,
            self.evolution_time, self.torch_hamiltonian, None,
            self.torch_controls, self.torch_initial,
            InterpolationPolicy.LINEAR, iteration_count, 0,
            self.torch_max_control_norms, MagnusPolicy[magnus], 0, Adam(),
            None, False, 0, self.n_steps)


def annihilation(d):
    return np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)


def random_density(rng, d):
    """A random full-rank density matrix."""
    x = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    rho = x @ x.conj().T
    return rho / np.trace(rho)


class LindbladProblem:
    """A Lindblad GRAPE problem in both packages: H = h0 + Σ c_i A_i + h.c.
    with a LinearHamiltonian (or the same H as a callable in each package),
    two decay channels (a, rate 0.05, and a random operator, rate 0.02), two
    initial densities (|0><0| and a mixed one) and their targets."""

    def __init__(self, seed=3, d=3, n_c=2, n_steps=12, evolution_time=1.0,
                 max_norm=10.0):
        from qoc_tpu import ConstantLindblad, LinearHamiltonian
        from qoc_tpu.standard import TargetDensityInfidelity
        from qoc_tpu_torch import convert

        rng = np.random.default_rng(seed)
        self.d, self.n_c, self.n_steps = d, n_c, n_steps
        self.evolution_time = evolution_time
        self.h0 = random_hermitian(rng, d)
        self.ops = 0.5 * (rng.normal(size=(n_c, d, d))
                          + 1j * rng.normal(size=(n_c, d, d)))
        self.rates = np.array([0.05, 0.02])
        self.lops = np.stack((annihilation(d), 0.3 * (
            rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))))
        pure = np.zeros((d, d), dtype=complex)
        pure[0, 0] = 1
        self.initial = np.stack((pure, random_density(rng, d)))
        target = np.zeros((d, d), dtype=complex)
        target[-1, -1] = 1
        self.targets = np.stack((target, random_density(rng, d)))
        self.controls = 0.3 * (rng.normal(size=(n_steps, n_c))
                               + 1j * rng.normal(size=(n_steps, n_c)))
        self.max_control_norms = np.full(n_c, max_norm)
        self.cost_eval_step = 1
        self.jax_hamiltonian = LinearHamiltonian(self.h0, self.ops)
        self.jax_lindblad = ConstantLindblad(self.rates, self.lops)
        self.jax_costs = [TargetDensityInfidelity(self.targets)]
        self.torch_hamiltonian = convert.linear_hamiltonian(
            self.jax_hamiltonian)
        self.torch_lindblad = convert.constant_lindblad(self.jax_lindblad)
        self.torch_costs = [convert.target_density_infidelity(c)
                            for c in self.jax_costs]
        self.torch_initial = convert.densities(self.initial)

    def add_step_costs(self, cost_eval_step=1):
        """Add the density step costs, on every ``cost_eval_step``-th step:
        ForbidDensities of |1><1| (ragged: two for the first density, one
        for the second; multiplier 0.1) and TargetDensityInfidelityTime of
        the targets (0.5), in both packages."""
        from qoc_tpu.standard import (ForbidDensities,
                                      TargetDensityInfidelityTime)
        from qoc_tpu_torch import convert
        one = np.zeros((self.d, self.d), dtype=complex)
        one[1, 1] = 1
        mixed = random_density(np.random.default_rng(self.d), self.d)
        self.cost_eval_step = cost_eval_step
        step_costs = [
            ForbidDensities([np.stack((one, mixed)), one[None]],
                            self.n_steps, cost_eval_step, cost_multiplier=0.1),
            TargetDensityInfidelityTime(self.n_steps, self.targets,
                                        cost_eval_step, cost_multiplier=0.5)]
        self.jax_costs = self.jax_costs + step_costs
        self.torch_costs = self.torch_costs + [
            convert.forbid_densities(step_costs[0]),
            convert.target_density_infidelity_time(step_costs[1])]
        return self

    def use_callables(self):
        """The same H as a time-dependent callable in each package,
        H(c, t) = cos(t) h0 + Σ_i c_i A_i + conj(c_i) A_i^H."""
        import jax.numpy as jnp
        import torch
        h0, ops = self.h0, self.ops
        h0_t, ops_t = torch.as_tensor(h0), torch.as_tensor(ops)

        def jax_hamiltonian(controls, t):
            drive = jnp.einsum("i,iab->ab", controls, ops)
            return jnp.cos(t) * h0 + drive + jnp.conjugate(drive.T)

        def torch_hamiltonian(controls, t):
            drive = torch.einsum("i,iab->ab", controls, ops_t)
            return torch.cos(t) * h0_t + drive + drive.mH

        self.jax_hamiltonian = jax_hamiltonian
        self.torch_hamiltonian = torch_hamiltonian
        return self

    def pstate(self, package, magnus="M2", iteration_count=1):
        """qoc_tpu's or the port's GrapeLindbladDiscreteState, under
        MAGNUS_EXPM."""
        if package == "jax":
            from qoc_tpu import models
            from qoc_tpu.optim import Adam
            ham, lind, costs = (self.jax_hamiltonian, self.jax_lindblad,
                                self.jax_costs)
            initial = self.initial
        else:
            from qoc_tpu_torch import Adam, models
            ham, lind, costs = (self.torch_hamiltonian, self.torch_lindblad,
                                self.torch_costs)
            initial = self.torch_initial
        pstate = models.GrapeLindbladDiscreteState(
            True, self.n_c, self.n_steps, self.cost_eval_step, costs,
            self.evolution_time, ham,
            None, self.controls, initial, models.InterpolationPolicy.LINEAR,
            iteration_count, lind, 0, self.max_control_norms, 0, Adam(),
            None, False, 0, self.n_steps)
        pstate.method_ = models.LindbladMethod.MAGNUS_EXPM
        pstate.magnus_policy_ = models.MagnusPolicy[magnus]
        return pstate


class EnsembleProblem(Problem):
    """An ensemble GRAPE problem in both packages: the Problem's system with
    an EnsembleLinearHamiltonian of two Hermitian parameter operators, h0
    (the (1 + δ)·H0 miscalibration) and a random one, and ``n_members``
    member rows, each row different."""

    def __init__(self, n_members=2, seed=5, d=3, n_c=2, n_steps=24,
                 evolution_time=1.5):
        from qoc_tpu.models import EnsembleLinearHamiltonian
        from qoc_tpu_torch import convert

        super().__init__(seed=seed, d=d, n_c=n_c, n_steps=n_steps,
                         evolution_time=evolution_time)
        rng = np.random.default_rng(seed + 100)
        self.param_ops = np.stack((self.h0, random_hermitian(rng, d)))
        self.params = np.stack((np.linspace(-0.1, 0.1, n_members),
                                0.3 * rng.normal(size=n_members)), axis=-1)
        self.jax_hamiltonian = EnsembleLinearHamiltonian(self.h0, self.ops,
                                                         self.param_ops)
        self.torch_hamiltonian = convert.linear_hamiltonian(
            self.jax_hamiltonian)

    def use_callables(self):
        """The members as one time-dependent callable in each package,
        H(row, c, t) = (cos(t) + row[0]) h0 + row[1] P + Σ_i c_i A_i + h.c.,
        taking the blocked route (qoc_tpu's generic route)."""
        import jax.numpy as jnp
        import torch
        h0, ops, p = self.h0, self.ops, self.param_ops[1]

        def jax_hamiltonian(row, controls, t):
            drive = jnp.einsum("i,iab->ab", controls, ops)
            return ((jnp.cos(t) + row[0]) * h0 + row[1] * p + drive
                    + jnp.conjugate(drive.T))

        h0_t, ops_t, p_t = (torch.as_tensor(x) for x in (h0, ops, p))

        def torch_hamiltonian(row, controls, t):
            drive = torch.einsum("i,iab->ab", controls, ops_t)
            return ((torch.cos(t) + row[0]) * h0_t + row[1] * p_t + drive
                    + drive.mH)

        self.jax_hamiltonian = jax_hamiltonian
        self.torch_hamiltonian = torch_hamiltonian
        return self

    def jax_pstate(self, iteration_count=1, magnus="M2"):
        pstate = super().jax_pstate(iteration_count, magnus)
        pstate.hamiltonian = None
        return pstate

    def torch_pstate(self, iteration_count=1, magnus="M2"):
        pstate = super().torch_pstate(iteration_count, magnus)
        pstate.hamiltonian = None
        return pstate


class LindbladEnsembleProblem:
    """An open-system ensemble in both packages, example 6's construction
    at Hilbert d (examples/6_lindblad_ensemble_robust.py; at d > 2 the drift
    0.1 n̂ of bench_lindblad_d20): H_m = (1 + δ_m) h0 + c a + conj(c) a^H as
    an EnsembleLinearHamiltonian with param_operators [h0], δ =
    linspace(-0.02, 0.02, M), T1 decay on a at ``rate``, |0><0| to
    |1><1|, random complex controls from ``seed``; MAGNUS_EXPM."""

    def __init__(self, d=2, n_members=8, control_eval_count=11,
                 system_eval_count=21, evolution_time=10.0, rate=1e-3,
                 seed=6):
        from qoc_tpu import ConstantLindblad, EnsembleLinearHamiltonian
        from qoc_tpu.standard import TargetDensityInfidelity
        from qoc_tpu_torch import convert

        rng = np.random.default_rng(seed)
        self.d, self.n_c = d, 1
        self.control_eval_count = control_eval_count
        self.system_eval_count = system_eval_count
        self.evolution_time = evolution_time
        self.a = annihilation(d)
        self.h0 = (np.diag([0.5, -0.5]).astype(complex) if d == 2
                   else 0.1 * self.a.conj().T @ self.a)
        self.params = np.linspace(-0.02, 0.02, n_members).reshape(-1, 1)
        self.initial = np.zeros((1, d, d), dtype=complex)
        self.initial[0, 0, 0] = 1
        self.target = np.zeros((1, d, d), dtype=complex)
        self.target[0, 1, 1] = 1
        self.controls = 0.3 * (rng.normal(size=(control_eval_count, 1))
                               + 1j * rng.normal(size=(control_eval_count,
                                                       1)))
        self.max_control_norms = np.full(1, 10.0)
        self.cost_eval_step = 1
        self.jax_hamiltonian = EnsembleLinearHamiltonian(
            self.h0, self.a[None], self.h0[None])
        self.jax_lindblad = ConstantLindblad(np.array([rate]), self.a[None])
        self.jax_costs = [TargetDensityInfidelity(self.target)]
        self.torch_hamiltonian = convert.linear_hamiltonian(
            self.jax_hamiltonian)
        self.torch_lindblad = convert.constant_lindblad(self.jax_lindblad)
        self.torch_costs = [convert.target_density_infidelity(c)
                            for c in self.jax_costs]
        self.torch_initial = convert.densities(self.initial)

    def add_step_costs(self):
        """TargetDensityInfidelityTime of the target (0.5) and
        ForbidDensities of a random density (0.1), every step."""
        from qoc_tpu.standard import (ForbidDensities,
                                      TargetDensityInfidelityTime)
        from qoc_tpu_torch import convert
        n_steps = self.system_eval_count - 1
        forbidden = random_density(np.random.default_rng(self.d), self.d)
        step_costs = [
            TargetDensityInfidelityTime(n_steps, self.target, 1,
                                        cost_multiplier=0.5),
            ForbidDensities([forbidden[None]], n_steps, 1,
                            cost_multiplier=0.1)]
        self.jax_costs = self.jax_costs + step_costs
        self.torch_costs = self.torch_costs + [
            convert.target_density_infidelity_time(step_costs[0]),
            convert.forbid_densities(step_costs[1])]
        return self

    def use_callables(self):
        """The members as one time-dependent callable in each package,
        H(row, c, t) = (cos(t) + row[0]) h0 + c a + conj(c) a^H (the
        generic route)."""
        import jax.numpy as jnp
        import torch
        h0, a = self.h0, self.a

        def jax_hamiltonian(row, controls, t):
            drive = controls[0] * a
            return ((jnp.cos(t) + row[0]) * h0 + drive
                    + jnp.conjugate(drive.T))

        h0_t, a_t = torch.as_tensor(h0), torch.as_tensor(a)

        def torch_hamiltonian(row, controls, t):
            drive = controls[0] * a_t
            return (torch.cos(t) + row[0]) * h0_t + drive + drive.mH

        self.jax_hamiltonian = jax_hamiltonian
        self.torch_hamiltonian = torch_hamiltonian
        return self

    def pstate(self, package):
        """qoc_tpu's or the port's GrapeLindbladDiscreteState under
        MAGNUS_EXPM, with no Hamiltonian of its own (the members')."""
        if package == "jax":
            from qoc_tpu import models
            from qoc_tpu.optim import Adam
            lind, costs, initial = (self.jax_lindblad, self.jax_costs,
                                    self.initial)
        else:
            from qoc_tpu_torch import Adam, models
            lind, costs, initial = (self.torch_lindblad, self.torch_costs,
                                    self.torch_initial)
        pstate = models.GrapeLindbladDiscreteState(
            True, 1, self.control_eval_count, self.cost_eval_step, costs,
            self.evolution_time, None, None, self.controls, initial,
            models.InterpolationPolicy.LINEAR, 1, lind, 0,
            self.max_control_norms, 0, Adam(), None, False, 0,
            self.system_eval_count)
        pstate.method_ = models.LindbladMethod.MAGNUS_EXPM
        pstate.magnus_policy_ = models.MagnusPolicy.M2
        return pstate
