"""Shared problem builders for the qoc_tpu <-> qoc_tpu_torch parity tests.

A problem (Schrödinger or Lindblad) is drawn once with numpy from a seed
and handed to both packages:
to ``qoc_tpu`` directly, to the port through ``qoc_tpu_torch.convert``. The
JAX side runs at float64 on the CPU (tests/conftest.py), the port at
float64 on the CPU.
"""

import numpy as np


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
