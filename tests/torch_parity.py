"""Shared problem builder for the qoc_tpu <-> qoc_tpu_torch parity tests.

A problem is drawn once with numpy from a seed and handed to both packages:
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
        self.h0, self.ops = h0, ops
        self.d, self.n_c, self.n_steps = d, n_c, n_steps
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

    def jax_pstate(self, iteration_count=1, magnus="M2"):
        from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                    InterpolationPolicy, MagnusPolicy)
        from qoc_tpu.optim import Adam
        return GrapeSchroedingerDiscreteState(
            True, self.n_c, self.n_steps, 1, self.jax_costs,
            self.evolution_time, self.jax_hamiltonian, None, self.controls,
            self.initial, InterpolationPolicy.LINEAR, iteration_count, 0,
            self.max_control_norms, MagnusPolicy[magnus], 0, Adam(), None,
            False, 0, self.n_steps)

    def torch_pstate(self, iteration_count=1, magnus="M2"):
        from qoc_tpu_torch import Adam
        from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                          InterpolationPolicy, MagnusPolicy)
        return GrapeSchroedingerDiscreteState(
            True, self.n_c, self.n_steps, 1, self.torch_costs,
            self.evolution_time, self.torch_hamiltonian, None,
            self.torch_controls, self.torch_initial,
            InterpolationPolicy.LINEAR, iteration_count, 0,
            self.torch_max_control_norms, MagnusPolicy[magnus], 0, Adam(),
            None, False, 0, self.n_steps)
