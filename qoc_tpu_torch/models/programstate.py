"""Program-state containers for the Schrödinger and Lindblad entry points.

Counterpart of ``qoc_tpu/models/programstate.py`` (reference
qoc/models/{programstate,schroedingermodels,lindbladmodels}.py): static
configuration that the loss closes over. Saving to H5 files is ROADMAP
slice 4 of the port, so ``save_file_path`` and ``save_iteration_step``
raise ``NotImplementedError`` here; nothing imports h5py. Without a save
file ``save_intermediate_states`` / ``save_intermediate_densities`` mean
what they mean in ``qoc_tpu``: evolve returns the intermediate states or
densities in its result, GRAPE ignores the flag.
"""

import numpy as np

from qoc_tpu_torch.models.cost import validate_cost_dimensions
from qoc_tpu_torch.models.policies import ProgramType

__all__ = [
    "ProgramState",
    "GrapeState",
    "EvolveSchroedingerDiscreteState",
    "GrapeSchroedingerDiscreteState",
    "EvolveLindbladDiscreteState",
    "GrapeLindbladDiscreteState",
]

_H5_SLICE = ("{} is not ported yet: H5 save files are ROADMAP slice 4 of "
             "qoc_tpu_torch (use qoc_tpu for saved runs).")


def _refuse_saving(save_file_path, save_iteration_step=0):
    if save_file_path is not None:
        raise NotImplementedError(_H5_SLICE.format("save_file_path"))
    if save_iteration_step:
        raise NotImplementedError(_H5_SLICE.format("save_iteration_step"))


class ProgramState:
    """Shared configuration (reference programstate.py:11-61)."""

    def __init__(self, control_eval_count, cost_eval_step, costs,
                 evolution_time, hamiltonian, interpolation_policy,
                 program_type, save_file_path, system_eval_count):
        self.control_eval_count = control_eval_count
        if control_eval_count:
            self.control_eval_times = np.linspace(0, evolution_time,
                                                  control_eval_count)
        else:
            self.control_eval_times = None
        self.cost_eval_step = cost_eval_step
        self.costs = costs
        self.dt = evolution_time / (system_eval_count - 1)
        self.evolution_time = evolution_time
        self.final_system_eval_step = system_eval_count - 1
        self.hamiltonian = hamiltonian
        self.interpolation_policy = interpolation_policy
        self.program_type = program_type
        self.save_file_path = save_file_path
        self.system_eval_count = system_eval_count
        self.step_costs = []
        self.step_cost_indices = []
        for i, cost in enumerate(costs):
            if cost.requires_step_evaluation:
                self.step_costs.append(cost)
                self.step_cost_indices.append(i)


class GrapeState(ProgramState):
    """Optimization-specific configuration (reference programstate.py:64-134)."""

    def __init__(self, complex_controls, control_count, control_eval_count,
                 cost_eval_step, costs, evolution_time, hamiltonian,
                 impose_control_conditions, initial_controls,
                 interpolation_policy, iteration_count, log_iteration_step,
                 max_control_norms, min_error, optimizer, save_file_path,
                 save_iteration_step, system_eval_count):
        super().__init__(control_eval_count, cost_eval_step, costs,
                         evolution_time, hamiltonian, interpolation_policy,
                         ProgramType.GRAPE, save_file_path, system_eval_count)
        self.complex_controls = complex_controls
        self.control_count = control_count
        self.controls_shape = (control_eval_count, control_count)
        self.final_iteration = iteration_count - 1
        self.impose_control_conditions = impose_control_conditions
        self.initial_controls = initial_controls
        self.iteration_count = iteration_count
        self.log_iteration_step = log_iteration_step
        self.max_control_norms = max_control_norms
        self.min_error = min_error
        self.optimizer = optimizer
        self.save_iteration_step = save_iteration_step
        self.should_log = log_iteration_step != 0

    def log_and_save_initial(self):
        if self.should_log:
            print("iter   |   total error  |    grads_l2   \n"
                  "=========================================")


class EvolveSchroedingerDiscreteState(ProgramState):
    """Reference schroedingermodels.py:15-110."""
    method = "evolve_schroedinger_discrete"

    def __init__(self, control_eval_count, cost_eval_step, costs,
                 evolution_time, hamiltonian, initial_states,
                 interpolation_policy, magnus_policy, save_file_path,
                 save_intermediate_states_, system_eval_count):
        _refuse_saving(save_file_path)
        super().__init__(control_eval_count, cost_eval_step, costs,
                         evolution_time, hamiltonian, interpolation_policy,
                         ProgramType.EVOLVE, save_file_path,
                         system_eval_count)
        self.initial_states = initial_states
        validate_cost_dimensions(costs, np.asarray(initial_states).shape[-2])
        self.magnus_policy = magnus_policy


class GrapeSchroedingerDiscreteState(GrapeState):
    """Reference schroedingermodels.py:134-344."""
    method = "grape_schroedinger_discrete"

    def __init__(self, complex_controls, control_count, control_eval_count,
                 cost_eval_step, costs, evolution_time, hamiltonian,
                 impose_control_conditions, initial_controls, initial_states,
                 interpolation_policy, iteration_count, log_iteration_step,
                 max_control_norms, magnus_policy, min_error, optimizer,
                 save_file_path, save_intermediate_states_,
                 save_iteration_step, system_eval_count):
        _refuse_saving(save_file_path, save_iteration_step)
        super().__init__(complex_controls, control_count, control_eval_count,
                         cost_eval_step, costs, evolution_time, hamiltonian,
                         impose_control_conditions, initial_controls,
                         interpolation_policy, iteration_count,
                         log_iteration_step, max_control_norms, min_error,
                         optimizer, save_file_path, save_iteration_step,
                         system_eval_count)
        self.hilbert_size = initial_states[0].shape[0]
        self.initial_states = initial_states
        validate_cost_dimensions(costs, np.asarray(initial_states).shape[-2])
        self.magnus_policy = magnus_policy


class EvolveLindbladDiscreteState(ProgramState):
    """Reference lindbladmodels.py:14-103."""
    method = "evolve_lindblad_discrete"

    def __init__(self, control_eval_count, cost_eval_step, costs,
                 evolution_time, hamiltonian, initial_densities,
                 interpolation_policy, lindblad_data, save_file_path,
                 save_intermediate_densities_, system_eval_count):
        _refuse_saving(save_file_path)
        super().__init__(control_eval_count, cost_eval_step, costs,
                         evolution_time, hamiltonian, interpolation_policy,
                         ProgramType.EVOLVE, save_file_path,
                         system_eval_count)
        self.initial_densities = initial_densities
        validate_cost_dimensions(costs,
                                 np.asarray(initial_densities).shape[-1])
        self.lindblad_data = lindblad_data


class GrapeLindbladDiscreteState(GrapeState):
    """Reference lindbladmodels.py:125-339."""
    method = "grape_lindblad_discrete"

    def __init__(self, complex_controls, control_count, control_eval_count,
                 cost_eval_step, costs, evolution_time, hamiltonian,
                 impose_control_conditions, initial_controls,
                 initial_densities, interpolation_policy, iteration_count,
                 lindblad_data, log_iteration_step, max_control_norms,
                 min_error, optimizer, save_file_path,
                 save_intermediate_densities_, save_iteration_step,
                 system_eval_count):
        _refuse_saving(save_file_path, save_iteration_step)
        super().__init__(complex_controls, control_count, control_eval_count,
                         cost_eval_step, costs, evolution_time, hamiltonian,
                         impose_control_conditions, initial_controls,
                         interpolation_policy, iteration_count,
                         log_iteration_step, max_control_norms, min_error,
                         optimizer, save_file_path, save_iteration_step,
                         system_eval_count)
        self.hilbert_size = initial_densities[0].shape[0]
        self.initial_densities = initial_densities
        validate_cost_dimensions(costs,
                                 np.asarray(initial_densities).shape[-1])
        self.lindblad_data = lindblad_data
