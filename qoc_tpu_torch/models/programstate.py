"""Program-state containers for the Schrödinger and Lindblad entry points.

Counterpart of ``qoc_tpu/models/programstate.py`` (reference
qoc/models/{programstate,schroedingermodels,lindbladmodels}.py): static
configuration that the loss closes over, with the save file's writes
delegated to ``qoc_tpu_torch.io.h5.H5Checkpointer`` (created with the
state when ``save_file_path`` is given; h5py is imported then). GRAPE
states save on ``save_iteration_step``'s cadence and on the final
iteration (:func:`save_step`; the runners write each row through the
checkpointer), evolve states save their file at the start
(``save_initial``) and the intermediate stack once. Without a save file
``save_intermediate_states`` / ``save_intermediate_densities`` mean what
they mean in ``qoc_tpu``: evolve returns the intermediate states or
densities in its result, GRAPE ignores the flag.

The GRAPE states carry the fields ``qoc_tpu``'s ensemble entry points set
on them: ``evolved_shape``, the shape of the final states or densities
the loss returns (with a leading member axis for an ensemble),
``ensemble_params``, the member rows (None outside an ensemble; both set
by ``set_ensemble``, ``member_shape`` being one member's shape), and
``fused_chunk``, the iterations between host pulls of the GRAPE loop
(None: its default). ``io/resume.py`` ``apply_resume`` sets
``resume_state`` and ``resuming_same_file``.
"""

import numpy as np

from qoc_tpu_torch.config import is_io_process
from qoc_tpu_torch.models.cost import validate_cost_dimensions
from qoc_tpu_torch.models.policies import ProgramType

__all__ = [
    "ProgramState",
    "GrapeState",
    "EvolveSchroedingerDiscreteState",
    "GrapeSchroedingerDiscreteState",
    "EvolveLindbladDiscreteState",
    "GrapeLindbladDiscreteState",
    "save_step",
]


def save_step(pstate, iteration):
    """The save row of ``iteration``, or None where it saves nothing: on
    ``save_iteration_step``'s cadence and on the final iteration."""
    if not pstate.should_save or iteration > pstate.final_iteration:
        return None
    if (iteration % pstate.save_iteration_step == 0
            or iteration == pstate.final_iteration):
        return iteration // pstate.save_iteration_step
    return None


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
        if save_file_path is not None:
            from qoc_tpu_torch.io.h5 import H5Checkpointer
            self.checkpointer = H5Checkpointer(save_file_path)
        else:
            self.checkpointer = None
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
        # Logging is gated on the I/O process; should_save is not, since
        # it shapes what the loop collects (the checkpointer's writes do
        # nothing off the I/O process instead).
        self.should_log = log_iteration_step != 0 and is_io_process()
        self.should_save = (save_iteration_step != 0
                            and save_file_path is not None)
        self.ensemble_params = None
        self.fused_chunk = None

    def set_ensemble(self, hamiltonian_params):
        """Mark the state as an ensemble's: one member a row of
        ``hamiltonian_params``, the final states (M, K, d, 1) or densities
        (M, K, d, d)."""
        self.ensemble_params = np.asarray(hamiltonian_params)
        self.evolved_shape = ((self.ensemble_params.shape[0],)
                              + self.member_shape)

    def _save_count(self):
        """Number of preallocated H5 rows (reference
        schroedingermodels.py:266-271)."""
        return -(-self.iteration_count // self.save_iteration_step)

    def log_and_save_initial(self):
        if self.should_save:
            if self.checkpointer._writes_enabled:
                print("QOC is saving this optimization run to {}."
                      "".format(self.save_file_path))
            # Resuming into the same file keeps its preallocated schema
            # (io/resume.py apply_resume).
            if not getattr(self, "resuming_same_file", False):
                self.checkpointer.create_grape_file(self, self._save_count())
        if self.should_log:
            print("iter   |   total error  |    grads_l2   \n"
                  "=========================================")

    def _save_intermediate(self, key, iteration, stack):
        step = save_step(self, iteration)
        if step is not None:
            self.checkpointer.save_intermediate(key, step, stack)


class EvolveSchroedingerDiscreteState(ProgramState):
    """Reference schroedingermodels.py:15-110."""
    method = "evolve_schroedinger_discrete"

    def __init__(self, control_eval_count, cost_eval_step, costs,
                 evolution_time, hamiltonian, initial_states,
                 interpolation_policy, magnus_policy, save_file_path,
                 save_intermediate_states_, system_eval_count):
        super().__init__(control_eval_count, cost_eval_step, costs,
                         evolution_time, hamiltonian, interpolation_policy,
                         ProgramType.EVOLVE, save_file_path,
                         system_eval_count)
        self.initial_states = initial_states
        validate_cost_dimensions(costs, np.asarray(initial_states).shape[-2])
        self.magnus_policy = magnus_policy
        self.save_intermediate_states_ = (save_file_path is not None
                                          and save_intermediate_states_)

    def save_initial(self, controls):
        if self.save_file_path is not None:
            if self.checkpointer._writes_enabled:
                print("QOC is saving this evolution to {}."
                      "".format(self.save_file_path))
            self.checkpointer.create_evolve_file(self, controls)

    def save_intermediate_states(self, states_stack):
        """Write the (system_eval_count, K, d, 1) stack at once."""
        if self.save_intermediate_states_:
            self.checkpointer.save_intermediate(
                "intermediate_states", slice(None), states_stack)


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
        super().__init__(complex_controls, control_count, control_eval_count,
                         cost_eval_step, costs, evolution_time, hamiltonian,
                         impose_control_conditions, initial_controls,
                         interpolation_policy, iteration_count,
                         log_iteration_step, max_control_norms, min_error,
                         optimizer, save_file_path, save_iteration_step,
                         system_eval_count)
        self.hilbert_size = initial_states[0].shape[0]
        self.initial_states = initial_states
        self.member_shape = self.evolved_shape = np.asarray(
            initial_states).shape
        validate_cost_dimensions(costs, np.asarray(initial_states).shape[-2])
        self.magnus_policy = magnus_policy
        self.save_intermediate_states_ = (self.should_save
                                          and save_intermediate_states_)

    def save_intermediate_states(self, iteration, states_stack):
        if self.save_intermediate_states_:
            self._save_intermediate("intermediate_states", iteration,
                                    states_stack)


class EvolveLindbladDiscreteState(ProgramState):
    """Reference lindbladmodels.py:14-103."""
    method = "evolve_lindblad_discrete"

    def __init__(self, control_eval_count, cost_eval_step, costs,
                 evolution_time, hamiltonian, initial_densities,
                 interpolation_policy, lindblad_data, save_file_path,
                 save_intermediate_densities_, system_eval_count):
        super().__init__(control_eval_count, cost_eval_step, costs,
                         evolution_time, hamiltonian, interpolation_policy,
                         ProgramType.EVOLVE, save_file_path,
                         system_eval_count)
        self.initial_densities = initial_densities
        validate_cost_dimensions(costs,
                                 np.asarray(initial_densities).shape[-1])
        self.lindblad_data = lindblad_data
        self.save_intermediate_densities_ = (save_intermediate_densities_
                                             and save_file_path is not None)

    def save_initial(self, controls):
        if self.save_file_path is not None:
            if self.checkpointer._writes_enabled:
                print("QOC is saving this evolution to {}."
                      "".format(self.save_file_path))
            self.checkpointer.create_evolve_file(self, controls)

    def save_intermediate_densities(self, densities_stack):
        if self.save_intermediate_densities_:
            self.checkpointer.save_intermediate(
                "intermediate_densities", slice(None), densities_stack)


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
        super().__init__(complex_controls, control_count, control_eval_count,
                         cost_eval_step, costs, evolution_time, hamiltonian,
                         impose_control_conditions, initial_controls,
                         interpolation_policy, iteration_count,
                         log_iteration_step, max_control_norms, min_error,
                         optimizer, save_file_path, save_iteration_step,
                         system_eval_count)
        self.hilbert_size = initial_densities[0].shape[0]
        self.initial_densities = initial_densities
        self.member_shape = self.evolved_shape = np.asarray(
            initial_densities).shape
        validate_cost_dimensions(costs,
                                 np.asarray(initial_densities).shape[-1])
        self.lindblad_data = lindblad_data
        self.save_intermediate_densities_ = (self.should_save
                                             and save_intermediate_densities_)

    def save_intermediate_densities(self, iteration, densities_stack):
        if self.save_intermediate_densities_:
            self._save_intermediate("intermediate_densities", iteration,
                                    densities_stack)
