"""Control-lifecycle helpers shared by the GRAPE entry points.

Counterpart of ``qoc_tpu/core/common.py`` (reference qoc/core/common.py):
norm clipping, initial-control generation (cosine / white noise / flat),
validation, and the optimizer-format (flat real R^2n) <-> cost-format
(complex (E, C)) transforms.

Host versions operate on numpy (around the optimizer boundary, like the
reference); ``*_torch`` are the tensor twins used inside the loss and the
on-device optimizer loop.
"""

import numpy as np
import torch

__all__ = [
    "clip_control_norms",
    "clip_control_norms_torch",
    "gen_controls_cos",
    "gen_controls_white",
    "gen_controls_flat",
    "initialize_controls",
    "slap_controls",
    "strip_controls",
    "slap_controls_torch",
    "strip_controls_torch",
]

_NORM_TOLERANCE = 1e-10


def clip_control_norms(controls, max_control_norms):
    """Rescale every control point whose modulus exceeds its channel's
    maximum norm back onto that norm (complex-aware). Returns a new array.

    Parity: reference common.py:8-30 (which mutates in place).
    """
    controls = np.array(controls)
    for i, max_control_norm in enumerate(max_control_norms):
        control = controls[:, i]
        control_norm = np.abs(control)
        offending = control_norm > max_control_norm
        safe_norm = np.where(offending, control_norm, 1.0)
        controls[:, i] = np.where(offending,
                                  (control / safe_norm) * max_control_norm,
                                  control)
    return controls


def clip_control_norms_torch(controls, max_control_norms):
    """Tensor twin of :func:`clip_control_norms` (the projection inside the
    on-device optimizer loop). ``max_control_norms`` is a real tensor (C,)
    on the controls' device."""
    max_norms = max_control_norms[None, :]
    norms = torch.abs(controls)
    offending = norms > max_norms
    safe_norm = torch.where(offending, norms, torch.ones_like(norms))
    return torch.where(offending, (controls / safe_norm) * max_norms,
                       controls)


def gen_controls_cos(complex_controls, control_count, control_eval_count,
                     evolution_time, max_control_norms, periods=10.0):
    """Cosine-shaped initial controls (reference common.py:33-75)."""
    period = np.divide(control_eval_count, periods)
    b = np.divide(2 * np.pi, period)
    controls = np.zeros((control_eval_count, control_count))
    for i in range(control_count):
        max_norm = max_control_norms[i]
        _controls = (np.divide(max_norm, 2)
                     * np.cos(b * np.arange(control_eval_count)))
        small_norm = max_norm * 1e-1
        _controls = np.where(_controls, _controls, small_norm)
        controls[:, i] = _controls
    if complex_controls:
        controls = (controls - 1j * controls) / np.sqrt(2)
    return controls


def gen_controls_white(complex_controls, control_count, control_eval_count,
                       evolution_time, max_control_norms, periods=10.0,
                       seed=None):
    """White-noise initial controls (reference common.py:78-108)."""
    rng = np.random.default_rng(seed)
    controls = np.zeros((control_eval_count, control_count))
    for i in range(control_count):
        max_norm = max_control_norms[i]
        stddev = max_norm / 5.0
        controls[:, i] = rng.normal(0, stddev, control_eval_count)
    if complex_controls:
        controls = (controls - 1j * controls) / np.sqrt(2)
    return controls


def gen_controls_flat(complex_controls, control_count, control_eval_count,
                      evolution_time, max_control_norms, periods=10.0):
    """Flat initial controls at 10% of each channel's max norm (the default;
    reference common.py:111-142)."""
    controls = np.zeros((control_eval_count, control_count))
    for i in range(control_count):
        controls[:, i] = np.repeat(max_control_norms[i] * 1e-1,
                                   control_eval_count)
    if complex_controls:
        controls = (controls - 1j * controls) / np.sqrt(2)
    return controls


def initialize_controls(complex_controls, control_count, control_eval_count,
                        evolution_time, initial_controls, max_control_norms):
    """Sanitize/generate initial controls and max norms.

    Parity: reference common.py:146-198 (flat generator default, dtype check
    against ``complex_controls``, norm check with 1e-10 tolerance).
    """
    if max_control_norms is None:
        max_control_norms = np.ones(control_count)
    if initial_controls is None:
        controls = gen_controls_flat(complex_controls, control_count,
                                     control_eval_count, evolution_time,
                                     max_control_norms)
    else:
        initial_controls = np.asarray(initial_controls)
        if complex_controls and not np.iscomplexobj(initial_controls):
            raise ValueError(
                "The program expected that the initial_controls specified by "
                "the user conformed to complex_controls, but the program "
                "found that the initial_controls were not complex and "
                "complex_controls was set to True.")
        if not complex_controls and np.iscomplexobj(initial_controls):
            raise ValueError(
                "The program expected that the initial_controls specified by "
                "the user conformed to complex_controls, but the program "
                "found that the initial_controls were complex and "
                "complex_controls was set to False.")
        for control_step, step_controls in enumerate(initial_controls):
            if not np.less_equal(np.abs(step_controls),
                                 np.asarray(max_control_norms)
                                 + _NORM_TOLERANCE).all():
                raise ValueError(
                    "The program expected that the initial_controls specified "
                    "by the user conformed to max_control_norms, but the "
                    "program found a conflict at initial_controls[{}]={} and "
                    "max_control_norms={}."
                    "".format(control_step, step_controls, max_control_norms))
        controls = initial_controls
    return controls, max_control_norms


def slap_controls(complex_controls, controls, controls_shape):
    """Optimizer format (flat real) -> cost format (complex (E, C)).

    Parity: reference common.py:201-223.
    """
    if complex_controls:
        real, imag = np.split(controls, 2)
        controls = real + 1j * imag
    return np.reshape(controls, controls_shape)


def strip_controls(complex_controls, controls):
    """Cost format (complex (E, C)) -> optimizer format (flat real).

    Parity: reference common.py:226-246.
    """
    controls = np.ravel(controls)
    if complex_controls:
        controls = np.hstack((np.real(controls), np.imag(controls)))
    return controls


def slap_controls_torch(complex_controls, controls, controls_shape):
    """Tensor twin of :func:`slap_controls`."""
    if complex_controls:
        real, imag = torch.chunk(controls, 2)
        controls = torch.complex(real, imag)
    return torch.reshape(controls, controls_shape)


def strip_controls_torch(complex_controls, controls):
    """Tensor twin of :func:`strip_controls`."""
    controls = torch.ravel(controls)
    if complex_controls:
        controls = torch.cat((torch.real(controls), torch.imag(controls)))
    return controls
