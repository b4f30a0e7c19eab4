"""L-BFGS-B through scipy, on the host loop.

Counterpart of ``qoc_tpu/optim/lbfgsb.py`` (reference
qoc/standard/optimizers/lbfgsb.py:7-49): a thin
``scipy.optimize.minimize(method="L-BFGS-B")`` wrapper behind the host
loop's ``run(function, iteration_count, initial_params, jacobian, args)``.
scipy's line search runs on the host and asks for losses and gradients on
its own cadence; the host loop (``core/graperunner.py``) answers a paired
loss and gradient at one point with one evaluation on the device. As in
the reference, ``terminate`` is discarded, so ``min_error`` has no effect.
scipy is imported when an optimization starts, not with the package.
"""

__all__ = ["LBFGSB"]


class LBFGSB:
    name = "lbfgsb"
    supports_fused = False

    def __init__(self, **minimize_options):
        self.minimize_options = minimize_options

    def __str__(self):
        return self.name

    def run(self, function, iteration_count, initial_params, jacobian,
            args=()):
        from scipy.optimize import minimize
        options = {"maxiter": iteration_count}
        options.update(self.minimize_options)
        return minimize(lambda *a: function(*a)[0], initial_params,
                        args=args, method="L-BFGS-B",
                        jac=lambda *a: jacobian(*a)[0], options=options)
