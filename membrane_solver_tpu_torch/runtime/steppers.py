"""Host-level stepper handles.

Copy of ``membrane_solver_tpu/runtime/steppers.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``runtime/steppers/{base,gradient_descent,conjugate_gradient,
bfgs}.py`` public API.  The actual stepping math is jitted in
:mod:`membrane_solver_tpu_torch.runtime.jit_core`; these objects only select the
device implementation and hold reset semantics.
"""

from __future__ import annotations


class BaseStepper:
    name = "base"

    def reset(self) -> None:  # device state is reset by the Minimizer
        pass

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class GradientDescent(BaseStepper):
    name = "gradient_descent"


class ConjugateGradient(BaseStepper):
    name = "conjugate_gradient"


class BFGS(BaseStepper):
    name = "bfgs"


_BY_NAME = {
    "gd": GradientDescent,
    "gradient_descent": GradientDescent,
    "cg": ConjugateGradient,
    "conjugate_gradient": ConjugateGradient,
    "bfgs": BFGS,
}


def make_stepper(name: str) -> BaseStepper:
    try:
        return _BY_NAME[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown stepper {name!r}") from None
