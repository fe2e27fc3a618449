"""Host-side core utilities (a copy of ``membrane_solver_tpu/core``)."""
