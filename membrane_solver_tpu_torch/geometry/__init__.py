"""Host mesh entities, readers and writers (a copy of ``membrane_solver_tpu/geometry``)."""
