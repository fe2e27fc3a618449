from membrane_solver_tpu_torch.parallel.sweep import (
    SweepBatch,
    batch_problem,
    make_sweep_minimize,
    run_sweep,
    sweep_mesh,
)

__all__ = ["SweepBatch", "batch_problem", "make_sweep_minimize", "run_sweep", "sweep_mesh"]
