from membrane_solver_tpu_torch.visualization.plot_core import plot_geometry
from membrane_solver_tpu_torch.visualization.plot_live import update_live_vis

__all__ = ["plot_geometry", "update_live_vis"]
