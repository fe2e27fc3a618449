"""Live (persistent-figure) visualization updated during minimization.

Counterpart of ``membrane_solver_tpu/visualization/plot_live.py`` (the
reference's ``visualization/plot_live.py``): a figure/axes pair reused
across minimize-step callbacks.
"""

from __future__ import annotations

from typing import Optional

from membrane_solver_tpu_torch.visualization.plot_core import _ensure_backend, plot_geometry


def update_live_vis(
    mesh,
    state=None,
    title: Optional[str] = None,
    color_by: Optional[str] = None,
    show_tilt_arrows: bool = False,
    show_edges: bool = True,
    device=None,
    dtype=None,
):
    """Redraw the mesh into a persistent figure; returns updated state.

    ``device`` and ``dtype`` are ``plot_geometry``'s (the ``div`` modes').
    """
    _ensure_backend()
    import matplotlib.pyplot as plt

    if state is None or not plt.fignum_exists(state["fig"].number):
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(111, projection="3d")
        state = {"fig": fig, "ax": ax}
        plt.ion()
    ax = state["ax"]
    ax.cla()
    plot_geometry(
        mesh,
        ax=ax,
        color_by=color_by,
        show_tilt_arrows=show_tilt_arrows,
        show_edges=show_edges,
        title=title,
        device=device,
        dtype=dtype,
    )
    state["fig"].canvas.draw_idle()
    try:
        state["fig"].canvas.flush_events()
    except Exception:
        pass
    return state
