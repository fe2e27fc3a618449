"""I/O commands: save, one-shot visualize, properties.

Counterpart of ``membrane_solver_tpu/commands/io.py``: the same host code,
except that the one-shot view (``s``/``visualize``) is not ported and raises
NotImplementedError.

Parity: reference ``commands/io.py``.
"""

from __future__ import annotations

import logging

from membrane_solver_tpu_torch.commands.base import Command
from membrane_solver_tpu_torch.geometry.io_writers import save_geometry

logger = logging.getLogger("membrane_solver_tpu_torch")


class SaveCommand(Command):
    help_text = "save <path> — write full mesh state (JSON/YAML)"

    def execute(self, context, args):
        path = args[0] if args else "mesh_out.json"
        save_geometry(context.mesh, path)
        logger.info("Saved mesh to %s", path)


class VisualizeCommand(Command):
    help_text = "s [tilt] [arrows] — one-shot matplotlib view (not ported)"

    def execute(self, context, args):
        raise NotImplementedError(
            "visualization (s/visualize) is not ported to membrane_solver_tpu_torch"
        )


class PropertiesCommand(Command):
    help_text = "p — print area/volume/Rg/targets"

    def execute(self, context, args):
        mesh = context.mesh
        area = mesh.compute_total_surface_area()
        print(f"Total surface area: {area:.8f}")
        for bid in sorted(mesh.bodies):
            body = mesh.bodies[bid]
            vol = mesh.body_volume(body)
            print(f"Body {bid}: volume={vol:.8f} target={body.target_volume}")
        # surface radius of gyration (area-weighted RMS distance from centroid)
        import numpy as np

        pts = mesh.positions_array()
        if len(pts):
            centroid = pts.mean(axis=0)
            rg = float(np.sqrt(np.mean(np.sum((pts - centroid) ** 2, axis=1))))
            print(f"Radius of gyration: {rg:.8f}")
