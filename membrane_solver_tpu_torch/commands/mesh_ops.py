"""Mesh-operation commands: refine, equiangulate, vertex-average, perturb, snapshot.

Copy of ``membrane_solver_tpu/commands/mesh_ops.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``commands/mesh_ops.py`` — refine replaces the mesh and
resets solver caches; vertex-average and equiangulate additionally re-enforce
hard constraints.
"""

from __future__ import annotations

import logging

import numpy as np

from membrane_solver_tpu_torch.commands.base import Command
from membrane_solver_tpu_torch.runtime.equiangulation import equiangulate_mesh
from membrane_solver_tpu_torch.runtime.refinement import (
    refine_polygonal_facets,
    refine_triangle_mesh,
)
from membrane_solver_tpu_torch.runtime.vertex_average import vertex_average

logger = logging.getLogger("membrane_solver_tpu_torch")


class RefineCommand(Command):
    help_text = "r[N] — refine the mesh N times (1→4 subdivision)"

    def execute(self, context, args):
        count = 1
        if args and args[0].isdigit():
            count = int(args[0])
        for i in range(count):
            logger.info("Refining mesh... (%d/%d)", i + 1, count)
            context.mesh = refine_polygonal_facets(context.mesh)
            context.mesh = refine_triangle_mesh(context.mesh)
            context.minimizer.set_mesh(context.mesh)
        logger.info("Mesh refinement complete after %d pass(es).", count)


class VertexAverageCommand(Command):
    help_text = "V[N] — Evolver-style vertex averaging, N passes"

    def execute(self, context, args):
        n_passes = 1
        if args and args[0].isdigit():
            n_passes = int(args[0])
        for _ in range(n_passes):
            vertex_average(context.mesh)
        logger.info("Vertex averaging done.")
        context.minimizer.invalidate()
        context.minimizer.enforce_constraints_after_mesh_ops(context.mesh)


class EquiangulateCommand(Command):
    help_text = "u — equiangulate (Delaunay edge flips)"

    def execute(self, context, args):
        logger.info("Starting equiangulation...")
        context.mesh = equiangulate_mesh(context.mesh)
        context.minimizer.set_mesh(context.mesh)
        context.minimizer.enforce_constraints_after_mesh_ops(context.mesh)
        logger.info("Equiangulation complete.")


class PerturbCommand(Command):
    help_text = "perturb [scale] — add random noise to movable vertices"

    def execute(self, context, args):
        scale = 0.01
        if args:
            try:
                scale = float(args[0])
            except ValueError:
                pass
        logger.info("Perturbing vertex positions (scale=%s)...", scale)
        for v in context.mesh.vertices.values():
            if not v.fixed:
                v.position += scale * np.random.normal(size=3)
        context.minimizer.invalidate()


class SnapshotCommand(Command):
    """snapshot [edges|facets|all] [where key=value] — freeze targets at current values."""

    def execute(self, context, args):
        what = args[0] if args else "all"
        where = {}
        if "where" in args:
            i = args.index("where")
            for token in args[i + 1 :]:
                if "=" in token:
                    k, v = token.split("=", 1)
                    where[k] = v

        def matches(options):
            return all(str(options.get(k)) == v for k, v in where.items())

        count = 0
        if what in {"facets", "all"}:
            for facet in context.mesh.facets.values():
                if matches(facet.options):
                    facet.options["target_area"] = context.mesh.facet_area(facet)
                    count += 1
        if what in {"edges", "all"}:
            for edge in context.mesh.edges.values():
                if matches(edge.options):
                    p1 = context.mesh.vertices[edge.tail_index].position
                    p2 = context.mesh.vertices[edge.head_index].position
                    edge.options["target_length"] = float(np.linalg.norm(p2 - p1))
                    count += 1
        logger.info("Snapshot updated %d entities.", count)
        context.minimizer.invalidate()
