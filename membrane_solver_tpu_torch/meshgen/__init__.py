"""Programmatic benchmark-mesh generators.

Copy of ``membrane_solver_tpu/meshgen/__init__.py`` (NumPy host code); only the
import paths differ.

The reference ships ~94 hand-maintained JSON/YAML input meshes
(reference ``meshes/`` + ``benchmarks/inputs/``), most of them produced
by one-off scripts (reference ``scripts/regenerate_free_disk_mesh.py``).
This package replaces that file zoo with parametric builders that emit
the same input schema (see ``geometry/io_readers.py``), so every
benchmark lane can be regenerated standalone:

    python -m membrane_solver_tpu_torch.meshgen kozlov_1disk -o lane.json
    python -m membrane_solver_tpu_torch.meshgen --list

Builders return plain dicts in the input-file schema; feed them to
``parse_geometry`` directly or serialize with ``json.dump``.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.meshgen.builders import (
    BUILDERS,
    build,
    catenoid,
    cube,
    dented_cube,
    flat_disk,
    kozlov_1disk,
    rect_tilt_source,
    sphere,
    spherical_cap,
    square_sheet,
    torus,
    two_disks_sphere,
)

__all__ = [
    "BUILDERS",
    "build",
    "cube",
    "square_sheet",
    "catenoid",
    "spherical_cap",
    "dented_cube",
    "sphere",
    "two_disks_sphere",
    "flat_disk",
    "kozlov_1disk",
    "rect_tilt_source",
    "torus",
]
