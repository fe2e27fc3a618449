"""Geometry output (Mesh -> JSON/YAML).

Copy of ``membrane_solver_tpu/geometry/io_writers.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``geometry/io_writers.py`` — serializes full state
(positions, all three tilt fields, options, module lists, global parameters,
instructions, macros, definitions) using the explicit-ID mapping form, which
``parse_geometry`` round-trips losslessly.  This doubles as the
checkpoint/resume mechanism (reference SURVEY §5.4).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

from membrane_solver_tpu_torch.geometry.mesh import Mesh


def _clean(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return [_clean(v) for v in value.tolist()]
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, dict):
        return {k: _clean(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_clean(v) for v in value]
    return value


def mesh_to_dict(mesh: Mesh, compact: bool = False) -> Dict[str, Any]:
    """Serialize a mesh to the explicit-ID geometry dict form."""
    vertices: Dict[str, Any] = {}
    for vid in sorted(mesh.vertices):
        v = mesh.vertices[vid]
        opts = dict(v.options)
        if v.fixed:
            opts["fixed"] = True
        if np.any(v.tilt):
            opts["tilt"] = _clean(v.tilt)
        if np.any(v.tilt_in):
            opts["tilt_in"] = _clean(v.tilt_in)
        if np.any(v.tilt_out):
            opts["tilt_out"] = _clean(v.tilt_out)
        if v.tilt_fixed:
            opts["tilt_fixed"] = True
        if v.tilt_fixed_in:
            opts["tilt_fixed_in"] = True
        if v.tilt_fixed_out:
            opts["tilt_fixed_out"] = True
        entry = [float(x) for x in v.position]
        if opts:
            entry.append(_clean(opts))
        vertices[str(vid)] = entry

    edges: Dict[str, Any] = {}
    for eid in sorted(mesh.edges):
        e = mesh.edges[eid]
        opts = dict(e.options)
        if e.fixed:
            opts["fixed"] = True
        entry = [e.tail_index, e.head_index]
        if opts:
            entry.append(_clean(opts))
        edges[str(eid)] = entry

    faces: Dict[str, Any] = {}
    for fid in sorted(mesh.facets):
        f = mesh.facets[fid]
        opts = dict(f.options)
        if f.fixed:
            opts["fixed"] = True
        if compact:
            for key in ("parent_facet",):
                opts.pop(key, None)
        entry = list(f.edge_indices)
        if opts:
            entry.append(_clean(opts))
        faces[str(fid)] = entry

    bodies: Dict[str, Any] = {}
    for bid in sorted(mesh.bodies):
        b = mesh.bodies[bid]
        spec: Dict[str, Any] = {"faces": list(b.facet_indices)}
        if b.target_volume is not None:
            spec["target_volume"] = float(b.target_volume)
        for k, v in b.options.items():
            if k not in spec:
                spec[k] = _clean(v)
        bodies[str(bid)] = spec

    out: Dict[str, Any] = {
        "vertices": vertices,
        "edges": edges,
        "faces": faces,
    }
    if bodies:
        out["bodies"] = bodies
    out["global_parameters"] = _clean(mesh.global_parameters.to_dict())
    # module lists are part of the checkpoint surface (reference
    # io_writers.py / test_save_geometry_preserves_modules.py)
    if mesh.energy_modules:
        out["energy_modules"] = list(mesh.energy_modules)
    if mesh.constraint_modules:
        out["constraint_modules"] = list(mesh.constraint_modules)
    if mesh.definitions:
        out["definitions"] = _clean(mesh.definitions)
    if mesh.instructions:
        out["instructions"] = list(mesh.instructions)
    if mesh.macros:
        out["macros"] = {k: list(v) for k, v in mesh.macros.items()}
    return out


def save_geometry(mesh: Mesh, path: str | Path, compact: bool = False) -> None:
    """Write a mesh to JSON or YAML (by extension)."""
    path = Path(path)
    payload = mesh_to_dict(mesh, compact=compact)
    if path.suffix.lower() in {".yaml", ".yml"}:
        import yaml

        path.write_text(yaml.safe_dump(payload, sort_keys=False))
    else:
        path.write_text(json.dumps(payload, indent=None if compact else 1))
