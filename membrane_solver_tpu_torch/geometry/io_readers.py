"""Geometry input parsing (JSON/YAML -> Mesh).

Copy of ``membrane_solver_tpu/geometry/io_readers.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``geometry/io_readers.py`` (list and explicit-ID entity
forms, ``defines`` evaluation, preset ``definitions``, constraint name
normalization and aliases, per-entity ``energy``/``constraints`` module
collection, volume-mode pairing, auto-triangulation of polygonal facets).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from membrane_solver_tpu_torch.core.expr import eval_expr, expr_free_names
from membrane_solver_tpu_torch.core.ordered_set import OrderedUniqueList
from membrane_solver_tpu_torch.core.parameters import GlobalParameters
from membrane_solver_tpu_torch.geometry.entities import Body, Edge, Facet, Vertex
from membrane_solver_tpu_torch.geometry.mesh import Mesh

logger = logging.getLogger("membrane_solver_tpu_torch")

CONSTRAINT_ALIASES = {
    "pin_surface_group_to_shape": "pin_to_plane",
}

PIN_TO_PLANE_KEY_ALIASES = {
    "pin_surface_group_to_shape_mode": "pin_to_plane_mode",
    "pin_surface_group_to_shape_group": "pin_to_plane_group",
    "pin_surface_group_to_shape_normal": "pin_to_plane_normal",
    "pin_surface_group_to_shape_point": "pin_to_plane_point",
}

_TRUTHY = {"1", "true", "yes", "y", "on"}

# global-parameter keys coerced to float when given as strings/ints
_FLOAT_PARAM_KEYS = (
    "surface_tension",
    "volume_stiffness",
    "intrinsic_curvature",
    "bending_modulus",
    "gaussian_modulus",
    "step_size",
    "tilt_modulus",
    "tilt_modulus_in",
    "tilt_modulus_out",
    "tilt_smoothness_modulus",
    "line_tension",
)


def load_data(filename: str | Path) -> dict:
    """Load a JSON or YAML geometry file into a plain dict."""
    path = Path(filename)
    text = path.read_text()
    if path.suffix.lower() in {".yaml", ".yml"}:
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def _as_bool(value) -> bool:
    if isinstance(value, str):
        return value.strip().lower() in _TRUTHY
    return bool(value)


def _apply_pin_aliases(options: dict) -> dict:
    for alias, canonical in PIN_TO_PLANE_KEY_ALIASES.items():
        if alias in options:
            options.setdefault(canonical, options[alias])
            options.pop(alias, None)
    return options


def _canonical_constraint(name: str) -> str:
    return CONSTRAINT_ALIASES.get(name, name)


def _normalize_constraint_list(raw) -> List[str]:
    if raw is None:
        return []
    if isinstance(raw, str):
        raw = [raw]
    return [_canonical_constraint(str(c)) for c in raw]


def parse_geometry(data: dict) -> Mesh:
    """Build a Mesh from parsed geometry data."""
    mesh = Mesh()
    # top-level module lists seed the ordered collections (io_readers.py:230-251)
    energy_modules = OrderedUniqueList(data.get("energy_modules", []) or [])
    constraint_modules = OrderedUniqueList(
        _normalize_constraint_list(data.get("constraint_modules", []) or [])
    )

    # -- global parameters + defines -----------------------------------
    gp_block = dict(data.get("global_parameters", {}) or {})
    _apply_pin_aliases(gp_block)
    gp = GlobalParameters(gp_block)
    for key in _FLOAT_PARAM_KEYS:
        val = gp.get(key)
        if val is not None and not isinstance(val, (dict, list)):
            try:
                gp.set(key, float(val))
            except (TypeError, ValueError):
                pass
    mesh.global_parameters = gp

    # Volume-mode default pairing (reference io_readers.py:195-228): the mode
    # and the geometric-projection flag are complementary — specifying only
    # one fixes the other.  lagrange pairs with projection OFF (pure KKT +
    # drift check); penalty pairs with projection ON.
    has_mode = "volume_constraint_mode" in gp_block
    has_proj = "volume_projection_during_minimization" in gp_block
    if not has_mode and not has_proj:
        gp.set("volume_constraint_mode", "lagrange")
        gp.set("volume_projection_during_minimization", False)
    elif has_mode and not has_proj:
        mode = str(gp.get("volume_constraint_mode", "lagrange")).lower()
        gp.set("volume_projection_during_minimization", mode != "lagrange")
    elif has_proj and not has_mode:
        proj = bool(gp.get("volume_projection_during_minimization", True))
        gp.set("volume_constraint_mode", "penalty" if proj else "lagrange")
    mode = str(gp.get("volume_constraint_mode", "lagrange")).lower()
    proj_flag = bool(gp.get("volume_projection_during_minimization", False))
    if mode == "lagrange" and proj_flag:
        logger.warning(
            "volume_constraint_mode='lagrange' with "
            "volume_projection_during_minimization=True is known to be unstable."
        )
    if mode == "penalty" and not proj_flag:
        logger.warning(
            "volume_constraint_mode='penalty' without geometric projection is "
            "not supported; consider enabling volume_projection_during_minimization."
        )

    defines = data.get("defines") or {}
    if defines:
        if not isinstance(defines, dict):
            raise TypeError("defines must be a mapping of name -> expression")
        known: Dict[str, float] = {
            k: float(v) for k, v in gp.to_dict().items() if isinstance(v, (int, float))
        }
        pending = dict(defines)
        for _ in range(len(pending) + 1):
            progressed = False
            for name in list(pending):
                expr = pending[name]
                if isinstance(expr, (int, float)):
                    value = float(expr)
                elif expr_free_names(str(expr)) <= set(known):
                    value = eval_expr(str(expr), known)
                else:
                    continue
                known[name] = value
                gp.set(name, value)
                del pending[name]
                progressed = True
            if not pending:
                break
            if not progressed:
                raise ValueError(f"Could not resolve defines: {sorted(pending)}")

    if not energy_modules and float(gp.get("surface_tension", 0.0) or 0.0) > 0:
        energy_modules.append("surface")
    if gp.get("target_surface_area") is not None:
        constraint_modules.append("global_area")

    definitions = data.get("definitions", {})
    mesh.definitions = dict(definitions) if isinstance(definitions, dict) else {}

    def resolve_options(raw_opts) -> dict:
        opts = dict(raw_opts or {})
        preset = opts.get("preset")
        if preset:
            if preset not in mesh.definitions:
                # Refined meshes keep preset *names* after the definitions are
                # dropped (see runtime/refinement.py parity note); tolerate
                # them on reload instead of failing the round-trip.
                logger.debug("Preset %r not in definitions; keeping name only.", preset)
                return _apply_pin_aliases(opts)
            merged = dict(mesh.definitions[preset])
            merged.update(opts)
            merged.setdefault("preset", preset)
            return _apply_pin_aliases(merged)
        return _apply_pin_aliases(opts)

    def normalize_constraints(options: dict, entity) -> List[str]:
        """Split 'fixed' out of constraints, canonicalize names, set entity.fixed."""
        raw = options.get("constraints")
        names = _normalize_constraint_list(raw)
        fixed = options.get("fixed", False)
        if "fixed" in names:
            fixed = True
            names = [c for c in names if c != "fixed"]
        if _as_bool(fixed):
            entity.fixed = True
        if raw is not None or names:
            options["constraints"] = names
        if options.get("constraint_expression") is not None or options.get(
            "expression_constraint"
        ) is not None:
            if "expression" not in names:
                names.append("expression")
                options["constraints"] = names
        return names

    def collect_energy(options: dict) -> None:
        spec = options.get("energy")
        if spec is None:
            pass
        elif isinstance(spec, str):
            energy_modules.add(spec)
        elif isinstance(spec, list):
            energy_modules.extend(spec)
        else:
            raise TypeError("energy modules should be a list or a single string")
        if options.get("expression") or options.get("energy_expression") or options.get("expr"):
            cur = options.get("energy")
            if cur is None:
                options["energy"] = ["expression"]
            elif isinstance(cur, str):
                options["energy"] = [cur, "expression"] if cur != "expression" else [cur]
            elif "expression" not in cur:
                cur.append("expression")
            energy_modules.add("expression")

    # -- vertices -------------------------------------------------------
    raw_vertices = data.get("vertices") or data.get("Vertices")
    if raw_vertices is None:
        raise ValueError("Geometry file must contain 'vertices'")
    if isinstance(raw_vertices, dict):
        vertex_items = sorted(((int(k), v) for k, v in raw_vertices.items()))
    else:
        vertex_items = list(enumerate(raw_vertices))

    for vid, entry in vertex_items:
        if isinstance(entry[-1], dict):
            *coords, raw_opts = entry
        else:
            coords, raw_opts = list(entry), {}
        options = resolve_options(raw_opts)
        pos = np.asarray(coords, dtype=float)
        if np.any(~np.isfinite(pos)):
            raise ValueError(f"Vertex {vid} has non-finite coordinates.")
        tilt_fixed = _as_bool(options.pop("tilt_fixed", options.pop("fixed_tilt", False)))
        tilt_fixed_in = _as_bool(options.pop("tilt_fixed_in", False))
        tilt_fixed_out = _as_bool(options.pop("tilt_fixed_out", False))
        vertex = Vertex(
            index=vid,
            position=pos,
            options=options,
            tilt=options.get("tilt"),
            tilt_in=options.get("tilt_in"),
            tilt_out=options.get("tilt_out"),
            tilt_fixed=tilt_fixed,
            tilt_fixed_in=tilt_fixed_in,
            tilt_fixed_out=tilt_fixed_out,
        )
        mesh.vertices[vid] = vertex
        collect_energy(options)
        constraint_modules.extend(normalize_constraints(options, vertex))

    # -- edges ----------------------------------------------------------
    raw_edges = data.get("edges") or data.get("Edges")
    if raw_edges is None:
        raise KeyError("Input geometry is missing required 'edges' section.")
    edges_explicit = isinstance(raw_edges, dict)
    if edges_explicit:
        edge_items = sorted(((int(k), v) for k, v in raw_edges.items()))
    else:
        # list form: edge ids are 1-based positions so signed refs can negate
        edge_items = [(i + 1, entry) for i, entry in enumerate(raw_edges)]

    for eid, entry in edge_items:
        tail, head, *rest = entry
        options = resolve_options(rest[0] if rest else {})
        edge = Edge(index=eid, tail_index=int(tail), head_index=int(head), options=options)
        if edge.tail_index not in mesh.vertices or edge.head_index not in mesh.vertices:
            raise ValueError(f"Edge {eid} references a missing vertex")
        mesh.edges[eid] = edge
        collect_energy(options)
        constraint_modules.extend(normalize_constraints(options, edge))
        if edge.fixed:
            mesh.vertices[edge.tail_index].fixed = True
            mesh.vertices[edge.head_index].fixed = True

    # -- facets ----------------------------------------------------------
    raw_faces = data.get("faces") or data.get("Faces") or data.get("Facets") or []
    faces_explicit = isinstance(raw_faces, dict)
    if faces_explicit:
        face_items = sorted(((int(k), v) for k, v in raw_faces.items()))
    else:
        face_items = list(enumerate(raw_faces))

    def parse_edge_ref(e) -> int:
        # "rN" = reversed edge N; in list form edge positions are 0-based on
        # disk, 1-based in the mesh, and negatives shift accordingly (-11 -> -12).
        # Explicit-ID quirk kept for parity: "r0" with explicit edge ids yields
        # -0 == 0, losing the reversal — identical to the reference
        # (io_readers.py:559-563); explicit ids are 1-based by convention.
        if isinstance(e, str) and e.startswith("r"):
            k = int(e[1:])
            return -k if edges_explicit else -(k + 1)
        i = int(e)
        if edges_explicit:
            return i
        return i + 1 if i >= 0 else i - 1

    for fid, entry in face_items:
        if isinstance(entry[-1], dict):
            *raw_refs, raw_opts = entry
        else:
            raw_refs, raw_opts = list(entry), {}
        options = resolve_options(raw_opts)
        facet = Facet(index=fid, edge_indices=[parse_edge_ref(e) for e in raw_refs], options=options)
        mesh.facets[fid] = facet
        if "energy" in options:
            if isinstance(options["energy"], str):
                options["energy"] = [options["energy"]]
            collect_energy(options)
        else:
            # surface energy is on by default iff the facet's tension contributes
            try:
                tension = float(
                    options.get("surface_tension", gp.get("surface_tension", 0.0))
                )
            except (TypeError, ValueError):
                tension = 0.0
            if tension != 0.0:
                options["energy"] = ["surface"]
                energy_modules.add("surface")
            else:
                options["energy"] = []
            collect_energy(options)
        options.setdefault("surface_tension", gp.get("surface_tension", 1.0))
        names = normalize_constraints(options, facet)
        if options.get("target_area") is not None and "fix_facet_area" not in names:
            names.append("fix_facet_area")
            options["constraints"] = names
        constraint_modules.extend(names)

    vol_mode = gp.get("volume_constraint_mode", "lagrange")
    if vol_mode == "penalty":
        energy_modules.add("volume")

    # -- bodies ----------------------------------------------------------
    def finish_body(body: Body, target_volume) -> None:
        mesh.bodies[body.index] = body
        if target_volume is not None:
            if isinstance(target_volume, str) and target_volume.lower() == "initial":
                body.target_volume = mesh.body_volume(body)
            else:
                body.target_volume = float(target_volume)
            body.options["target_volume"] = body.target_volume
        collect_energy(body.options)
        names = _normalize_constraint_list(body.options.get("constraints", []))
        if target_volume is not None and vol_mode == "lagrange" and "volume" not in names:
            names.append("volume")
        if body.options.get("target_area") is not None and "body_area" not in names:
            names.append("body_area")
        if body.options.get("constraint_expression") is not None or body.options.get(
            "expression_constraint"
        ) is not None:
            if "expression" not in names:
                names.append("expression")
        if names:
            body.options["constraints"] = names
            constraint_modules.extend(names)

    bodies_section = data.get("bodies") or data.get("Bodies")
    if bodies_section:
        explicit_map = (
            isinstance(bodies_section, dict)
            and "faces" not in bodies_section
            and all(isinstance(s, dict) and "faces" in s for s in bodies_section.values())
        )
        if explicit_map:
            for raw_bid, spec in bodies_section.items():
                bid = int(raw_bid)
                opts = {k: v for k, v in spec.items() if k != "faces"}
                target_volume = opts.pop("target_volume", None)
                if opts.get("target_area") is not None:
                    opts["target_area"] = float(opts["target_area"])
                body = Body(
                    index=bid,
                    facet_indices=[int(f) for f in spec["faces"]],
                    target_volume=None,
                    options=opts,
                )
                finish_body(body, target_volume)
        else:
            groups = bodies_section["faces"]
            n = len(groups)

            def _parallel(key, default=None):
                vals = bodies_section.get(key, [default] * n)
                if not isinstance(vals, list) or len(vals) != n:
                    vals = [vals] * n
                return vals

            volumes = _parallel("target_volume")
            areas = _parallel("target_area")
            energies = _parallel("energy")
            constraints = _parallel("constraints")
            for i, facet_ids in enumerate(groups):
                opts: Dict[str, Any] = {}
                if isinstance(energies[i], dict):
                    opts.update(energies[i])
                elif energies[i] is not None:
                    opts["energy"] = (
                        [energies[i]] if isinstance(energies[i], str) else energies[i]
                    )
                if constraints[i] is not None:
                    opts["constraints"] = _normalize_constraint_list(constraints[i])
                if areas[i] is not None:
                    opts.setdefault("target_area", float(areas[i]))
                body = Body(
                    index=i,
                    facet_indices=[int(f) for f in facet_ids],
                    target_volume=None,
                    options=opts,
                )
                finish_body(body, volumes[i])

    # -- instructions / macros ------------------------------------------
    mesh.instructions = list(data.get("instructions", []) or [])

    def split_commands(text: str) -> List[str]:
        return [c.strip() for c in text.replace("\n", ";").split(";") if c.strip()]

    macros: Dict[str, List[str]] = {}
    for name, bodytext in (data.get("macros", {}) or {}).items():
        if not isinstance(name, str) or not name.strip():
            raise TypeError("macro names must be non-empty strings")
        if isinstance(bodytext, str):
            macros[name.strip()] = split_commands(bodytext)
        elif isinstance(bodytext, list):
            lines: List[str] = []
            for item in bodytext:
                if not isinstance(item, str):
                    raise TypeError("macro entries must be strings")
                lines.extend(split_commands(item))
            macros[name.strip()] = lines
        elif bodytext is None:
            macros[name.strip()] = []
        else:
            raise TypeError("macros must be a string or a list of strings")
    mesh.macros = macros

    mesh.energy_modules = energy_modules
    mesh.constraint_modules = constraint_modules

    mesh.initialize_tilts_from_options()
    mesh.validate_edge_indices()

    def strip_tilt_options(m: Mesh) -> None:
        for vertex in m.vertices.values():
            for key in (
                "tilt",
                "tilt_fixed",
                "fixed_tilt",
                "tilt_in",
                "tilt_out",
                "tilt_fixed_in",
                "tilt_fixed_out",
            ):
                vertex.options.pop(key, None)

    # Auto-triangulate polygonal facets at load time (centroid fans).
    if any(len(f.edge_indices) > 3 for f in mesh.facets.values()):
        from membrane_solver_tpu_torch.runtime.refinement import refine_polygonal_facets

        mesh = refine_polygonal_facets(mesh)
        mesh.initialize_tilts_from_options()

    strip_tilt_options(mesh)
    mesh.full_mesh_validate()
    mesh.project_tilts_to_tangent()
    return mesh


def load_geometry(filename: str | Path) -> Mesh:
    """Convenience: load + parse in one call."""
    return parse_geometry(load_data(filename))
