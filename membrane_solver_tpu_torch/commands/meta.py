"""Meta commands: set/print/energy/step-size/help/history/tilt_stats/refresh.

Counterpart of ``membrane_solver_tpu/commands/meta.py``: the same host
code; ``energy stats`` takes the curvature data from
``kernels/tri_kernels.curvature_data`` (the CUDA kernel on a card, its twin
on the CPU), and the device tensors reach NumPy through ``.cpu()``.

Parity: reference ``commands/meta.py`` (subset now; filters and reference
deltas grow with the tilt lanes).
"""

from __future__ import annotations

import logging

import numpy as np

from membrane_solver_tpu_torch.commands.base import Command

logger = logging.getLogger("membrane_solver_tpu_torch")


def _coerce(text: str):
    low = text.lower()
    if low in {"true", "yes", "on"}:
        return True
    if low in {"false", "no", "off"}:
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


class SetCommand(Command):
    """set <param> <value> | set vertex <id> <attr> <value> | set <entity> <id> <key> <value>"""

    def execute(self, context, args):
        if not args:
            for k, v in sorted(context.mesh.global_parameters.to_dict().items()):
                print(f"{k} = {v}")
            return
        entity_kinds = {"vertex", "edge", "facet", "face", "body"}
        if args[0].lower() in entity_kinds and len(args) >= 4:
            kind = args[0].lower()
            idx = int(args[1])
            key = args[2]
            value = _coerce(" ".join(args[3:]))
            store = {
                "vertex": context.mesh.vertices,
                "edge": context.mesh.edges,
                "facet": context.mesh.facets,
                "face": context.mesh.facets,
                "body": context.mesh.bodies,
            }[kind]
            entity = store[idx]
            if hasattr(entity, key) and not isinstance(getattr(entity, key, None), dict):
                setattr(entity, key, value)
            else:
                entity.options[key] = value
            context.minimizer.invalidate()
            logger.info("Set %s %d %s = %r", kind, idx, key, value)
            return
        if len(args) >= 2:
            key = args[0]
            value = _coerce(" ".join(args[1:]))
            context.mesh.global_parameters.set(key, value)
            context.minimizer.invalidate()
            logger.info("Set %s = %r", key, value)
        else:
            value = context.mesh.global_parameters.get(args[0])
            print(f"{args[0]} = {value}")


class PrintEntityCommand(Command):
    """print vertices|edges|facets|bodies [filter-expr]"""

    def execute(self, context, args):
        mesh = context.mesh
        what = args[0].lower() if args else "summary"
        if what.startswith("vert"):
            for vid in sorted(mesh.vertices):
                v = mesh.vertices[vid]
                flags = "F" if v.fixed else " "
                print(f"v{vid:5d} {flags} pos={np.round(v.position, 6)}")
        elif what.startswith("edge"):
            for eid in sorted(mesh.edges):
                e = mesh.edges[eid]
                length = np.linalg.norm(
                    mesh.vertices[e.head_index].position - mesh.vertices[e.tail_index].position
                )
                print(f"e{eid:5d} {e.tail_index}->{e.head_index} len={length:.6f}")
        elif what.startswith("face") or what.startswith("facet"):
            for fid in sorted(mesh.facets):
                f = mesh.facets[fid]
                print(f"f{fid:5d} area={mesh.facet_area(f):.6f} edges={f.edge_indices}")
        elif what.startswith("bod"):
            for bid in sorted(mesh.bodies):
                b = mesh.bodies[bid]
                print(
                    f"b{bid:3d} volume={mesh.body_volume(b):.6f} "
                    f"target={b.target_volume} facets={len(b.facet_indices)}"
                )
        else:
            print(mesh)


class EnergyCommand(Command):
    """energy [breakdown|total|ref|stats] — reference commands/meta.py:84-187.

    Modes:
      breakdown/details/detail (default) — total + internal/external-work
        split (modules flagged IS_EXTERNAL_WORK), deltas vs a stored
        reference, then the per-module lines;
      ref/reference — store the current total and internal total as the
        reference for later breakdown deltas;
      stats/curvature — per-vertex |H| quantile diagnostics (cotan/Meyer
        mixed-area curvature, boundary rows reported separately);
      total/sum — just the total;
      save — repo extension: store the per-module breakdown for per-line
        deltas.
    """

    def _external_names(self, context):
        from membrane_solver_tpu_torch.energy import get_module

        names = getattr(context.minimizer, "energy_module_names", []) or []
        return {
            n for n in names if getattr(get_module(n), "IS_EXTERNAL_WORK", False)
        }

    def execute(self, context, args):
        mode = str(args[0]).lower().strip() if args else "breakdown"

        if mode in {"ref", "reference"}:
            breakdown = context.minimizer.compute_energy_breakdown()
            external = self._external_names(context)
            internal_total = sum(
                v for n, v in breakdown.items() if n not in external
            )
            total = sum(breakdown.values())
            context.minimizer.energy_ref_total = float(total)
            context.minimizer.energy_ref_internal = float(internal_total)
            print(
                f"Energy reference set: total={total:.10f} "
                f"internal={internal_total:.10f}"
            )
            return

        if mode in {"stats", "curvature"}:
            import torch

            from membrane_solver_tpu_torch.kernels import tri_kernels

            p = context.minimizer.problem()
            nv = len(context.mesh.vertices)
            with torch.no_grad():
                cd = tri_kernels.curvature_data(
                    p.state.positions, p.topo.tri_rows, p.topo.tri_valid,
                    p.topo.corner_csr(),
                )
            k = cd.k_vecs.cpu().numpy()[:nv]
            areas = cd.vertex_areas.cpu().numpy()[:nv]
            H = np.linalg.norm(k, axis=1) / np.maximum(2.0 * areas, 1e-30)
            boundary = p.topo.boundary_vertex_mask.cpu().numpy()[:nv]

            def _stats(name, vals):
                if vals.size == 0:
                    print(f"{name}: (no vertices)")
                    return
                q = np.quantile(np.asarray(vals, dtype=float),
                                [0.0, 0.5, 0.9, 0.99, 1.0])
                print(
                    f"{name}: min={q[0]:.4e} med={q[1]:.4e} "
                    f"p90={q[2]:.4e} p99={q[3]:.4e} max={q[4]:.4e}"
                )

            print("Curvature diagnostics (|H|):")
            print(f"  vertices: {nv} (boundary {int(boundary.sum())})")
            _stats("  all", H)
            if np.any(~boundary):
                _stats("  interior", H[~boundary])
            return

        if mode in {"total", "sum"}:
            print(f"Current Total Energy: {float(context.minimizer.compute_energy()):.10f}")
            return

        if mode not in {"breakdown", "details", "detail", "save"}:
            print("Usage: energy [breakdown|total|ref|stats]")
            return

        breakdown = context.minimizer.compute_energy_breakdown()
        external = self._external_names(context)
        internal_total = sum(v for n, v in breakdown.items() if n not in external)
        external_total = sum(v for n, v in breakdown.items() if n in external)
        total = internal_total + external_total
        print(f"Current Total Energy: {total:.10f}")
        if external:
            print(f"  internal (no sources): {internal_total:.10f}")
            print(f"  external work (sources): {external_total:.10f}")
            ref_total = getattr(context.minimizer, "energy_ref_total", None)
            ref_internal = getattr(context.minimizer, "energy_ref_internal", None)
            if ref_total is not None:
                print(f"  Δtotal vs ref: {total - float(ref_total):.10f}")
            if ref_internal is not None:
                print(
                    f"  Δinternal vs ref: "
                    f"{internal_total - float(ref_internal):.10f}"
                )
        ref = context.reference_energy
        for name, value in breakdown.items():
            line = f"  {name}: {value:.10f}"
            if ref and name in ref:
                line += f"   (delta {value - ref[name]:+.3e})"
            print(line)
        if mode == "save":
            context.reference_energy = dict(breakdown)


class StepSizeCommand(Command):
    """t<value> — set the optimizer step size; tf frees it (adaptive)."""

    def execute(self, context, args):
        if not args:
            print(f"step size = {context.minimizer.step_size:.3e}")
            return
        if args[0] == "free":
            context.mesh.global_parameters.set("step_size_mode", "adaptive")
            logger.info("Step size control: adaptive")
            return
        try:
            value = float(args[0])
        except ValueError:
            logger.warning("Invalid step size: %s", args[0])
            return
        context.minimizer.step_size = value
        context.mesh.global_parameters.set("step_size", value)
        logger.info("Step size set to %.3e", value)


class TiltStatsCommand(Command):
    """tilt_stats — |t| and div(t) summaries per leaflet."""

    def execute(self, context, args):
        p = context.minimizer.problem()
        from membrane_solver_tpu_torch.device.tilt_ops import p1_vertex_divergence

        nv = p.n_vertices
        for label, arr in (
            ("tilt", p.state.tilts),
            ("tilt_in", p.state.tilts_in),
            ("tilt_out", p.state.tilts_out),
        ):
            mags = np.linalg.norm(arr[:nv].cpu().numpy(), axis=1)
            if not mags.size or not np.any(mags):
                continue
            div = p1_vertex_divergence(
                p.state.positions, arr, p.topo.tri_rows, p.topo.tri_valid, p.topo.corner_csr()
            ).cpu().numpy()[:nv]
            print(
                f"{label}: |t| mean={mags.mean():.6f} max={mags.max():.6f}  "
                f"div mean={div.mean():.6f} max={np.abs(div).max():.6f}"
            )


class HelpCommand(Command):
    def execute(self, context, args):
        from membrane_solver_tpu_torch.commands.registry import COMMAND_REGISTRY

        seen = {}
        for name, cmd in COMMAND_REGISTRY.items():
            seen.setdefault(id(cmd), []).append(name)
        for cmd_names in sorted(seen.values()):
            cmd = COMMAND_REGISTRY[cmd_names[0]]
            text = getattr(cmd, "help_text", "") or type(cmd).__name__
            print(f"{'/'.join(cmd_names):24s} {text}")


class HistoryCommand(Command):
    def execute(self, context, args):
        for line in getattr(context, "history", []) or []:
            print(line)


class RefreshModulesCommand(Command):
    def execute(self, context, args):
        context.minimizer.invalidate()
        logger.info("Solver caches refreshed; modules re-resolved on next evaluation.")


class QuitCommand(Command):
    def execute(self, context, args):
        raise SystemExit(0)
