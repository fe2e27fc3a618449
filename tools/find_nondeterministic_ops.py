#!/usr/bin/env python3
"""List the PyTorch operations on the port's solver path that CUDA runs nondeterministically.

Turns on ``torch.use_deterministic_algorithms(True, warn_only=True)`` for
this process only (the package never does), drives the port's lanes on the
card at a small size, and prints every warning PyTorch raises for an
operation without a deterministic CUDA implementation, by the source line
that issued it.  An empty list means the lanes' CUDA operations add in a
fixed order.  The lanes: kozlov (meshgen ``kozlov_1disk``, small, one
refinement), the same with ``tilt_smoothness_{in,out}`` (the smooth lane of
``chip_smoke.py`` phases 18-19), the leaflet tilt-field drives of phase 20
(each module's energy and gradients on the small kozlov mesh), the free-disk
and local-interface lanes of phases 21-24, the match drives of phase 25 and
the physical-edge and scaffold-trace lanes of phases 26-29 (on the small
kozlov mesh, their fixtures' protocols), the Helfrich
vesicle (meshgen cube, surface + bending, hard volume, two refinements), the
cube recipe's stepper segment through the command layer (``bfgs; g5; cg;
g5``) and ``square_to_circle`` at n = 8 through the command layer, each at
float32 and float64.

Usage (on a machine with a CUDA GPU)::

    python3 tools/find_nondeterministic_ops.py [-o nondeterministic_ops.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def lanes(torch, dtype):
    """(name, callable) pairs, each driving one lane a few steps on the card."""
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )
    from membrane_solver_tpu_torch.runtime.steppers import make_stepper

    def kozlov():
        mesh = parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4, n_disk_rings=2))
        mesh.global_parameters.update({"tilt_solve_mode": "coupled", "tilt_step_size": 0.15,
                                       "tilt_inner_steps": 40, "tilt_tol": 1e-10,
                                       "step_size": 0.005, "step_size_mode": "fixed"})
        mn = Minimizer(mesh, device="cuda", dtype=dtype, quiet=True)
        mn.mesh = refine_triangle_mesh(refine_polygonal_facets(mn.mesh))
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
        mn.minimize(3)

    def vesicle():
        data = build("cube")
        data.pop("instructions", None)
        data["energy_modules"] = ["surface", "bending"]
        data["constraint_modules"] = ["volume"]
        data["global_parameters"].update({"bending_modulus": 1.0,
                                          "volume_constraint_mode": "lagrange"})
        mn = Minimizer(parse_geometry(data), device="cuda", dtype=dtype, quiet=True)
        mn.mesh = refine_polygonal_facets(mn.mesh)
        for _ in range(2):
            mn.mesh = refine_triangle_mesh(mn.mesh)
            mn.invalidate()
            mn.enforce_constraints_after_mesh_ops()
        mn.minimize(3)

    def command_lane(name, lines, **kw):
        def run():
            mesh = parse_geometry(build(name, **kw))
            gp = mesh.global_parameters
            mn = Minimizer(mesh, stepper=make_stepper("gd"),
                           step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True,
                           device="cuda", dtype=dtype)
            ctx = CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper)
            for line in lines:
                execute_command_line(ctx, line)
                ctx.sync_mesh()
        return run

    def kozlov_smooth():
        """The kozlov lane with the leaflet smoothness (chip_smoke.py phases 18-19)."""
        mesh = parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4, n_disk_rings=2))
        mesh.global_parameters.update({"tilt_solve_mode": "coupled", "tilt_step_size": 0.15,
                                       "tilt_inner_steps": 40, "tilt_tol": 1e-10,
                                       "step_size": 0.005, "step_size_mode": "fixed"})
        mesh.energy_modules.extend(["tilt_smoothness_in", "tilt_smoothness_out"])
        mn = Minimizer(mesh, device="cuda", dtype=dtype, quiet=True)
        mn.mesh = refine_triangle_mesh(refine_polygonal_facets(mn.mesh))
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
        mn.minimize(3)

    def drives():
        """Each leaflet tilt-field drive's energy and gradients (chip_smoke.py phase 20)."""
        import dataclasses

        from chip_smoke import drives_setup
        from membrane_solver_tpu_torch.device import geo as dgeo
        from membrane_solver_tpu_torch.energy import get_module
        from tools.record_torch_port_fixture import kozlov_drives_protocol

        protocol = kozlov_drives_protocol()
        mesh = parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4, n_disk_rings=2))
        drives_setup(mesh, protocol)
        p = Minimizer(mesh, device="cuda", dtype=dtype, quiet=True).problem()
        fields = ("positions", "tilts_in", "tilts_out")
        for name in protocol["modules"]:
            module = get_module(name)
            maker = getattr(module, "make_energy", None)
            fn = maker(p.spec) if maker is not None else module.energy
            leaves = [getattr(p.state, f).detach().clone().requires_grad_(True) for f in fields]
            st = dataclasses.replace(p.state, **dict(zip(fields, leaves)))
            geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
            torch.autograd.grad(fn(geo, st, p.topo, p.params), leaves, allow_unused=True)

    def protocol_lane(protocol):
        """A kozlov fixture protocol's edits (``chip_smoke.lane_edits``) on the small mesh."""

        def run():
            from chip_smoke import lane_edits, lane_tags

            mesh = parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4,
                                        n_disk_rings=2))
            mesh.global_parameters.update(protocol["global_parameters"])
            lane_edits(mesh, protocol)
            mn = Minimizer(mesh, device="cuda", dtype=dtype, quiet=True)
            mn.mesh = refine_triangle_mesh(refine_polygonal_facets(mn.mesh))
            mn.invalidate()
            mn.enforce_constraints_after_mesh_ops()
            lane_tags(mn, protocol)
            mn.minimize(3)

        return run

    def match_drives():
        """The local-interface family's drives (chip_smoke.py phase 25)."""
        from chip_smoke import match_drives_setup, port_match_record
        from tools.record_torch_port_fixture import kozlov_match_drives_protocol

        protocol = kozlov_match_drives_protocol()
        mesh = parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4, n_disk_rings=2))
        mesh.global_parameters.update(protocol["kozlov"]["global_parameters"])
        match_drives_setup(mesh, protocol)
        port_match_record(torch, mesh, protocol, dtype, "cuda")

    from tools.record_torch_port_fixture import (
        kozlov_free_disk_protocol,
        kozlov_interface_protocol,
        kozlov_physical_edge_protocol,
        kozlov_scaffold_protocol,
    )

    return [("kozlov", kozlov), ("vesicle", vesicle), ("kozlov smooth", kozlov_smooth),
            ("drives", drives), ("free disk", protocol_lane(kozlov_free_disk_protocol())),
            ("interface", protocol_lane(kozlov_interface_protocol())),
            ("match drives", match_drives),
            ("physical edge", protocol_lane(kozlov_physical_edge_protocol())),
            ("scaffold", protocol_lane(kozlov_scaffold_protocol())),
            ("cube steppers", command_lane("cube", ["g5", "r", "bfgs", "g5", "cg", "g5"])),
            ("square_to_circle", command_lane("square_to_circle",
                                              ["g40", "r", "g40", "u", "V4", "g60"], n=8))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("find_nondeterministic_ops: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.use_deterministic_algorithms(True, warn_only=True)
    found = {}
    for dtype in (torch.float32, torch.float64):
        for name, run in lanes(torch, dtype):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
                torch.cuda.synchronize()
            sites = collections.Counter(
                f"{Path(w.filename).name}:{w.lineno} {str(w.message).splitlines()[0][:120]}"
                for w in caught if "deterministic" in str(w.message))
            key = f"{name} {str(dtype).removeprefix('torch.')}"
            found[key] = [(n, site) for site, n in sites.most_common()]
            print(f"[nondeterministic ops] lane={key!r} sites={json.dumps(found[key])}",
                  flush=True)
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(found, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
