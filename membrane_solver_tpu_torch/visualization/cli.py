"""Visualization CLI (counterpart of ``membrane_solver_tpu/visualization/cli.py``).

    python -m membrane_solver_tpu_torch.visualization mesh.json --tilt --save out.png
    python -m membrane_solver_tpu_torch.visualization gen:kozlov_1disk --divergence --cpu

Renders a mesh file (or a meshgen builder via ``gen:<name>``) with the
same options surface as the reference CLI: facet coloring by tilt
magnitude or P1 divergence, tilt arrows, edge/vertex/index overlays,
PNG export, optional pre-render instruction run.  The device is a flag:
the card by default (which raises without one: there is no fallback),
``--cpu`` for the CPU, ``--f32`` for float32 (float64 otherwise); the
``--run`` commands and the ``div`` modes' divergence run there.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="membrane_solver_tpu_torch.visualization")
    ap.add_argument("input", help="mesh path or gen:<builder>")
    ap.add_argument("--tilt", action="store_true", help="color facets by |tilt|")
    ap.add_argument("--divergence", "--tilt-div", action="store_true",
                    help="color facets by P1 tilt divergence")
    ap.add_argument("--color-by", default=None,
                    choices=["tilt", "tilt_in", "tilt_out", "tilt_bilayer",
                             "div", "div_in", "div_out"],
                    help="explicit facet color mode (per-leaflet variants)")
    ap.add_argument("--tilt-arrows", action="store_true")
    ap.add_argument("--tilt-arrows-max", type=int, default=2000)
    ap.add_argument("--tilt-arrow-scale", type=float, default=0.1)
    ap.add_argument("--tilt-streamlines", action="store_true",
                    help="trace mesh-graph streamlines along the tilt field")
    ap.add_argument("--streamlines-max", "--tilt-streamlines-max",
                    type=int, default=200)
    ap.add_argument("--streamlines-steps", "--tilt-streamlines-steps",
                    type=int, default=80)
    ap.add_argument("--tilt-streamlines-cos-min", type=float, default=0.2,
                    help="minimum cosine alignment to continue a streamline")
    ap.add_argument("--patch-boundaries", action="store_true",
                    help="overlay facet patch-label boundaries")
    ap.add_argument("--patch-key", default="disk_patch")
    ap.add_argument("--no-colorbar", action="store_true")
    ap.add_argument("--no-axes", action="store_true")
    ap.add_argument("--no-edges", action="store_true")
    ap.add_argument("--no-facets", action="store_true",
                    help="disable drawing of polygonal facets")
    ap.add_argument("--vertices", "--scatter", action="store_true",
                    help="draw vertices as scatter points")
    ap.add_argument("--indices", "--show-indices", action="store_true")
    ap.add_argument("--boundary-loops", "--boundary-geodesic",
                    action="store_true",
                    help="overlay open-boundary loops with geodesic sums")
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--transparent", action="store_true",
                    help="render facets semi-transparent (alpha 0.3)")
    ap.add_argument("--log", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="write logs to PATH (default: next to the input mesh)")
    ap.add_argument("--title", default=None)
    ap.add_argument("--save", default=None, metavar="PNG")
    ap.add_argument("--run", default=None, metavar="MACRO",
                    help="instruction line to execute before rendering")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--f32", action="store_true", help="float32 compute (float64 otherwise)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from membrane_solver_tpu_torch.geometry.io_readers import load_data, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime.minimizer import resolve_device
    from membrane_solver_tpu_torch.visualization.plot_core import plot_geometry

    device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = torch.float32 if args.f32 else torch.float64

    if args.log is not None:
        import logging
        from pathlib import Path

        path = (
            args.log
            if args.log != "auto"
            else str(Path(args.input).with_suffix(".viz.log"))
            if not args.input.startswith("gen:")
            else f"{args.input[4:]}.viz.log"
        )
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter("%(levelname)s:%(name)s:%(message)s"))
        logging.getLogger("membrane_solver_tpu_torch").addHandler(handler)
        logging.getLogger("membrane_solver_tpu_torch").setLevel(logging.INFO)

    data = build(args.input[4:]) if args.input.startswith("gen:") else load_data(args.input)
    mesh = parse_geometry(data)

    if args.run:
        from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line
        from membrane_solver_tpu_torch.runtime.minimizer import Minimizer

        ctx = CommandContext(mesh=mesh, minimizer=Minimizer(mesh, quiet=True, device=device,
                                                            dtype=dtype))
        execute_command_line(ctx, args.run)
        ctx.sync_mesh()
        mesh = ctx.mesh

    color_by = args.color_by or (
        "divergence" if args.divergence else ("tilt" if args.tilt else None)
    )
    plot_geometry(
        mesh,
        color_by=color_by,
        show_colorbar=False if args.no_colorbar else None,
        show_tilt_arrows=args.tilt_arrows,
        tilt_arrows_max=args.tilt_arrows_max,
        tilt_arrow_scale=args.tilt_arrow_scale,
        show_tilt_streamlines=args.tilt_streamlines,
        tilt_streamlines_max=args.streamlines_max,
        tilt_streamlines_steps=args.streamlines_steps,
        tilt_streamlines_cos_min=args.tilt_streamlines_cos_min,
        show_patch_boundaries=args.patch_boundaries,
        patch_key=args.patch_key,
        show_facets=not args.no_facets,
        show_edges=not args.no_edges,
        show_vertices=args.vertices,
        show_indices=args.indices,
        show_boundary_loops=args.boundary_loops,
        no_axes=args.no_axes,
        alpha=0.3 if args.transparent else args.alpha,
        title=args.title or args.input,
        show=args.save is None,
        save_path=args.save,
        device=device,
        dtype=dtype,
    )
    if args.save:
        print(f"saved {args.save}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
