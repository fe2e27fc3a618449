"""Matplotlib 3D mesh plotting.

Counterpart of ``membrane_solver_tpu/visualization/plot_core.py`` (the
reference's ``visualization/plot_core.py``): facet polygons, edges, vertex
scatter and indices, tilt-magnitude and divergence facet colouring, tilt
arrows and streamlines, patch-boundary and boundary-loop overlays,
equal-aspect axes.  Headless-safe (Agg) when no display exists.

matplotlib is imported inside the drawing calls only, so the package and
:func:`_face_values` import without it.  The facet colour values are a
function of their own (:func:`_face_values`): the ``div`` modes take the
per-triangle P1 divergence on a device through
``kernels/tri_kernels.p1_divergence_and_area`` (the ``tri_p1_div`` kernel on
the card, no shape gradients written; its plain twin on the CPU), every
triangle valid, as the JAX
package's ``device.tilt_ops.p1_triangle_divergence`` call does.  The device
is the caller's: the card unless it asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

TILT_MODES = frozenset({"tilt", "tilt_in", "tilt_out", "tilt_bilayer"})
DIV_MODES = frozenset({"divergence", "div", "div_in", "div_out"})


def _ensure_backend():
    import matplotlib

    if not os.environ.get("DISPLAY") and os.name != "nt":
        matplotlib.use("Agg", force=False)


def _tilt_streamline_segments(mesh, *, max_seeds, steps, cos_min):
    """Mesh-graph streamlines following the tilt direction (reference
    plot_core.py:601-695): from each seeded vertex, repeatedly hop to the
    unvisited neighbor whose direction best aligns with the local tilt
    (cosine > cos_min), tracing forward and backward."""
    positions = mesh.positions_array()
    tilts = np.asarray(_tilt_field_for(mesh, None))
    if not len(tilts):
        return []
    mags = np.linalg.norm(tilts, axis=1)
    good_rows = np.where(mags > 1e-12)[0]
    if not good_rows.size:
        return []
    if good_rows.size > int(max_seeds):
        sample = np.linspace(0, good_rows.size - 1, int(max_seeds), dtype=int)
        good_rows = good_rows[sample]

    neighbors: dict = {int(v): [] for v in mesh.vertex_ids}
    for edge in mesh.edges.values():
        neighbors[int(edge.tail_index)].append(int(edge.head_index))
        neighbors[int(edge.head_index)].append(int(edge.tail_index))
    for vids in neighbors.values():
        vids.sort()

    idx_map = {int(v): i for i, v in enumerate(mesh.vertex_ids)}
    row_to_vid = [int(v) for v in mesh.vertex_ids]

    def _step(vid, direction, visited):
        row = idx_map.get(vid)
        if row is None:
            return None
        origin = positions[row]
        best_vid, best_cos = None, float(cos_min)
        for nb in neighbors.get(vid, []):
            if nb in visited:
                continue
            nb_row = idx_map.get(nb)
            if nb_row is None:
                continue
            dpos = positions[nb_row] - origin
            nd = float(np.linalg.norm(dpos))
            if nd <= 1e-15:
                continue
            cosv = float(np.dot(dpos / nd, direction))
            if cosv > best_cos:
                best_cos, best_vid = cosv, nb
        return best_vid

    segments = []
    for row in good_rows:
        seed_vid = row_to_vid[int(row)]
        d0 = tilts[int(row)] / mags[int(row)]

        def _trace(sign):
            path = [seed_vid]
            visited = {seed_vid}
            vid, direction = seed_vid, sign * d0
            for _ in range(int(steps)):
                nxt = _step(vid, direction, visited)
                if nxt is None:
                    break
                path.append(nxt)
                visited.add(nxt)
                vid = nxt
                row_n = idx_map.get(vid)
                if row_n is None:
                    break
                t = tilts[row_n]
                nt = float(np.linalg.norm(t))
                if nt <= 1e-12:
                    break
                direction = sign * (t / nt)
            return path

        full = list(reversed(_trace(-1.0)[:-1])) + _trace(1.0)
        if len(full) < 2:
            continue
        seg_pts = np.stack(
            [np.asarray(mesh.vertices[v].position, dtype=float) for v in full]
        )
        segments.extend(list(np.stack([seg_pts[:-1], seg_pts[1:]], axis=1)))
    return segments


def _tilt_field_for(mesh, color_by):
    """Vertex tilt field selected by the color mode (reference
    _tilt_field_for_color_by): tilt_in/div_in -> inner leaflet,
    tilt_out/div_out -> outer, tilt_bilayer -> t_in + t_out, else the
    dominant nonzero field."""
    tin = mesh.tilts_in_array()
    tout = mesh.tilts_out_array()
    tv = mesh.tilts_array()
    if color_by in {"tilt_in", "div_in"}:
        return tin
    if color_by in {"tilt_out", "div_out"}:
        return tout
    if color_by == "tilt_bilayer":
        return tin + tout
    fields = [tv, tin, tout]
    return max(fields, key=lambda t: float(np.abs(t).max()) if len(t) else 0.0)


def _triangle_divergence(mesh, tilts, device, dtype):
    """(facet ids, P1 divergence per triangle as float64) of ``tilts`` on ``device``.

    One ``tri_kernels.p1_divergence_and_area`` call on the mesh's triangles,
    every one valid: the ``tri_p1_div`` kernel (no shape gradients written) on
    a CUDA device, its twin on the CPU.
    """
    import torch

    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import tri_kernels
    from membrane_solver_tpu_torch.runtime.minimizer import resolve_device

    rows, tri_fids = mesh.triangle_rows()
    if not len(tri_fids):
        return [], np.zeros(0)
    dev = resolve_device("cuda" if device is None else device)
    dtype = torch.float64 if dtype is None else dtype
    pos = torch.as_tensor(mesh.positions_array(), dtype=dtype, device=dev)
    tri_rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    with torch.no_grad():
        div, _area = tri_kernels.p1_divergence_and_area(
            pos, torch.as_tensor(np.asarray(tilts), dtype=dtype, device=dev), tri_rows,
            torch.ones(len(tri_fids), dtype=torch.bool, device=dev),
            corner_csr(tri_rows, pos.shape[0]))
    return tri_fids, div.cpu().to(torch.float64).numpy()


def _face_values(mesh, color_by, device=None, dtype=None):
    """(facet ids in ascending order, one colour value each) of ``color_by``.

    Tilt modes: the mean over the facet's vertices of the selected field's
    magnitude; ``div`` modes: |P1 divergence| of the selected field per
    triangle on ``device`` (the card when None; ``dtype`` float64 when
    None), 0 on a facet that is not a triangle; otherwise 0.  No matplotlib.
    """
    fids = sorted(mesh.facets)
    values = np.zeros(len(fids))
    if color_by in TILT_MODES:
        field = _tilt_field_for(mesh, color_by)
        mag_of = {int(v): float(np.linalg.norm(field[i])) for i, v in enumerate(mesh.vertex_ids)}
        for k, fid in enumerate(fids):
            loop = mesh.facet_vertex_loop(mesh.facets[fid])
            values[k] = np.mean([mag_of.get(int(v), 0.0) for v in loop])
    elif color_by in DIV_MODES:
        tri_fids, div = _triangle_divergence(mesh, _tilt_field_for(mesh, color_by), device,
                                             dtype)
        div_by_fid = {int(f): float(d) for f, d in zip(tri_fids, div)}
        values = np.array([abs(div_by_fid.get(fid, 0.0)) for fid in fids])
    return fids, values


def plot_geometry(
    mesh,
    *,
    color_by: Optional[str] = None,  # None | tilt[/_in/_out/_bilayer] | div[ergence][/_in/_out]
    show_colorbar: Optional[bool] = None,
    show_tilt_arrows: bool = False,
    tilt_arrows_max: Optional[int] = 2000,
    tilt_arrow_scale: float = 0.1,
    show_tilt_streamlines: bool = False,
    tilt_streamlines_max: int = 200,
    tilt_streamlines_steps: int = 80,
    tilt_streamlines_cos_min: float = 0.2,
    show_patch_boundaries: bool = False,
    patch_key: str = "disk_patch",
    show_facets: bool = True,  # --no-facets (reference cli.py:34-37)
    show_edges: bool = True,
    show_vertices: bool = False,
    show_indices: bool = False,
    show_boundary_loops: bool = False,
    no_axes: bool = False,
    alpha: float = 0.6,
    title: Optional[str] = None,
    ax=None,
    show: bool = False,
    save_path: Optional[str] = None,
    device=None,
    dtype=None,
):
    """Render the mesh; returns the matplotlib Axes.

    ``device`` and ``dtype`` are where the ``div`` modes' divergence runs
    (:func:`_face_values`): the card and float64 unless the caller names
    others.
    """
    _ensure_backend()
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection, Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(111, projection="3d")
    else:
        fig = ax.figure

    fids, face_values = _face_values(mesh, color_by, device, dtype)
    polys = [np.array([mesh.vertices[v].position
                       for v in mesh.facet_vertex_loop(mesh.facets[fid])]) for fid in fids]

    mappable = None
    if polys and show_facets:
        collection = Poly3DCollection(polys, alpha=alpha)
        if color_by:
            vals = np.asarray(face_values)
            vmax = vals.max() if vals.max() > 0 else 1.0
            colors = plt.cm.viridis(vals / vmax)
            collection.set_facecolor(colors)
            mappable = plt.cm.ScalarMappable(cmap=plt.cm.viridis)
            mappable.set_array(vals)
        else:
            collection.set_facecolor("lightsteelblue")
        if show_edges:
            collection.set_edgecolor("k")
            collection.set_linewidth(0.3)
        ax.add_collection3d(collection)

    if not show_facets and show_edges and len(mesh.edges):
        segs = [
            np.array(
                [
                    mesh.vertices[mesh.edges[eid].tail_index].position,
                    mesh.vertices[mesh.edges[eid].head_index].position,
                ]
            )
            for eid in sorted(mesh.edges)
        ]
        ax.add_collection3d(Line3DCollection(segs, colors="k", linewidths=0.3))

    if (show_colorbar if show_colorbar is not None else bool(color_by)) and mappable is not None:
        cbar = fig.colorbar(mappable, ax=ax, shrink=0.6, pad=0.05)
        cbar.set_label("|t|" if color_by in TILT_MODES else "div(t)")

    pts = mesh.positions_array()
    if show_vertices and len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=8, c="crimson")
    if show_indices:
        for vid, v in mesh.vertices.items():
            ax.text(*v.position, str(vid), fontsize=7)

    if show_tilt_arrows and len(pts):
        # capped, span-scaled straight segments (reference plot_core
        # tilt_arrows_max / tilt_arrow_scale)
        span = pts.max(axis=0) - pts.min(axis=0)
        max_range = float(np.max(span)) if span.size else 0.0
        arrow_len = tilt_arrow_scale * max_range if max_range > 0 else 1.0
        segs = []
        colors = []
        ids = mesh.vertex_ids
        for arr, color in (
            (mesh.tilts_array(), "red"),
            (mesh.tilts_in_array(), "blue"),
            (mesh.tilts_out_array(), "green"),
        ):
            mags = np.linalg.norm(arr, axis=1) if len(arr) else np.zeros(0)
            good = np.where(mags > 1e-12)[0]
            if tilt_arrows_max is not None and good.size > tilt_arrows_max:
                sample = np.linspace(0, good.size - 1, int(tilt_arrows_max), dtype=int)
                good = good[sample]
            for i in good:
                start = np.asarray(mesh.vertices[int(ids[i])].position, dtype=float)
                segs.append(np.stack([start, start + arrow_len * arr[i] / mags[i]]))
                colors.append(color)
        if segs:
            ax.add_collection3d(Line3DCollection(segs, colors=colors, linewidths=1.0, alpha=0.8))

    if show_tilt_streamlines and len(pts):
        segs = _tilt_streamline_segments(
            mesh,
            max_seeds=tilt_streamlines_max,
            steps=tilt_streamlines_steps,
            cos_min=tilt_streamlines_cos_min,
        )
        if segs:
            ax.add_collection3d(
                Line3DCollection(segs, colors=(0.1, 0.1, 0.1, 0.6), linewidths=1.0)
            )

    if show_patch_boundaries:
        from membrane_solver_tpu_torch.runtime.diagnostics.patches import (
            patch_boundary_edges,
        )

        groups = patch_boundary_edges(mesh, patch_key=patch_key)
        cmap = plt.get_cmap("tab10")
        for idx, (label, edges) in enumerate(sorted(groups.items())):
            segs = [
                np.stack([
                    np.asarray(mesh.vertices[e.tail_index].position, dtype=float),
                    np.asarray(mesh.vertices[e.head_index].position, dtype=float),
                ])
                for e in edges
            ]
            if segs:
                ax.add_collection3d(
                    Line3DCollection(segs, colors=[cmap(idx % 10)], linewidths=2.0, alpha=0.9)
                )

    if show_boundary_loops:
        # open-surface boundary loops with geodesic-turning annotation
        # (reference plot_core boundary-loop overlay)
        from membrane_solver_tpu_torch.runtime.diagnostics.gauss_bonnet import (
            boundary_geodesic_sum,
            extract_boundary_loops,
            find_boundary_edges,
        )

        loops = extract_boundary_loops(mesh, find_boundary_edges(mesh))
        geos = boundary_geodesic_sum(mesh, loops)
        for li, loop in enumerate(loops):
            lp = np.array([mesh.vertices[v].position for v in loop + loop[:1]])
            ax.plot(lp[:, 0], lp[:, 1], lp[:, 2], color="darkorange", lw=1.6)
            g = geos.get(li, geos.get(loop[0], 0.0)) if isinstance(geos, dict) else 0.0
            ax.text(*lp[0], f"∮κg={g:.3f}", fontsize=7, color="darkorange")

    if len(pts):
        # equal aspect
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = 0.5 * (lo + hi)
        radius = 0.5 * float((hi - lo).max() or 1.0)
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(center[2] - radius, center[2] + radius)

    if no_axes:
        ax.set_axis_off()
    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=150)
    if show:
        plt.show()
    return ax
