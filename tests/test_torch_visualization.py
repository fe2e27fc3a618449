"""The port's visualization (``membrane_solver_tpu_torch/visualization``) against the JAX package's.

Modelled on ``tests/test_visualization.py``: the same ``tilted_mesh`` (the
kozlov disk mesh with a coherent +x inner-leaflet tilt field whose
magnitude grows with the radius, tangent-projected, and two facet patch
labels) built by both packages, rendered by both to an Agg canvas, and the
produced matplotlib artists compared: the facet polygons and their face
colours (the ``div`` modes' values to float64 round-off of the JAX
package's ``device.tilt_ops.p1_triangle_divergence``), the tilt-arrow and
streamline segments, colorbars, texts and overlays, the live figure's
reuse, and the CLI end to end with ``--cpu --save``.  The port's ``div``
modes run on the device the caller names (here the CPU, through the
twin of the ``tri_p1_div`` kernel).  One more test computes the face
values with matplotlib blocked from import: the card's host has none.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d.art3d import (  # noqa: E402
    Line3DCollection,
    Path3DCollection,
    Poly3DCollection,
)

import membrane_solver_tpu  # noqa: E402
import membrane_solver_tpu_torch  # noqa: E402
from membrane_solver_tpu.visualization import plot_geometry as jax_plot  # noqa: E402
from membrane_solver_tpu_torch.visualization import plot_geometry, update_live_vis  # noqa: E402

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
MODES = ["tilt", "tilt_in", "tilt_out", "tilt_bilayer", "div", "div_in", "div_out"]
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _tilted(pkg):
    """``tests/test_visualization.py``'s ``tilted_mesh``, built by ``pkg``."""
    if pkg is membrane_solver_tpu:
        from membrane_solver_tpu.meshgen import build
    else:
        from membrane_solver_tpu_torch.meshgen import build
    mesh = pkg.parse_geometry(build("kozlov_1disk"))
    nv = len(mesh.vertices)
    pos = mesh.positions_array()
    radial = np.linalg.norm(pos[:, :2], axis=1)
    mags = 0.2 + 0.8 * radial / max(radial.max(), 1e-12)
    tilts = np.stack([mags, 0.05 * mags, np.zeros(nv)], axis=1)
    mesh.set_tilts_array(tilts, which="tilt_in")
    mesh.project_tilts_to_tangent()
    for fid in sorted(mesh.facets):
        centroid = np.mean(
            [mesh.vertices[v].position for v in mesh.facet_vertex_loop(mesh.facets[fid])],
            axis=0,
        )
        mesh.facets[fid].options["disk_patch"] = "disk_a" if centroid[0] >= 0.0 else "ambient"
    return mesh


@pytest.fixture(scope="module")
def meshes():
    """(the JAX package's tilted mesh, the port's)."""
    return _tilted(membrane_solver_tpu), _tilted(membrane_solver_tpu_torch)


def _collections_of(ax, cls):
    return [c for c in ax.collections if isinstance(c, cls)]


def _segments3d(lc):
    return np.asarray(lc._segments3d)


def _segment_count(ax):
    return sum(len(_segments3d(lc)) for lc in _collections_of(ax, Line3DCollection))


def test_plain_render_has_the_facet_polygons_of_jax(meshes):
    jm, tm = meshes
    ax, jax_ax = plot_geometry(tm), jax_plot(jm)
    polys, want = _collections_of(ax, Poly3DCollection), _collections_of(jax_ax, Poly3DCollection)
    assert len(polys) == 1 and len(ax.figure.axes) == 1
    got_v, want_v = polys[0]._vec, want[0]._vec
    assert got_v.shape == want_v.shape
    assert np.max(np.abs(got_v - want_v)) <= 1e-12 * np.max(np.abs(want_v))


@pytest.mark.parametrize("mode", MODES)
def test_color_modes_match_jax_and_add_colorbar(meshes, mode):
    """Face colours of every mode equal the JAX package's; the ``div`` modes' values
    (``plot_core._face_values``) to float64 round-off of JAX's divergence."""
    from membrane_solver_tpu_torch.visualization.plot_core import _face_values

    jm, tm = meshes
    ax, jax_ax = plot_geometry(tm, color_by=mode, **CPU), jax_plot(jm, color_by=mode)
    polys = _collections_of(ax, Poly3DCollection)
    colors = np.asarray(polys[0].get_facecolor())
    want = np.asarray(_collections_of(jax_ax, Poly3DCollection)[0].get_facecolor())
    assert np.all(np.isfinite(colors)) and len(ax.figure.axes) == 2
    assert np.max(np.abs(colors - want)) <= 1e-6
    if mode in {"tilt", "tilt_in", "tilt_bilayer", "div_in", "div"}:
        assert len(np.unique(colors, axis=0)) > 1
    fids, values = _face_values(tm, mode, "cpu")
    assert fids == sorted(tm.facets)
    if mode.startswith("div"):
        from membrane_solver_tpu.visualization.plot_core import _tilt_field_for

        import jax.numpy as jnp
        from membrane_solver_tpu.device.tilt_ops import p1_triangle_divergence

        rows, tri_fids = jm.triangle_rows()
        div, _a, _g = p1_triangle_divergence(
            jnp.asarray(jm.positions_array()), jnp.asarray(np.asarray(_tilt_field_for(jm, mode))),
            jnp.asarray(np.asarray(rows)), jnp.ones(len(tri_fids), bool))
        by_fid = dict(zip((int(f) for f in tri_fids), np.abs(np.asarray(div))))
        ref = np.array([by_fid.get(f, 0.0) for f in fids])
        assert np.max(np.abs(values - ref)) <= 1e-12 * max(np.max(ref), 1e-300)


def test_tilt_out_mode_uniform_when_field_zero(meshes):
    ax = plot_geometry(meshes[1], color_by="tilt_out", show_colorbar=False)
    assert len(ax.figure.axes) == 1


def test_tilt_arrows_segment_count(meshes):
    jm, tm = meshes
    ax = plot_geometry(tm, show_tilt_arrows=True, tilt_arrows_max=None)
    mags = np.linalg.norm(tm.tilts_in_array(), axis=1)
    assert _segment_count(ax) == int((mags > 1e-12).sum()) > 0
    jax_ax = jax_plot(jm, show_tilt_arrows=True, tilt_arrows_max=None)
    got = np.concatenate([_segments3d(c) for c in _collections_of(ax, Line3DCollection)])
    want = np.concatenate([_segments3d(c) for c in _collections_of(jax_ax, Line3DCollection)])
    assert np.max(np.abs(got - want)) <= 1e-12


def test_tilt_arrows_cap(meshes):
    ax = plot_geometry(meshes[1], show_tilt_arrows=True, tilt_arrows_max=10)
    assert _segment_count(ax) == 10


def test_streamlines_match_jax(meshes):
    jm, tm = meshes
    ax = plot_geometry(tm, show_tilt_streamlines=True, tilt_streamlines_max=40)
    jax_ax = jax_plot(jm, show_tilt_streamlines=True, tilt_streamlines_max=40)
    segs = np.concatenate([_segments3d(lc) for lc in _collections_of(ax, Line3DCollection)])
    want = np.concatenate([_segments3d(lc) for lc in _collections_of(jax_ax, Line3DCollection)])
    assert len(segs) == len(want) >= 10
    assert np.max(np.abs(segs - want)) <= 1e-12
    deltas = segs[:, 1, :] - segs[:, 0, :]
    assert np.mean(deltas[:, 0] != 0.0) > 0.5


def test_patch_boundary_overlay(meshes):
    jm, tm = meshes
    n_base = len(_collections_of(plot_geometry(tm), Line3DCollection))
    ax = plot_geometry(tm, show_patch_boundaries=True)
    lines = _collections_of(ax, Line3DCollection)
    assert len(lines) == n_base + 2
    want = _collections_of(jax_plot(jm, show_patch_boundaries=True), Line3DCollection)
    assert [len(_segments3d(c)) for c in lines] == [len(_segments3d(c)) for c in want]


def test_vertices_and_indices_overlays(meshes):
    tm = meshes[1]
    nv = len(tm.vertices)
    ax = plot_geometry(tm, show_vertices=True, show_indices=True)
    scatters = _collections_of(ax, Path3DCollection)
    assert scatters and scatters[0].get_offsets().shape[0] == nv
    assert len(ax.texts) == nv


def test_boundary_loops_overlay_matches_jax(meshes):
    jm, tm = meshes
    ax = plot_geometry(tm, show_boundary_loops=True)
    jax_ax = jax_plot(jm, show_boundary_loops=True)
    assert len(ax.lines) == len(jax_ax.lines) >= 1
    assert [t.get_text() for t in ax.texts] == [t.get_text() for t in jax_ax.texts]
    assert any("κg" in t.get_text() for t in ax.texts)


def test_edges_only_render(meshes):
    tm = meshes[1]
    ax = plot_geometry(tm, show_facets=False, show_edges=True)
    assert not _collections_of(ax, Poly3DCollection)
    assert _segment_count(ax) == len(tm.edges)


def test_save_path_writes_png(meshes, tmp_path):
    out = tmp_path / "mesh.png"
    plot_geometry(meshes[1], color_by="tilt_in", save_path=str(out))
    assert out.exists() and out.stat().st_size > 10_000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_live_vis_reuses_figure(meshes):
    tm = meshes[1]
    state = update_live_vis(tm, title="step 0")
    fig_first = state["fig"]
    state = update_live_vis(tm, state=state, title="step 1", color_by="div_in", device="cpu")
    assert state["fig"] is fig_first
    assert state["ax"].get_title() == "step 1"


def test_viz_cli_end_to_end(tmp_path):
    """``python -m membrane_solver_tpu_torch.visualization`` in-process, with ``--cpu``."""
    from membrane_solver_tpu_torch.visualization.cli import main

    out = tmp_path / "cli.png"
    rc = main(["gen:kozlov_1disk", "--tilt", "--tilt-streamlines", "--patch-boundaries",
               "--no-axes", "--save", str(out), "--cpu"])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 10_000


def test_face_values_need_no_matplotlib():
    """The face values (and the package's import) run with matplotlib blocked."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError('matplotlib blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from membrane_solver_tpu_torch import parse_geometry\n"
        "from membrane_solver_tpu_torch.meshgen import build\n"
        "from membrane_solver_tpu_torch.visualization import plot_core\n"
        "mesh = parse_geometry(build('kozlov_1disk'))\n"
        "rng = np.random.default_rng(0)\n"
        "mesh.set_tilts_array(rng.standard_normal((len(mesh.vertices), 3)), which='tilt_in')\n"
        "fids, vals = plot_core._face_values(mesh, 'div_in', 'cpu')\n"
        "assert len(fids) == len(mesh.facets) and np.all(np.isfinite(vals)) and vals.max() > 0\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
