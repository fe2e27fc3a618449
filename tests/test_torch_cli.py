"""The port's CLI and command layer against the JAX package's, on the CPU.

Command-name resolution, macros and their guards, unknown commands; the
cube recipe of ``meshes/cube.json`` through ``execute_command_line`` at
float64 against the NumPy reference's trace
(``tests/fixtures/cube_reference_trace.json``, abs 5e-12, the JAX test's
own bar), then the stepper segment ``bfgs; g10; hessian 2; cg; g20``
against a live JAX run (rel 1e-10); ``cli.main`` end to end with
``--cpu``; the entry points that are not ported raise.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_port_harness  # noqa: F401  (its torch thread count for the xdist workers)
from membrane_solver_tpu_torch import cli
from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line
from membrane_solver_tpu_torch.commands.registry import get_command

REPO = Path(__file__).resolve().parent.parent
CUBE = REPO / "meshes" / "cube.json"
TRACE = json.loads((REPO / "tests" / "fixtures" / "cube_reference_trace.json").read_text())
SEGMENT = ["bfgs", "g10", "hessian 2", "cg", "g20"]


def port_context(*extra_args):
    args = cli.build_parser().parse_args(
        ["--cpu", "-q", "--non-interactive", "-i", str(CUBE), *extra_args])
    return cli.make_context(args, cli.load_mesh_interactive(args.input, interactive=False))


def jax_context(edit_mesh=None):
    """The JAX command context as its cli.main builds it (less the capacity plan).

    ``edit_mesh(mesh)`` runs before the Minimizer is built, where cli.main
    applies its flags.
    """
    import membrane_solver_tpu as jpkg
    from membrane_solver_tpu.commands import CommandContext as JCtx
    from membrane_solver_tpu.runtime.steppers import make_stepper

    mesh = jpkg.parse_geometry(jpkg.load_data(CUBE))
    if edit_mesh is not None:
        edit_mesh(mesh)
    gp = mesh.global_parameters
    mn = jpkg.Minimizer(mesh, stepper=make_stepper("gd"),
                        step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True)
    return JCtx(mesh=mesh, minimizer=mn, stepper=mn.stepper)


def record(ctx, run, lines):
    rows = []
    for line in lines:
        run(ctx, line)
        ctx.sync_mesh()
        mn = ctx.minimizer
        rows.append({"cmd": line, "energy": float(mn.compute_energy()),
                     "n_vertices": len(mn.mesh.vertices), "n_facets": len(mn.mesh.facets)})
    return rows


@pytest.fixture(scope="module")
def port_run():
    ctx = port_context()
    assert ctx.minimizer.device.type == "cpu" and ctx.minimizer.dtype == torch.float64
    recipe = record(ctx, execute_command_line, ctx.mesh.instructions)
    return recipe, record(ctx, execute_command_line, SEGMENT)


@pytest.fixture(scope="module")
def jax_segment():
    from membrane_solver_tpu.commands import execute_command_line as jrun

    ctx = jax_context()
    record(ctx, jrun, ctx.mesh.instructions)
    return record(ctx, jrun, SEGMENT)


# ----------------------------------------------------------------------
# command resolution, macros
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "token,name,args",
    [("g10", "g", ["10"]), ("g", "g", []), ("r2", "r", ["2"]), ("V3", "v", ["3"]),
     ("v2", "v", ["2"]), ("t0.01", "t", ["0.01"]), ("tf", "t", ["free"]),
     ("tstat", "tilt_stats", []), ("U", "u", []), ("hessian", "hessian", [])],
)
def test_suffix_parsing(token, name, args):
    from membrane_solver_tpu_torch.commands.registry import COMMAND_REGISTRY

    cmd, got = get_command(token)
    assert cmd is COMMAND_REGISTRY[name] and got == args


def test_unknown_name_resolves_to_none():
    assert get_command("no_such_cmd")[0] is None


def _ctx_with_macros(macros):
    from membrane_solver_tpu_torch import Minimizer, parse_geometry

    data = json.loads(CUBE.read_text())
    data["macros"] = macros
    mesh = parse_geometry(data)
    mn = Minimizer(mesh, quiet=True, device="cpu")
    return CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper)


def test_macro_expansion_runs_its_lines():
    ctx = _ctx_with_macros({"gogo": "g2; g2", "go_go": ["gogo", "gogo"]})
    ctx.history = []
    e0 = ctx.minimizer.compute_energy()
    execute_command_line(ctx, "go_go")
    ctx.sync_mesh()
    assert ctx.minimizer.compute_energy() < e0
    assert ctx.history == ["g2"] * 4


def test_macro_recursion_and_depth_guards():
    ctx = _ctx_with_macros({"loop_a": ["loop_b"], "loop_b": ["loop_a"],
                            **{f"m{i}": [f"m{i + 1}"] for i in range(30)}})
    with pytest.raises(RuntimeError, match="Recursive macro call"):
        execute_command_line(ctx, "loop_a")
    with pytest.raises(RuntimeError, match="max depth"):
        execute_command_line(ctx, "m0")


def test_unknown_command_warns_and_continues(caplog):
    ctx = port_context()
    e0 = ctx.minimizer.compute_energy()
    with caplog.at_level(logging.WARNING, logger="membrane_solver_tpu_torch"):
        execute_command_line(ctx, "definitely_not_a_command_42; g2")
    assert "Unknown instruction: definitely_not_a_command_42" in caplog.text
    ctx.sync_mesh()
    assert ctx.minimizer.compute_energy() < e0


# ----------------------------------------------------------------------
# the cube recipe and the stepper segment
# ----------------------------------------------------------------------
def test_recipe_matches_the_reference_trace(port_run):
    recipe, _segment = port_run
    assert [r["cmd"] for r in recipe] == TRACE["instructions"]
    for got, want in zip(recipe, TRACE["trace"], strict=True):
        assert (got["n_vertices"], got["n_facets"]) == (want["n_vertices"], want["n_facets"])
        assert got["energy"] == pytest.approx(want["energy"], abs=5e-12), got["cmd"]


def test_stepper_segment_matches_jax(port_run, jax_segment):
    _recipe, segment = port_run
    for got, want in zip(segment, jax_segment, strict=True):
        assert (got["n_vertices"], got["n_facets"]) == (want["n_vertices"], want["n_facets"])
        assert got["energy"] == pytest.approx(want["energy"], rel=1e-10), got["cmd"]
    # the segment descends below the recipe's end
    assert segment[-1]["energy"] < TRACE["trace"][-1]["energy"]


# ----------------------------------------------------------------------
# cli.main
# ----------------------------------------------------------------------
def test_main_runs_the_recipe_and_saves(tmp_path, capsys):
    from membrane_solver_tpu_torch import Minimizer, load_data, parse_geometry, save_geometry

    out = tmp_path / "out.json"
    assert cli.main(["--cpu", "--non-interactive", "-q", "-i", str(CUBE), "-o", str(out)]) == 0
    assert f"Saved mesh to {out}" in capsys.readouterr().out
    mesh = parse_geometry(load_data(out))
    assert (len(mesh.vertices), len(mesh.facets)) == (770, 1536)
    energy = Minimizer(mesh, device="cpu", quiet=True).compute_energy()
    assert energy == pytest.approx(TRACE["trace"][-1]["energy"], abs=5e-12)
    again = tmp_path / "again.json"
    save_geometry(mesh, again)
    back = parse_geometry(load_data(again))
    np.testing.assert_array_equal(back.positions_array(), mesh.positions_array())
    assert {f: list(x.edge_indices) for f, x in back.facets.items()} == {
        f: list(x.edge_indices) for f, x in mesh.facets.items()}


def test_main_without_cpu_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--non-interactive", "-q", "-i", str(CUBE)])


def test_main_flags_select_dtype_stepper_and_volume_mode():
    ctx = port_context("--f32", "--stepper", "cg", "--step-size", "0.002", "--tol", "1e-7",
                       "--volume-mode", "lagrange")
    mn = ctx.minimizer
    assert mn.dtype == torch.float32 and mn.device.type == "cpu"
    assert mn.stepper.name == "conjugate_gradient" and ctx.stepper is mn.stepper
    assert (mn.step_size, mn.tol) == (0.002, 1e-7)
    gp = ctx.mesh.global_parameters
    assert gp.get("volume_constraint_mode") == "lagrange"
    assert gp.get("volume_projection_during_minimization") is False
    execute_command_line(ctx, "g2")
    assert np.isfinite(mn.compute_energy())


def test_properties_flag_through_the_console_entry():
    proc = subprocess.run(
        [sys.executable, "-m", "membrane_solver_tpu_torch", "--cpu", "--properties",
         "-i", str(CUBE)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Total surface area:" in proc.stdout and "Radius of gyration:" in proc.stdout


def _agg():
    """matplotlib on its headless backend (the tests skip without it)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


@pytest.mark.parametrize("flags", [["--viz"], ["--viz-save", "x.png"]])
def test_visualization_flags_raise(flags, tmp_path, monkeypatch):
    """``--viz`` and ``--viz-save`` render the final mesh (they raised before visualization was
    ported): the drawing runs, and ``--viz-save`` writes a PNG."""
    plt = _agg()
    monkeypatch.chdir(tmp_path)
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(True))
    try:
        assert cli.main(["--cpu", "--non-interactive", "-q", "-i", str(CUBE), *flags]) == 0
    finally:
        plt.close("all")
    if "--viz-save" in flags:
        assert (tmp_path / "x.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    else:
        assert shown == [True]


@pytest.mark.parametrize("line", ["s", "visualize tilt", "lv; g1"])
def test_visualization_commands_raise(line, monkeypatch):
    """``s``, ``visualize tilt`` and ``g`` with live visualization on draw through the
    command layer on the context's device (they raised before visualization was ported)."""
    plt = _agg()
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(True))
    ctx = port_context()
    try:
        execute_command_line(ctx, line)
        figures = [plt.figure(n) for n in plt.get_fignums()]
    finally:
        plt.close("all")
    assert figures and figures[-1].axes[0].collections
    if line.startswith("lv"):
        assert ctx.minimizer.live_vis_state["ax"].get_title() == "Step 0"
    else:
        assert shown == [True]


def test_line_tension_flags_run_as_in_jax():
    """``--line-tension`` and ``--line-tension-edges`` run as in the JAX package.

    The two flags reach the ported ``line_tension`` module, and the tagged
    cube runs ``g5; r; g3`` as the JAX package does (rel 1e-10)."""
    from membrane_solver_tpu.commands import execute_command_line as jrun

    edges = sorted(port_context().mesh.edges)[:4]
    ctx = port_context("--line-tension", "0.5", "--line-tension-edges",
                       ",".join(str(e) for e in edges))
    assert "line_tension" in ctx.mesh.energy_modules
    assert ctx.mesh.global_parameters.get("line_tension") == 0.5
    def tag(mesh):  # what the JAX cli.main does with the two flags
        mesh.global_parameters.set("line_tension", 0.5)
        for eid in edges:
            mesh.edges[eid].options.setdefault("energy", []).append("line_tension")
        mesh.energy_modules.append("line_tension")

    jctx = jax_context(tag)
    lines = ["g5", "r", "g3"]
    got, want = record(ctx, execute_command_line, lines), record(jctx, jrun, lines)
    for g, w in zip(got, want, strict=True):
        assert (g["n_vertices"], g["n_facets"]) == (w["n_vertices"], w["n_facets"])
        assert g["energy"] == pytest.approx(w["energy"], rel=1e-10), g["cmd"]
    breakdown = ctx.minimizer.compute_energy_breakdown()
    assert breakdown["line_tension"] > 0.0


def test_placeholder_constraints_load_through_the_cli(tmp_path):
    """A mesh that lists the reference's empty constraint modules runs as without them."""
    data = json.loads(CUBE.read_text())
    data["instructions"] = ["g5"]
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps(data))
    data["constraint_modules"] = list(data.get("constraint_modules", [])) + [
        "edge", "fix_facet_angle", "fix_vertex_position", "dummy_module"]
    listed = tmp_path / "listed.json"
    listed.write_text(json.dumps(data))
    energies = []
    for path in (plain, listed):
        out = tmp_path / f"out_{path.name}"
        assert cli.main(["--cpu", "--non-interactive", "-q", "-i", str(path), "-o", str(out)]) == 0
        energies.append(float(cli.Minimizer(cli.load_mesh_interactive(str(out), False),
                                            device="cpu", quiet=True).compute_energy()))
    assert energies[1] == energies[0]


# ----------------------------------------------------------------------
# meta and I/O commands against the JAX package
# ----------------------------------------------------------------------
def _both_outputs(capsys, lines):
    from membrane_solver_tpu.commands import execute_command_line as jrun

    outs = []
    for ctx, run in ((jax_context(), jrun), (port_context(), execute_command_line)):
        capsys.readouterr()
        for line in lines:
            run(ctx, line)
            ctx.sync_mesh()
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("line", ["energy", "energy total", "energy stats", "energy ref",
                                  "energy bogus", "properties", "print bodies", "set",
                                  "set surface_tension", "t"])
def test_meta_command_output_matches_jax(capsys, line):
    want, got = _both_outputs(capsys, ["g5", "r", line])
    assert got == want and got.strip()


def test_set_save_history_and_quit(tmp_path):
    from membrane_solver_tpu_torch import load_data, parse_geometry

    ctx = port_context()
    ctx.history = []
    execute_command_line(ctx, "set surface_tension 2.5; set vertex 0 fixed true; g1; t1e-4")
    assert ctx.mesh.global_parameters.get("surface_tension") == 2.5
    assert ctx.mesh.vertices[0].fixed and ctx.minimizer.step_size == 1e-4
    path = tmp_path / "saved.json"
    execute_command_line(ctx, f"save {path}; refresh; history")
    saved = parse_geometry(load_data(path))
    np.testing.assert_array_equal(saved.positions_array(), ctx.mesh.positions_array())
    assert ctx.history[-1] == "history"
    with pytest.raises(SystemExit):
        execute_command_line(ctx, "q")


def test_tilt_stats_matches_jax(capsys):
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.commands import CommandContext as JCtx
    from membrane_solver_tpu.commands import execute_command_line as jrun
    from membrane_solver_tpu.meshgen import build

    outs = []
    for pkg, Ctx, run, kw in ((jpkg, JCtx, jrun, {}),
                              (tpkg, CommandContext, execute_command_line, {"device": "cpu"})):
        mesh = pkg.parse_geometry(build("kozlov_1disk", n_sectors=8, n_outer_rings=4,
                                        n_disk_rings=2))
        rng = np.random.default_rng(3)
        for vid in sorted(mesh.vertices):
            mesh.vertices[vid].tilt_in[:] = 0.1 * rng.standard_normal(3)
        capsys.readouterr()
        run(Ctx(mesh=mesh, minimizer=pkg.Minimizer(mesh, quiet=True, **kw)), "tilt_stats")
        outs.append(capsys.readouterr().out)
    assert "tilt_in" in outs[1] and outs[1] == outs[0]


def test_completion_matches_jax():
    from membrane_solver_tpu.commands.completion import command_line_completions as jcomp
    from membrane_solver_tpu.commands.registry import COMMAND_REGISTRY as JREG
    from membrane_solver_tpu_torch.commands.completion import command_line_completions
    from membrane_solver_tpu_torch.commands.registry import COMMAND_REGISTRY

    assert sorted(COMMAND_REGISTRY) == sorted(JREG)
    for text, buf in (("g", "g"), ("en", "g5; en"), ("st", "energy st"), ("", "energy "),
                      ("x", "r; g2 x")):
        kw = {"text": text, "line_buffer": buf, "macro_names": ["gogo"]}
        assert command_line_completions(command_names=COMMAND_REGISTRY, **kw) == jcomp(
            command_names=JREG, **kw)


def test_meshgen_entry_lists_and_writes(tmp_path, capsys):
    from membrane_solver_tpu_torch import parse_geometry
    from membrane_solver_tpu_torch.meshgen import BUILDERS
    from membrane_solver_tpu_torch.meshgen.__main__ import main as meshgen_main

    assert meshgen_main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(BUILDERS)
    out = tmp_path / "lane.json"
    assert meshgen_main(["kozlov_1disk", "--set", "n_sectors=8", "-o", str(out)]) == 0
    mesh = parse_geometry(json.loads(out.read_text()))
    assert len(mesh.vertices) > 0


def test_repl_runs_commands_from_stdin(tmp_path):
    import os

    env = {**os.environ, "MEMBRANE_HISTORY_FILE": str(tmp_path / "history")}
    proc = subprocess.run(
        [sys.executable, "-m", "membrane_solver_tpu_torch", "--cpu", "-q", "-i", str(CUBE)],
        cwd=REPO, input="g2\nenergy total\nbogus_cmd\nq\n", capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Interactive mode." in proc.stdout
    assert "Current Total Energy:" in proc.stdout
