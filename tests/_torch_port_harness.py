"""Shared set-up for the PyTorch port's parity tests (``tests/test_torch_*.py``).

Both packages are built from the same meshgen dict; the JAX package's
compiled (capacity-padded) arrays go to the port through
``membrane_solver_tpu_torch.device.state.problem_from_numpy``, which drops
the padding rows, so both sides evaluate identical inputs.  Data passes
between the frameworks as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

# the suite runs under pytest-xdist with several workers on one host
torch.set_num_threads(2)

# the kozlov lane's protocol, as tools/record_torch_port_fixture.py defines
# and records it (the bench lane's global parameters and step size)
FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "kozlov_L3_f64_jax.json"
PROTOCOL = json.loads(FIXTURE.read_text())["protocol"]
BENCH_GP = PROTOCOL["global_parameters"]
STEP_SIZE = PROTOCOL["step_size"]
# 49 vertices; kozlov_1disk with its default arguments gives 177
SMALL = {"n_sectors": 8, "n_outer_rings": 4, "n_disk_rings": 2}

STATE_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def _pkg(port: bool):
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build
        from membrane_solver_tpu_torch.runtime import refinement
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build
        from membrane_solver_tpu.runtime import refinement
    return pkg, build, refinement


def make_minimizer(port: bool, kw=None, refines: int = 0, gp=None, **port_kw):
    """The kozlov lane's protocol up to the first step: build, parse, refine.

    ``kw`` are kozlov_1disk arguments (None: its defaults);
    ``port_kw`` go to the port's Minimizer (device, dtype).
    """
    pkg, build, refinement = _pkg(port)
    mesh = pkg.parse_geometry(build("kozlov_1disk", **(kw or {})))
    mesh.global_parameters.update(BENCH_GP if gp is None else gp)
    if port:
        port_kw.setdefault("device", "cpu")
        mn = pkg.Minimizer(mesh, quiet=True, **port_kw)
    else:
        mn = pkg.Minimizer(mesh, quiet=True)
    mn.step_size = STEP_SIZE
    for _ in range(refines):
        m = refinement.refine_polygonal_facets(mn.mesh)
        m = refinement.refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def jax_arrays(problem):
    """(state, topo, params) of a JAX CompiledProblem as numpy mappings."""
    state = {k: np.asarray(getattr(problem.state, k)) for k in STATE_FIELDS}
    topo = {
        f.name: np.asarray(getattr(problem.topo, f.name))
        for f in dataclasses.fields(problem.topo)
        if f.name != "extras"
    }
    topo["extras"] = {k: np.asarray(v) for k, v in problem.topo.extras.items()}
    params = {k: np.asarray(v) for k, v in problem.params.items()}
    return state, topo, params


def port_from_jax(problem, dtype=torch.float64):
    """The port's (state, topo, params) built from a JAX compiled problem."""
    from membrane_solver_tpu_torch.device.state import problem_from_numpy

    state, topo, params = jax_arrays(problem)
    return problem_from_numpy(state, topo, params, device="cpu", dtype=dtype)


def perturbation(nv: int, seed: int, amp: float = 0.05):
    """Seeded (positions, tilts_in, tilts_out) offsets for nv rows."""
    rng = np.random.default_rng(seed)
    dpos = np.zeros((nv, 3))
    dpos[:, 2] = amp * rng.standard_normal(nv)
    dpos[:, :2] = 0.2 * amp * rng.standard_normal((nv, 2))
    return dpos, amp * rng.standard_normal((nv, 3)), amp * rng.standard_normal((nv, 3))


def perturbed_pair(problem, seed: int, dtype=torch.float64):
    """(JAX state, port state) with the same seeded offsets on the live rows."""
    nv = problem.n_vertices
    dpos, dtin, dtout = perturbation(nv, seed)
    offsets = {"positions": dpos, "tilts_in": dtin, "tilts_out": dtout}
    jax_fields, port_fields = {}, {}
    for name in STATE_FIELDS:
        arr = np.array(getattr(problem.state, name))
        if name in offsets:
            arr[:nv] += offsets[name]
        jax_fields[name] = jnp.asarray(arr)
        port_fields[name] = torch.as_tensor(arr[:nv], dtype=dtype)
    from membrane_solver_tpu.device.state import MeshState as JaxState
    from membrane_solver_tpu_torch.device.state import MeshState as PortState

    return JaxState(**jax_fields), PortState(**port_fields)


def to_np(x):
    """numpy float64 copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(got, want, rel: float, what: str = "", atol_scale=None):
    """max|got - want| <= rel * max(max|want|, atol_scale or tiny)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    scale = max(scale, atol_scale or 1e-300)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel:.1e} * {scale:.3e}"
