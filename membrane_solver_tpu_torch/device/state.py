"""Device-side problem state: exact-size tensors plus a static spec.

Counterpart of ``membrane_solver_tpu/device/state.py``.  The mesh is
compiled into dataclasses of tensors; every solver step is a function of
them.  The JAX package pads every array to a power-of-two capacity so XLA
does not recompile after a refinement; PyTorch runs eagerly, so the port
compiles at exact sizes, in the JAX package's row order, and keeps the
validity masks (all true here).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Collection, Dict, Mapping, Tuple

import numpy as np
import torch

from membrane_solver_tpu_torch.geometry.mesh import Mesh

# int64 indices: torch's gather/scatter ops index with int64
INDEX = torch.int64


@dataclasses.dataclass
class MeshState:
    """Unknowns that change every step: (Nv, 3) tensors."""

    positions: torch.Tensor
    tilts: torch.Tensor
    tilts_in: torch.Tensor
    tilts_out: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CornerCSR:
    """Which triangle corners touch each vertex, as a CSR.

    ``slots[offsets[v]:offsets[v + 1]]`` hold ``tri * 3 + corner`` for every
    corner at vertex row ``v``, in triangle order (a stable sort by vertex).
    The vertex-sum kernel and its twin (``kernels/vertex_sum``) add corner
    rows into vertex rows in this order, so the sums are deterministic.
    """

    offsets: torch.Tensor  # (N + 1,) int32
    slots: torch.Tensor  # (3T,) int32

    @property
    def n_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @functools.cached_property
    def max_degree(self) -> int:
        """Corners at the busiest vertex: the twin's loop count (one host read, at first use)."""
        return int(torch.max(self.offsets[1:] - self.offsets[:-1])) if self.n_rows else 0


def corner_csr(tri_rows: torch.Tensor, n_rows: int) -> CornerCSR:
    """The :class:`CornerCSR` of ``tri_rows`` (T, 3) over ``n_rows`` vertex rows.

    Plain PyTorch, once per topology, with one host read (the range check):
    a stable sort by vertex, then each vertex's first slot by binary search.
    """
    flat = tri_rows.reshape(-1)
    if flat.numel() >= 2**31 or n_rows >= 2**31:
        raise ValueError(f"{flat.numel()} corners / {n_rows} rows exceed the int32 CSR")
    if flat.numel():
        lo, hi = (int(x) for x in torch.stack(torch.aminmax(flat)).tolist())
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"tri_rows span [{lo}, {hi}], outside the {n_rows} vertex rows")
    by_vertex, slots = torch.sort(flat, stable=True)
    first = torch.arange(n_rows + 1, dtype=flat.dtype, device=flat.device)
    offsets = torch.searchsorted(by_vertex, first).to(torch.int32)
    return CornerCSR(offsets=offsets, slots=slots.to(torch.int32))


@dataclasses.dataclass
class Topology:
    """Connectivity and per-entity parameters."""

    tri_rows: torch.Tensor  # (Nf, 3) int64 vertex rows
    tri_valid: torch.Tensor  # (Nf,) bool
    tri_surface_tension: torch.Tensor  # (Nf,)
    tri_body: torch.Tensor  # (Nf,) int64 body slot; n_body_slots = "no body"
    edge_rows: torch.Tensor  # (Ne, 2) int64
    edge_valid: torch.Tensor  # (Ne,) bool
    vertex_valid: torch.Tensor  # (Nv,) bool
    boundary_vertex_mask: torch.Tensor  # (Nv,) bool (vertices on 1-facet edges)
    fixed_mask: torch.Tensor  # (Nv,) bool
    tilt_fixed_mask: torch.Tensor
    tilt_fixed_in_mask: torch.Tensor
    tilt_fixed_out_mask: torch.Tensor
    body_valid: torch.Tensor  # (Nb,) bool, Nb = max(bodies, 1)
    body_target_volume: torch.Tensor
    body_has_target: torch.Tensor
    body_volume_stiffness: torch.Tensor
    # per-module compiled extras, namespaced "kind:module/key"
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def kept(self, key, make):
        """``make()``, built at first use for ``key`` and kept with this topology.

        Kept beside the ``tri_rows`` tensor it was built for, so a topology
        whose ``tri_rows`` is replaced builds anew.  Holds the corner CSR and
        the kernels' scratch (``kernels/tri_kernels.workspace``).
        """
        store = self.__dict__.get("_kept")
        if store is None or store[0] is not self.tri_rows:
            store = (self.tri_rows, {})
            self.__dict__["_kept"] = store
        if key not in store[1]:
            store[1][key] = make()
        return store[1][key]

    def corner_csr(self) -> CornerCSR:
        """The vertex-to-corner CSR of ``tri_rows``, built at first use and kept."""
        return self.kept("corner_csr",
                         lambda: corner_csr(self.tri_rows, self.vertex_valid.shape[0]))


_TOPO_FIELDS = tuple(f.name for f in dataclasses.fields(Topology) if f.name != "extras")


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static description of the problem: module set and mode switches."""

    energy_modules: Tuple[str, ...]
    constraint_modules: Tuple[str, ...]
    volume_mode: str
    volume_projection_during_minimization: bool = True
    static_options: Tuple[Tuple[str, str], ...] = ()
    extra_static: Tuple[Tuple[str, Any], ...] = ()

    def option(self, key: str, default: str = "") -> str:
        for k, v in self.static_options:
            if k == key:
                return v
        return default

    def static_of(self, key: str, default=None):
        for k, v in self.extra_static:
            if k == key:
                return v
        return default


@dataclasses.dataclass
class CompileLayout:
    """Host-side layout handed to the modules' compile_topology hooks."""

    mesh: Mesh
    vertex_ids: np.ndarray
    row_of: Dict[int, int]
    edge_ids: list
    tri_facet_ids: list
    n_vertices: int
    n_tris: int


@dataclasses.dataclass
class CompiledProblem:
    """Host bundle tying a Mesh snapshot to device tensors."""

    spec: ProblemSpec
    state: MeshState
    topo: Topology
    params: Dict[str, torch.Tensor]
    vertex_ids: np.ndarray  # row -> host vertex id
    tri_facet_ids: list  # tri row -> host facet id
    n_vertices: int
    n_tris: int
    n_edges: int
    n_bodies: int


# Mode-like global parameters captured in the spec (as in the JAX package).
_STATIC_PARAM_KEYS: Tuple[str, ...] = (
    "bending_energy_model",
    "bending_gradient_mode",
    "tilt_solver",
    "tilt_solve_mode",
    "tilt_cg_preconditioner",
    "tilt_transport_model",
    "tilt_divergence_mode",
    "tilt_divergence_mode_in",
    "tilt_coupling_mode",
    "tilt_couping_mode",
    "tilt_thetaB_contact_penalty_mode",
    "tilt_thetaB_contact_work_mode",
    "bending_tilt_energy_model",
    "tilt_cg_rejection_fallback",
    "shape_scaffold_rejected_step_fallback",
    "rim_slope_match_mode",
    "tilt_kkt_projection_during_relaxation",
    "tilt_mass_mode",
    "tilt_mass_mode_in",
    "tilt_mass_mode_out",
    "rim_slope_match_kkt_rows",
    "line_search_reduced_energy",
    "line_search_reduced_accept_rule",
    "tilt_projection_cadence",
    "inner_coupled_update_mode",
    "curved_theta_objective_ablation_mode",
    "bending_tilt_in_update_mode",
    "bending_tilt_interface_divergence_mode",
    "bending_tilt_interface_divergence_mode_out",
    "bending_tilt_out_interface_divergence_mode",
    "bending_tilt_in_scaffold_shape_stencil_mode",
    "benchmark_geometry_lane",
    "benchmark_parameterization",
    "bending_tilt_base_term_reference_mode",
    "bending_tilt_base_term_reference_mode_in",
    "bending_tilt_base_term_reference_mode_out",
    "theory_parity_lane",
)

# The values of the static options that the port implements: the kozlov
# coupled-tilt lane's own, the bending models, plus the defaults that select
# the same branches.
# Any other value raises NotImplementedError when the problem is compiled.
_PORTED_STATIC_VALUES: Dict[str, Tuple[str, ...]] = {
    "bending_energy_model": ("helfrich", "willmore"),
    "bending_gradient_mode": ("analytic",),
    "tilt_solver": ("cg",),
    "tilt_solve_mode": ("coupled",),
    "tilt_cg_preconditioner": ("jacobi",),
    "tilt_transport_model": ("ambient_v1",),
    "tilt_thetaB_contact_penalty_mode": ("off",),
    "tilt_thetaB_contact_work_mode": ("scalar",),
    "tilt_cg_rejection_fallback": ("off",),
    "shape_scaffold_rejected_step_fallback": ("off",),
    "rim_slope_match_mode": ("pointwise_radial_v1",),
    "tilt_mass_mode": ("lumped",),
    "tilt_mass_mode_in": ("lumped",),
    "tilt_mass_mode_out": ("lumped",),
    "rim_slope_match_kkt_rows": ("span_reduced",),
    "tilt_projection_cadence": ("per_step",),
    "inner_coupled_update_mode": ("off",),
    "curved_theta_objective_ablation_mode": ("off",),
    "bending_tilt_in_update_mode": ("off",),
    "bending_tilt_interface_divergence_mode": ("p1_triangle",),
    "bending_tilt_interface_divergence_mode_out": ("p1_triangle",),
    "bending_tilt_out_interface_divergence_mode": ("p1_triangle",),
    "bending_tilt_in_scaffold_shape_stencil_mode": ("off",),
    "bending_tilt_base_term_reference_mode": ("current_geometry",),
    "bending_tilt_base_term_reference_mode_in": ("current_geometry",),
    "bending_tilt_base_term_reference_mode_out": ("current_geometry",),
}

# Read by the JAX package only as documentation or by unported modules; the
# lane's branches do not depend on them.
_IGNORED_STATIC_KEYS = frozenset({"tilt_kkt_projection_during_relaxation"})


def collect_static_options(gp) -> Tuple[Tuple[str, str], ...]:
    out = []
    for key in _STATIC_PARAM_KEYS:
        val = gp.get(key)
        if val is not None:
            out.append((key, str(val)))
    if bool(gp.get("tilt_axisymmetric_about_thetaB_center", False)):
        out.append(("tilt_axisym", "on"))
    guard = gp.get("tilt_relax_energy_guard_factor")
    if guard is not None and float(guard) > 0.0:
        out.append(("tilt_guard", "on"))
    return tuple(out)


def check_ported_options(static_options) -> None:
    """Raise NotImplementedError for a static option the port does not run."""
    for key, val in static_options:
        if key in _IGNORED_STATIC_KEYS:
            continue
        allowed = _PORTED_STATIC_VALUES.get(key)
        if allowed is None or val.strip().lower() not in allowed:
            raise NotImplementedError(
                f"static option {key}={val!r} is not ported to membrane_solver_tpu_torch"
            )


# Scalar global parameters forwarded as 0-dim tensors (same keys as JAX).
_SCALAR_PARAM_KEYS: Tuple[str, ...] = (
    "surface_tension",
    "volume_stiffness",
    "intrinsic_curvature",
    "bending_modulus",
    "gaussian_modulus",
    "line_tension",
    "tilt_modulus",
    "tilt_modulus_in",
    "tilt_modulus_out",
    "tilt_smoothness_modulus",
    "tilt_smoothness_modulus_in",
    "tilt_smoothness_modulus_out",
    "tilt_coupling_modulus",
    "edge_stiffness",
    "target_surface_area",
    "volume_tolerance",
    "spontaneous_curvature",
    "spontaneous_curvature_in",
    "spontaneous_curvature_out",
    "bending_modulus_in",
    "bending_modulus_out",
    "jordan_stiffness",
    "jordan_target_area",
    "area_stiffness",
    "tilt_rigidity",
    "tilt_smoothness_rigidity",
    "tilt_thetaB_value",
    "tilt_thetaB_strength_in",
    "tilt_thetaB_contact_strength_in",
    "tilt_step_size",
    "tilt_tol",
    "rim_slope_match_strength",
    "tilt_relax_energy_guard_factor",
    "tilt_relax_energy_guard_min",
    "tilt_relax_energy_guard_retries",
    "tilt_projection_interval",
    "benchmark_disk_radius",
    "benchmark_lambda_value",
    "curved_theta_objective_ablation_inner_scale",
    "curved_theta_objective_ablation_outer_scale",
    "curved_theta_objective_ablation_contact_scale",
    "tilt_splay_modulus_in",
    "tilt_twist_modulus",
    "tilt_twist_modulus_in",
    "tilt_rim_source_strength_in",
    "tilt_rim_source_strength_out",
    "tilt_rim_source_strength",
    "tilt_disk_contact_strength_in",
    "tilt_disk_target_strength_in",
    "tilt_disk_target_strength_out",
    "tilt_disk_target_value_in",
    "tilt_disk_target_value_out",
    "curved_local_interface_law_strength",
    "curved_local_interface_penalty_strength",
)


def build_params(mesh: Mesh, device, dtype) -> Dict[str, torch.Tensor]:
    gp = mesh.global_parameters
    params: Dict[str, torch.Tensor] = {}
    for key in _SCALAR_PARAM_KEYS:
        val = gp.get(key)
        if val is not None and isinstance(val, (int, float)) and not isinstance(val, bool):
            params[key] = torch.tensor(float(val), dtype=dtype, device=device)
    return params


def to_tensor(arr, device, dtype) -> torch.Tensor:
    """numpy -> tensor (a copy): floats in ``dtype``, integers as int64, bools as bool."""
    arr = np.array(arr)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int64), device=device)
    return torch.as_tensor(arr.astype(np.float64), device=device).to(dtype)


def compile_state(
    mesh: Mesh, device, dtype, energy_modules=None, constraint_modules=None
) -> CompiledProblem:
    """Compile a host mesh into exact-size tensors and a static spec.

    ``energy_modules`` / ``constraint_modules`` override the mesh's lists.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.energy import get_module
    from membrane_solver_tpu_torch.energy import leaflet_presence as _lp

    gp = mesh.global_parameters
    static_options = collect_static_options(gp)
    check_ported_options(static_options)
    energy_names = tuple(mesh.energy_modules if energy_modules is None else energy_modules)
    constraint_names = tuple(
        mesh.constraint_modules if constraint_modules is None else constraint_modules
    )
    energy_mods = [(n, get_module(n)) for n in dict.fromkeys(energy_names)]
    constraint_mods = [(n, get_constraint(n)) for n in dict.fromkeys(constraint_names)]

    mesh.build_connectivity_maps()
    vertex_ids = mesh.vertex_ids
    row_of = {int(v): i for i, v in enumerate(vertex_ids)}
    nv = len(vertex_ids)

    tri_rows_np, tri_fids = mesh.triangle_rows()
    nf = tri_rows_np.shape[0]

    edge_items = sorted(mesh.edges)
    ne = len(edge_items)
    edge_rows_np = np.zeros((ne, 2), dtype=np.int64)
    for i, eid in enumerate(edge_items):
        e = mesh.edges[eid]
        edge_rows_np[i] = (row_of[e.tail_index], row_of[e.head_index])

    body_items = sorted(mesh.bodies)
    nb = len(body_items)
    nb_slots = max(nb, 1)

    facet_body = {}
    for bslot, bid in enumerate(body_items):
        for fid in mesh.bodies[bid].facet_indices:
            facet_body[fid] = bslot
    tri_body_np = np.array([facet_body.get(fid, nb_slots) for fid in tri_fids], dtype=np.int64)

    body_tv = np.zeros(nb_slots)
    body_has_tv = np.zeros(nb_slots, dtype=bool)
    body_k = np.full(nb_slots, float(gp.get("volume_stiffness", 1000.0)))
    for bslot, bid in enumerate(body_items):
        body = mesh.bodies[bid]
        tv = body.target_volume
        if tv is None:
            tv = body.options.get("target_volume")
        if tv is not None:
            body_tv[bslot] = float(tv)
            body_has_tv[bslot] = True
        if "volume_stiffness" in body.options:
            body_k[bslot] = float(body.options["volume_stiffness"])

    boundary = np.zeros(nv, dtype=bool)
    for eid, fids in mesh.edge_to_facets.items():
        if len(fids) == 1:
            e = mesh.edges[eid]
            boundary[row_of[e.tail_index]] = True
            boundary[row_of[e.head_index]] = True

    verts = [mesh.vertices[int(v)] for v in vertex_ids]
    t = lambda a: to_tensor(a, device, dtype)  # noqa: E731
    topo = Topology(
        tri_rows=t(tri_rows_np),
        tri_valid=t(np.ones(nf, dtype=bool)),
        tri_surface_tension=t(mesh.facet_parameter_array("surface_tension")),
        tri_body=t(tri_body_np),
        edge_rows=t(edge_rows_np),
        edge_valid=t(np.ones(ne, dtype=bool)),
        vertex_valid=t(np.ones(nv, dtype=bool)),
        boundary_vertex_mask=t(boundary),
        fixed_mask=t(mesh.fixed_mask()),
        tilt_fixed_mask=t(np.array([v.tilt_fixed for v in verts], dtype=bool)),
        tilt_fixed_in_mask=t(np.array([v.tilt_fixed_in for v in verts], dtype=bool)),
        tilt_fixed_out_mask=t(np.array([v.tilt_fixed_out for v in verts], dtype=bool)),
        body_valid=t(np.arange(nb_slots) < nb),
        body_target_volume=t(body_tv),
        body_has_target=t(body_has_tv),
        body_volume_stiffness=t(body_k),
    )
    state = MeshState(
        positions=t(mesh.positions_array()),
        tilts=t(mesh.tilts_array()),
        tilts_in=t(mesh.tilts_in_array()),
        tilts_out=t(mesh.tilts_out_array()),
    )

    layout = CompileLayout(
        mesh=mesh,
        vertex_ids=np.asarray(vertex_ids),
        row_of=row_of,
        edge_ids=list(edge_items),
        tri_facet_ids=list(tri_fids),
        n_vertices=nv,
        n_tris=nf,
    )
    extras: Dict[str, torch.Tensor] = {}
    extra_static = []
    for kind, mods in (("energy", energy_mods), ("constraint", constraint_mods)):
        for name, module in mods:
            hook = getattr(module, "compile_topology", None)
            if hook is not None:
                for key, arr in hook(layout).items():
                    extras[f"{kind}:{name}/{key}"] = t(arr)
            static_hook = getattr(module, "compile_static", None)
            if static_hook is not None:
                extra_static.append((f"{kind}:{name}", static_hook(layout)))
    # core hook: leaflet-absence masks, consulted whenever the gp keys are set
    for key, arr in _lp.compile_topology(layout).items():
        extras[f"energy:leaflet_presence/{key}"] = t(arr)
    topo.extras = extras

    spec = ProblemSpec(
        energy_modules=energy_names,
        constraint_modules=constraint_names,
        volume_mode=str(gp.get("volume_constraint_mode", "lagrange")),
        volume_projection_during_minimization=bool(
            gp.get("volume_projection_during_minimization", True)
        ),
        static_options=static_options,
        extra_static=tuple(extra_static),
    )
    return CompiledProblem(
        spec=spec,
        state=state,
        topo=topo,
        params=build_params(mesh, device, dtype),
        vertex_ids=np.asarray(vertex_ids),
        tri_facet_ids=tri_fids,
        n_vertices=nv,
        n_tris=nf,
        n_edges=ne,
        n_bodies=nb,
    )


def writeback(problem: CompiledProblem, mesh: Mesh) -> None:
    """Copy device state (positions, tilts) back into the host mesh entities."""
    st = problem.state
    pos, tilts, tilts_in, tilts_out = (
        x.detach().to("cpu", torch.float64).numpy()
        for x in (st.positions, st.tilts, st.tilts_in, st.tilts_out)
    )
    for i, vid in enumerate(problem.vertex_ids):
        v = mesh.vertices[int(vid)]
        v.position[:] = pos[i]
        v.tilt[:] = tilts[i]
        v.tilt_in[:] = tilts_in[i]
        v.tilt_out[:] = tilts_out[i]


def _extra_mask_key(name: str, extras: Mapping[str, np.ndarray], prefix: str):
    """The validity mask that bounds the live rows of one padded extras key."""
    if name.startswith(("g_", "group_")):
        return None
    for head, mask in (("f_", "f_valid"), ("m_", "m_valid"), ("outer", "outer_valid"),
                       ("disk", "disk_valid")):
        if name.startswith(head):
            return f"{prefix}/{mask}"
    if f"{prefix}/valid" in extras:
        return f"{prefix}/valid"
    return None


def problem_from_numpy(
    state: Mapping[str, np.ndarray],
    topo: Mapping[str, Any],
    params: Mapping[str, Any],
    *,
    vertex_tables: Collection[str] = (),
    device="cpu",
    dtype=torch.float64,
) -> Tuple[MeshState, Topology, Dict[str, torch.Tensor]]:
    """Build the port's (state, topo, params) from the JAX package's arrays.

    ``state`` maps the MeshState field names to numpy arrays, ``topo`` the
    Topology field names (plus ``extras``, a mapping of its own), and
    ``params`` scalar names to numbers, as ``numpy.asarray`` gives them from
    the JAX package's compiled problem.  Capacity-padding rows are dropped:
    vertex, triangle, edge and body arrays keep their valid rows, and each
    padded extras table keeps the live rows of its validity mask (at least
    one row, as an empty table compiles to one invalid row).  The extras
    keys in ``vertex_tables`` hold one row per vertex and keep the live
    vertex rows (an energy module lists its own in ``VERTEX_TABLES``).
    """
    t = lambda a: to_tensor(a, device, dtype)  # noqa: E731
    nv = int(np.sum(topo["vertex_valid"]))
    nf = int(np.sum(topo["tri_valid"]))
    ne = int(np.sum(topo["edge_valid"]))
    nb = max(int(np.sum(topo["body_valid"])), 1)
    rows_of = {"tri": nf, "edge": ne, "body": nb}

    def live(name, arr):
        head = name.split("_")[0]
        n = rows_of.get(head, nv)
        return np.asarray(arr)[:n]

    fields = {name: t(live(name, topo[name])) for name in _TOPO_FIELDS}
    raw_extras = {k: np.asarray(v) for k, v in topo.get("extras", {}).items()}
    extras = {}
    for key, arr in raw_extras.items():
        prefix, name = key.rsplit("/", 1)
        mask_key = _extra_mask_key(name, raw_extras, prefix)
        if mask_key is not None and arr.ndim and arr.shape[0] == raw_extras[mask_key].shape[0]:
            arr = arr[: max(int(np.sum(raw_extras[mask_key])), 1)]
        elif name.startswith("tri_present"):
            arr = arr[:nf]
        elif arr.ndim and (name.startswith(("absent", "row_weights")) or key in vertex_tables):
            arr = arr[:nv]
        extras[key] = t(arr)
    port_state = MeshState(**{k: t(np.asarray(state[k])[:nv]) for k in
                              ("positions", "tilts", "tilts_in", "tilts_out")})
    port_params = {k: torch.tensor(float(np.asarray(v)), dtype=dtype, device=device)
                   for k, v in params.items()}
    return port_state, Topology(**fields, extras=extras), port_params
