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

# compile_state calls in this process: a change of a dynamic-only global
# parameter (the theta_B scan's) must not add one
COMPILES = {"compile_state": 0}


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
    corner at vertex row ``v``: corner 0 of every triangle in triangle
    order, then corner 1, then corner 2 (:func:`corner_csr`), the order in
    which the JAX package's scatter (``.at[tri_rows[:, k]].add`` for k = 0,
    1, 2) adds them on the CPU.  ``rows`` (T, 3) is the inverse map, the
    vertex row of each corner (the backward of a vertex sum gathers through
    it).  The vertex-sum kernel and its twin (``kernels/vertex_sum``) add
    corner rows into vertex rows in this order, so the sums are
    deterministic.
    """

    offsets: torch.Tensor  # (N + 1,) int32
    slots: torch.Tensor  # (3T,) int32
    rows: torch.Tensor  # (T, 3) int64

    @property
    def n_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @functools.cached_property
    def max_degree(self) -> int:
        """Corners at the busiest vertex: the twin's loop count (one host read, at first use)."""
        return int(torch.max(self.offsets[1:] - self.offsets[:-1])) if self.n_rows else 0


def _csr(keys: torch.Tensor, n_rows: int, slot_of, rows: torch.Tensor) -> CornerCSR:
    """CSR of ``keys`` (the vertex row of each position) in position order within a row.

    A stable sort by vertex, then each vertex's first position by binary
    search; ``slot_of`` maps sorted positions to slots.
    """
    by_vertex, order = torch.sort(keys, stable=True)
    first = torch.arange(n_rows + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(by_vertex, first).to(torch.int32)
    return CornerCSR(offsets=offsets, slots=slot_of(order).to(torch.int32), rows=rows)


def corner_csr(tri_rows: torch.Tensor, n_rows: int) -> CornerCSR:
    """The :class:`CornerCSR` of ``tri_rows`` (T, 3) over ``n_rows`` vertex rows.

    Plain PyTorch, once per topology, with one host read (the range check).
    """
    T = tri_rows.shape[0]
    if 3 * T >= 2**31 or n_rows >= 2**31:
        raise ValueError(f"{3 * T} corners / {n_rows} rows exceed the int32 CSR")
    if T:
        lo, hi = (int(x) for x in torch.stack(torch.aminmax(tri_rows)).tolist())
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"tri_rows span [{lo}, {hi}], outside the {n_rows} vertex rows")
    # corner-major positions j = corner * T + tri, slot = tri * 3 + corner
    return _csr(tri_rows.T.reshape(-1), n_rows, lambda j: (j % T) * 3 + j // T, tri_rows)


def slot_csr(rows: torch.Tensor, n_rows: int) -> CornerCSR:
    """A :class:`CornerCSR` of K target rows in ``[0, n_rows]`` (any shape, read flat).

    For sums of K slot values into vertex rows (``kernels/vertex_sum.row_sum``),
    added in the order of the flat list, as the JAX package's ``.at[rows].add``
    adds them on the CPU.  The list is padded to a multiple of 3 with the
    spare row ``n_rows``, and the CSR covers ``n_rows + 1`` rows, the spare
    one last.  Callers build ``rows`` themselves, so the range is not read
    back.
    """
    flat = rows.reshape(-1).to(INDEX)
    flat = torch.cat([flat, flat.new_full(((-flat.numel()) % 3,), n_rows)])
    return _csr(flat, n_rows + 1, lambda j: j, flat.reshape(-1, 3))


def kept_slot_csr(topo: Topology, key: str, rows: torch.Tensor, n_rows: int,
                  keep: torch.Tensor | None = None) -> CornerCSR:
    """The :func:`slot_csr` of ``rows``, built at first use for ``key`` and kept with ``topo``.

    ``rows`` must be fixed per topology.  Entries where ``keep`` is False
    are aimed at the spare row and dropped.  Later calls with the same key
    return the kept CSR without reading ``rows`` again.
    """

    def make():
        target = rows if keep is None else torch.where(keep, rows, n_rows)
        return slot_csr(target, n_rows)

    return topo.kept(("slot_csr", key), make)


def check_unique_rows(rows, what: str) -> None:
    """Raise unless the vertex rows ``rows`` are distinct.

    A module whose scatter (``index_add``) rows are distinct adds at most one
    value into each row, which is exact in any order; it calls this where it
    compiles the rows instead of summing over a slot CSR.
    """
    rows = np.asarray(rows).reshape(-1)
    if np.unique(rows).size != rows.size:
        raise ValueError(f"{what}: a vertex row repeats; its sums need a fixed order")


def occurrence_levels(rows: torch.Tensor) -> list:
    """The positions of ``rows`` (flattened) in levels: level k holds every row's k-th occurrence.

    Each level's positions ascend and its rows are distinct.  One host read
    of ``rows`` and one copy back: the levels are slices of one index
    tensor on ``rows``' device.
    """
    flat = rows.detach().reshape(-1).cpu().numpy()
    rank = np.zeros(flat.size, dtype=np.int64)
    seen: Dict[int, int] = {}
    for i, r in enumerate(flat.tolist()):
        rank[i] = seen.get(r, 0)
        seen[r] = rank[i] + 1
    order = torch.as_tensor(np.argsort(rank, kind="stable"), device=rows.device)
    ends = np.cumsum(np.bincount(rank)) if rank.size else np.zeros(0, dtype=np.int64)
    return [order[a:b] for a, b in zip(np.concatenate([[0], ends[:-1]]).tolist(), ends.tolist())]


def ordered_index_add(topo: "Topology", key: str, target: torch.Tensor, rows: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """``target`` with ``values`` added into ``rows``, a repeated row's values one after the other.

    The JAX package's ``.at[rows].add`` on the CPU adds a row's values in
    list order onto the target; here the list is split once per topology
    (one host read of ``rows``, kept for ``key``) into levels of distinct
    rows, the k-th occurrence of every row in level k, and each level is
    one ``index_add`` of at most one value per row: the same bits in the
    same order, on any device.  ``rows`` must be fixed per topology.
    """

    levels = topo.kept(("ordered_index_add", key), lambda: occurrence_levels(rows))
    if len(levels) == 1:
        return target.index_add(0, rows, values)
    for idx in levels:
        target = target.index_add(0, rows[idx], values[idx])
    return target


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
    """Host-side layout handed to the modules' compile_topology hooks.

    ``row_of[vertex_id]`` -> vertex row, ``edge_slot_of[edge_id]`` -> edge
    row, ``tri_slot_of[facet_id]`` -> triangle row, ``body_slot_of[body_id]``
    -> body slot, as in the JAX package's layout (without its capacities).
    """

    mesh: Mesh
    vertex_ids: np.ndarray
    row_of: Dict[int, int]
    edge_ids: list
    tri_facet_ids: list
    n_vertices: int
    n_tris: int
    edge_slot_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    tri_slot_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    body_ids: list = dataclasses.field(default_factory=list)
    body_slot_of: Dict[int, int] = dataclasses.field(default_factory=dict)


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
    "tilt_rim_source_edge_mode",
)

# The values of the static options that the port implements: the kozlov
# coupled-tilt lane's own and its solver options (the reduced-energy line
# search, the unpreconditioned CG with its GD retry, the per-pass projection
# cadence, the inner-coupled delta cap, the curved-theta ablation, the
# reference-exact rim KKT skip, the ring-average, shared-rim staggered and
# physical-edge rim matching, the axisymmetric tilt projection, the
# scaffold-trace lane's rejected-step ``trace_z`` fallback, trace-boundary
# stencil and trace-reconstructed divergence), the single-field tilt
# lane's, the bending models, the leaflet tilt-field energies' (the consistent
# and diagonal tilt mass, the splay-twist divergence modes, the rim sources'
# edge selection), the bending-tilt inner update modes, plus the defaults
# that select the same branches.  Any other value raises NotImplementedError
# when the problem is compiled; a value the JAX package rejects raises its
# ValueError instead (``_VALID_STATIC_VALUES``).
_PORTED_STATIC_VALUES: Dict[str, Tuple[str, ...]] = {
    "bending_energy_model": ("helfrich", "willmore"),
    "bending_gradient_mode": ("analytic",),
    "tilt_solver": ("cg", "gd"),
    "tilt_solve_mode": ("coupled", "nested", "fixed"),
    "tilt_transport_model": ("ambient_v1", "connection_v1"),
    "shape_scaffold_rejected_step_fallback": ("off", "trace_z"),
    "rim_slope_match_mode": ("pointwise_radial_v1", "ring_average_radial_v1",
                             "shared_rim_staggered_v1", "physical_edge_staggered_v1"),
    # diagonal: the lumped energy, and the frozen-tilt kernel steps aside (the
    # JAX package's gate reads any value but lumped so)
    "tilt_mass_mode": ("lumped", "consistent", "diagonal"),
    "tilt_mass_mode_in": ("lumped", "consistent", "diagonal"),
    "tilt_mass_mode_out": ("lumped", "consistent", "diagonal"),
    "tilt_divergence_mode": ("native", "vertex_recovered"),
    "tilt_divergence_mode_in": ("native", "vertex_recovered"),
    "tilt_rim_source_edge_mode": ("boundary", "all"),
    "tilt_projection_cadence": ("per_step", "per_pass"),
    "inner_coupled_update_mode": ("off", "rim_matched_radial_continuation_v1"),
    "curved_theta_objective_ablation_mode": ("off", "inner_outer_rescaled"),
    "bending_tilt_in_update_mode": ("off", "outer_near_divergence_cap_v1",
                                    "radial_cross_term_off_v1"),
    "bending_tilt_interface_divergence_mode": ("p1_triangle", "trace_reconstructed_v1"),
    "bending_tilt_interface_divergence_mode_out": ("p1_triangle", "trace_reconstructed_v1"),
    "bending_tilt_out_interface_divergence_mode": ("p1_triangle", "trace_reconstructed_v1"),
    "bending_tilt_in_scaffold_shape_stencil_mode": ("off", "trace_boundary_v1"),
    # the energy-spike guard of the per-iteration leaflet relax
    # (tilt_relax_energy_guard_factor > 0)
    "tilt_guard": ("on",),
    # tilt_axisymmetric_about_thetaB_center
    "tilt_axisym": ("on",),
}

# Values the JAX package accepts but the port does not run yet: a value of
# these keys outside the ported and the not-yet-ported sets is not a value of
# the JAX package at all, and raises the ValueError the JAX package raises
# there (with its text), where the JAX package raises it: the rim mode when
# the rim module compiles, the cadence when the leaflet relax is built, the
# ablation when the energy is assembled, the bending-tilt interface
# divergence, scaffold stencil and inner update modes when the bending-tilt
# energies are made.
_VALID_STATIC_VALUES: Dict[str, Tuple[str, ...]] = {
    "rim_slope_match_mode": (),
    "tilt_projection_cadence": (),
    "inner_coupled_update_mode": (),
    "curved_theta_objective_ablation_mode": (),
    "bending_tilt_interface_divergence_mode": (),
    "bending_tilt_interface_divergence_mode_out": (),
    "bending_tilt_out_interface_divergence_mode": (),
    "bending_tilt_in_scaffold_shape_stencil_mode": (),
    "bending_tilt_in_update_mode": (),
}

# Read by the JAX package only as documentation, by unported modules, or
# under a rule that gives every value a meaning (a switch that is on for a
# few words and off otherwise: the reduced line search, the preconditioner,
# the CG's GD retry, the rim KKT rows; ``theory_parity_lane``, on for any
# non-empty value: the recovered inner divergence of ``bending_tilt_in``
# and, on the physical-edge trace lanes, the trace-layer row weights of
# ``tilt_in``/``tilt_out``; a selector whose unknown values select the
# default: the ablation's lane gates, the theta_B contact term's legacy
# penalty (on for legacy, on, true, 1) and field-linear work mode, the
# bending-tilt flat reference base term (on for flat_reference_zero_J0);
# tilt_coupling reads an unknown mode as off); the port runs them at every
# value.  The reduced
# line search's accept rule raises the JAX package's ValueError when the
# minimize block is built with the reduced line search on.
_IGNORED_STATIC_KEYS = frozenset({
    "tilt_kkt_projection_during_relaxation", "tilt_coupling_mode", "tilt_couping_mode",
    "line_search_reduced_energy", "line_search_reduced_accept_rule", "tilt_cg_preconditioner",
    "tilt_cg_rejection_fallback", "rim_slope_match_kkt_rows", "benchmark_geometry_lane",
    "benchmark_parameterization", "theory_parity_lane", "tilt_thetaB_contact_penalty_mode",
    "tilt_thetaB_contact_work_mode", "bending_tilt_base_term_reference_mode",
    "bending_tilt_base_term_reference_mode_in", "bending_tilt_base_term_reference_mode_out",
})


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
    """Raise NotImplementedError for a static option the port does not run.

    Values outside the JAX package's own set pass here for the keys of
    ``_VALID_STATIC_VALUES``: they raise its ValueError later, where it does.
    """
    for key, val in static_options:
        if key in _IGNORED_STATIC_KEYS:
            continue
        allowed = _PORTED_STATIC_VALUES.get(key)
        v = val.strip().lower()
        if allowed is not None and v in allowed:
            continue
        if key in _VALID_STATIC_VALUES and v not in _VALID_STATIC_VALUES[key]:
            continue
        raise NotImplementedError(
            f"static option {key}={val!r} is not ported to membrane_solver_tpu_torch"
        )


def compile_core_extras(layout: "CompileLayout", tri_rows_np: np.ndarray) -> Dict[str, np.ndarray]:
    """The extras the core solver reads (JAX ``compile_state``'s core hooks).

    - ``core:tilt_axisym/{center,axis}``: the axisymmetric tilt projection's
      center and unit axis (``tilt_thetaB_center``, ``tilt_thetaB_normal``),
      with ``tilt_axisymmetric_about_thetaB_center`` on;
    - ``core:inner_coupled/center_xy``: the inner-coupled delta cap's xy
      center (``assume_J0_center_xy``), with ``inner_coupled_update_mode``
      other than off (any value but the two the JAX package knows raises
      its ValueError here);
    - ``core:curved_disk/transition_mask``: with ``rim_slope_match_mode``
      ``shared_rim_staggered_v1`` and the three rim groups set, every vertex
      of a triangle that touches the outer matching ring (the shape
      gradient's z is zeroed there, its x and y everywhere);
    - ``core:scaffold_trace/mask``: with ``shape_scaffold_rejected_step_fallback``
      ``trace_z``, the rows whose ``pin_to_circle_group`` is ``trace_layer``
      (the fallback's line search moves their heights only).
    """
    from membrane_solver_tpu_torch.energy.bending_tilt_leaflet import assume_J0_center_xy

    gp = layout.mesh.global_parameters
    out: Dict[str, np.ndarray] = {}
    if bool(gp.get("tilt_axisymmetric_about_thetaB_center", False)):
        out["core:tilt_axisym/center"] = np.asarray(
            gp.get("tilt_thetaB_center") or [0.0, 0.0, 0.0], dtype=float).reshape(3)
        axis = np.asarray(gp.get("tilt_thetaB_normal") or [0.0, 0.0, 1.0], dtype=float).reshape(3)
        n = float(np.linalg.norm(axis))
        out["core:tilt_axisym/axis"] = axis / n if n > 1e-15 else np.array([0.0, 0.0, 1.0])
    icm = str(gp.get("inner_coupled_update_mode") or "off").strip().lower()
    if icm not in {"off", "rim_matched_radial_continuation_v1"}:
        raise ValueError(
            "inner_coupled_update_mode must be 'off' or "
            "'rim_matched_radial_continuation_v1'."
        )
    if icm != "off":
        out["core:inner_coupled/center_xy"] = assume_J0_center_xy(gp)
    mode = str(gp.get("rim_slope_match_mode") or "").strip().lower()
    if mode == "shared_rim_staggered_v1" and all(
        gp.get(k) is not None for k in ("rim_slope_match_group", "rim_slope_match_outer_group",
                                        "rim_slope_match_disk_group")
    ):
        support_group = str(gp.get("rim_slope_match_outer_group") or "").strip()
        support = np.zeros(layout.n_vertices, dtype=bool)
        for row, vid in enumerate(layout.vertex_ids):
            opts = layout.mesh.vertices[int(vid)].options or {}
            if str(opts.get("rim_slope_match_group") or "") == support_group:
                support[row] = True
        transition = np.zeros(layout.n_vertices, dtype=bool)
        if support.any() and layout.n_tris:
            tri_arr = np.asarray(tri_rows_np, dtype=int)
            transition[np.unique(tri_arr[support[tri_arr].any(axis=1)])] = True
        out["core:curved_disk/transition_mask"] = transition
    if str(gp.get("shape_scaffold_rejected_step_fallback", "") or "").lower() == "trace_z":
        out["core:scaffold_trace/mask"] = np.array(
            [str((layout.mesh.vertices[int(v)].options or {}).get("pin_to_circle_group") or "")
             == "trace_layer" for v in layout.vertex_ids], dtype=bool)
    return out


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

    COMPILES["compile_state"] += 1
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
        edge_slot_of={int(eid): i for i, eid in enumerate(edge_items)},
        tri_slot_of={int(fid): i for i, fid in enumerate(tri_fids)},
        body_ids=list(body_items),
        body_slot_of={int(bid): i for i, bid in enumerate(body_items)},
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
    for key, arr in compile_core_extras(layout, tri_rows_np).items():
        extras[key] = t(arr)
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
                       ("disk", "disk_valid"), ("rim_", "rim_valid")):
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
        elif arr.ndim and (name.startswith(("absent", "row_weights", "transition_mask",
                                            "scaffold_", "stencil_", "assume_J0",
                                            "region_zero"))
                           or key == "core:scaffold_trace/mask" or key in vertex_tables):
            arr = arr[:nv]
        extras[key] = t(arr)
    port_state = MeshState(**{k: t(np.asarray(state[k])[:nv]) for k in
                              ("positions", "tilts", "tilts_in", "tilts_out")})
    port_params = {k: torch.tensor(float(np.asarray(v)), dtype=dtype, device=device)
                   for k, v in params.items()}
    return port_state, Topology(**fields, extras=extras), port_params
