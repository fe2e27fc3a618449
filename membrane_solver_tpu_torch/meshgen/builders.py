"""Parametric builders for the benchmark-lane input meshes.

Copy of ``membrane_solver_tpu/meshgen/builders.py`` (NumPy host code); only the
import paths differ.

Every builder returns a dict in the input-file schema consumed by
``geometry/io_readers.py`` (vertices / edges / faces / bodies /
definitions / global_parameters / instructions), the same schema the
reference's ``meshes/*.json`` use.  Geometry is generated fresh — these
are not copies of the reference's stored meshes; the lanes they define
are physically equivalent (same energies, constraints, and instruction
recipes), which is what the benchmark suite and the standalone user
need.

Conventions (see io_readers):
- vertices: ``[x, y, z]`` or ``[x, y, z, {options}]``, 0-based ids;
- edges: ``[tail, head]`` vertex ids, 0-based;
- faces: lists of signed edge references, 0-based, ``"rN"`` = reversed;
- bodies: ``{"faces": [[face ids]], "target_volume": [v]}``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple


# ----------------------------------------------------------------------
# small mesh-assembly helper
# ----------------------------------------------------------------------
class _Builder:
    """Accumulates vertices/edges/triangles; deduplicates shared edges."""

    def __init__(self) -> None:
        self.vertices: List[list] = []
        self.vertex_opts: Dict[int, dict] = {}
        self.edges: List[Tuple[int, int]] = []
        self.edge_opts: Dict[int, dict] = {}
        self._edge_ids: Dict[Tuple[int, int], int] = {}
        self.faces: List[list] = []
        self.face_opts: Dict[int, dict] = {}

    def vertex(self, x: float, y: float, z: float, **opts) -> int:
        vid = len(self.vertices)
        self.vertices.append([float(x), float(y), float(z)])
        if opts:
            self.vertex_opts[vid] = opts
        return vid

    def tag(self, vid: int, **opts) -> None:
        self.vertex_opts.setdefault(vid, {}).update(opts)

    def edge(self, a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        eid = self._edge_ids.get(key)
        if eid is None:
            eid = len(self.edges)
            self.edges.append((a, b))
            self._edge_ids[key] = eid
        return eid

    def _signed(self, a: int, b: int):
        eid = self.edge(a, b)
        return eid if self.edges[eid] == (a, b) else f"r{eid}"

    def tri(self, a: int, b: int, c: int, **opts) -> int:
        fid = len(self.faces)
        self.faces.append([self._signed(a, b), self._signed(b, c), self._signed(c, a)])
        if opts:
            self.face_opts[fid] = opts
        return fid

    def quad(self, a: int, b: int, c: int, d: int) -> int:
        fid = len(self.faces)
        self.faces.append(
            [self._signed(a, b), self._signed(b, c), self._signed(c, d), self._signed(d, a)]
        )
        return fid

    def boundary_edge_ids(self) -> List[int]:
        """Edges used by exactly one face (any orientation)."""
        count: Dict[int, int] = {}
        for loop in self.faces:
            for ref in loop:
                eid = int(str(ref).lstrip("r"))
                count[eid] = count.get(eid, 0) + 1
        return [eid for eid, c in count.items() if c == 1]

    def to_dict(self) -> dict:
        verts = []
        for vid, pos in enumerate(self.vertices):
            opts = self.vertex_opts.get(vid)
            verts.append(pos + [opts] if opts else list(pos))
        edges = []
        for eid, (a, b) in enumerate(self.edges):
            opts = self.edge_opts.get(eid)
            edges.append([a, b, opts] if opts else [a, b])
        faces = []
        for fid, loop in enumerate(self.faces):
            opts = self.face_opts.get(fid)
            faces.append(list(loop) + [opts] if opts else list(loop))
        return {"vertices": verts, "edges": edges, "faces": faces}


# ----------------------------------------------------------------------
# closed shells
# ----------------------------------------------------------------------
def cube(size: float = 1.0, target_volume: float = 1.0, instructions=None) -> dict:
    """Unit cube shell with a volume-penalty body (the cube→sphere lane)."""
    b = _Builder()
    s = float(size)
    corners = [
        (0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s),
        (0, s, s), (0, s, 0), (s, s, 0), (s, s, s),
    ]
    for c in corners:
        b.vertex(*c)
    # outward-oriented quad faces
    quads = [
        (0, 1, 2, 3),  # y=0
        (5, 4, 7, 6),  # y=s
        (0, 3, 4, 5),  # x=0
        (1, 6, 7, 2),  # x=s
        (0, 5, 6, 1),  # z=0
        (3, 2, 7, 4),  # z=s
    ]
    for q in quads:
        b.quad(*q)
    out = b.to_dict()
    out["bodies"] = {"faces": [list(range(6))], "target_volume": [float(target_volume)]}
    out["global_parameters"] = {
        "surface_tension": 1.0,
        "volume_stiffness": 1000.0,
        "volume_constraint_mode": "penalty",
        "volume_projection_during_minimization": True,
    }
    out["instructions"] = instructions or [
        "g50", "r", "u", "V2", "g50", "r", "u", "V2", "g100", "r", "u", "V2", "g200",
    ]
    return out


def dented_cube(dent: float = 0.4, **kw) -> dict:
    """Cube with one face's corner pushed inward — volume-recovery lane."""
    out = cube(**kw)
    out["vertices"][7] = [1.0 - float(dent)] * 3
    out["instructions"] = ["g60", "r", "g60", "u", "g120"]
    return out


def sphere(n_subdiv: int = 1, radius: float = 1.0, target_volume: float | None = None) -> dict:
    """Octahedron-based triangulated sphere shell."""
    b = _Builder()
    r = float(radius)
    top = b.vertex(0, 0, r)
    bot = b.vertex(0, 0, -r)
    ring = [b.vertex(r * math.cos(a), r * math.sin(a), 0.0)
            for a in (0.0, math.pi / 2, math.pi, 3 * math.pi / 2)]
    for i in range(4):
        j = (i + 1) % 4
        b.tri(top, ring[i], ring[j])
        b.tri(bot, ring[j], ring[i])
    out = b.to_dict()
    vol = target_volume if target_volume is not None else 4.0 / 3.0 * math.pi * r**3
    out["bodies"] = {"faces": [list(range(8))], "target_volume": [float(vol)]}
    out["global_parameters"] = {
        "surface_tension": 1.0,
        "volume_stiffness": 1000.0,
        "volume_constraint_mode": "penalty",
    }
    out["instructions"] = ["r"] * max(int(n_subdiv), 0) + ["g100"]
    return out


# ----------------------------------------------------------------------
# open sheets
# ----------------------------------------------------------------------
def square_sheet(n: int = 4, line_tension: float = 1.0) -> dict:
    """Flat unit square; boundary carries line tension, area is conserved.

    Minimizing perimeter at fixed area drives the boundary to a circle —
    the reference's ``square_to_circle`` scenario.
    """
    b = _Builder()
    grid = {}
    for j in range(n + 1):
        for i in range(n + 1):
            grid[(i, j)] = b.vertex(i / n, j / n, 0.0)
    for j in range(n):
        for i in range(n):
            v00, v10 = grid[(i, j)], grid[(i + 1, j)]
            v01, v11 = grid[(i, j + 1)], grid[(i + 1, j + 1)]
            b.tri(v00, v10, v11)
            b.tri(v00, v11, v01)
    for eid in b.boundary_edge_ids():
        b.edge_opts.setdefault(eid, {})["line_tension"] = float(line_tension)
    out = b.to_dict()
    out["global_parameters"] = {
        "surface_tension": 0.0,
        "target_surface_area": 1.0,
    }
    out["energy_modules"] = ["surface", "line_tension"]
    out["constraint_modules"] = ["global_area"]
    out["instructions"] = ["g40", "r", "g40", "u", "V4", "g60"]
    return out


def catenoid(n_theta: int = 12, n_z: int = 6, radius: float = 1.0, height: float = 1.0) -> dict:
    """Open cylinder between two fixed rings; tension relaxes it to a catenoid."""
    b = _Builder()
    rings = []
    for k in range(n_z + 1):
        z = -height / 2 + height * k / n_z
        fixed = k in (0, n_z)
        row = []
        for i in range(n_theta):
            a = 2 * math.pi * i / n_theta
            opts = {"fixed": True} if fixed else {}
            row.append(b.vertex(radius * math.cos(a), radius * math.sin(a), z, **opts))
        rings.append(row)
    for k in range(n_z):
        lo, hi = rings[k], rings[k + 1]
        for i in range(n_theta):
            j = (i + 1) % n_theta
            b.tri(lo[i], lo[j], hi[j])
            b.tri(lo[i], hi[j], hi[i])
    out = b.to_dict()
    out["global_parameters"] = {"surface_tension": 1.0}
    out["instructions"] = ["g60", "r", "g60", "u", "g120"]
    return out


def spherical_cap(n_rings: int = 4, n_sectors: int = 12, rim_radius: float = 1.0,
                  target_volume: float = 0.5) -> dict:
    """Flat disk pinned at the rim with a volume target — bulges to a cap."""
    b = _Builder()
    rings = _polar_disk(b, n_rings, n_sectors, rim_radius)
    for vid in rings[-1]:
        b.tag(vid, preset="rim")
    out = b.to_dict()
    out["definitions"] = {
        "rim": {
            "constraints": ["pin_to_circle"],
            "pin_to_circle_group": "rim",
            "pin_to_circle_radius": float(rim_radius),
            "pin_to_circle_normal": [0.0, 0.0, 1.0],
            "pin_to_circle_point": [0.0, 0.0, 0.0],
            "pin_to_circle_mode": "fixed",
        }
    }
    out["bodies"] = {"faces": [list(range(len(out["faces"])))],
                     "target_volume": [float(target_volume)]}
    out["global_parameters"] = {
        "surface_tension": 1.0,
        "volume_constraint_mode": "lagrange",
    }
    out["constraint_modules"] = ["volume", "pin_to_circle"]
    out["instructions"] = ["g40", "r", "g40", "u", "g80"]
    return out


def two_disks_sphere(n_subdiv: int = 1, cap_angle_deg: float = 35.0) -> dict:
    """Sphere with two polar caps tagged as rigid disk groups."""
    out = sphere(n_subdiv=0)
    # tag polar vertices (z extremes) as disk groups
    cut = math.cos(math.radians(float(cap_angle_deg)))
    for v in out["vertices"]:
        x, y, z = v[0], v[1], v[2]
        r = math.sqrt(x * x + y * y + z * z) or 1.0
        if z / r > cut:
            (v.append({}) if len(v) == 3 else None)
            v[3]["disk_tag"] = "north"
        elif z / r < -cut:
            (v.append({}) if len(v) == 3 else None)
            v[3]["disk_tag"] = "south"
    out["instructions"] = ["r"] * max(int(n_subdiv), 0) + ["g60", "r", "g60", "u", "V2", "g100"]
    return out


def torus(n_major: int = 12, n_minor: int = 8, R: float = 1.0, r: float = 0.35) -> dict:
    """Closed torus shell — the Gauss–Bonnet genus-1 diagnostic lane (∮K dA = 0)."""
    b = _Builder()
    grid = {}
    for i in range(n_major):
        a = 2 * math.pi * i / n_major
        for j in range(n_minor):
            t = 2 * math.pi * j / n_minor
            x = (R + r * math.cos(t)) * math.cos(a)
            y = (R + r * math.cos(t)) * math.sin(a)
            z = r * math.sin(t)
            grid[(i, j)] = b.vertex(x, y, z)
    for i in range(n_major):
        for j in range(n_minor):
            i2, j2 = (i + 1) % n_major, (j + 1) % n_minor
            b.tri(grid[(i, j)], grid[(i2, j)], grid[(i2, j2)])
            b.tri(grid[(i, j)], grid[(i2, j2)], grid[(i, j2)])
    out = b.to_dict()
    out["global_parameters"] = {"surface_tension": 1.0, "gaussian_modulus": 1.0}
    out["energy_modules"] = ["surface", "gaussian_curvature"]
    out["instructions"] = ["g20"]
    return out


# ----------------------------------------------------------------------
# tilt / caveolin lanes
# ----------------------------------------------------------------------
def _polar_disk(b: _Builder, n_rings: int, n_sectors: int, radius: float,
                ring_radii: List[float] | None = None) -> List[List[int]]:
    """Center vertex + concentric rings, fan+strip triangulated.

    Returns the ring vertex lists (rings[0] = [center]).
    """
    center = b.vertex(0.0, 0.0, 0.0)
    rings: List[List[int]] = [[center]]
    radii = ring_radii or [radius * k / n_rings for k in range(1, n_rings + 1)]
    for rk in radii:
        row = []
        for i in range(n_sectors):
            a = 2 * math.pi * i / n_sectors
            row.append(b.vertex(rk * math.cos(a), rk * math.sin(a), 0.0))
        rings.append(row)
    first = rings[1]
    for i in range(n_sectors):
        b.tri(center, first[i], first[(i + 1) % n_sectors])
    for k in range(1, len(rings) - 1):
        lo, hi = rings[k], rings[k + 1]
        for i in range(n_sectors):
            j = (i + 1) % n_sectors
            b.tri(lo[i], hi[i], hi[j])
            b.tri(lo[i], hi[j], lo[j])
    return rings


def flat_disk(n_rings: int = 6, n_sectors: int = 16, radius: float = 1.0) -> dict:
    """Plain flat disk with a pinned rim — base geometry for tilt lanes."""
    b = _Builder()
    rings = _polar_disk(b, n_rings, n_sectors, radius)
    for vid in rings[-1]:
        b.tag(vid, preset="rim")
    out = b.to_dict()
    out["definitions"] = {
        "rim": {
            "constraints": ["pin_to_circle"],
            "pin_to_circle_group": "rim",
            "pin_to_circle_radius": float(radius),
            "pin_to_circle_normal": [0.0, 0.0, 1.0],
            "pin_to_circle_point": [0.0, 0.0, 0.0],
            "pin_to_circle_mode": "fixed",
        }
    }
    out["global_parameters"] = {"surface_tension": 1.0}
    out["instructions"] = ["g20"]
    return out


def kozlov_1disk(disk_radius: float = 1.0, outer_radius: float = 12.0,
                 n_sectors: int = 16, n_disk_rings: int = 3,
                 n_outer_rings: int = 8, kappa: float = 1.0,
                 tilt_modulus: float = 225.0, thetaB_strength: float = 100.0,
                 contact_strength: float = 4.286, thetaB_value: float = 0.3) -> dict:
    """Caveolin/Kozlov–Hamm 1-disk hard-rim lane, generated standalone.

    Physically equivalent to the reference's
    ``bench_kozlov_1disk_profile_hard_rim_R12.yaml`` lane (same energy
    modules, constraint set, leaflet moduli, θ_B contact term, hard
    kinematic rim matching); the triangulation itself is this package's
    own polar construction with geometrically-graded outer rings.
    """
    b = _Builder()
    # disk rings (uniform) then outer rings (geometric grading to R_outer)
    disk_radii = [disk_radius * k / n_disk_rings for k in range(1, n_disk_rings + 1)]
    grade = (outer_radius / disk_radius) ** (1.0 / n_outer_rings)
    outer_radii = [disk_radius * grade**k for k in range(1, n_outer_rings + 1)]
    rings = _polar_disk(b, 0, n_sectors, 0.0, ring_radii=disk_radii + outer_radii)

    b.tag(rings[0][0], preset="disk", fixed=True,
          tilt_fixed_in=True, tilt_fixed_out=True,
          tilt_in=[0.0, 0.0], tilt_out=[0.0, 0.0])
    for k in range(1, n_disk_rings):  # interior disk rings
        for vid in rings[k]:
            # the FIRST interior ring carries the rim-matching disk group
            # (reference fixture: rim_slope_match_group "disk" tags only the
            # innermost disk ring, bench_kozlov_..._R12.yaml vertices)
            if k == 1:
                b.tag(vid, preset="disk", rim_slope_match_group="disk")
            else:
                b.tag(vid, preset="disk")
    for vid in rings[n_disk_rings]:  # the disk boundary = rim ring
        b.tag(vid, preset="rim")
    for vid in rings[n_disk_rings + 1]:  # first membrane ring outside the rim
        b.tag(vid, preset="outer")
    for vid in rings[-1]:  # far boundary
        b.tag(vid, preset="outer_rim", fixed=True)

    out = b.to_dict()
    plane = {"pin_to_plane_normal": [0.0, 0.0, 1.0], "pin_to_plane_point": [0.0, 0.0, 0.0]}
    out["definitions"] = {
        "disk": {"constraints": ["pin_to_plane"], "tilt_thetaB_group_in": "disk", **plane},
        "rim": {
            "constraints": ["pin_to_plane", "pin_to_circle"], **plane,
            "pin_to_circle_group": "rim",
            "pin_to_circle_radius": float(disk_radius),
            "pin_to_circle_normal": [0.0, 0.0, 1.0],
            "pin_to_circle_point": [0.0, 0.0, 0.0],
            "pin_to_circle_mode": "fixed",
            "rim_slope_match_group": "rim",
        },
        # members of the outer matching ring are selected by
        # rim_slope_match_group == <outer_group> (reference
        # rim_slope_match_utils._collect_group_rows matches this key for
        # every group role)
        "outer": {"rim_slope_match_group": "outer"},
        "outer_rim": {
            "constraints": ["pin_to_circle"],
            "pin_to_circle_group": "outer_rim",
            "pin_to_circle_radius": float(outer_radius),
            "pin_to_circle_normal": [0.0, 0.0, 1.0],
            "pin_to_circle_point": [0.0, 0.0, 0.0],
            "pin_to_circle_mode": "fixed",
        },
    }
    out["global_parameters"] = {
        "surface_tension": 0.0,
        "bending_energy_model": "helfrich",
        "spontaneous_curvature": 0.0,
        "bending_modulus_in": float(kappa),
        "bending_modulus_out": float(kappa),
        "tilt_modulus_in": float(tilt_modulus),
        "tilt_modulus_out": float(tilt_modulus),
        "tilt_thetaB_group_in": "disk",
        "tilt_thetaB_strength_in": float(thetaB_strength),
        "tilt_thetaB_contact_strength_in": float(contact_strength),
        # nonzero boundary tilt drives the lane from its flat start (the
        # reference fixture instead ships a mid-protocol relaxed state)
        "tilt_thetaB_value": float(thetaB_value),
        "tilt_thetaB_center": [0.0, 0.0, 0.0],
        "tilt_thetaB_normal": [0.0, 0.0, 1.0],
        "rim_slope_match_thetaB_param": "tilt_thetaB_value",
        "rim_slope_match_group": "rim",
        "rim_slope_match_outer_group": "outer",
        "rim_slope_match_disk_group": "disk",
        "rim_slope_match_strength": 0.0,
        "tilt_solve_mode": "coupled",
        "tilt_step_size": 0.15,
        "tilt_inner_steps": 40,
        "tilt_tol": 1.0e-10,
        "step_size": 0.01,
        "step_size_mode": "fit",
        **plane,
    }
    out["constraint_modules"] = ["pin_to_plane", "pin_to_circle", "rim_slope_match_out",
                                 "tilt_thetaB_boundary_in"]
    out["energy_modules"] = [
        "surface", "tilt_in", "tilt_out",
        "bending_tilt_in", "bending_tilt_out", "tilt_thetaB_contact_in",
    ]
    out["macros"] = {"relax": "g10; u; g10"}
    return out


def rect_tilt_source(nx: int = 10, ny: int = 4, length: float = 5.0,
                     width: float = 2.0, tilt_modulus: float = 4.0,
                     kappa: float = 1.0) -> dict:
    """Rectangular sheet with a fixed unit tilt source along one edge.

    The tilt field decays into the sheet with decay length sqrt(κ/k_t) —
    the bilayer-tilt decay diagnostic lane.
    """
    b = _Builder()
    grid = {}
    for j in range(ny + 1):
        for i in range(nx + 1):
            opts = {}
            if i == 0:
                opts = {"tilt_fixed": True, "tilt": [1.0, 0.0, 0.0], "fixed": True}
            elif i == nx:
                opts = {"fixed": True}
            grid[(i, j)] = b.vertex(length * i / nx, width * j / ny, 0.0, **opts)
    for j in range(ny):
        for i in range(nx):
            v00, v10 = grid[(i, j)], grid[(i + 1, j)]
            v01, v11 = grid[(i, j + 1)], grid[(i + 1, j + 1)]
            b.tri(v00, v10, v11)
            b.tri(v00, v11, v01)
    out = b.to_dict()
    out["global_parameters"] = {
        "surface_tension": 0.0,
        "tilt_modulus": float(tilt_modulus),
        "bending_modulus": float(kappa),
        "tilt_solve_mode": "nested",
        "tilt_inner_steps": 60,
        "tilt_step_size": 0.2,
        "tilt_tol": 1e-10,
    }
    out["energy_modules"] = ["surface", "tilt", "tilt_smoothness"]
    out["instructions"] = ["g5"]
    return out


# ----------------------------------------------------------------------
# registry + dispatch
# ----------------------------------------------------------------------
BUILDERS: Dict[str, Callable[..., dict]] = {
    "cube": cube,
    "dented_cube": dented_cube,
    "sphere": sphere,
    "square_sheet": square_sheet,
    "square_to_circle": square_sheet,
    "catenoid": catenoid,
    "spherical_cap": spherical_cap,
    "two_disks_sphere": two_disks_sphere,
    "torus": torus,
    "flat_disk": flat_disk,
    "kozlov_1disk": kozlov_1disk,
    "rect_tilt_source": rect_tilt_source,
}


def build(name: str, **kwargs) -> dict:
    try:
        fn = BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown mesh builder {name!r}; known: {sorted(BUILDERS)}")
    return fn(**kwargs)
