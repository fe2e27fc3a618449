"""The bending-tilt base-term overrides and inner update modes against the JAX package (float64).

On meshgen ``kozlov_1disk`` (177 vertices) with a spontaneous curvature of
1 in both leaflets (the Helfrich base term is then order one, as
``tests/test_gp_option_parity.py`` sets it) and seeded heights and tilts
(``_torch_port_harness.seeded_pair``):

- the compiled masks (``assume_J0`` with and without its radius clip,
  ``region_zero`` of both region modes, the cap's ``update_center``) from
  the port's own compile against the JAX package's;
- ``bending_tilt_in``/``_out``'s energy and its gradients in the positions
  and both leaflet tilts, full and frozen split, at rel 1e-12, per mode:
  the flat-reference base term per leaflet and for both, the assume-J0
  presets, both base-term regions, ``outer_near_divergence_cap_v1`` (its
  bands binding on the seeded tilts) and ``radial_cross_term_off_v1``;
- ``tilt_mass_mode: diagonal``: ``tilt_in``/``tilt_out`` and the Jacobi
  preconditioner's diagonal as the JAX package's (the lumped mass);
- the frozen-tilt kernel's gate at float32: the kernel steps aside under
  the in-update modes and ``tilt_mass_mode: diagonal``, and keeps the zeroed
  base rows in its payload under the masks;
- the JAX package's ValueError texts for bad values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, assert_close, energy_and_grads, port_from_jax, \
    seeded_pair, to_np

REL = 1e-12
C0 = {"spontaneous_curvature_in": 1.0, "spontaneous_curvature_out": 1.0}
BANDS = {"benchmark_disk_radius": 1.0, "benchmark_lambda_value": 0.25}
REGION = {"bending_tilt_base_term_region_radius": 1.0}
# mode -> (global parameters, the modules it acts on)
MODES = {
    "cap": ({"bending_tilt_in_update_mode": "outer_near_divergence_cap_v1", **BANDS},
            ("bending_tilt_in",)),
    "radial": ({"bending_tilt_in_update_mode": "radial_cross_term_off_v1"}, ("bending_tilt_in",)),
    "flat_in": ({"bending_tilt_base_term_reference_mode_in": "flat_reference_zero_J0"},
                ("bending_tilt_in",)),
    "flat_out": ({"bending_tilt_base_term_reference_mode_out": "flat_reference_zero_J0"},
                 ("bending_tilt_out",)),
    "flat_both": ({"bending_tilt_base_term_reference_mode": "flat_reference_zero_J0"},
                  ("bending_tilt_in", "bending_tilt_out")),
    "j0_in": ({"bending_tilt_assume_J0_presets_in": ["disk"]}, ("bending_tilt_in",)),
    "j0_clip": ({"bending_tilt_assume_J0_presets": ["disk", "rim"],
                 "bending_tilt_assume_J0_presets_radius_max": 0.75},
                ("bending_tilt_in", "bending_tilt_out")),
    "disk_only": ({"bending_tilt_base_term_region_mode": "disk_only_base_term_v1", **REGION},
                  ("bending_tilt_in",)),
    "split": ({"bending_tilt_base_term_region_mode": "physical_disk_split_v1", **REGION},
              ("bending_tilt_out",)),
    # the tilt energies' mass mode (test_diagonal_tilt_mass_matches_jax)
    "diagonal": ({"tilt_mass_mode": "diagonal"}, ()),
}
CASES = [(mode, name) for mode, (_gp, names) in MODES.items() for name in names]
_CACHE: dict = {}


def _mesh(pkg, gp):
    from membrane_solver_tpu.meshgen import build

    m = pkg.parse_geometry(build("kozlov_1disk"))
    m.global_parameters.update({**BENCH_GP, **C0, **gp})
    return m


def case(mode: str):
    """(JAX problem, JAX state, port spec, port (state, topo, params), port's own topo)."""
    if mode in _CACHE:
        return _CACHE[mode]
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    gp = MODES[mode][0]
    jp = jpkg.Minimizer(_mesh(jpkg, gp), quiet=True).problem()
    tp = tpkg.Minimizer(_mesh(tpkg, gp), quiet=True, device="cpu").problem()
    js, ts = seeded_pair(jp, 9)
    _s, topo, params = port_from_jax(jp)
    _CACHE[mode] = (jp, js, tp.spec, (ts, topo, params), tp.topo)
    return _CACHE[mode]


def _mode_keys(extras) -> list:
    return sorted(k for k in extras if k.startswith("energy:bending_tilt_")
                  and k.rsplit("/", 1)[1] in ("assume_J0", "region_zero", "update_center"))


@pytest.mark.parametrize("mode", ["cap", "j0_in", "j0_clip", "disk_only", "split"])
def test_compile_masks_match_jax(mode):
    """The same mask and center keys, equal rows, from compile-time host positions."""
    jp, _js, _spec, _port, own = case(mode)
    nv = jp.n_vertices
    keys = _mode_keys(jp.topo.extras)
    assert keys and keys == _mode_keys(own.extras)
    for key in keys:
        want = np.asarray(jp.topo.extras[key])
        if key.endswith("update_center"):
            np.testing.assert_array_equal(to_np(own.extras[key]), want)
        else:
            got = to_np(own.extras[key]).astype(bool)
            np.testing.assert_array_equal(got, want[:nv])
            assert got.any() and not got.all(), key


def jax_energy(mode: str, name: str):
    """The JAX package's (energy, gradients) of ``name`` on the mode's seeded state, once."""
    key = (mode, name)
    if key not in _CACHE:
        jp, js, *_rest = case(mode)
        _CACHE[key] = energy_and_grads(jp, name, js, port=False)
    return _CACHE[key]


@pytest.mark.parametrize("mode,name", CASES)
def test_energy_matches_jax(mode, name):
    from types import SimpleNamespace

    _jp, _js, tspec, (ts, topo, params), _own = case(mode)
    port = SimpleNamespace(spec=tspec, topo=topo, params=params)
    e_j, g_j = jax_energy(mode, name)
    e_t, g_t = energy_and_grads(port, name, ts, port=True)
    assert abs(e_t - e_j) <= REL * abs(e_j), (e_t, e_j)
    for f, gw, gt in zip(("positions", "tilts", "tilts_in", "tilts_out"), g_j, g_t):
        assert_close(gt, gw, REL, f"{name} {f}", atol_scale=1e-300)


@pytest.mark.parametrize("mode,name", CASES)
def test_frozen_split_matches_jax(mode, name):
    """The frozen split's value and tilt gradients against the JAX package's energy.

    The JAX package's frozen split has the full energy's value and tilt
    gradients by construction (the surrogate's value cancels and its tilt
    input is detached), so the port's is held against those.
    """
    from membrane_solver_tpu_torch.energy import get_module

    _jp, _js, tspec, (ts, topo, params), _own = case(mode)
    e_j, (_gp, _gt, gi_j, go_j) = jax_energy(mode, name)
    pre, fn = get_module(name).make_tilt_frozen(tspec)
    fr = pre(ts, topo, params)
    tin, tout = (x.detach().clone().requires_grad_(True) for x in (ts.tilts_in, ts.tilts_out))
    e = fn(tin, tout, fr, topo, params)
    gi, go = torch.autograd.grad(e, (tin, tout), allow_unused=True)
    assert abs(float(e.detach()) - e_j) <= REL * abs(e_j)
    assert_close(gi if gi is not None else torch.zeros_like(tin), gi_j, REL, "tilts_in",
                 atol_scale=1e-300)
    assert_close(go if go is not None else torch.zeros_like(tout), go_j, REL, "tilts_out",
                 atol_scale=1e-300)


def test_cap_binds_on_the_same_triangles():
    """The divergence cap clips the same outer-near triangles in both packages."""
    from membrane_solver_tpu.device.tilt_ops import p1_triangle_divergence
    from membrane_solver_tpu.energy import bending_tilt_leaflet as jbt
    from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as tbt
    from membrane_solver_tpu_torch.kernels import tri_kernels

    jp, js, _spec, (ts, topo, params), _own = case("cap")
    div_j, _a, _g = p1_triangle_divergence(js.positions, js.tilts_in, jp.topo.tri_rows,
                                           jp.topo.tri_valid)
    center = jp.topo.extras["energy:bending_tilt_in/update_center"].astype(np.float64)
    capped_j = to_np(jbt._apply_divergence_cap(
        -div_j, *jbt._tri_cap_masks(js.positions, jp.topo, jp.params, center)))
    div_t, _a, _g = tri_kernels.p1_triangle_divergence(ts.positions, ts.tilts_in, topo.tri_rows,
                                                       topo.tri_valid, topo.corner_csr())
    capped_t = to_np(tbt._apply_divergence_cap(-div_t, *tbt.cap_masks(ts.positions, topo,
                                                                      params)))
    nt = topo.tri_rows.shape[0]
    hit_j = capped_j[:nt] != -to_np(div_j)[:nt]
    hit_t = capped_t != -to_np(div_t)
    assert hit_t.sum() > 0
    np.testing.assert_array_equal(hit_t, hit_j)
    assert_close(capped_t, capped_j[:nt], REL, "capped divergence")


def test_radial_cross_term_off_keeps_the_value():
    """radial_cross_term_off_v1: the value of mode off, another tilt gradient, the same shape gradient."""
    from types import SimpleNamespace

    _jp, _js, tspec, (ts, topo, params), _own = case("radial")
    off = dataclasses.replace(tspec, static_options=tuple(
        (k, v) for k, v in tspec.static_options if k != "bending_tilt_in_update_mode"))
    got = [energy_and_grads(SimpleNamespace(spec=s, topo=topo, params=params),
                            "bending_tilt_in", ts, port=True) for s in (tspec, off)]
    assert abs(got[0][0] - got[1][0]) <= REL * abs(got[1][0])
    assert_close(got[0][1][0], got[1][1][0], REL, "shape gradient")
    assert np.max(np.abs(got[0][1][2] - got[1][1][2])) > 1e-6 * np.max(np.abs(got[1][1][2]))


def test_diagonal_tilt_mass_matches_jax():
    """Under ``diagonal`` the tilt energies are the lumped ones; the Jacobi diagonal is JAX's."""
    from types import SimpleNamespace

    from membrane_solver_tpu.runtime.tilt_relax import jacobi_preconditioner as jjacobi
    from membrane_solver_tpu_torch.runtime.tilt_relax import jacobi_preconditioner as tjacobi

    jp, js, tspec, (ts, topo, params), _own = case("diagonal")
    assert dict(tspec.static_options)["tilt_mass_mode"] == "diagonal"
    port = SimpleNamespace(spec=tspec, topo=topo, params=params)
    lumped = SimpleNamespace(spec=dataclasses.replace(tspec, static_options=()), topo=topo,
                             params=params)
    for name in ("tilt_in", "tilt_out"):
        e_j, g_j = energy_and_grads(jp, name, js, port=False)
        e_t, g_t = energy_and_grads(port, name, ts, port=True)
        e_l, _g = energy_and_grads(lumped, name, ts, port=True)
        assert abs(e_t - e_j) <= REL * abs(e_j) and e_t == e_l
        for f, gw, gt in zip(("positions", "tilts", "tilts_in", "tilts_out"), g_j, g_t):
            assert_close(gt, gw, REL, f"{name} {f}", atol_scale=1e-300)
    nv = jp.n_vertices
    for want, got in zip(jjacobi(js.positions, jp.topo, jp.params),
                         tjacobi(ts.positions, topo, params)):
        assert_close(got, np.asarray(want)[:nv], REL, "Jacobi diagonal")


@pytest.mark.parametrize("gp,fused", [
    ({"bending_tilt_in_update_mode": "outer_near_divergence_cap_v1", **BANDS}, False),
    ({"bending_tilt_in_update_mode": "radial_cross_term_off_v1"}, False),
    ({"tilt_mass_mode": "diagonal"}, False),
    ({"tilt_mass_mode_out": "diagonal"}, False),
    ({"bending_tilt_assume_J0_presets_in": ["disk"],
      "bending_tilt_base_term_region_mode": "physical_disk_split_v1", **REGION}, True),
], ids=["cap", "radial", "diagonal", "diagonal_out", "zeroed_rows"])
def test_frozen_tilt_kernel_gate(gp, fused):
    """The float32 relax's fused frozen-tilt energy: none under the modes JAX's gate sends aside.

    Under the zero masks it is built, and its payload's base columns (inner
    2:5, outer 8:11) are 0 on every corner of a masked row and match the
    frozen splits' own base terms.
    """
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu_torch.runtime import tilt_relax

    tp = tpkg.Minimizer(_mesh(tpkg, gp), quiet=True, device="cpu",
                        dtype=torch.float32).problem()
    e_pre, e_fns, _c_pre, _c_fns, e_names = tilt_relax.collect_frozen_tilt_program(tp.spec)
    e_frozen = [pre(tp.state, tp.topo, tp.params) for pre in e_pre]
    out = tilt_relax.build_fused_tilt_energy(tp.spec, e_names, e_fns, e_frozen, tp.topo,
                                             tp.params, torch.float32)
    assert (out is not None) == fused
    if out is None:
        return
    payload = out[0].payload
    rows = tp.topo.tri_rows
    fr = dict(zip(e_names, e_frozen))
    for key, cols, module in (("energy:bending_tilt_in/assume_J0", slice(2, 5), "bending_tilt_in"),
                              ("energy:bending_tilt_out/region_zero", slice(8, 11),
                               "bending_tilt_out")):
        masked = tp.topo.extras[key][rows]
        assert masked.any()
        assert float(torch.max(torch.abs(payload[:, cols][masked]))) == 0.0
        assert float(torch.max(torch.abs(payload[:, cols][~masked]))) > 0.0
        assert torch.equal(payload[:, cols], fr[module]["base_c"])


@pytest.mark.parametrize("gp,match", [
    ({"bending_tilt_in_update_mode": "bogus"}, "bending_tilt_in_update_mode must be"),
    ({"bending_tilt_base_term_region_mode": "bogus", **REGION},
     "bending_tilt_base_term_region_mode must be"),
    ({"bending_tilt_base_term_region_mode": "physical_disk_split_v1"},
     "bending_tilt_base_term_region_radius is required"),
], ids=["update_mode", "region_mode", "region_radius"])
def test_bad_values_raise_the_jax_value_error(gp, match):
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    texts = []
    for pkg, kw in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            pkg.Minimizer(_mesh(pkg, gp), quiet=True, **kw).compute_energy()
        texts.append(str(err.value))
    assert texts[0] == texts[1]
