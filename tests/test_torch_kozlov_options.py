"""The kozlov lane's solver options: the port against the JAX package, float64.

On meshgen ``kozlov_1disk`` (L0, 177 vertices), with the JAX package's own
option-test parameters (``tests/test_gp_option_parity.py``: coupled solve,
6 inner CG steps, tol 1e-12, fixed step 0.005), both packages run each
option of the port's static-option set on the same inputs:

- one leaflet relax (6 iterations, step 0.15) from seeded positions and
  tilts (``_torch_port_harness.perturbed_pair``): tilts and the relax's
  energies within rel 1e-10;
- ``minimize(2)`` from the lane's start, the options in three groups (each
  JAX group traces its own minimize block, ~20 s; two are in
  ``tests/test_torch_kozlov_reduced.py``, the ring-average one in
  ``tests/test_torch_rim_modes.py``);
- the card lane's protocol (``kozlov_L3_reduced``) at L0, in
  ``tests/test_torch_kozlov_reduced_lane.py``.

Also: the JAX package's ValueError texts for bad values, and the energy and
projected gradient of the per-module modes that raised until they were
ported.
``decrease_only`` against ``armijo`` and the CG's GD retry are in
``tests/test_torch_kozlov_reduced.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import (
    ABLATION,
    BANDS,
    OPTION_GP,
    assert_close,
    assert_energy_and_gradient_match,
    make_minimizer,
    option_minimizers,
    perturbed_pair,
    port_from_jax,
    seed_host,
)

from membrane_solver_tpu.device.state import build_params as jbuild_params
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

ITERS, STEP, TOL = 6, 0.15, 1e-12
REL = 1e-10
# every option of the port's static-option set, one relax each
OPTIONS = {
    "default": {},
    "preconditioner_none": {"tilt_cg_preconditioner": "none"},
    "rejection_fallback_gd": {"tilt_cg_rejection_fallback": "gd"},
    "cadence_per_pass": {"tilt_projection_cadence": "per_pass"},
    "per_step_interval_2": {"tilt_projection_interval": 2},
    "inner_coupled": {"inner_coupled_update_mode": "rim_matched_radial_continuation_v1",
                      **BANDS},
    "ablation": ABLATION,
    "axisym": {"tilt_axisymmetric_about_thetaB_center": True},
    "ring_average": {"rim_slope_match_mode": "ring_average_radial_v1"},
    "staggered": {"rim_slope_match_mode": "shared_rim_staggered_v1"},
    "reference_exact": {"rim_slope_match_kkt_rows": "reference_exact"},
    "gd_solver": {"tilt_solver": "gd", "tilt_projection_cadence": "per_pass"},
}


# options that change this relax's result (the others act where this
# relax does not reach: a rejected CG direction, the shape projection, or a
# refresh that is the identity on this constraint-consistent lane)
EFFECTIVE = ("preconditioner_none", "inner_coupled", "ablation", "axisym", "ring_average",
             "staggered", "gd_solver")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_relax_matches_jax(name):
    jm, tm = option_minimizers(OPTIONS[name])
    jp, tspec = jm.problem(), tm.problem().spec
    js, ts = perturbed_pair(jp, seed=17)
    jparams = jbuild_params(jm.mesh)
    jout, jstats = jrelax.make_relax_leaflet_tilts(jp.spec)(
        js, jp.topo, jparams, jnp.asarray(ITERS, jnp.int32), jnp.asarray(STEP, jnp.float64),
        jnp.asarray(TOL, jnp.float64))
    _s, topo, params = port_from_jax(jp)
    tout, tstats = trelax.make_relax_leaflet_tilts(tspec)(ts, topo, params, ITERS, STEP, TOL)
    nv = jp.n_vertices
    assert tstats.accepted_steps == int(jstats.accepted_steps)
    assert tstats.rejected == bool(jstats.rejected)
    for f in ("tilts_in", "tilts_out"):
        assert_close(getattr(tout, f), np.asarray(getattr(jout, f))[:nv], REL, f, atol_scale=1.0)
    for f in ("initial_energy", "final_energy"):
        want = float(getattr(jstats, f))
        assert getattr(tstats, f) == pytest.approx(want, rel=REL, abs=1e-14), f
    if name in EFFECTIVE:
        plain = make_minimizer(True, gp=OPTION_GP, dtype=torch.float64).problem().spec
        base, _stats = trelax.make_relax_leaflet_tilts(plain)(ts, topo, params, ITERS, STEP, TOL)
        assert not torch.equal(tout.tilts_in, base.tilts_in), f"{name} had no effect"


# (option, bad value, where the JAX package raises, its message's pattern)
BAD_VALUES = [
    ("tilt_projection_cadence", "bogus", "relax", "per_step.*per_pass"),
    ("inner_coupled_update_mode", "bogus", "compile", "inner_coupled_update_mode must be"),
    ("curved_theta_objective_ablation_mode", "bogus", "energy",
     "curved_theta_objective_ablation_mode must be"),
    ("rim_slope_match_mode", "bogus", "compile", "rim_slope_match_mode must be"),
    ("line_search_reduced_accept_rule", "bogus", "minimize", "accept rule"),
]


def _raise_at(mn, where: str, port: bool):
    if where == "compile":
        mn.problem()
    elif where == "relax":
        relax = trelax if port else jrelax
        relax.make_relax_leaflet_tilts(mn.problem().spec)
    elif where == "energy":
        mn.compute_energy()
    else:
        mn.minimize(1)


@pytest.mark.parametrize("key,value,where,match", BAD_VALUES, ids=[b[0] for b in BAD_VALUES])
def test_bad_values_raise_the_jax_value_error(key, value, where, match):
    gp = {key: value}
    if key == "line_search_reduced_accept_rule":
        gp["line_search_reduced_energy"] = "on"
    for port in (False, True):
        full = {**OPTION_GP, **gp}
        mn = make_minimizer(port, gp=full, **({"dtype": torch.float64} if port else {}))
        with pytest.raises(ValueError, match=match):
            _raise_at(mn, where, port)


# values that raised NotImplementedError until they were ported (the first
# key names the case)
NOT_PORTED = [
    {"tilt_thetaB_contact_penalty_mode": "legacy"},
    {"tilt_mass_mode": "diagonal"},  # the JAX package runs it as lumped
    {"pin_to_plane_mode": "fit"},
    {"bending_tilt_in_update_mode": "outer_near_divergence_cap_v1", **BANDS},
    {"bending_tilt_base_term_region_mode": "physical_disk_split_v1",
     "bending_tilt_base_term_region_radius": 1.0},
]


@pytest.mark.parametrize("gp", NOT_PORTED, ids=[next(iter(g)) for g in NOT_PORTED])
def test_unported_values_raise_not_implemented(gp):
    """The value now runs: energy and projected gradient on a seeded state as the JAX package's."""
    jm, tm = option_minimizers(gp)
    for mn in (jm, tm):
        seed_host(mn, 8)
    assert_energy_and_gradient_match(jm, tm, 1e-12, next(iter(gp)))
