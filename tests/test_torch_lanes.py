"""Each meshgen builder's own recipe through both command layers, on the CPU at float64.

The command context is the one ``cli.main`` builds (gradient descent, the
mesh's step size, tol 1e-6), in each package, from the builder's dict at
its default size; every command of the builder's ``instructions`` runs
through ``execute_command_line``, as ``tests/test_torch_cli.py`` runs the
cube's recipe.

- ``dented_cube``, ``sphere``, ``two_disks_sphere``, ``torus``,
  ``flat_disk``, ``square_sheet``, ``square_to_circle`` and
  ``rect_tilt_source`` (the single-field tilt lane, nested solve with 60
  inner CG steps; its float64 run keeps JAX's accept decisions through
  ``g5``): every command's energy within rel 1e-12 of the JAX package's,
  with equal vertex and facet counts.
- ``catenoid`` and ``spherical_cap`` amplify round-off (ROADMAP C3), so
  their recipes run with every ``gN`` expanded into N ``g1`` commands and
  are compared step for step up to their first Armijo flip (the first
  command after which the step sizes differ): there, each energy within
  rel max(1e-12, 2 s_k), and the final energies within rel 2 s_final, where
  s_k is the largest relative spread of the JAX package's own energy after
  command k under one-ulp noise on every free vertex (four seeds;
  ``tools/lane_noise_spread.py``, recorded in
  ``tests/fixtures/torch_port/lane_noise_spread.json``).  Counts are equal
  at every command.
"""

from __future__ import annotations

import json

import pytest

import _torch_port_harness  # noqa: F401  (its torch thread count for the xdist workers)
from _torch_port_harness import recipe_trace

RTOL = 1e-12
SPREAD = json.loads((_torch_port_harness.FIXTURE.parent / "lane_noise_spread.json").read_text())


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", ["dented_cube", "sphere", "two_disks_sphere", "torus",
                                  "flat_disk", "square_sheet", "square_to_circle",
                                  "rect_tilt_source"])
def test_recipe_matches_jax(name):
    got, want = recipe_trace(True, name), recipe_trace(False, name)
    assert [g[0] for g in got] == [w[0] for w in want] and got
    for g, w in zip(got, want, strict=True):
        assert g[2:4] == w[2:4], g[0]
        assert _rel(g[1], w[1]) <= RTOL, (g[0], g[1], w[1])


@pytest.mark.parametrize("name", ["catenoid", "spherical_cap"])
def test_sensitive_recipe_matches_jax_up_to_its_first_flip(name):
    got, want = recipe_trace(True, name, expand=True), recipe_trace(False, name, expand=True)
    spread = SPREAD[name]
    assert [w[0] for w in want] == spread["commands"]
    flip = next((k for k, (g, w) in enumerate(zip(got, want)) if g[4] != w[4]), len(want))
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g[2:4] == w[2:4], k
        if k < flip:
            assert _rel(g[1], w[1]) <= max(RTOL, 2 * spread["spread"][k]), (k, g, w)
    assert _rel(got[-1][1], want[-1][1]) <= 2 * spread["final_spread"]
