"""The card phase ``kozlov_L3_match_drives`` at L0: the port against the JAX package, float64.

The protocol of ``tests/fixtures/torch_port/kozlov_L3_match_drives_f64_jax.json``
(``chip_smoke.match_drives_setup``: the local-interface penalty, the soft rim
matching with the disk group, the single-field bending-tilt and the legacy
stub; the rim-ring leaflet match, the rim/outer vector match, the curved
interface match, each in its modes; the rigid disk's double fit) on meshgen
``kozlov_1disk`` without its refinements.  The recorder's JAX run
(``match_drives_run``) and the port's (``chip_smoke.port_match_record``, the
phase's own code) on the same inputs: energies, gradients, tilt rows and
enforcements within 1e-12 (``chip_smoke.match_deviations``: relative to
each array's largest entry).  The fixture's ``protocol`` block must be the
recorder's, so the card and the fixture run one protocol.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from _torch_port_harness import FIXTURE, make_minimizer

from chip_smoke import match_deviations, match_drives_setup, port_match_record
from tools.record_torch_port_fixture import kozlov_match_drives_protocol, match_drives_run

MATCH_FIXTURE = FIXTURE.parent / "kozlov_L3_match_drives_f64_jax.json"
REL = 1e-12


def test_fixture_protocol_is_the_recorders():
    fixture = json.loads(MATCH_FIXTURE.read_text())
    assert fixture["protocol"] == json.loads(json.dumps(kozlov_match_drives_protocol()))
    assert fixture["n_vertices"] == 10817 and fixture["energies"]["mean_curvature_tilt"][
        "energy"] == 0.0


def test_match_drives_match_jax_at_L0():
    protocol = kozlov_match_drives_protocol()
    want = match_drives_run(refines=0)
    mesh = make_minimizer(True).mesh
    match_drives_setup(mesh, protocol)
    got = port_match_record(torch, mesh, protocol, torch.float64, "cpu")
    dev = match_deviations(want, got, np)
    worst = max([v for row in dev["energies"].values() for v in row.values()]
                + [v for row in dev["constraints"].values() for v in row.values()]
                + [dev["rigid_disk"]])
    assert worst <= REL, json.dumps(dev)
    # every drive is live: nonzero energies (but the stub), rows and enforcement changes
    assert all(abs(want["energies"][n]["energy"]) > 1e-6 for n in protocol["energy_modules"]
               if n != "mean_curvature_tilt")
    assert got["energies"]["mean_curvature_tilt"]["energy"] == 0.0
    assert set(got["constraints"]) == set(want["constraints"])
