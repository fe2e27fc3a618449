"""A sweep member's sums are the bits of its own call (``device/reduce.tree_sum``).

Under ``torch.func.vmap`` a whole-array ``torch.sum`` of one member becomes
a reduction over an inner axis of the (B, ...) batch, whose order PyTorch
picks from the shapes: on the card eleven of phase 41's items came out a
few ulp off their single calls (nine energies, and the inner-leaflet
gradients of ``tilt_disk_contact_in`` and the ``rim_slope_match_out``
energy, which read the ring's summed weights).  The member path now adds
every such sum in a fixed halving tree of elementwise additions.

Here on the CPU: ``tree_sum`` under ``vmap`` against its single calls in
bits (at 70,000 entries too, where the CPU's batched ``torch.sum`` may
split the work otherwise) and against ``torch.sum`` to round-off; and each
of the eleven items on phase 41's set-ups (``chip_smoke.sweep_tilt_setup``)
on kozlov L1 with four seeded members (``chip_smoke.tilt_items``): member m
of the map equal in bits to member m's single call.  The card's own check
is phase 41 of ``chip_smoke.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.func import vmap

from membrane_solver_tpu_torch.device.reduce import tree_sum
from tests._torch_port_harness import make_minimizer

ITEMS = [
    ("match", "energy/tilt"),
    ("drives", "energy/tilt_coupling"),
    ("drives", "energy/tilt_splay_twist_in"),
    ("drives", "energy/tilt_smoothness_in"),
    ("drives", "energy/tilt_smoothness_out"),
    ("drives", "energy/tilt_smoothness_leaflet"),
    ("drives", "energy/tilt_disk_target_out"),
    ("drives", "energy/tilt_disk_contact_in"),
    ("match", "energy/bending_tilt"),
    ("drives", "energy/tilt_disk_contact_in/tilts_in"),
    ("match", "energy/rim_slope_match_out/tilts_in"),
]


@pytest.mark.parametrize("shape,dim", [((1,), None), ((5,), None), ((1000, 3), None),
                                       ((70_000,), None), ((70_000, 3, 3), 0), ((9, 70_001), 1)])
def test_tree_sum_maps_per_member_bit_for_bit(shape, dim):
    rng = np.random.default_rng(len(shape) + shape[0])
    x = torch.as_tensor(rng.standard_normal((4,) + shape) * 10.0 ** rng.integers(-6, 6, (4,) + shape))
    got = vmap(lambda a: tree_sum(a, dim))(x)
    for m in range(4):
        one = tree_sum(x[m], dim)
        assert torch.equal(got[m], one)
        ref = torch.sum(x[m]) if dim is None else torch.sum(x[m], dim=dim)
        scale = torch.sum(torch.abs(x[m])) if dim is None else torch.sum(torch.abs(x[m]), dim=dim)
        assert bool(torch.all(torch.abs(one - ref) <= 1e-13 * scale))


def test_tree_sum_gradient_is_the_sums():
    x = torch.linspace(-1.0, 2.0, 37, dtype=torch.float64).reshape(37, 1).repeat(1, 3)
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(tree_sum(x * x), (x,))
    assert torch.equal(g, 2.0 * x.detach())
    assert tree_sum(torch.zeros(0, 3), 0).shape == (3,)


@pytest.fixture(scope="module")
def items():
    """Phase 41's items on kozlov L1, per set-up: the vmapped and the single evaluations."""
    import chip_smoke
    from chip_smoke import TILT_FIELDS, sweep_tilt_setup, tilt_items, tilt_member_inputs
    from membrane_solver_tpu_torch import Minimizer

    with open("tests/fixtures/torch_port/kozlov_L3_sweep_tilt_drives_f64_jax.json") as fh:
        protocol = json.load(fh)["protocol"]
    out = {}
    saved, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        for setup in ("drives", "match"):
            mesh = make_minimizer(True, refines=1, dtype=torch.float64).mesh
            sweep_tilt_setup(mesh, protocol, setup)
            p = Minimizer(mesh, device="cpu", dtype=torch.float64, quiet=True).problem()
            base = {f: getattr(p.state, f).numpy().astype(np.float64) for f in TILT_FIELDS}
            out[setup] = tilt_items(torch, p, protocol, setup, tilt_member_inputs(protocol, base))
    finally:
        chip_smoke.DEVICE = saved
    return out


@pytest.mark.parametrize("setup,item", ITEMS, ids=[i for _s, i in ITEMS])
def test_item_members_equal_their_single_calls(items, setup, item):
    got = items[setup]["vmapped"][item]
    singles = items[setup]["single"][item]
    assert np.max(np.abs(got)) > 0.0
    for m, one in enumerate(singles):
        assert np.array_equal(got[m], one), f"member {m}: {np.max(np.abs(got[m] - one)):.3e}"
