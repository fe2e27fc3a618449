"""A sweep member is its one-member sweep's bits, at any member count (``parallel``).

Member m of a B-member sweep must not feel the other members: every sum
and product on its path adds in an order that does not depend on B
(``parallel/member_block.member_dot``; ``device/reduce``: ``tree_sum``,
``member_sum``, ``per_member``, ``each_member``).  PyTorch
picks a batched reduction's or product's order by the batch's shape, on
the card at any size and on the CPU once a reduction is large enough to
be split over threads.

Held here, with ``torch.equal`` on every field and every stat and flag:
member m of sweeps at B = 1, 3 and 8 against a one-member sweep of member
m, on the kozlov lane (L0, seeded heights and tilts; its theta_B contact
ring, its pins, enforced in every trial), the kozlov lane with the rim's
circle fitted and the disk sliding (the pins' per-group solve), the
Helfrich vesicle (L1, the volume's sums, enforced in every trial), the
square_to_circle sheet (the hard area's and the line tension's sums) and
rect_tilt_source (20 x 8, the tilt-decay scan).  Then the member block's
norm and dot and the per-member helpers on batches of 37,500 and 40,000
entries a member, where the CPU's batched reductions split.  The card's
own check is every sweep phase of ``chip_smoke.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.func import vmap

from membrane_solver_tpu_torch.device.reduce import each_member, member_sum, per_member
from membrane_solver_tpu_torch.parallel import member_block
from tests._torch_port_harness import (
    make_minimizer,
    make_vesicle_minimizer,
    recipe_context,
    seed_host,
)

SEED = 5
STEPS = 2
STEP_SIZE = 1e-3
SIZES = (1, 3, 8)
ENFORCE = {"enforce_in_line_search": True}
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
FIT = {"definition_options": {"rim": {"pin_to_circle_mode": "fit"},
                              "disk": {"pin_to_plane_mode": "slide"}}}
# per lane: the scanned parameters (times 1 + scale m, or plus shift m), the dilation, options
SCANS = {
    "kozlov": ({"tilt_modulus_in": ("scale", 0.1), "tilt_thetaB_value": ("shift", 0.01)},
               0.01, ENFORCE),
    "kozlov_fit": ({"tilt_modulus_in": ("scale", 0.1), "tilt_thetaB_value": ("shift", 0.01)},
                   0.01, ENFORCE),
    "vesicle": ({"bending_modulus": ("scale", 0.1), "intrinsic_curvature": ("shift", 0.1)},
                0.001, ENFORCE),
    "square": ({"target_surface_area": ("scale", 0.01)}, 0.001, ENFORCE),
    "rect": ({"tilt_modulus": ("scale", 0.1), "tilt_smoothness_rigidity": ("scale", 0.1)},
             0.001, {}),
}


def _problem(lane: str):
    if lane in ("kozlov", "kozlov_fit"):
        mn = make_minimizer(True, edits=FIT if lane == "kozlov_fit" else None,
                            dtype=torch.float64)
        seed_host(mn, SEED)
    elif lane == "vesicle":
        mn = make_vesicle_minimizer(True, 1, dtype=torch.float64)
        seed_host(mn, SEED)
    else:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build

        if lane == "square":
            data = build("square_to_circle", n=6)
            mn = pkg.Minimizer(pkg.parse_geometry(json.loads(json.dumps(data))), quiet=True,
                               device="cpu", dtype=torch.float64)
        else:
            ctx, run, recipe = recipe_context(True, "rect_tilt_source",
                                              gp={"tilt_smoothness_rigidity": 1.0}, nx=20, ny=8)
            for cmd in recipe:
                run(ctx, cmd)
            ctx.sync_mesh()
            mn = ctx.minimizer
    return mn.problem()


@pytest.fixture(scope="module")
def lanes():
    cache = {}

    def get(lane):
        if lane not in cache:
            cache[lane] = _problem(lane)
        return cache[lane]

    return get


def sweep(problem, lane: str, members):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    scan, dilation, options = SCANS[lane]
    base = {k: float(problem.params[k]) for k in scan}
    params = [{k: base[k] * (1.0 + s * m) if rule == "scale" else base[k] + s * m
               for k, (rule, s) in scan.items()} for m in members]
    positions = [problem.state.positions.numpy() * (1.0 + dilation * m) for m in members]
    return run_sweep(problem, params, STEPS, step_size=STEP_SIZE,
                     options=MinimizeOptions(**options), member_positions=positions)


@pytest.fixture(scope="module")
def singles(lanes):
    cache = {}

    def get(lane, m):
        if (lane, m) not in cache:
            cache[(lane, m)] = sweep(lanes(lane), lane, [m])
        return cache[(lane, m)]

    return get


def assert_member_bits(got, m: int, one, what: str) -> None:
    """Member ``m`` of ``got`` is member 0 of ``one`` in bits: every state field, every stat."""
    (g_states, _g_ss, g_stats), (o_states, _o_ss, o_stats) = got, one
    for f in FIELDS:
        assert torch.equal(getattr(g_states, f)[m], getattr(o_states, f)[0]), f"{what}: {f}"
    for f in type(g_stats).__dataclass_fields__:
        g, o = np.asarray(getattr(g_stats, f))[m], np.asarray(getattr(o_stats, f))[0]
        assert np.asarray(g).tobytes() == np.asarray(o).tobytes(), f"{what}: {f} {g!r} vs {o!r}"


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("lane", list(SCANS))
def test_member_is_its_one_member_sweep(lanes, singles, lane, B):
    problem = lanes(lane)
    got = sweep(problem, lane, range(B))
    assert np.asarray(got[2].iterations).tolist() == [STEPS] * B
    for m in range(B):
        assert_member_bits(got, m, singles(lane, m), f"{lane} B={B} member {m}")
    if B > 1:  # the members differ, so each one's bits are its own
        assert len({np.asarray(got[2].energy)[m].tobytes() for m in range(B)}) == B


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_member_norm_and_dot_do_not_feel_the_batch(dtype):
    """The block's gradient norm and Armijo slope on (B, 3N) rows of 37,500 entries: member m
    at B = 1, 3, 8 in bits, and within round-off of PyTorch's own norm and dot."""
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(8, 12500, 3, generator=gen, dtype=torch.float64).to(dtype)
    b = torch.randn(8, 12500, 3, generator=gen, dtype=torch.float64).to(dtype)
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    norm = torch.cat([member_block.member_norm(a[m:m + 1]) for m in range(8)])
    dot = torch.cat([member_block.member_dot(a[m:m + 1], b[m:m + 1]) for m in range(8)])
    for B in SIZES:
        assert torch.equal(member_block.member_norm(a[:B]), norm[:B]), B
        assert torch.equal(member_block.member_dot(a[:B], b[:B]), dot[:B]), B
    for got, want in ((norm, torch.linalg.vector_norm(a.reshape(8, -1), dim=1)),
                      (dot, torch.sum(a * b, dim=(1, 2)))):
        assert torch.all(torch.abs(got - want) <= rel * torch.abs(want))


def test_each_member_is_one_call_per_member():
    """BFGS's products per member: the same bits as the product on the member alone."""
    gen = torch.Generator().manual_seed(9)
    V = torch.randn(5, 33, 33, generator=gen, dtype=torch.float64)
    H = torch.randn(5, 33, 33, generator=gen, dtype=torch.float64)
    g = torch.randn(5, 33, generator=gen, dtype=torch.float64)
    out = each_member(torch.mv, V, g)
    for m in range(5):
        assert torch.equal(out[m], torch.mv(V[m].clone(), g[m].clone()))
        assert torch.equal(each_member(torch.mv, V[m:m + 1], g[m:m + 1])[0], out[m])
    prod = each_member(member_block._congruence, V, H)
    assert torch.equal(prod[3], each_member(member_block._congruence, V[3:4],
                                                         H[3:4])[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_member_sum_and_per_member_are_their_single_calls(dtype):
    """Under ``vmap`` at B = 8 and 40,000 entries a member: ``member_sum`` (whole and along an
    axis, with its gradient) and ``per_member`` (a solve) give each member its single call's
    bits; outside a map they are the single call itself."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(8, 20000, 2, generator=gen, dtype=torch.float64).to(dtype)
    x.requires_grad_(True)
    whole = vmap(lambda y: member_sum(y * y))(x)
    along = vmap(lambda y: member_sum(y, 0))(x)
    (grad_whole,) = torch.autograd.grad(whole.sum(), (x,), retain_graph=True)
    (grad_along,) = torch.autograd.grad(along.sum(), (x,))
    assert torch.equal(grad_whole, 2 * x.detach())
    assert torch.equal(grad_along, torch.ones_like(grad_along))
    for m in range(8):
        y = x.detach()[m].clone()
        assert torch.equal(whole[m], torch.sum(y * y))
        assert torch.equal(along[m], torch.sum(y, 0))
        assert torch.equal(member_sum(y * y), torch.sum(y * y))
    A = torch.randn(8, 6, 3, 3, generator=gen, dtype=torch.float64).to(dtype)
    rhs = torch.randn(8, 6, 3, 1, generator=gen, dtype=torch.float64).to(dtype)

    def solve(p, q):
        return torch.linalg.solve_ex(p, q).result

    mapped = vmap(lambda p, q: per_member(solve, p, q))(A, rhs)
    for m in range(8):
        assert torch.equal(mapped[m], solve(A[m].clone(), rhs[m].clone()))
