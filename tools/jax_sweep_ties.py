#!/usr/bin/env python3
"""How far the JAX package's vmapped sweep gradient lies from each member's own, on the CPU.

Refined cube meshes keep exact right angles, where the Meyer mixed area's
gradient jumps (a Meyer branch tie, cotangent 0).  XLA:CPU rounds a batch
of members otherwise than one member and may take the other side of such
a tie.  For each vesicle start below, three or eight members (positions
times 1 + 0.001 m, ``bending_modulus`` times 1 + 0.1 m), this prints the
count of triangle cotangents below 1e-12 in absolute value and the largest
deviation of the vmapped projected gradient from each member's own
evaluation (absolute, and over that member's max |g|):

- the vesicle protocol at two triangle refines (194 vertices), as built,
  and with ``tests/_torch_port_harness.seed_host``'s seeded heights (the
  CPU sweep tests' start);
- with ``--l5``, the start of ``helfrich_cube_L5_sweep_f64_jax.json``
  (the vesicle protocol's five refines and five steps, ~1 minute).

Usage::

    python tools/jax_sweep_ties.py [--l5]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def deviations(problem, members: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from membrane_solver_tpu.device import geo as jgeo
    from membrane_solver_tpu.parallel.sweep import batch_problem
    from membrane_solver_tpu.runtime import jit_core

    x = np.asarray(problem.state.positions)
    kappa = float(problem.params["bending_modulus"])
    batch = batch_problem(problem, [{"bending_modulus": kappa * (1 + 0.1 * m)}
                                    for m in range(members)],
                          [x * (1 + 0.001 * m) for m in range(members)])
    eg = jit_core.make_energy_and_grad(problem.spec)
    _E, g = jax.vmap(eg, in_axes=(0, None, 0))(batch.states, problem.topo, batch.params)
    absolute, relative = [], []
    for m in range(members):
        st = jax.tree_util.tree_map(lambda a, m=m: a[m], batch.states)
        _e, g1 = eg(st, problem.topo, {k: v[m] for k, v in batch.params.items()})
        err = float(jnp.max(jnp.abs(g[m] - g1)))
        absolute.append(err)
        relative.append(err / float(jnp.max(jnp.abs(g1))))
    curv = jgeo.curvature_data(jnp.asarray(x), problem.topo.tri_rows, problem.topo.tri_valid,
                               x.shape[0])
    cot = np.abs(np.asarray(curv.weights)[np.asarray(problem.topo.tri_valid)])
    return {"members": members, "cotangents_below_1e-12": int(np.sum(cot < 1e-12)),
            "max_abs_dev": max(absolute), "max_rel_dev": max(relative)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--l5", action="store_true", help="also the L5 sweep fixture's start")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import record_torch_port_fixture as rec

    pkg, build, refinement = rec._jax()
    from tests._torch_port_harness import seed_host

    out = {}
    for label, seeded in (("L2", False), ("L2 seeded", True)):
        mn = rec.build_vesicle(pkg, build, refinement, rec.vesicle_protocol(refines=2))
        if seeded:
            seed_host(mn, 5)
        out[label] = deviations(mn.problem(), 3)
    if args.l5:
        protocol = rec.vesicle_sweep_protocol()
        mn = rec.build_vesicle(pkg, build, refinement, protocol["vesicle"])
        for _ in range(protocol["vesicle"]["steps"]):
            mn.minimize(1)
        for key, value in protocol["global_parameters"].items():
            mn.global_params.set(key, value)
        out["L5 sweep start"] = deviations(mn.problem(), protocol["members"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
