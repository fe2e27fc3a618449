"""Per-group sums of the pin constraints' fit and slide groups, in a fixed order.

``pin_to_plane`` and ``pin_to_circle`` fit a plane or a circle to each group
of pinned vertices from the group's current positions: counts, centroids,
scatter matrices and the circle's normal equations are sums over the
group's members.  The JAX package adds them with ``.at[group].add`` (entry
order on the CPU); here they go through ``vertex_sum.row_sum`` over a slot
CSR built once per topology, in the same order, on the card and on the CPU
(no float atomics).
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device.state import kept_slot_csr
from membrane_solver_tpu_torch.kernels import vertex_sum


def group_sums(values, topo, key: str, group, keep, n_groups: int):
    """(G, m) sums of the (K, m) entry ``values`` over each entry's group, ``keep`` entries only.

    The m columns are padded to whole 3-vectors, and each (entry, 3-vector)
    pair is one slot of a CSR over G x ceil(m / 3) rows, kept with ``topo``
    under ``key`` (``group`` and ``keep`` must be fixed per topology): one
    launch of the vertex-sum kernel per call.
    """
    k, m = values.shape
    blocks = -(-m // 3)
    padded = torch.cat([values, values.new_zeros((k, 3 * blocks - m))], dim=1)
    col = torch.arange(blocks, device=group.device)
    rows = group[:, None] * blocks + col[None, :]
    csr = kept_slot_csr(topo, key, rows, n_groups * blocks, keep=keep[:, None].expand(k, blocks))
    out = vertex_sum.row_sum(padded.reshape(k * blocks, 3), csr)
    return out.reshape(n_groups, 3 * blocks)[:, :m]
