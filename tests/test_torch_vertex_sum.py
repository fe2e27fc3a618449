"""The corner CSR and the deterministic vertex sum against the ``index_add`` route.

``device/state.corner_csr`` lists, for each vertex row, the corner slots
(``tri * 3 + corner``) that touch it, in triangle order; the vertex-sum
kernel and its twin (``kernels/vertex_sum``) add corner rows into vertex
rows in that order.  Here, on the CPU: every slot appears exactly once,
under its own vertex; the twin equals the ``index_add`` scatter of
``geo.scatter_add_rows`` (exactly on integer-valued rows, to round-off
otherwise) and adds in slot order bit for bit; its weighted form equals the
plain sum of pre-scaled rows bit for bit; the topology keeps its CSR; the
launcher refuses CPU tensors.  On a card only, the kernel against the
twin, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, make_minimizer

from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import vertex_sum as vs


def _rows(T=301, nv=160, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    return torch.as_tensor(rows), nv


def _index_add(values, rows, nv):
    return tgeo.scatter_add_rows(values[:, 0], values[:, 1], values[:, 2], rows, nv)


@pytest.fixture(scope="module", params=["random", "kozlov_L1"])
def topology(request):
    if request.param == "random":
        return _rows()
    p = make_minimizer(True, kw=SMALL, refines=1).problem()
    return p.topo.tri_rows, p.n_vertices


def test_csr_holds_every_corner_slot_once_under_its_vertex(topology):
    rows, nv = topology
    csr = corner_csr(rows, nv)
    offsets, slots = csr.offsets.long(), csr.slots.long()
    assert csr.offsets.dtype == csr.slots.dtype == torch.int32
    assert torch.equal(torch.sort(slots).values, torch.arange(3 * rows.shape[0]))
    flat = rows.reshape(-1)
    degree = offsets[1:] - offsets[:-1]
    assert torch.equal(degree, torch.bincount(flat, minlength=nv))
    assert csr.max_degree == int(degree.max()) and int(offsets[-1]) == flat.numel()
    owner = torch.repeat_interleave(torch.arange(nv), degree)
    assert torch.equal(flat[slots], owner)
    # within each vertex, the slots run in triangle order
    same = owner[1:] == owner[:-1]
    assert bool(torch.all(slots[1:][same] > slots[:-1][same]))


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_equals_index_add(topology, width, dtype):
    rows, nv = topology
    csr = corner_csr(rows, nv)
    rng = np.random.default_rng(11)
    shape = (rows.shape[0], 3) + ((3,) if width == 3 else ())
    # integer values: every order of addition gives the same sum
    ints = torch.as_tensor(rng.integers(-50, 50, size=shape), dtype=dtype)
    assert torch.equal(vs.reference(ints, csr), _index_add(ints, rows, nv))
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    got, want = vs.reference(vals, csr), _index_add(vals, rows, nv)
    assert got.shape == want.shape == (nv,) + shape[2:]
    rtol = 1e-12 if dtype == torch.float64 else 2e-6
    assert float(torch.max(torch.abs(got - want))) <= rtol * float(torch.max(torch.abs(want)))


def test_reference_adds_in_slot_order_bit_for_bit(topology):
    rows, nv = topology
    csr = corner_csr(rows, nv)
    vals = torch.as_tensor(np.random.default_rng(13).standard_normal((rows.shape[0], 3, 3)),
                           dtype=torch.float32)
    flat = vals.reshape(-1, 3)
    want = torch.zeros((nv, 3), dtype=torch.float32)
    offsets, slots = csr.offsets.tolist(), csr.slots.tolist()
    for v in range(nv):
        acc = torch.zeros(3, dtype=torch.float32)
        for s in slots[offsets[v]:offsets[v + 1]]:
            acc = acc + flat[s]
        want[v] = acc
    assert torch.equal(vs.reference(vals, csr), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weighted_reference_equals_sum_of_prescaled_rows(topology, width, dtype, masked):
    """The weighted twin (the divergence backward's) is the plain sum of w_t * row, bit for bit."""
    rows, nv = topology
    csr = corner_csr(rows, nv)
    rng = np.random.default_rng(17)
    T = rows.shape[0]
    shape = (T, 3) + ((3,) if width == 3 else ())
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    weight = torch.as_tensor(rng.standard_normal(T), dtype=dtype)
    if masked:
        weight = torch.where(torch.as_tensor(rng.random(T) < 0.8), weight, 0.0)
    scaled = weight.reshape((T,) + (1,) * (len(shape) - 1)) * vals
    assert torch.equal(vs.reference(vals, csr, weight=weight), vs.reference(scaled, csr))


def test_topology_keeps_its_csr_and_rebuilds_for_new_rows():
    topo = make_minimizer(True, kw=SMALL).problem().topo
    csr = topo.corner_csr()
    assert topo.corner_csr() is csr
    assert csr.n_rows == topo.vertex_valid.shape[0]
    flipped = dataclasses.replace(topo, tri_rows=topo.tri_rows.flip(0).contiguous())
    other = flipped.corner_csr()
    assert other is not csr and torch.equal(other.offsets, csr.offsets)
    assert not torch.equal(other.slots, csr.slots)


def test_csr_rejects_rows_outside_the_vertex_range():
    rows, nv = _rows(T=10, nv=12)
    with pytest.raises(ValueError, match="outside"):
        corner_csr(rows, int(rows.max()))
    with pytest.raises(ValueError, match="outside"):
        corner_csr(rows - 1 - int(rows.min()), nv)


def test_launch_refuses_cpu_tensors_and_the_build_is_keyed_by_the_header():
    rows, nv = _rows(T=4, nv=6)
    with pytest.raises(ValueError, match="CUDA"):
        vs.launch(torch.zeros(4, 3, 3), corner_csr(rows, nv))
    flags = " ".join(vs.KERNEL.flags)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert vs.KERNEL.library_path().parent == _build.BUILD_DIR
    assert vs.HEADER.is_file() and 'extern "C" int vertex_sum_rows(' in vs.SOURCE.read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_equals_twin_bit_for_bit(dtype):
    """Card only: the kernel adds in the twin's order, so the sums are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rows, nv = _rows(T=21_504, nv=10_817)
    rows = rows.cuda()
    csr = corner_csr(rows, nv)
    for shape in ((rows.shape[0], 3), (rows.shape[0], 3, 3)):
        vals = torch.randn(shape, dtype=dtype, device="cuda")
        assert torch.equal(vs.launch(vals, csr), vs.reference(vals, csr))
