"""The corner CSR and the deterministic vertex sum against the ``index_add`` route.

``device/state.corner_csr`` lists, for each vertex row, the corner slots
(``tri * 3 + corner``) that touch it, in triangle order; the vertex-sum
kernel and its twin (``kernels/vertex_sum``) add corner rows into vertex
rows in that order.  Here, on the CPU: every slot appears exactly once,
under its own vertex, corner-major; the twin equals an ``index_add``
scatter column by column (the JAX package's scatter order) bit for bit and
adds in slot order bit for bit; its weighted form equals the plain sum of pre-scaled rows bit for
bit; ``geo.scatter_add_rows`` is the twin, and its backward the gather;
``row_sum`` over a ``slot_csr`` sums repeated slot rows and drops the
spare row; ``geo.body_sums`` equals the segment sum, and the card's masked
reduction does within round-off; the topology keeps its corner CSR and
each ``kept_slot_csr``; the launcher refuses CPU tensors; a CSR's launch
check is kept on it per device and slot count.  On a skewed slot CSR whose
rows straddle the kernel's chunks (``chip_smoke.skewed_slot_case``, chunks
of 4, 8, 16 and 32 corners), the twin, plain and weighted, equals a plain
loop that
adds each row's slots left to right from +0.0, in value and sign bits (a
row whose one value is -0.0 sums to +0.0): the order contract the kernel
meets.  On a card only, the kernel against the twin, bit for bit (the
skewed CSR too, weighted and over members), and two calls of
``scatter_add_rows`` (value and gradient) and of ``body_sums`` give the
same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, make_minimizer

from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device.state import (
    check_unique_rows,
    corner_csr,
    kept_slot_csr,
    slot_csr,
)
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import vertex_sum as vs


def _rows(T=301, nv=160, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    return torch.as_tensor(rows), nv


def _index_add(values, rows, nv):
    """The ``index_add`` scatter that the vertex sum replaces, corner column by column."""
    out = values.new_zeros((nv,) + tuple(values.shape[2:]))
    for k in range(3):
        out = out.index_add(0, rows[:, k], values[:, k])
    return out


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
    # within each vertex, corner 0 of every triangle in triangle order, then
    # corner 1, then corner 2: the JAX package's scatter order
    key = (slots % 3) * rows.shape[0] + slots // 3
    same = owner[1:] == owner[:-1]
    assert bool(torch.all(key[1:][same] > key[:-1][same]))


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
    # the CSR's corner-major order is index_add's: the same additions, the same bits
    assert torch.equal(got, want)


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


def test_scatter_add_rows_is_the_twin_and_its_backward_gathers(topology):
    rows, nv = topology
    csr = corner_csr(rows, nv)
    rng = np.random.default_rng(19)
    vals = [torch.as_tensor(rng.standard_normal((rows.shape[0], 3))).requires_grad_(True)
            for _ in range(3)]
    got = tgeo.scatter_add_rows(*vals, csr)
    assert torch.equal(got.detach(), vs.reference(torch.stack(vals, dim=1).detach(), csr))
    up = torch.as_tensor(rng.standard_normal((nv, 3)))
    grads = torch.autograd.grad(torch.sum(got * up), vals)
    for k, g in enumerate(grads):
        assert torch.equal(g, up[rows[:, k]])


def test_row_sum_adds_repeated_slots_and_drops_the_spare_row():
    rng = np.random.default_rng(23)
    nv, K = 17, 40
    rows = torch.as_tensor(rng.integers(0, nv + 1, size=K))  # nv: the spare row
    vals = torch.as_tensor(rng.standard_normal((K, 3)))
    csr = slot_csr(rows, nv)
    assert csr.n_rows == nv + 1 and csr.slots.shape[0] % 3 == 0
    got = vs.row_sum(vals, csr)
    keep = rows < nv
    want = torch.zeros((nv, 3), dtype=vals.dtype).index_add(0, rows[keep], vals[keep])
    assert got.shape == (nv, 3)
    assert float(torch.max(torch.abs(got - want))) <= 1e-14
    ints = torch.as_tensor(rng.integers(-9, 9, size=K), dtype=torch.float64)
    want = torch.zeros(nv, dtype=torch.float64).index_add(0, rows[keep], ints[keep])
    assert torch.equal(vs.row_sum(ints, csr), want)


def test_kept_slot_csr_is_built_once_per_topology():
    """Built at first use for its key, with the dropped entries aimed at the spare row."""
    topo = make_minimizer(True, kw=SMALL).problem().topo
    nv = topo.vertex_valid.shape[0]
    rows = torch.as_tensor([3, 1, 3, 0, 5])
    keep = torch.as_tensor([True, True, True, False, True])
    csr = kept_slot_csr(topo, "test/rows", rows, nv, keep=keep)
    assert kept_slot_csr(topo, "test/rows", rows.flip(0), nv) is csr
    assert kept_slot_csr(topo, "test/other", rows, nv) is not csr
    vals = torch.as_tensor([[1.0] * 3, [2.0] * 3, [4.0] * 3, [8.0] * 3, [16.0] * 3])
    want = torch.zeros((nv, 3), dtype=vals.dtype).index_add(0, rows[keep], vals[keep])
    assert torch.equal(vs.row_sum(vals, csr), want)


def test_unique_row_check_raises_on_a_repeat():
    check_unique_rows([3, 1, 2], "rows")
    with pytest.raises(ValueError, match="repeats"):
        check_unique_rows([3, 1, 3], "rows")


def test_body_sums_equal_the_segment_sum():
    """``body_sums`` (the segment sum's bits on the CPU) and the card's masked
    reduction, run here on the CPU, against a segment sum: exact on integers,
    the masked reduction within round-off on floats."""
    rng = np.random.default_rng(29)
    T, nb = 200, 3
    tri_body = torch.as_tensor(rng.integers(0, nb + 2, size=T))  # >= nb: no body
    vals = torch.as_tensor(rng.integers(-20, 20, size=T), dtype=torch.float64)
    want = torch.zeros(nb + 2, dtype=torch.float64).index_add(0, tri_body, vals)[:nb]
    assert torch.equal(tgeo.body_sums(vals, tri_body, nb), want)
    assert torch.equal(tgeo.masked_body_sums(vals, tri_body, nb), want)
    for dtype, eps in ((torch.float64, 2.3e-16), (torch.float32, 1.2e-7)):
        vals = torch.as_tensor(rng.standard_normal(T), dtype=dtype)
        x, b = vals.double().numpy(), tri_body.numpy()
        want = np.array([np.sum(x[b == k]) for k in range(nb)])
        got = tgeo.masked_body_sums(vals, tri_body, nb).double().numpy()
        assert np.max(np.abs(got - want)) <= T * eps * np.sum(np.abs(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_scatter_and_body_sums_repeat_bit_for_bit(dtype):
    """Card only: two calls of scatter_add_rows (value and gradient) and body_sums are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rows, nv = _rows(T=21_504, nv=10_817)
    rows = rows.cuda()
    csr = corner_csr(rows, nv)
    gen = torch.Generator(device="cuda").manual_seed(3)
    vals = [torch.randn((rows.shape[0], 3), dtype=dtype, device="cuda", generator=gen)
            for _ in range(3)]
    up = torch.randn((nv, 3), dtype=dtype, device="cuda", generator=gen)
    tri_body = torch.randint(0, 4, (rows.shape[0],), device="cuda", generator=gen)

    def once():
        xs = [v.clone().requires_grad_(True) for v in vals]
        out = tgeo.scatter_add_rows(*xs, csr)
        return (out.detach(), *torch.autograd.grad(torch.sum(out * up), xs),
                tgeo.body_sums(vals[0][:, 0], tri_body, 3))

    first, second = once(), once()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _left_to_right(case, dtype, weighted: bool):
    """Each target row's slot values added in list order from +0.0, one numpy add at a time."""
    values = case["values"].astype(dtype)
    flat = values.reshape(values.shape[0] * 3, -1)
    n_slots = flat.shape[0]
    rows = np.concatenate([case["rows"], np.full(n_slots - case["rows"].size, case["n_rows"])])
    weight = np.where(case["mask"], case["weight"].astype(dtype), dtype(0))
    out = np.zeros((case["n_rows"] + 1, flat.shape[1]), dtype=dtype)
    for j in range(n_slots):
        x = weight[j // 3] * flat[j] if weighted else flat[j]
        out[rows[j]] = out[rows[j]] + x
    return torch.as_tensor(out.reshape((case["n_rows"] + 1,) + values.shape[2:]))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_reference_on_a_skewed_slot_csr_adds_left_to_right_from_plus_zero(chunk, dtype, width,
                                                                         weighted):
    """Rows of degree 0, 1, C - 1, C, C + 1, 2C + 1 and 131: the twin is the plain ordered loop."""
    from chip_smoke import skewed_slot_case

    case = skewed_slot_case(chunk, width)
    csr = slot_csr(torch.as_tensor(case["rows"]), case["n_rows"])
    vals = torch.as_tensor(case["values"], dtype=dtype)
    weight = None
    if weighted:
        weight = torch.where(torch.as_tensor(case["mask"]),
                             torch.as_tensor(case["weight"], dtype=dtype), 0.0)
    got = vs.reference(vals, csr, weight=weight)
    want = _left_to_right(case, {torch.float32: np.float32, torch.float64: np.float64}[dtype],
                          weighted)
    assert csr.max_degree == 131
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    # row 1 holds one -0.0: the sum from +0.0 is +0.0
    assert not bool(torch.any(torch.signbit(got[1]))) and not bool(torch.any(got[1]))


def test_chunk_is_the_kernel_headers():
    """``CHUNK``, which the chunk-edge cases are built for, is the header's ``kChunk``."""
    assert f"constexpr int kChunk = {vs.CHUNK};" in vs.HEADER.read_text()


def test_check_csr_is_kept_per_csr_device_and_slot_count():
    rows, nv = _rows(T=10, nv=12)
    csr = corner_csr(rows, nv)
    like = torch.zeros(1)
    vs.check_csr(csr, like, 10)
    vs.check_csr(csr, like, 10)  # kept: no second check
    with pytest.raises(ValueError, match="shape"):
        vs.check_csr(csr, like, 11)
    vs.check_csr(csr, like, 10)
    bad = dataclasses.replace(csr, slots=csr.slots.long())
    with pytest.raises(ValueError, match="int32"):
        vs.check_csr(bad, like, 10)
    strided = dataclasses.replace(csr, offsets=torch.stack([csr.offsets] * 2, dim=1)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        vs.check_csr(strided, like, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_skewed_slot_csr_weighted_and_members_bit_for_bit(dtype):
    """Card only: the skewed slot CSR at the kernel's chunk, plain, weighted, members."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from chip_smoke import same_bits, skewed_slot_case

    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    for width in (1, 3):
        case = skewed_slot_case(vs.CHUNK, width)
        csr = slot_csr(torch.as_tensor(case["rows"], device="cuda"), case["n_rows"])
        vals = torch.as_tensor(case["values"], dtype=dtype, device="cuda")
        assert same_bits(torch, vs.launch(vals, csr), vs.reference(vals, csr))
        stack = torch.stack([vals, -vals, 2 * vals]).contiguous()
        got = vs.launch_members(stack, csr)
        for m in range(3):
            assert same_bits(torch, got[m], vs.launch(stack[m].contiguous(), csr))
            assert same_bits(torch, got[m], vs.reference(stack[m], csr))
        if width == 3:
            w = torch.as_tensor(case["weight"], dtype=dtype, device="cuda")
            mask = torch.as_tensor(case["mask"], device="cuda")
            assert same_bits(torch, tk.launch_p1_div_bwd(vals, mask, w, csr),
                             tk.p1_div_vjp_reference(vals, mask, w, csr))
