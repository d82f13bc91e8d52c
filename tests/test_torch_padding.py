"""The width padding of the op-level kernel callers (``ops/padding``), on the
CPU.

K1/K6 and K7 take d % 4 == 0, K4/K5 d % 8 == 0; the callers
(``ops/backend.spmm_kernels``, which ``backend.spmm`` and
``spmm.rect_spmm`` take on the card, the lookups' backward and
``fused_ce.ce_kernels``) pad d with zeros and slice the results back.  Here
each kernel wrapper is replaced by a stand-in that asserts the padded width
and runs the kernel's plain version, and the callers' values and gradients
are held against the plain versions at the unpadded width, at d 36 and 10,
to 1e-6 of the largest value.  At a width that is already a multiple the
stand-in must receive the caller's tensor itself: no copy.
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.graph.build import CooGraph
from c2dsr_tpu_torch.ops import (backend, fused_ce, fused_ce_cuda, lookup,
                                 segsum_cuda, spmm, spmm_cuda)
from c2dsr_tpu_torch.ops.padding import on_padded_width, pad_width

TOL = 1e-6


def _close(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= TOL * scale


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32))


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernel wrappers replaced by their plain versions, each asserting
    the width it is given; the widths seen, by wrapper."""
    seen = {}

    def note(name, width, multiple):
        assert width % multiple == 0, (name, width)
        seen.setdefault(name, []).append(width)

    def hop(graph, h, n_out=None, bf16=False):
        note("hop", h.shape[1], spmm_cuda.D_MULTIPLE)
        seen.setdefault("hop_inputs", []).append(h)
        return spmm.spmm_reference(graph, h, n_out, bf16)

    def flagged_hop(graph, h, flag, bf16=False):
        note("flagged_hop", h.shape[1], spmm_cuda.D_MULTIPLE)
        return spmm.spmm_reference_flagged(graph, h, flag, "dest", bf16)

    def segsum(ids, g, n_rows):
        note("segsum", g.shape[1], segsum_cuda.D_MULTIPLE)
        assert g.is_contiguous()
        return segsum_cuda.segsum_plain(ids, g, n_rows)

    def ce_fwd(h, w, b, pad, tgt, bf16=False):
        note("ce_fwd", h.shape[1], fused_ce_cuda.D_MULTIPLE)
        assert w.shape[0] == h.shape[1]
        return fused_ce.ce_fwd_plain(h, w, b, pad, tgt, bf16)

    def ce_bwd(h, w, b, lse, dlse, dt, tgt, bf16=False):
        note("ce_bwd", h.shape[1], fused_ce_cuda.D_MULTIPLE)
        return fused_ce.ce_bwd_plain(h, w, b, lse, dlse, dt, tgt, bf16)

    monkeypatch.setattr(spmm_cuda, "hop", hop)
    monkeypatch.setattr(spmm_cuda, "flagged_hop", flagged_hop)
    monkeypatch.setattr(segsum_cuda, "segsum", segsum)
    monkeypatch.setattr(fused_ce_cuda, "ce_fwd", ce_fwd)
    monkeypatch.setattr(fused_ce_cuda, "ce_bwd", ce_bwd)
    return seen


def _graph(rng, n=40, nnz=160):
    rows = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    return spmm.device_graph(CooGraph(rows, cols, vals, n), "cpu"), (
        rows, cols, vals)


def _value_and_grad(fn, x, cot):
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (out * cot).sum().backward()
    return out.detach(), x.grad


def test_pad_width_appends_zeros_and_copies_nothing_at_a_multiple():
    x = torch.arange(30, dtype=torch.float32).view(3, 10)
    assert pad_width(x, 5) is x
    assert pad_width(x, 3, dim=0) is x
    p = pad_width(x, 4)
    assert p.shape == (3, 12) and torch.equal(p[:, :10], x)
    assert (p[:, 10:] == 0).all()
    q = pad_width(x, 4, dim=0)
    assert q.shape == (4, 10) and torch.equal(q[:3], x) and (q[3] == 0).all()
    assert on_padded_width(lambda t: t, x, 5) is x
    assert on_padded_width(lambda t: 2 * t, x, 4).shape == x.shape


@pytest.mark.parametrize("d", [36, 10])
def test_spmm_hops_at_odd_widths(stand_ins, d):
    rng = np.random.default_rng(d)
    graph, (rows, cols, vals) = _graph(rng)
    h, cot = _t(rng, 44, d), _t(rng, 44, d)
    got = _value_and_grad(lambda x: backend.spmm_kernels(graph, x), h, cot)
    want = _value_and_grad(lambda x: spmm.spmm_reference(graph, x), h, cot)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)
    flag = torch.from_numpy((rng.random(44) < 0.5).astype(np.uint8))
    got = _value_and_grad(lambda x: backend.spmm_kernels(graph, x, flag), h,
                          cot)
    want = _value_and_grad(lambda x: spmm.spmm_reference_flagged(
        graph, x, flag, "dest"), h, cot)
    for a, b in zip(got, want):
        _close(a, b)
    # the rectangular local sum of the sharded SpMM (spmm.rect_spmm's path)
    rect = spmm.rect_graph(rows[rows < 30], cols[rows < 30],
                           vals[rows < 30], 30, 44, "cpu")
    got = _value_and_grad(lambda x: backend.spmm_kernels(rect, x,
                                                         n_out=rect.n),
                          h, cot[:30])
    want = _value_and_grad(lambda x: spmm.spmm_reference(rect, x, rect.n),
                           h, cot[:30])
    for a, b in zip(got, want):
        _close(a, b)
    assert set(stand_ins["hop"]) == {d + (-d % 4)}


def test_spmm_at_a_multiple_hands_the_kernel_the_table_itself(stand_ins):
    rng = np.random.default_rng(0)
    graph, _ = _graph(rng)
    h = _t(rng, 44, 128)
    backend.spmm_kernels(graph, h)
    assert stand_ins["hop_inputs"][0] is h


@pytest.mark.parametrize("d", [36, 10])
def test_lookup_backward_at_odd_widths(stand_ins, d):
    rng = np.random.default_rng(d + 1)
    a, b = _t(rng, 50, d), _t(rng, 50, d)
    ids = torch.from_numpy(rng.integers(0, 50, 70))
    cot = _t(rng, 70, d)
    got = _value_and_grad(lambda t: lookup._Lookup.apply(t, ids), a, cot)
    want = _value_and_grad(lambda t: t.index_select(0, ids), a, cot)
    for x, y in zip(got, want):
        _close(x, y)
    la, lb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    (lookup._LookupAdd.apply(la, lb, ids) * cot).sum().backward()
    _, want_g = want
    _close(la.grad, want_g)
    _close(lb.grad, want_g)
    assert set(stand_ins["segsum"]) == {d + (-d % 4)}


def _ce_case(rng, d, N=24, V=40, n_real=37):
    h, w = _t(rng, N, d), _t(rng, d, V, scale=0.3)
    b = _t(rng, V, scale=0.1)
    pad = _t(rng, N)
    tgt = torch.from_numpy(rng.integers(0, n_real + 1, N))
    return h, w, fused_ce.mask_bias(b, n_real), pad, tgt


@pytest.mark.parametrize("d", [36, 10])
def test_fused_ce_at_odd_widths(stand_ins, d):
    rng = np.random.default_rng(d + 2)
    h, w, bm, pad, tgt = _ce_case(rng, d)
    c_lse, c_t = _t(rng, 24), _t(rng, 24)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (h, w, bm, pad)]
        lse, tl = fn(*leaves, tgt)
        ((lse * c_lse).sum() + (tl * c_t).sum()).backward()
        return [lse.detach(), tl.detach()] + [t.grad for t in leaves]

    got, want = run(fused_ce.ce_kernels), run(fused_ce.ce_fwd_plain)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)
    assert set(stand_ins["ce_fwd"]) == set(stand_ins["ce_bwd"]) == {
        d + (-d % 8)}


def test_fused_ce_refuses_rows_wider_than_512_naming_the_roadmap(stand_ins):
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="ROADMAP §B item 1"):
        fused_ce.ce_kernels(*_ce_case(rng, 520))
    assert "ce_fwd" not in stand_ins
