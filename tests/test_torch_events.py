"""Bit-parity of the port's fused traceback round (longcalld_torch/ops/
band.py:backward_events, and ops/wfa.py:align_device built on it) with
the JAX package's device program: _backward_resolve, _compact_events and
the meta row of longcalld_tpu/ops/wfa.py:_align_device.

Tolerance: exact equality (events and meta are integers).  On CPU the
wrapper takes its plain version, backward_events_plain; chip_smoke.py
holds the CUDA kernel's events epilogue to it on the card.  Inputs are
tests/torch_helpers.py:random_walk_inputs with long runs and the two
walks the compaction cannot encode (more than K events; an insertion
chain of more than 4095 columns at B 4096), made with numpy from seeds.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import band  # noqa: E402
from longcalld_torch.ops import wfa as twfa  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_tpu.ops import wfa as jwfa  # noqa: E402

from test_torch_band import _build  # noqa: E402
from torch_helpers import random_walk_inputs  # noqa: E402

CPU = torch.device("cpu")
X, O1, E1, O2, E2 = 4, 4, 2, 24, 1
N = 16                       # pairs of a random-walk batch
FLOOD, CHAIN = N - 2, N - 1  # the two overflow pairs (overflow=True)


def _jax_events(tbs, plen, tlen, dlo, finals, edge_min, B, Lp):
    """The tail of wfa.py:_align_device after the forward DP."""
    args = [jnp.asarray(a) for a in (tbs, plen, tlen, dlo, finals)]
    nins, ops, b0 = jwfa._backward_resolve(*args, B, Lp)
    evs, n_ev = jwfa._compact_events(nins, ops, Lp)
    meta = jnp.stack([jnp.min(jnp.asarray(finals), axis=1), b0,
                      jnp.asarray(edge_min), n_ev], axis=1).astype(jnp.int32)
    return np.asarray(evs), np.asarray(meta)


@pytest.mark.parametrize("seed,B,Lp,overflow", [
    pytest.param(0, 256, 1000, True, id="B256-Lp1000-overflow"),
    pytest.param(1, 256, 33, False, id="B256-Lp33"),
    pytest.param(2, 1024, 1000, True, id="B1024-Lp1000-overflow"),
    pytest.param(3, 1024, 33, False, id="B1024-Lp33"),
    pytest.param(4, 4096, 1000, True, id="B4096-Lp1000-overflow"),
    pytest.param(5, 4096, 33, False, id="B4096-Lp33"),
])
def test_backward_events_plain_matches_jax(seed, B, Lp, overflow):
    """Random traceback bytes with the long runs (walks off each band
    edge, plen 0 and 1, an insertion chain and a D run past the kernel's
    window) and, at Lp 1000, the overflow pairs: the events and the meta
    row equal the JAX package's, and each case the walks were built for
    shows in them."""
    rng = np.random.default_rng(seed)
    arrays = random_walk_inputs(rng, B, Lp, N, spread=60, long_runs=True,
                                overflow=overflow)
    edge_min = rng.integers(0, 1 << 20, N).astype(np.int32)
    evs_j, meta_j = _jax_events(*arrays, edge_min, B, Lp)
    targs = from_numpy((*arrays, edge_min), CPU)
    evs_t, meta_t = band.backward_events_plain(*targs, B, Lp)
    assert evs_t.dtype == torch.int32 and meta_t.dtype == torch.int32
    assert evs_t.shape == (N, band.event_k(Lp)) and meta_t.shape == (N, 4)
    np.testing.assert_array_equal(evs_t.numpy(), evs_j)
    np.testing.assert_array_equal(meta_t.numpy(), meta_j)
    # the wrapper on CPU tensors is the plain version
    got = band.backward_events(*targs, B, Lp)
    for a, b in zip(got, (evs_t, meta_t)):
        assert torch.equal(a, b)

    _, _, off_edge = band.backward_resolve_plain(*targs[:5], B, Lp)
    assert (off_edge.numpy() == band.OFF_LEFT).any()
    assert (off_edge.numpy() == band.OFF_RIGHT).any()
    evs, meta = evs_t.numpy(), meta_t.numpy()
    # plen 0: b0 0, no events, a zero row
    assert arrays[1][0] == 0
    assert list(meta[0, 1:]) == [0, int(edge_min[0]), 0]
    assert not evs[0].any()
    if overflow:
        K = band.event_k(Lp)
        # more than K events: n_ev -1, the first K stored
        assert meta[FLOOD, 3] == -1 and evs[FLOOD].all()
        assert (evs[FLOOD] >> 14).tolist() == sorted(evs[FLOOD] >> 14)
        assert int((evs[FLOOD] >> 14)[-1]) < Lp and K == 512
        # an insertion chain of B columns on row Lp (r = 0): clamped at
        # 4095 in the event, and past it (B 4096) n_ev -1
        assert evs[CHAIN, 0] == (1 << 12) | min(B, 4095)
        assert meta[CHAIN, 3] == (-1 if B > 4095 else 1)
        assert not evs[CHAIN, 1:].any()


@pytest.mark.parametrize("budget_pairs", [1, 5, 12])
def test_align_device_matches_jax_over_budget_split(monkeypatch,
                                                    budget_pairs):
    """align_device against wfa.py:_align_device with the batch split by
    the traceback budget into chunks of ``budget_pairs`` pairs (12: one
    chunk): each chunk's walk writes its rows of one pair of outputs."""
    rng = np.random.default_rng(40 + budget_pairs)
    B, Lp = 128, 64
    arrays = _build(rng, 12, B, Lp, empty=True)
    evs_j, meta_j = jwfa._align_device(*[jnp.asarray(a) for a in arrays],
                                       B, Lp, X, O1, E1, O2, E2)
    monkeypatch.setattr(twfa, "TB_BUDGET_BYTES", budget_pairs * (Lp + 1) * B)
    calls = []
    real = band.backward_events

    def spy(tbs, *a, **kw):
        calls.append(tbs.shape[1])
        return real(tbs, *a, **kw)

    monkeypatch.setattr(band, "backward_events", spy)
    evs_t, meta_t = twfa.align_device(*from_numpy(arrays, CPU), B, Lp, X,
                                      O1, E1, O2, E2)
    assert calls == [min(budget_pairs, 12 - k)
                     for k in range(0, 12, budget_pairs)]
    np.testing.assert_array_equal(evs_t.numpy(), np.asarray(evs_j))
    np.testing.assert_array_equal(meta_t.numpy(), np.asarray(meta_j))


def test_backward_events_writes_into_rows_of_out():
    """``out`` takes rows of larger tensors and leaves the other rows."""
    rng = np.random.default_rng(9)
    B, Lp = 128, 48
    arrays = random_walk_inputs(rng, B, Lp, 11, spread=30)
    edge_min = rng.integers(0, 100, 11).astype(np.int32)
    targs = from_numpy((*arrays, edge_min), CPU)
    want = band.backward_events_plain(*targs, B, Lp)
    evs = torch.full((15, band.event_k(Lp)), 7, dtype=torch.int32)
    meta = torch.full((15, 4), 7, dtype=torch.int32)
    got = band.backward_events(*targs, B, Lp, out=(evs[2:13], meta[2:13]))
    assert got[0].data_ptr() == evs[2:13].data_ptr()
    for full, w in ((evs, want[0]), (meta, want[1])):
        assert torch.equal(full[2:13], w)
        assert (full[:2] == 7).all() and (full[13:] == 7).all()


def test_wfa_keeps_the_compaction_names():
    assert twfa.compact_events is band.compact_events
    assert twfa._event_k(1024) == band.event_k(1024) == 512
    assert band.event_k(131072) == 16384
