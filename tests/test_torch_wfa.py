"""Parity of the port's aligner (longcalld_torch/ops/wfa.py) with the JAX
package's (longcalld_tpu/ops/wfa.py): the fused device program
(align_device vs _align_device, compact_events vs _compact_events) and the
BatchAligner around it, mirroring tests/test_wfa_device.py and
tests/test_device_routing.py.

Tolerance: exact equality (events, meta, CIGARs, scores and routing
counters are all integers).  The port runs on CPU tensors here, where its
kernel wrappers take their plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import wfa as twfa  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_tpu.ops import wfa as jwfa  # noqa: E402
from longcalld_tpu.ops.affine_align import align_affine2p  # noqa: E402

from test_torch_band import _build  # noqa: E402
from torch_helpers import SV_WIDTHS, sv_pairs  # noqa: E402

CPU = torch.device("cpu")
X, O1, E1, O2, E2 = 4, 4, 2, 24, 1


@pytest.mark.parametrize("seed,batch,B,Lp,escape", [
    (0, 8, 128, 64, False),
    (1, 8, 256, 96, True),
    (2, 16, 256, 128, True),
])
def test_align_device_matches_jax(seed, batch, B, Lp, escape):
    rng = np.random.default_rng(seed)
    arrays = _build(rng, batch, B, Lp, empty=True, escape=escape)
    evs_j, meta_j = jwfa._align_device(*[jnp.asarray(a) for a in arrays],
                                       B, Lp, X, O1, E1, O2, E2)
    evs_t, meta_t = twfa.align_device(*from_numpy(arrays, CPU), B, Lp, X,
                                      O1, E1, O2, E2)
    assert evs_t.dtype == torch.int32 and meta_t.dtype == torch.int32
    np.testing.assert_array_equal(evs_t.numpy(), np.asarray(evs_j))
    np.testing.assert_array_equal(meta_t.numpy(), np.asarray(meta_j))


def test_align_device_splits_batch_under_budget(monkeypatch):
    """A traceback budget smaller than the batch splits it into several
    launches with identical outputs."""
    rng = np.random.default_rng(4)
    arrays = _build(rng, 12, 128, 64, empty=True)
    ref = twfa.align_device(*from_numpy(arrays, CPU), 128, 64, X, O1, E1,
                            O2, E2)
    monkeypatch.setattr(twfa, "TB_BUDGET_BYTES", 5 * 65 * 128)
    got = twfa.align_device(*from_numpy(arrays, CPU), 128, 64, X, O1, E1,
                            O2, E2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_compact_events_overflow_matches_jax():
    """Unencodable walks: n_ins > 4095 and more than K events both give
    n_ev = -1, with the first K events still written."""
    rng = np.random.default_rng(5)
    Lp, batch = 1024, 6
    nins = np.where(rng.random((Lp, batch)) < 0.05,
                    rng.integers(1, 50, (Lp, batch)), 0).astype(np.int32)
    ops = np.where(rng.random((Lp, batch)) < 0.1, 2, 1).astype(np.int32)
    ops[:, 0] = 0
    ops[::2, 1] = 2                     # 512 D rows + insertions > K=512
    nins[7, 2] = 5000                   # beyond the 12-bit field
    nins[9, 3] = 16383
    evs_j, n_j = jwfa._compact_events(jnp.asarray(nins), jnp.asarray(ops),
                                      Lp)
    evs_t, n_t = twfa.compact_events(*from_numpy((nins, ops), CPU), Lp)
    np.testing.assert_array_equal(evs_t.numpy(), np.asarray(evs_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert (n_t.numpy()[1:4] == -1).all()


def _mutate(rng, seq, n_snp=3, ins=0, dele=0):
    t = seq.copy()
    for _ in range(n_snp):
        i = int(rng.integers(0, len(t)))
        t[i] = (t[i] + 1) % 4
    if ins:
        i = int(rng.integers(0, len(t)))
        t = np.concatenate([t[:i], rng.integers(0, 4, ins).astype(np.uint8),
                            t[i:]])
    if dele:
        i = int(rng.integers(0, max(1, len(t) - dele)))
        t = np.concatenate([t[:i], t[i + dele:]])
    return t


def _aligners():
    return (twfa.BatchAligner(use_device=True, device_min_cells=1,
                              device=CPU),
            jwfa.BatchAligner(use_device=True, device_min_cells=1))


def _same(res_t, res_j):
    assert len(res_t) == len(res_j)
    for a, b in zip(res_t, res_j):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cigar, b.cigar)
        np.testing.assert_array_equal(a.pattern_alg, b.pattern_alg)
        np.testing.assert_array_equal(a.text_alg, b.text_alg)


_COUNTERS = ("n_fallback", "cells_device", "cells_host", "cells_memo",
             "cells_retry_host", "n_memo_hit", "n_dispatch", "n_dev_rounds",
             "bytes_h2d", "model_wf_cells", "model_poa_cells")


def _same_counters(tal, jal):
    for k in _COUNTERS:
        assert getattr(tal, k) == getattr(jal, k), k


def test_batch_aligner_matches_jax_and_host_oracle():
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(24):
        n = int(rng.integers(50, 400))
        p = rng.integers(0, 4, n).astype(np.uint8)
        t = _mutate(rng, p, n_snp=int(rng.integers(0, 6)),
                    ins=int(rng.integers(0, 40)),
                    dele=int(rng.integers(0, 40)))
        pairs.append((p, t))
    flags = [bool(k % 2) for k in range(len(pairs))]
    tal, jal = _aligners()
    res_t = tal.align_many(pairs, left_align=flags)
    _same(res_t, jal.align_many(pairs, left_align=flags))
    _same_counters(tal, jal)
    assert tal.cells_device > 0
    for (p, t), f, r in zip(pairs, flags, res_t):
        assert r.score == align_affine2p(p, t, left_align=f).score


def test_batch_aligner_band_escape_fallback():
    """Compensating INS+DEL far apart pushes the path off the band: the
    pair takes the host fallback in both packages."""
    rng = np.random.default_rng(11)
    p = rng.integers(0, 4, 600).astype(np.uint8)
    t = np.concatenate([p[:100], rng.integers(0, 4, 300).astype(np.uint8),
                        p[100:300], p[500:]])
    q = rng.integers(0, 4, 300).astype(np.uint8)
    pairs = [(p, t), (q, _mutate(rng, q, n_snp=2, ins=5))]
    tal, jal = _aligners()
    _same(tal.align_many(pairs, left_align=True),
          jal.align_many(pairs, left_align=True))
    _same_counters(tal, jal)
    assert tal.n_fallback == 1


def test_empty_and_tiny():
    p = np.array([0, 1, 2, 3], dtype=np.uint8)
    e = np.zeros(0, dtype=np.uint8)
    tal, jal = _aligners()
    res = tal.align_many([(p, e), (e, p), (p, p)], left_align=True)
    _same(res, jal.align_many([(p, e), (e, p), (p, p)], left_align=True))
    assert (res[0].cigar == [[2, 4]]).all()
    assert (res[1].cigar == [[1, 4]]).all()
    assert (res[2].cigar == [[7, 4]]).all()


def test_memo_and_host_routing():
    rng = np.random.default_rng(3)
    p = rng.integers(0, 4, 200).astype(np.uint8)
    t = _mutate(rng, p, n_snp=2, ins=5)
    al = twfa.BatchAligner(use_device=True, device_min_cells=10**9,
                           device=CPU)
    al.align_many([(p, t)])
    al.align_many([(p, t)])
    assert al.n_memo_hit == 1
    assert al.cells_memo == len(p) * len(t)
    assert al.cells_host == len(p) * len(t) and al.cells_device == 0


def test_host_only_aligner_touches_no_device(monkeypatch):
    """use_device=False never resolves a device (so no CUDA is needed)."""
    def boom(*a, **k):
        raise AssertionError("resolved a device")
    monkeypatch.setattr(twfa, "resolve_device", boom)
    rng = np.random.default_rng(2)
    p = rng.integers(0, 4, 300).astype(np.uint8)
    al = twfa.BatchAligner(use_device=False)
    r = al.align_many([(p, _mutate(rng, p))])[0]
    assert r.score > 0 and al.cells_host == 300 * 300


def test_calibration_env_override_and_cpu_threshold(monkeypatch):
    monkeypatch.setenv("LONGCALLD_DEVICE_MIN_CELLS", "12345")
    assert twfa.calibrate_min_cells(CPU) == 12345
    monkeypatch.delenv("LONGCALLD_DEVICE_MIN_CELLS")
    twfa._CALIBRATED_MIN_CELLS.clear()
    try:
        assert twfa.calibrate_min_cells(CPU) == 25_000_000
        assert twfa.calibrate_min_cells(CPU) == 25_000_000
    finally:
        twfa._CALIBRATED_MIN_CELLS.clear()


def test_get_aligner_keys_on_device_and_threshold():
    from longcalld_tpu.config import CallOpts
    twfa._ALIGNER_CACHE.clear()
    try:
        o1 = CallOpts.hifi(device_min_cells=1)
        o2 = CallOpts.hifi()
        a = twfa.get_aligner(o1, CPU)
        assert twfa.get_aligner(o1, CPU) is a
        assert twfa.get_aligner(o2, CPU) is not a
        assert twfa.get_aligner(o1, None) is not a
        assert set(twfa.aligner_totals()) >= set(_COUNTERS) - {
            "cells_retry_host"}
    finally:
        twfa._ALIGNER_CACHE.clear()


def _jax_reference(w, pairs):
    """The pairs that go through the JAX package's _align_batch.  Past the
    widest bucket only the insertion: the deletion's 5900 bp pattern puts
    the JAX device call (made there for host-masked groups too) at 32768
    rows, ~90 s on CPU, and JAX returns the host aligner's result for a
    host-masked pair, which the align_affine2p comparison covers."""
    return pairs if SV_WIDTHS[w] <= 4096 else pairs[:1]


@pytest.mark.parametrize("w", sorted(SV_WIDTHS))
def test_align_batch_wide_bands(w):
    """BatchAligner._align_batch on SV-like pairs (a w bp insertion and a
    w bp deletion against 900 bp): band buckets 1024 and 4096, which the
    routing of submit() keeps on the host, and 5128, past the widest
    bucket, whose group goes to the host aligner whole.  The port equals
    the JAX package's _align_batch and the host aligner, with the same
    fallbacks (the 1500 bp deletion's 1500 D rows overflow the 512-event
    buffer, so it takes the host ladder in both packages)."""
    pairs = sv_pairs(3)[w]
    tal, jal = _aligners()
    res_t = tal._align_batch(pairs)
    _same(res_t, [align_affine2p(p, t, left_align=False) for p, t in pairs])
    ref = _jax_reference(w, pairs)
    _same(res_t[:len(ref)], jal._align_batch(ref))
    assert tal.n_fallback == jal.n_fallback
    assert all(abs(r.score) >= w for r in res_t)


def test_align_batch_past_widest_bucket_makes_no_device_call(monkeypatch):
    """A group whose band bucket is past 4096 is host-masked whole: no call
    of align_device, and still the JAX package's outputs."""
    def boom(*a, **k):
        raise AssertionError("align_device called for a host-only group")
    monkeypatch.setattr(twfa, "align_device", boom)
    w = max(SV_WIDTHS)
    assert SV_WIDTHS[w] > 4096
    pairs = sv_pairs(4)[w]
    tal, jal = _aligners()
    res_t = tal._align_batch(pairs)
    _same(res_t, [align_affine2p(p, t, left_align=False) for p, t in pairs])
    ref = _jax_reference(w, pairs)
    _same(res_t[:len(ref)], jal._align_batch(ref))
    assert tal.n_dispatch == 0
