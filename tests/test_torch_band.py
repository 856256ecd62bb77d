"""Bit-parity of the port's banded DP (longcalld_torch/ops/band.py) with the
JAX package's two forms of it: the lax twins ops/wfa.py:_banded_dp /
_backward_resolve and the Pallas kernels banded_dp_pallas /
backward_resolve_pallas (run in interpret mode, as tests/test_pallas_band.py
runs them).

Tolerance: exact equality of every output (all are integers).  Inputs are
built with numpy from seeds the way BatchAligner._submit_batch builds them
(tests/test_pallas_band.py:_build), and fed to both packages.  On CPU the
port's wrappers take their plain PyTorch versions; the CUDA kernels are
compared with those plain versions on the card by chip_smoke.py, which
also runs every configuration of band_fwd's warp design (B <= 512).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import band  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_tpu.ops import wfa  # noqa: E402
from longcalld_tpu.ops.pallas_band import (  # noqa: E402
    ROWS_PER_STEP, backward_resolve_pallas, banded_dp_pallas)
from torch_helpers import (LONG_CHAIN, long_run_rows,  # noqa: E402
                           random_walk_inputs)

X, O1, E1, O2, E2 = 4, 4, 2, 24, 1
CPU = torch.device("cpu")


def _mutate(rng, seq, n_sub, n_indel):
    s = list(seq)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = rng.integers(0, 4)
    for _ in range(n_indel):
        i = rng.integers(0, max(1, len(s)))
        if rng.random() < 0.5 and len(s) > 2:
            del s[i:i + int(rng.integers(1, 4))]
        else:
            s[i:i] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
    return np.array(s, dtype=np.uint8)


def _escape_pair(rng, B, Lp):
    """A pair whose optimal path leaves the band: a long insertion followed
    by a compensating deletion (tests/test_wfa_device.py's band-escape
    shape, scaled to the band)."""
    L = Lp - 4
    p = rng.integers(0, 4, L).astype(np.uint8)
    w = B // 2 + 8
    a = L // 4
    t = np.concatenate([p[:a], rng.integers(0, 4, w).astype(np.uint8),
                        p[a:L - w]])
    return p, t


def _build(rng, n_pairs, B, Lp, empty=False, escape=False, full=False):
    """Numpy inputs exactly as BatchAligner._submit_batch builds them;
    ``full`` makes pair 2 as long as the batch (plen == Lp)."""
    pairs = []
    for _ in range(n_pairs):
        L = int(rng.integers(3, Lp))
        p = rng.integers(0, 4, L).astype(np.uint8)
        t = _mutate(rng, p, int(rng.integers(0, 4)), int(rng.integers(0, 3)))
        if abs(len(t) - len(p)) + 4 >= B:
            t = t[:len(p)]
        pairs.append((p, t))
    if empty:       # the plen == 0 case, and a length-1 batch-padding dummy
        pairs[0] = (np.zeros(0, np.uint8), rng.integers(0, 4, 5)
                    .astype(np.uint8))
        pairs[1] = (np.zeros(1, np.uint8), np.zeros(1, np.uint8))
    if full:
        p = rng.integers(0, 4, Lp).astype(np.uint8)
        pairs[2] = (p, _mutate(rng, p, 4, 2))
    if escape:
        pairs[-1] = _escape_pair(rng, B, Lp)
    n = len(pairs)
    plens = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
    m_n = tlens - plens
    dlo = (np.minimum(0, m_n) - (B - np.abs(m_n)) // 2).astype(np.int32)
    P = np.full((n, Lp), 4, dtype=np.int8)
    Tband = np.full((n, Lp + B), 127, dtype=np.int8)
    for k, (p, t) in enumerate(pairs):
        P[k, :len(p)] = p
        off = -int(dlo[k])
        end = min(off + len(t), Lp + B)
        if end > off >= 0:
            Tband[k, off:end] = t[:end - off]
    return P, Tband, plens, tlens, dlo


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _check_forward(arrays, B, Lp):
    tbs_l, fin_l, edge_l = wfa._banded_dp(*_jax(arrays), B, Lp, X, O1, E1,
                                          O2, E2)
    tbs_p, fin_p, edge_p = banded_dp_pallas(*_jax(arrays), B, Lp, X, O1, E1,
                                            O2, E2, interpret=True)
    tbs_t, fin_t, edge_t = band.banded_dp(*from_numpy(arrays, CPU), B, Lp,
                                          X, O1, E1, O2, E2)
    assert tbs_t.dtype == torch.uint8 and fin_t.dtype == torch.int32
    assert edge_t.dtype == torch.int32
    for ref in ((tbs_l, fin_l, edge_l), (tbs_p, fin_p, edge_p)):
        np.testing.assert_array_equal(tbs_t.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(fin_t.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(edge_t.numpy(), np.asarray(ref[2]))
    return np.asarray(tbs_l), np.asarray(fin_l)


def _check_backward(tbs, finals, arrays, B, Lp):
    _, _, plen, tlen, dlo = arrays
    args = (jnp.asarray(tbs), *_jax((plen, tlen, dlo)), jnp.asarray(finals))
    nins_l, ops_l, b0_l = wfa._backward_resolve(*args, B, Lp)
    packed_l = (np.asarray(ops_l).astype(np.int32) << 14) | np.minimum(
        np.asarray(nins_l), (1 << 14) - 1)
    packed_p, b0_p = backward_resolve_pallas(*args, B, Lp, interpret=True)
    np.testing.assert_array_equal(np.asarray(packed_p), packed_l)

    targs = from_numpy((tbs, plen, tlen, dlo, finals), CPU)
    packed_t, b0_t = band.backward_resolve(*targs, B, Lp)
    assert packed_t.dtype == torch.int32 and b0_t.dtype == torch.int32
    np.testing.assert_array_equal(packed_t.numpy(), packed_l)
    np.testing.assert_array_equal(b0_t.numpy(), np.asarray(b0_l))
    # The two JAX forms differ on one b0: when ROWS_PER_STEP does not
    # divide Lp, the Pallas kernel's padded tail reaches row 0 and starts
    # a plen == 0 walk there (b0 = b_final), where the lax form (and the
    # port) never starts it (b0 = 0).  The main path's Lp buckets are
    # multiples of ROWS_PER_STEP.
    same = (np.asarray(plen) != 0) | (Lp % ROWS_PER_STEP == 0)
    np.testing.assert_array_equal(b0_t.numpy()[same], np.asarray(b0_p)[same])
    _, _, off_edge = band.backward_resolve_plain(*targs, B, Lp)
    return off_edge.numpy()


@pytest.mark.parametrize("seed,batch,B,Lp", [
    (0, 8, 128, 32),
    (1, 8, 128, 96),
    (2, 16, 256, 64),
    (3, 8, 256, 128),
    (4, 8, 384, 64),
    (5, 8, 1024, 64),
    (6, 4, 4096, 32),
])
def test_band_matches_jax(seed, batch, B, Lp):
    rng = np.random.default_rng(seed)
    arrays = _build(rng, batch, B, Lp, empty=seed % 2 == 1)
    tbs, finals = _check_forward(arrays, B, Lp)
    _check_backward(tbs, finals, arrays, B, Lp)


@pytest.mark.parametrize("B,Lp", [(128, 160), (256, 320), (1024, 1280)])
def test_band_escape_pair(B, Lp):
    """A pair whose optimal path leaves the band: outputs stay bit-equal,
    and the band-edge bound flags it for the host fallback
    (edge_min < score, ops/wfa.py:_reconstruct)."""
    rng = np.random.default_rng(11)
    arrays = _build(rng, 8, B, Lp, empty=True, escape=True)
    tbs, finals = _check_forward(arrays, B, Lp)
    _check_backward(tbs, finals, arrays, B, Lp)
    _, fin, edge = band.banded_dp(*from_numpy(arrays, CPU), B, Lp, X, O1, E1,
                                  O2, E2)
    assert int(edge[-1]) < int(fin[-1].min()), "escape pair stayed in band"


# the long-run cases: Lp not a multiple of 32, plen 0, 1 and Lp in one
# batch; batch 1 and 3 are pairs (2,) and (2, 3, 5) of an 11-pair batch
@pytest.mark.parametrize("seed,B,Lp,batch,long_runs", [
    pytest.param(0, 128, 64, 16, False, id="0"),
    pytest.param(1, 128, 64, 16, False, id="1"),
    pytest.param(2, 128, 64, 16, False, id="2"),
    pytest.param(3, 1024, 64, 16, False, id="3-B1024"),
    pytest.param(4, 384, 64, 16, False, id="4-B384"),
    pytest.param(5, 4096, 64, 16, False, id="5-B4096"),
    pytest.param(6, 256, 1000, 67, True, id="6-B256-Lp1000-long"),
    pytest.param(7, 1024, 33, 67, True, id="7-B1024-Lp33-long"),
    pytest.param(8, 256, 1000, 1, True, id="8-B256-Lp1000-batch1-long"),
    pytest.param(9, 384, 1000, 3, True, id="9-B384-Lp1000-batch3-long"),
    pytest.param(10, 4096, 33, 3, True, id="10-B4096-Lp33-batch3-long"),
])
def test_walk_on_random_traceback_bytes(seed, B, Lp, batch, long_runs):
    """Random traceback bytes and finals drive the walk through every
    branch and off both band edges (tests/torch_helpers.py:
    random_walk_inputs); the one-hot forms encode the off-band position
    as an all-zero vector.  The port must match both JAX forms bit for
    bit, and walks must actually have left through each edge.  With
    ``long_runs`` the plain walk's output must show the long insertion
    chain and the long D run that take the CUDA kernel out of its
    shared-memory window (chip_smoke.py runs the same inputs on the
    card)."""
    rng = np.random.default_rng(seed)
    arrays = random_walk_inputs(rng, B, Lp, max(batch, 11), spread=60,
                                long_runs=long_runs)
    if batch < 9:
        keep = [2, 3, 5][:batch]
        arrays = tuple(np.ascontiguousarray(a[:, keep] if a.ndim == 3
                                            else a[keep]) for a in arrays)
    tbs, plen, tlen, dlo, finals = arrays
    off_edge = _check_backward(tbs, finals, (None, None, plen, tlen, dlo),
                               B, Lp)
    if batch >= 9:
        assert (off_edge == band.OFF_LEFT).any()
        assert (off_edge == band.OFF_RIGHT).any()
    if long_runs:
        packed, _, _ = band.backward_resolve_plain(
            *from_numpy(arrays, CPU), B, Lp)
        chain, d_run = _long_runs(packed.numpy(), Lp)
        k2, k3 = (2, 3) if batch >= 9 else (0, 1)   # pairs 2 and 3
        assert chain[k2] == min(LONG_CHAIN, B - 21) + 1 > 128
        if batch != 1:
            # the extending rows, then one D row that ends the run
            ic, d_rows = long_run_rows(Lp)
            assert d_run[k3] == d_rows + (ic - d_rows > 1)
            assert d_run[k3] > 32 or Lp < 64
        if batch >= 9:
            assert list(plen[:3]) == [0, 1, Lp]


def _long_runs(packed, Lp):
    """Per pair, the longest insertion chain (n_ins) and the longest run
    of consecutive D rows in a packed walk output."""
    n_ins, op = packed & ((1 << 14) - 1), packed >> 14
    runs = []
    for col in (op == 2).T:
        best = cur = 0
        for d in col:
            cur = cur + 1 if d else 0
            best = max(best, cur)
        runs.append(best)
    return n_ins.max(axis=0), runs


# the warp design's widths (B <= 512), at batches the pairs per CTA do not
# divide (1, 3, 67, 70), Lp 256 and 1024 and, not a multiple of 32, 33 and
# 1000; plen == 0 dummies where the batch holds two pairs, a band-escape
# pair where Lp leaves it room, and in the Lp 33 / 1000 cases a pair of
# plen == Lp where the batch holds three
@pytest.mark.parametrize("B,batch,Lp", [
    (128, 1, 256), (128, 70, 1024), (256, 3, 1024), (256, 70, 256),
    (256, 1, 1024), (384, 3, 256), (384, 70, 1024), (512, 1, 1024),
    (512, 70, 256), (512, 3, 1024),
    (256, 67, 1000), (256, 3, 33), (256, 1, 1000), (128, 67, 33),
    (512, 3, 1000), (384, 67, 33),
])
def test_warp_widths_match_jax(B, batch, Lp):
    rng = np.random.default_rng(B + batch + Lp)
    escape = Lp >= 2 * B
    full = Lp % 32 != 0 and batch >= 3
    arrays = _build(rng, batch, B, Lp, empty=batch >= 2, escape=escape,
                    full=full)
    if full:
        assert list(arrays[2][:3]) == [0, 1, Lp]
    tbs, finals = _check_forward(arrays, B, Lp)
    _check_backward(tbs, finals, arrays, B, Lp)
    if escape:
        _, fin, edge = band.banded_dp(*from_numpy(arrays, CPU), B, Lp, X, O1,
                                      E1, O2, E2)
        assert int(edge[-1]) < int(fin[-1].min()), "escape pair stayed in band"


@pytest.mark.parametrize("batch", [1, 3, 64, 70, 256, 512, 515, 2048])
def test_band_fwd_config_is_built(batch):
    """band_fwd_config gives every width of the warp design a configuration
    the CUDA source instantiates (ops/band.py:WARP_CONFIGS), with at least
    one CTA per SM where the batch allows it, and one CTA per pair above
    B = 512; other configurations raise before any launch."""
    for B in (128, 256, 384, 512):
        for sms in (132, 8):
            wpp, ppc = band.band_fwd_config(B, batch, sms)
            band._check_config(B, wpp, ppc)
            assert ppc == 1 or -(-batch // ppc) >= sms
    assert band.band_fwd_config(1024, batch) == (0, 0)
    band._check_config(1024, 0, 0)
    for B, wpp, ppc in ((256, 3, 1), (256, 1, 9), (128, 4, 1), (1024, 1, 1),
                        (512, 0, 0)):
        with pytest.raises(ValueError, match="no configuration"):
            band._check_config(B, wpp, ppc)


@pytest.mark.parametrize("B,batch,want", [
    (256, 64, (4, 1)), (256, 512, (1, 2)), (256, 2048, (1, 8)),
    (128, 64, (1, 1)), (384, 512, (3, 2)), (512, 64, (4, 1)),
])
def test_band_fwd_config_takes_the_fastest_timed(B, batch, want):
    """The configurations the H100 ran fastest at the main path's batch
    buckets (PERF.md: tools/time_band_fwd.py, 132 SMs)."""
    assert band.band_fwd_config(B, batch, 132) == want


@pytest.mark.parametrize("B,ok", [
    (128, True), (384, True), (1024, True), (4096, True),
    (64, False), (192, False), (4224, False), (5128, False),
])
def test_cuda_kernels_refuse_other_bands(B, ok):
    """The CUDA kernels take every band width of the Pallas kernels, B a
    multiple of 128 from 128 to 4096; other widths are refused before any
    launch (the plain versions take any B on CPU)."""
    if ok:
        band._check_band(B)
    else:
        with pytest.raises(ValueError, match=f"got B={B}"):
            band._check_band(B)
