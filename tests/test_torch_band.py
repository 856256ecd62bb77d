"""Bit-parity of the port's banded DP (longcalld_torch/ops/band.py) with the
JAX package's two forms of it: the lax twins ops/wfa.py:_banded_dp /
_backward_resolve and the Pallas kernels banded_dp_pallas /
backward_resolve_pallas (run in interpret mode, as tests/test_pallas_band.py
runs them).

Tolerance: exact equality of every output (all are integers).  Inputs are
built with numpy from seeds the way BatchAligner._submit_batch builds them
(tests/test_pallas_band.py:_build), and fed to both packages.  On CPU the
port's wrappers take their plain PyTorch versions; the CUDA kernels are
compared with those plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import band  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_tpu.ops import wfa  # noqa: E402
from longcalld_tpu.ops.pallas_band import (backward_resolve_pallas,  # noqa
                                           banded_dp_pallas)
from torch_helpers import random_walk_inputs  # noqa: E402

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


def _build(rng, n_pairs, B, Lp, empty=False, escape=False):
    """Numpy inputs exactly as BatchAligner._submit_batch builds them."""
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
    np.testing.assert_array_equal(b0_t.numpy(), np.asarray(b0_p))
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


@pytest.mark.parametrize("seed,B", [
    pytest.param(0, 128, id="0"), pytest.param(1, 128, id="1"),
    pytest.param(2, 128, id="2"), pytest.param(3, 1024, id="3-B1024"),
    pytest.param(4, 384, id="4-B384"), pytest.param(5, 4096, id="5-B4096"),
])
def test_walk_on_random_traceback_bytes(seed, B):
    """Random traceback bytes and finals drive the walk through every
    branch and off both band edges (tests/torch_helpers.py:
    random_walk_inputs); the one-hot forms encode the off-band position
    as an all-zero vector.  The port must match both JAX forms bit for
    bit, and walks must actually have left through each edge."""
    rng = np.random.default_rng(seed)
    tbs, plen, tlen, dlo, finals = random_walk_inputs(rng, B, 64, 16)
    off_edge = _check_backward(tbs, finals, (None, None, plen, tlen, dlo),
                               B, 64)
    assert (off_edge == band.OFF_LEFT).any()
    assert (off_edge == band.OFF_RIGHT).any()


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
