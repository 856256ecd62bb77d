"""The published peaks of the card, and the least time of a band_fwd
launch (its operations and bytes) that the band_fwd_roofline metric
divides by the kernel's measured time.

Peaks: NVIDIA H100 SXM5 80GB data sheet and architecture whitepaper.
The int32 rate is 132 SMs x 64 INT32 lanes x 1.98 GHz (the boost clock):
16.73 Tops/s.  HBM3: 3.35 TB/s.  They hold at the card's full 700 W;
the run reports the power limit it found beside the share.

band_fwd computes, for every cell of its band, the two-piece gap-affine
recurrence and one traceback byte.  The operations the recurrence needs
a cell, as int32 adds, compares, selects and mins:
  E1, E2 (gap in the pattern) and F1, F2 (gap in the text): from the
    left or upper H, add the open-plus-extend cost; from the same state,
    add the extend cost; take the min: 3 each, 12;
  H: the substitution cost (compare the two bases, select 0 or the
    mismatch cost: 2), add it to the diagonal H (1), min with the four
    gap states (4): 7.
That is OPS_PER_CELL = 19; the traceback byte's bits are the outcomes of
the comparisons those mins make, so they add bytes, not operations.
Bytes a launch: each input byte read once (the pattern row and the
shifted text row of every pair, plen, tlen and dlo), each output byte
written once (one traceback byte a cell on rows 0..plen, five int32
finals and the edge minimum a pair)."""

from __future__ import annotations

from typing import Iterable, Tuple

H100_SMS = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = H100_SMS * INT32_LANES_PER_SM * BOOST_HZ
HBM_BYTES_PER_S = 3.35e12
FULL_POWER_W = 700.0

OPS_PER_CELL = 19


def band_fwd_launch(B: int, Lp: int, batch: int, plen_sum: int
                    ) -> Tuple[float, float]:
    """(int32 operations, bytes) one band_fwd launch needs: ``batch``
    pairs padded to Lp rows, whose real rows sum to ``plen_sum``."""
    cells = B * plen_sum
    ops = OPS_PER_CELL * cells
    read = plen_sum + (plen_sum + B * batch) + 3 * 4 * batch
    written = B * (plen_sum + batch) + (5 + 1) * 4 * batch
    return float(ops), float(read + written)


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def band_fwd_least_seconds(launches: Iterable[Tuple[int, int, int, int]]
                           ) -> float:
    """The least time of a list of (B, Lp, batch, plen_sum) launches."""
    return sum(least_seconds(*band_fwd_launch(*l)) for l in launches)
