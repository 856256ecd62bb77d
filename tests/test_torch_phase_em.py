"""The EM kernel's host side (longcalld_torch/ops/phase_kernel.py:
phase_em, phase_fixpoint, pack_phase_out / unpack_phase_out) and the
plain version at shapes tests/test_torch_phase.py does not reach, against
the JAX program (longcalld_tpu/ops/phase_kernel.py:phase_fixpoint_kernel)
on the CPU.

The kernel itself (csrc/phase_em.cu) runs only on a card: chip_smoke.py
phase 9 holds it bit-equal to phase_fixpoint_plain there.  Here:
* phase_fixpoint on CPU tensors (the plain version) equals the JAX form
  past the last bucket on either axis, under a max_iter cap of 1 and 2 on
  windows that run longer uncapped, and on a window of padding reads only;
* phase_em refuses a CPU tensor, a wrong dtype, a wrong shape and a
  non-contiguous alleles tensor with ValueError before the kernel library
  is loaded, and a CUDA tensor never reaches the plain version;
* the packed layout round-trips, and utils/kbuild.py binds the C entry
  with the source's parameters.

Tolerance: exact equality of every output (all are integers).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import phase_kernel as tpk  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_torch.utils import kbuild  # noqa: E402
from longcalld_tpu.ops import phase_kernel as jpk  # noqa: E402
from torch_helpers import phase_window  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("cons", "haps", "ps_start", "agree", "conflict", "profile")


def _compare(arrays, max_iter=10):
    ref = jpk.phase_fixpoint_kernel(*[jnp.asarray(a) for a in arrays],
                                    max_iter=max_iter)
    out = tpk.phase_fixpoint(*from_numpy(arrays, CPU), max_iter=max_iter)
    for name in FIELDS:
        want = np.asarray(getattr(ref, name))
        got = getattr(out, name)
        assert got.dtype == from_numpy(want, CPU).dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert out.n_iter == int(ref.n_iter)
    return out


@pytest.mark.parametrize("R,V", [(64, 8200), (8200, 64)])
def test_past_the_last_bucket(R, V):
    """R or V above 8192 runs at the exact count (phase_kernel.py:
    _bucket), so the EM takes any size on either axis."""
    _compare(phase_window(R + V, R=R, V=V, noise=0.05))


@pytest.mark.parametrize("max_iter", [1, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_max_iter_cap(seed, max_iter):
    """Noisy windows that run 10 rounds uncapped stop at the cap, which
    sets n_iter; the outputs are those of the last round run."""
    arrays = phase_window(seed, noise=0.3)
    assert _compare(arrays).n_iter > 2
    assert _compare(arrays, max_iter=max_iter).n_iter == max_iter


def test_all_padding_reads():
    """A window of padding reads only (starts -1, ends -2, hap 0), as
    run_phase_kernel pads R: no read scores or counts."""
    arrays = list(phase_window(5, R=32, V=40))
    R = arrays[0].shape[0]
    arrays[1] = np.full(R, -1, np.int32)
    arrays[2] = np.full(R, -2, np.int32)
    arrays[4] = np.zeros(R, np.int8)
    out = _compare(tuple(arrays))
    assert not out.haps.any() and not out.profile.any()


@pytest.fixture
def no_library(monkeypatch):
    """kbuild.load fails the test if called."""
    def load():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(kbuild, "load", load)


def _args(R=16, V=24):
    return list(from_numpy(phase_window(1, R=R, V=V), CPU))


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on cuda:0."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["cpu", "dtype", "shape", "contiguous"])
def test_phase_em_refusals(no_library, case):
    args = _args()
    match = {"cpu": "CUDA device", "dtype": "dtype", "shape": "shape",
             "contiguous": "contiguous"}[case]
    if case == "dtype":
        args[6] = args[6].to(torch.int64)              # w_score
    elif case == "shape":
        args[3] = args[3][:, :-1].contiguous()         # cons0 (2, V-1)
    elif case == "contiguous":
        args[0] = args[0].t().contiguous().t()         # alleles (R, V)
        assert not args[0].is_contiguous()
    with pytest.raises(ValueError, match=match):
        tpk.phase_em(*args)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """phase_fixpoint on CUDA tensors goes to the kernel: without a
    library it raises, and the plain version is never called."""
    def plain(*a, **k):
        raise AssertionError("phase_fixpoint_plain called for CUDA tensors")

    def load():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(tpk, "phase_fixpoint_plain", plain)
    monkeypatch.setattr(kbuild, "load", load)
    args = [a.as_subclass(FakeCuda) for a in _args()]
    with pytest.raises(RuntimeError, match="nvcc"):
        tpk.phase_fixpoint(*args)
    with pytest.raises(ValueError, match="starts is on cpu"):
        tpk.phase_fixpoint(args[0], *_args()[1:])


@pytest.mark.parametrize("R,V", [(16, 24), (96, 80)])
def test_pack_unpack_round_trip(R, V):
    out = tpk.phase_fixpoint(*_args(R, V))
    buf = tpk.pack_phase_out(out)
    assert buf.dtype == torch.int32
    assert tuple(buf.shape) == (tpk.packed_size(R, V),) == (7 * V + 3 * R
                                                            + 1,)
    # the layout csrc/phase_em.cu writes: cons | haps | ps_start | agree |
    # conflict | profile | n_iter
    assert torch.equal(buf[:2 * V], out.cons.flatten().int())
    assert torch.equal(buf[2 * V:2 * V + R], out.haps.int())
    assert int(buf[-1]) == out.n_iter
    back = tpk.unpack_phase_out(buf, R, V)
    for name in FIELDS:
        a, b = getattr(back, name), getattr(out, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert back.n_iter == out.n_iter
    with pytest.raises(ValueError, match="packed"):
        tpk.unpack_phase_out(buf[:-1], R, V)


def test_em_ctas():
    """One CTA up to 2^16 cells of the allele matrix, one more per 2^16,
    at most one an SM."""
    assert tpk.em_ctas(128, 128, 132) == tpk.em_ctas(256, 256, 132) == 1
    assert tpk.em_ctas(512, 512, 132) == 4
    assert tpk.em_ctas(2048, 512, 132) == 16
    assert tpk.em_ctas(64, 8200, 132) == 9
    assert tpk.em_ctas(2048, 2048, 132) == 64
    assert tpk.em_ctas(8192, 8192, 132) == 132
    assert tpk.em_ctas(8192, 8192, 8) == 8


def test_signature_matches_the_source():
    """utils/kbuild.py binds lcd_phase_em with the C entry's parameters:
    a pointer for each pointer (and the stream), an int for each int."""
    src = open(os.path.join(kbuild.CSRC_DIR, "phase_em.cu")).read()
    params = re.search(r'extern "C" int lcd_phase_em\(([^)]*)\)', src)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.group(1).split(",")]
    assert kbuild.SIGNATURES["lcd_phase_em"] == kinds
