"""Parity of the port's phasing EM (longcalld_torch/ops/phase_kernel.py)
with the JAX program it replaces (longcalld_tpu/ops/phase_kernel.py:
_phase_fixpoint, _cons_update and the serial phase-set scan).

Tolerance: exact equality of every output.  All outputs are integers; the
port's float32 dots are exact because every count stays below 2^24, the
same argument the JAX form rests on.  Inputs are made with numpy from seeds
and fed to both packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_torch.ops import phase_kernel as tpk  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_tpu.ops import phase_kernel as jpk  # noqa: E402

CPU = torch.device("cpu")


def _window(seed, R=96, V=80, noise=0.03, hp_on=False):
    """Two haplotypes plus noise, with partial read spans, -1 (uncovered)
    and -2 alleles, digar-less reads, unphased reads and a partly
    filled starting consensus."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, V)
    haps = rng.integers(1, 3, R)
    alle = np.where(haps[:, None] == 1, truth[None, :], 1 - truth[None, :])
    alle = np.where(rng.random((R, V)) < noise, 1 - alle, alle)
    starts = rng.integers(0, V, R)
    ends = np.minimum(starts + rng.integers(5, V, R), V - 1)
    cols = np.arange(V)[None, :]
    span = (cols >= starts[:, None]) & (cols <= ends[:, None])
    A = np.where(span, alle, -1)
    A = np.where(span & (rng.random((R, V)) < 0.05), -2, A).astype(np.int8)
    starts, ends = starts.astype(np.int32), ends.astype(np.int32)
    skip = rng.random(R) < 0.05                  # digar-less reads
    starts[skip], ends[skip] = -1, -2
    cons0 = np.stack([truth, 1 - truth]).astype(np.int8)
    cons0[:, rng.random(V) < 0.1] = -1
    flip = rng.random(V) < 0.15                  # consensus to repair
    cons0[:, flip] = cons0[::-1, flip]
    haps0 = np.where(rng.random(R) < 0.1, 0, haps).astype(np.int8)
    valid = rng.random(V) < 0.9
    scoreable = valid & (rng.random(V) < 0.95)
    w_score = rng.integers(0, 4, V).astype(np.int32)
    clean_snp = scoreable & (rng.random(V) < 0.8)
    hp = rng.random(V) < (0.2 if hp_on else 0.0)
    hp_ont = hp & hp_on
    return (A, starts, ends, cons0, haps0, scoreable, w_score, clean_snp,
            valid, hp, hp_ont)


def _compare(arrays):
    ref = jpk.phase_fixpoint_kernel(*[jnp.asarray(a) for a in arrays])
    out = tpk.phase_fixpoint(*from_numpy(arrays, CPU))
    for name in ("cons", "haps", "ps_start", "agree", "conflict", "profile"):
        got = getattr(out, name)
        want = np.asarray(getattr(ref, name))
        assert got.dtype == from_numpy(want, CPU).dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert out.n_iter == int(ref.n_iter)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_phase_fixpoint_matches_jax(seed):
    out = _compare(_window(seed, hp_on=seed % 2 == 1))
    assert out.n_iter >= 1


def test_phase_fixpoint_converges_over_several_rounds():
    """Noisier windows need more than one round; n_iter must agree."""
    outs = [_compare(_window(s, noise=0.2)) for s in (10, 11, 12)]
    assert max(o.n_iter for o in outs) >= 2


def test_phase_fixpoint_example_batch():
    """The JAX package's own synthetic window layout
    (parallel/mesh.py:make_example_window_batch)."""
    rng = np.random.default_rng(3)
    R, V = 64, 128
    truth = rng.integers(0, 2, V)
    haps = rng.integers(1, 3, R)
    alle = np.where(haps[:, None] == 1, truth[None, :], 1 - truth[None, :])
    A = np.where(rng.random((R, V)) < 0.02, 1 - alle, alle).astype(np.int8)
    ones = np.ones(V, dtype=bool)
    _compare((A, np.zeros(R, np.int32), np.full(R, V - 1, np.int32),
              np.stack([truth, 1 - truth]).astype(np.int8),
              haps.astype(np.int8), ones, np.full(V, 2, np.int32), ones,
              ones, np.zeros(V, bool), np.zeros(V, bool)))


def test_phase_fixpoint_no_valid_vars():
    arrays = list(_window(7))
    arrays[8] = np.zeros_like(arrays[8])
    _compare(tuple(arrays))


def test_cons_update_ont_hp_rule():
    """update_var_hap_to_cons_alle core (assign_hap.c:244-268): majority
    with ref preferred on ties; ONT homopolymer indels need >=67%
    (tests/test_phase_kernel.py:104-116 for the JAX form)."""
    p0 = np.array([5, 2, 3, 0, 6, 2, 1, 67], dtype=np.int32)
    p1 = np.array([2, 5, 3, 0, 3, 5, 2, 133], dtype=np.int32)
    hp = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=bool)
    got = tpk._cons_update(*from_numpy((p0, p1, hp), CPU)).numpy()
    want = np.asarray(jpk._cons_update(jnp.asarray(p0), jnp.asarray(p1),
                                       jnp.asarray(hp)))
    np.testing.assert_array_equal(got, want)
    assert list(got[:6]) == [0, 1, 0, -1, -1, 1]


def _scan_reference(valid, het, n_agree, n_conflict):
    """phase_kernel.py:149-164's serial scan, step by step."""
    V = len(valid)
    first_valid = int(np.argmax(valid))
    start, flip = -1, 0
    ps = np.full(V, -1, dtype=np.int32)
    flips = np.zeros(V, dtype=bool)
    for v in range(V):
        is_first = v == first_valid
        new_seg = het[v] and n_agree[v] < 2 and n_conflict[v] < 2
        do_flip = het[v] and not new_seg and n_conflict[v] > n_agree[v]
        if valid[v] and (is_first or new_seg):
            start = v
        if valid[v] and not is_first and do_flip:
            flip ^= 1
        flips[v] = valid[v] and not is_first and het[v] and flip == 1
        ps[v] = start if valid[v] else -1
    return ps, flips


@pytest.mark.parametrize("seed", range(8))
def test_prefix_scan_equals_serial_scan(seed):
    """The two prefix operations (cummax start, cumsum flip parity that is
    never reset at a segment start) equal the serial scan."""
    rng = np.random.default_rng(seed)
    V = int(rng.integers(1, 200))
    valid = rng.random(V) < (0.0 if seed == 0 else 0.8)
    het = valid & (rng.random(V) < 0.7)
    n_agree = rng.integers(0, 5, V).astype(np.int32)
    n_conflict = rng.integers(0, 5, V).astype(np.int32)
    ps, flips = tpk.scan_phase_sets(*from_numpy(
        (valid, het, n_agree, n_conflict), CPU))
    ps_r, flips_r = _scan_reference(valid, het, n_agree, n_conflict)
    np.testing.assert_array_equal(ps.numpy(), ps_r)
    np.testing.assert_array_equal(flips.numpy(), flips_r)


def test_tf32_refused_on_cuda(monkeypatch):
    """The torch form's dots are exact only in full fp32: with TF32 on, a
    CUDA run of it (the mesh's EM, the yardstick on the card) must refuse
    rather than round.  The kernel sums in int32."""
    arrays = from_numpy(_window(0, R=8, V=8), CPU)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)

    class FakeCuda(torch.Tensor):
        pass

    fake = arrays[0].as_subclass(FakeCuda)
    monkeypatch.setattr(FakeCuda, "device", property(
        lambda self: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tpk.phase_fixpoint_plain(fake, *arrays[1:])
