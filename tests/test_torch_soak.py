"""tests/soak_torch.py, the port's soak, against tests/soak.py on the CPU.

tests/soak.py is imported as a module and pointed at a seeded random 2 Mb
chr11 (soak_torch.seeded_base) through ``soak.CHR11_FA``; its sdust cache
``soak._LOW_COMP`` is reset per scene.  The port runs on CPU tensors, so
its forced device calls (device_min_cells=1) go through the kernels' plain
versions.

* pipeline, ont, stitch and somatic at one seed each: the scene BAMs are
  byte-equal; the outcomes are equal and not FAIL; every call's VCF body
  equals the JAX call's in the same place, and the port's forced-device
  body equals the JAX host body.  The pipeline, ont and stitch seeds send
  DP cells to the device aligner; the somatic scene sends no pair to
  either aligner (SNVs only, substitution errors only).
* f1 on the shortest prefix of the base at which seed 10004's scene is
  eligible (>= 500 planted variants): 510 kb, against 505 kb that is not.
  The outcomes are equal (~6 s for both runners on one core).
* main() over 5 seeds on the CPU writes the summary with the audit keys
  and no FAIL; without CUDA the default device raises before the first
  seed; the module loads in a process that refuses jax and the JAX
  package; the sdust cache is per base; a kernel or CUDA error ends the
  run while a scene's other errors count as FAIL.

Tolerance: exact (file bytes, VCF lines, outcome strings).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import soak  # noqa: E402
import soak_torch  # noqa: E402

CPU = torch.device("cpu")
# one seed per family, from main's round-robin over base seed 10000 (the
# stitch seed is the first whose scene aligns a DP cell)
SEEDS = {"pipeline": 10000, "ont": 10001, "stitch": 10007, "somatic": 10003}
BAMS = {"pipeline": "soak.bam", "ont": "soak.bam", "stitch": "soak.bam",
        "somatic": "som.bam"}
F1_SEED, F1_LEN, F1_SHORT = 10004, 510_000, 505_000


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return soak_torch.seeded_base(str(tmp_path_factory.mktemp("soak_base")))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the plain kernel versions launch many small ops: beside the other
    # test processes, intra-op threads would only contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_jax(fam, seed, base, d):
    """tests/soak.py's family on ``base``; returns (outcome, [(use_device,
    body)] of its calls)."""
    calls = []
    real = soak._call

    def spy(opt):
        out = real(opt)
        calls.append((opt.use_device, soak._body(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(soak, "CHR11_FA", base.fa)
        mp.setattr(soak, "_LOW_COMP", None)
        mp.setattr(soak, "_call", spy)
        outcome = soak.FAMILIES[fam](seed, base.ref4, base.fa_len, d)
    return outcome, calls


def _run_port(fam, seed, base, d):
    """The port's family on ``base`` on CPU tensors; returns (outcome,
    [(use_device, device_min_cells, body)], audit delta)."""
    calls = []
    real = soak_torch._call

    def spy(opt, device):
        out = real(opt, device)
        calls.append((opt.use_device, opt.device_min_cells,
                      soak_torch._body(out)))
        return out

    before = soak_torch._audit()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(soak_torch, "_call", spy)
        outcome = soak_torch.FAMILIES[fam](seed, base, d, CPU)
    after = soak_torch._audit()
    delta = {k: after[k] - before[k] for k in ("cells_device", "cells_host")}
    return outcome, calls, delta


@pytest.fixture(scope="module", params=list(SEEDS))
def scene(request, base, tmp_path_factory):
    fam = request.param
    jd, td = (str(tmp_path_factory.mktemp(f"{k}_{fam}"))
              for k in ("jax", "port"))
    j_out, j_calls = _run_jax(fam, SEEDS[fam], base, jd)
    t_out, t_calls, cells = _run_port(fam, SEEDS[fam], base, td)
    with open(os.path.join(jd, BAMS[fam]), "rb") as f:
        j_bam = f.read()
    with open(os.path.join(td, BAMS[fam]), "rb") as f:
        t_bam = f.read()
    return dict(fam=fam, jax=j_out, port=t_out, j_calls=j_calls,
                t_calls=t_calls, cells=cells, j_bam=j_bam, t_bam=t_bam)


def test_scene_bam_equal(scene):
    assert len(scene["t_bam"]) > 10_000
    assert scene["t_bam"] == scene["j_bam"]


def test_outcome_and_bodies_equal(scene):
    assert scene["port"] == scene["jax"]
    assert scene["port"][0] != "FAIL", scene["port"]
    j_calls, t_calls = scene["j_calls"], scene["t_calls"]
    assert [u for u, _ in j_calls] == [u for u, _, _ in t_calls]
    for (_, jb), (use_device, min_cells, tb) in zip(j_calls, t_calls):
        assert tb == jb
        assert min_cells == (1 if use_device else None)
    # the port's forced-device body against the JAX host body
    dev_body = t_calls[0][2]
    host_body = next(b for u, b in j_calls if not u)
    assert t_calls[0][0] and dev_body == host_body and dev_body
    if scene["fam"] == "somatic":
        assert scene["cells"] == {"cells_device": 0, "cells_host": 0}
    else:
        assert scene["cells"]["cells_device"] > 0


def test_f1_outcome_equal(base, tmp_path):
    """The F1 family on the shortest base prefix where it is eligible."""
    from torch_helpers import build_truth

    short = base.ref4[:F1_SHORT]
    assert len(build_truth(np.random.default_rng(F1_SEED), short, 10_000,
                           F1_SHORT - 10_000)) < 500
    ref4 = base.ref4[:F1_LEN]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = soak.family_f1(F1_SEED, ref4, F1_LEN, str(tmp_path / "jax"))
    got = soak_torch.family_f1(
        F1_SEED, soak_torch.Base(base.fa, ref4, F1_LEN, "prefix"),
        str(tmp_path / "port"), CPU)
    assert got == want == ("pass", "")


def test_main_cpu_summary(tmp_path, capsys):
    out = tmp_path / "soak.json"
    assert soak_torch.main(["--seeds", "5", "--device", "cpu", "--out",
                            str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["counts"] == {"pass": 5, "ineligible": 0, "known_miss": 0,
                           "FAIL": 0}
    assert s["seeds"] == 5 and s["non_pass"] == [] and s["wall_s"] > 0
    assert s["device"] == "cpu" and s["card"] is None
    assert s["audit_failures"] == [] and s["device_min_cells"] == 1
    assert "seeded random chr11" in s["base"]["source"]
    assert s["base"]["length"] == soak_torch.BASE_LEN
    fams = s["families"]
    assert list(fams) == list(soak_torch.FAMILIES)
    for fam, rec in fams.items():
        assert rec["seeds"] == 1 and rec["counts"]["pass"] == 1, fam
        assert rec["wall_s"] > 0
        # launches are counted on the card only
        assert rec["launches"] == {"band_fwd": 0, "band_bwd": 0}
        assert rec["launch_shapes"] == {"band_fwd": {}, "band_bwd": {}}
        assert rec["phase_cuda_calls"] == 0
        assert rec["phase_em_launches"] == 0
    assert fams["pipeline"]["cells_device"] > 0
    assert fams["pipeline"]["device_share_of_dp_cells"] == 1.0
    assert fams["f1"]["cells_device"] == 0 and fams["f1"]["cells_host"] > 0
    # the last stdout line is the summary
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(soak_torch, "FAMILIES", {
        "pipeline": lambda *a: ran.append(a) or ("pass", "")})
    out = tmp_path / "soak.json"
    with pytest.raises(RuntimeError, match="cuda"):
        soak_torch.main(["--seeds", "1", "--out", str(out)])
    assert not ran and not out.exists()


_REFUSING_IMPORT = r"""
import importlib.abc, sys

REFUSED = ("jax", "jaxlib", "longcalld_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(name + " is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tests")
import soak_torch
assert callable(soak_torch.main) and callable(soak_torch.sim_read)
assert "JAX_PLATFORMS" not in __import__("os").environ
assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
"""


def test_soak_loads_without_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _REFUSING_IMPORT],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_low_comp_cache_per_base(base, monkeypatch):
    """Two bases, the second with low-complexity runs planted in the scene
    region: different intervals, each equal to tests/soak.py's."""
    lo = soak_torch.REF_BEG
    other = base.ref4.copy()
    for k in range(6):
        s = lo + 700 + 1_300 * k
        other[s:s + 40] = np.tile(np.array([0, 1], np.uint8), 20)
    monkeypatch.setattr(soak_torch, "_LOW_COMP", {})
    first = soak_torch.low_comp_intervals(base.ref4)
    second = soak_torch.low_comp_intervals(other)
    assert first != second and len(soak_torch._LOW_COMP) == 2
    assert soak_torch.low_comp_intervals(base.ref4) == first
    assert len(second) >= 6
    probe = range(lo, lo + soak_torch.REF_LEN, 7)
    for ref4 in (base.ref4, other):
        monkeypatch.setattr(soak, "_LOW_COMP", None)
        assert ([soak._low_comp_context(ref4, p) for p in probe]
                == [soak_torch._low_comp_context(ref4, p) for p in probe])


def _kernel_launch_error(*a):
    from longcalld_torch.utils import kbuild
    kbuild.check(700, "band_fwd")


def _band_width_error(*a):
    from longcalld_torch.ops import band
    band._check_band(100)


def _cuda_error(*a):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _scene_error(*a):
    raise ValueError("the scene went wrong")


@pytest.mark.parametrize("fault, ends_run", [
    (_kernel_launch_error, True), (_band_width_error, True),
    (_cuda_error, True), (_scene_error, False)])
def test_kernel_fault_ends_the_run(base, monkeypatch, fault, ends_run):
    """An error of the kernel wrappers or of CUDA is raised out of the
    soak; any other error of a scene is that seed's FAIL."""
    monkeypatch.setattr(soak_torch, "FAMILIES", {"pipeline": fault})
    if ends_run:
        with pytest.raises((RuntimeError, ValueError)) as info:
            soak_torch.soak(2, base, CPU, log=lambda s: None)
        assert soak_torch.kernel_fault(info.value)
        return
    s = soak_torch.soak(2, base, CPU, log=lambda s: None)
    assert s["counts"]["FAIL"] == 2
    assert s["non_pass"][0]["detail"].startswith("exception: ValueError")
