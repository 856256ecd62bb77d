"""Per-window checkpoint / resume.

The reference is a single-pass batch tool with no checkpointing — its
closest analog is manual region sharding via --region-file
(reference/README.md:154-161).  Long multi-hour WGS runs on shared
accelerator time want real resume, so `--checkpoint DIR` persists, per
window: the emitted VCF record text plus the tiny stitch-carry state the
NEXT window needs (stitch_pair reads only the boundary-read haps /
phase-sets / skip flags and a has-variants flag from the previous
window, core/pipeline.py:234-280).  A re-run with the same configuration
replays completed windows from disk byte-identically and computes only
the rest.  With phased-alignment output (-b/-C/-S, --refine-aln) the
finalized per-window read records are persisted too and replayed through
the same writer, so the resumed run's BAM/CRAM/SAM is byte-identical to
an uninterrupted run's.

Durability contract: each window is written to a temp file and
os.replace'd into place, so a file's presence == its completeness; a
kill at any point loses at most the in-flight windows.  meta.json pins
the run configuration — resuming with different inputs or gates is
refused instead of silently mixing outputs.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


class StitchCarry:
    """The slice of a WindowChunk that stitch_pair reads from `prev`."""
    __slots__ = ("tid", "down_ovlp_read_i", "is_skipped", "haps",
                 "phase_sets", "cand_vars")

    def __init__(self, tid, down_idx, is_skipped, haps, phase_sets,
                 has_vars):
        self.tid = int(tid)
        self.down_ovlp_read_i = list(range(len(down_idx)))
        self.is_skipped = is_skipped
        self.haps = haps
        self.phase_sets = phase_sets
        self.cand_vars = [0] if has_vars else []


def _opt_fingerprint(opt) -> dict:
    """Configuration fields that define the window plan and the output."""
    keys = ("ref_fa_fn", "in_bam_fns", "window_size", "shard",
            "is_pb_hifi", "is_ont", "out_somatic", "min_mq", "min_bq",
            "min_dp", "min_alt_dp", "min_af", "max_af", "min_sv_len",
            "sample_name", "refine_bam",
            # window-plan fields (plan_windows inputs): a different plan
            # means win_N indices address different genomic windows
            "regions", "reg_bed_fn", "only_autosome", "only_autosome_XY",
            "exc_tnames",
            # output-affecting extras
            "te_seq_fn", "out_amb_base",
            # phased-alignment output: payload presence/content must match
            # (refine_bam above already pins --refine-aln)
            "out_is_cram", "out_is_sam")
    fp = {}
    for k in keys:
        v = getattr(opt, k, None)
        fp[k] = list(v) if isinstance(v, (list, tuple)) else v
    # derived: whether per-window phased-read payloads are persisted —
    # a VCF-only checkpoint cannot be resumed into a -b run (the done
    # windows would have no reads to replay) and vice versa
    fp["write_bam"] = getattr(opt, "out_bam_fn", None) is not None
    return fp


class Checkpoint:
    """Window-granular VCF checkpoint under one directory."""

    def __init__(self, ckpt_dir: str, opt):
        self.dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        meta_fn = os.path.join(ckpt_dir, "meta.json")
        fp = _opt_fingerprint(opt)
        if os.path.exists(meta_fn):
            with open(meta_fn) as f:
                old = json.load(f)
            if old != fp:
                diffs = sorted(k for k in set(old) | set(fp)
                               if old.get(k) != fp.get(k))
                raise ValueError(
                    f"checkpoint dir {ckpt_dir!r} was written by a run with "
                    f"different configuration (differs: {', '.join(diffs)}); "
                    "use a fresh directory or matching options")
        else:
            tmp = meta_fn + ".tmp"
            with open(tmp, "w") as f:
                json.dump(fp, f, sort_keys=True)
            os.replace(tmp, meta_fn)
        self._done = {
            int(fn[4:-4]) for fn in os.listdir(ckpt_dir)
            if fn.startswith("win_") and fn.endswith(".npz")
            and fn[4:-4].isdigit()}

    def pin_window_plan(self, wins) -> None:
        """Refuse to resume against a DIFFERENT window plan: win_N.npz
        files address windows by position in the run's (post-busy-filter)
        window list, so if the emptiness scan degrades differently
        between runs (e.g. a transient index failure kept every window
        once), the same indices would mean different genomic windows —
        silently corrupting the resumed VCF.  The plan (count + hash of
        every window's coordinates) is pinned on first use and compared
        on resume."""
        import hashlib
        h = hashlib.sha256()
        for w in wins:
            h.update(f"{w.tid}:{w.beg}:{w.end}:{w.chunk_i}:{w.reg_i};"
                     .encode())
        plan = {"n_wins": len(wins), "wins_hash": h.hexdigest()}
        plan_fn = os.path.join(self.dir, "plan.json")
        if os.path.exists(plan_fn):
            with open(plan_fn) as f:
                old = json.load(f)
            if old != plan:
                raise ValueError(
                    f"checkpoint dir {self.dir!r} was written against a "
                    f"different window plan ({old['n_wins']} windows vs "
                    f"{plan['n_wins']} now; the emptiness filter may have "
                    "degraded differently) — use a fresh directory")
        else:
            tmp = plan_fn + ".tmp"
            with open(tmp, "w") as f:
                json.dump(plan, f)
            os.replace(tmp, plan_fn)

    def done(self, wi: int) -> bool:
        return wi in self._done

    def _path(self, wi: int) -> str:
        return os.path.join(self.dir, f"win_{wi}.npz")

    def save(self, wi: int, body: str, n_records: int, n_reads: int,
             chunk, bam_payloads=None) -> None:
        """Persist one completed window (chunk may be None: empty window).
        bam_payloads: finalized phased-read record bytes for -b/-C/-S runs
        (io.bam_writer.finalize_record output), replayed verbatim on
        resume."""
        arrs = {
            "body": np.frombuffer(body.encode(), dtype=np.uint8),
            "n_records": np.int64(n_records),
            "n_reads": np.int64(n_reads),
            "empty": np.bool_(chunk is None),
        }
        if bam_payloads is not None:
            blob = b"".join(bam_payloads)
            arrs["bam_blob"] = np.frombuffer(blob, dtype=np.uint8) \
                if blob else np.zeros(0, dtype=np.uint8)
            arrs["bam_lens"] = np.asarray([len(p) for p in bam_payloads],
                                          dtype=np.int64)
        if chunk is not None:
            down = np.asarray(chunk.down_ovlp_read_i, dtype=np.int64)
            arrs.update(
                tid=np.int64(chunk.tid),
                down_idx=down,
                skip=np.asarray(chunk.is_skipped, dtype=np.uint8)[down],
                haps=np.asarray(chunk.haps, dtype=np.int64)[down],
                ps=np.asarray(chunk.phase_sets, dtype=np.int64)[down],
                has_vars=np.bool_(len(chunk.cand_vars or []) > 0))
        tmp = self._path(wi) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, self._path(wi))
        self._done.add(wi)

    def load(self, wi: int) -> Tuple[str, int, int, Optional[StitchCarry]]:
        with np.load(self._path(wi)) as z:
            body = z["body"].tobytes().decode()
            n_records = int(z["n_records"])
            n_reads = int(z["n_reads"])
            if bool(z["empty"]):
                return body, n_records, n_reads, None
            carry = StitchCarry(int(z["tid"]), z["down_idx"],
                                z["skip"], z["haps"], z["ps"],
                                bool(z["has_vars"]))
        return body, n_records, n_reads, carry

    def save_procs_state(self, wi: int, body: str, n_records: int,
                         n_reads: int, state: Optional[dict]) -> None:
        """Procs-path save: the worker returns a boundary-state dict
        (pipeline._boundary_state) instead of a chunk; only the POST-flip
        "down" side is needed on resume (the next boundary's vote reads
        prev_state["down"]/"tid"/"has_cands" only) — the same fields the
        sequential save persists, so the npz schema is shared and a
        checkpoint written by either mode resumes under the other."""
        arrs = {
            "body": np.frombuffer(body.encode(), dtype=np.uint8),
            "n_records": np.int64(n_records),
            "n_reads": np.int64(n_reads),
            "empty": np.bool_(state is None),
        }
        if state is not None:
            skip, haps, ps = state["down"]
            arrs.update(
                tid=np.int64(state["tid"]),
                down_idx=np.arange(len(skip), dtype=np.int64),
                skip=np.asarray(skip, dtype=np.uint8),
                haps=np.asarray(haps, dtype=np.int64),
                ps=np.asarray(ps, dtype=np.int64),
                has_vars=np.bool_(bool(state["has_cands"])))
        tmp = self._path(wi) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, self._path(wi))
        self._done.add(wi)

    def load_procs_state(self, wi: int):
        """Procs-path load: (body, n_records, n_reads, state-dict | None);
        reads either mode's npz (the sequential save stores the same
        boundary fields)."""
        with np.load(self._path(wi)) as z:
            body = z["body"].tobytes().decode()
            n_records = int(z["n_records"])
            n_reads = int(z["n_reads"])
            if bool(z["empty"]):
                return body, n_records, n_reads, None
            state = {
                "tid": int(z["tid"]),
                "has_cands": bool(z["has_vars"]),
                "down": (np.asarray(z["skip"], dtype=np.uint8),
                         np.asarray(z["haps"], dtype=np.int8),
                         np.asarray(z["ps"], dtype=np.int64)),
                "up": (np.zeros(0, np.uint8), np.zeros(0, np.int8),
                       np.zeros(0, np.int64)),
            }
        return body, n_records, n_reads, state

    def resume_prefix(self) -> int:
        """Largest K with windows [0, K) all done — the procs-path resume
        point (the in-order consumer saves sequentially, so holes only
        appear from a foreign directory; anything past the first hole is
        recomputed)."""
        k = 0
        while k in self._done:
            k += 1
        return k

    def load_bam_payloads(self, wi: int) -> list:
        """The window's finalized phased-read records (possibly empty)."""
        with np.load(self._path(wi)) as z:
            if "bam_lens" not in z:
                return []
            blob = z["bam_blob"].tobytes()
            out, off = [], 0
            for ln in z["bam_lens"]:
                out.append(blob[off:off + int(ln)])
                off += int(ln)
        return out
