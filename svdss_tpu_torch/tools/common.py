"""What the scale tools share: the JAX repo's genome and read generators,
cached stages in a work directory under a scheme stamp, the report, the
host and card numbers every report carries, the oracle worker processes
and the kernels' least times."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..index.fmd import FMDIndex
from ..ops import anchor_wide_device as aw
from ..ops.anchor_wide import (AnchorIndexWide, NeedsFallback,
                               anchor_search_wide, make_heavy_resolver)

# the card's peak rates the kernel tables' bounds use (one H100 SXM)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations the work needs, counted from the recurrences: a
# rank step is 32 packed words x (xor, add, and-not, mask, popcount,
# accumulate) plus ~8 for the interval update; an anchor round's state
# machine outside its loops ~60, and a verify round 4 a compared symbol
# (two fetches, the compare, the loop test); a jump-table parent, at each
# endpoint, 32 packed words x 5 symbols x the rank step's 6, then 4
# children of ~8; a jump-mode lookup, the key at ~4 a symbol and the
# row's tests
OPS_PER_RANK_STEP = 32 * 6 + 8
OPS_PER_ANCHOR_ROUND = 60
OPS_PER_COMPARED_SYMBOL = 4
OPS_PER_KEY_SYMBOL = 4
OPS_PER_JUMP_PARENT = 2 * 32 * 5 * 6 + 4 * 8
# two-strand symbols from which `run` takes the wide anchor tables
# (cli._wide_anchor)
WIDE_BY_SIZE = 1_200_000_000

PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def need_native() -> None:
    """The native host library (built on first use by io/native.py): the
    host stages at genome scale run in it."""
    from ..io import native
    if native.load() is None:
        raise RuntimeError("the native host library did not build "
                           "(make -C native)")


# ------------------------------------------------------------ generators

def chrom_nt6(seed: int, n: int) -> np.ndarray:
    """One chromosome of uniform ACGT as nt6 codes 1..4 (the JAX repo's
    tools/giant_wide.py:105 and giant_validation.py:55)."""
    return np.random.default_rng(seed).integers(1, 5, n, dtype=np.uint8)


def forward_genome(chrom_mbp: int, n_chrom: int) -> np.ndarray:
    """Chromosomes chrom_nt6(1000 + i) joined by one 0 separator: the
    forward text of tools/giant_wide.py, filled in place."""
    L = chrom_mbp * 1_000_000
    text = np.zeros(n_chrom * (L + 1) - 1, dtype=np.uint8)
    for i in range(n_chrom):
        text[i * (L + 1):i * (L + 1) + L] = chrom_nt6(1000 + i, L)
    return text


def snv_reads(src: np.ndarray, n_reads: int, read_len: int, seed: int = 7,
              insertions: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """HiFi-like reads of `src`: uniform starts, 0.2% substitutions and,
    with `insertions`, a 100 bp novel insertion in ~30% of them. The
    generator of tools/giant_wide.py:146 gen_reads and
    giant_validation.py:97 (src = chromosome 1), and without insertions
    that of tools/repeat_validation.py:166 (src = the genome). Returns
    ([n, L + 1] uint8, [n] int32 lengths)."""
    rr = np.random.default_rng(seed)
    L = read_len
    reads = np.zeros((n_reads, L + 1), dtype=np.uint8)
    lens = np.full(n_reads, L, dtype=np.int32)
    starts = rr.integers(0, len(src) - L, n_reads)
    reads[:, :L] = src[starts[:, None] + np.arange(L)]
    cols = rr.integers(0, L, (n_reads, max(1, int(L * 0.002))))
    rows = np.repeat(np.arange(n_reads), cols.shape[1])
    reads[rows, cols.ravel()] = rr.integers(1, 5, cols.size)
    if insertions:
        for i in np.nonzero(rr.random(n_reads) < 0.3)[0]:
            at = int(rr.integers(200, L - 200))
            ins = rr.integers(1, 5, 100).astype(np.uint8)
            reads[i, at + 100:L] = reads[i, at:L - 100].copy()
            reads[i, at:at + 100] = ins
    return reads, lens


def mutate(rng: np.random.Generator, seq: np.ndarray,
           rate: float) -> np.ndarray:
    out = seq.copy()
    n = rng.binomial(len(seq), rate)
    if n:
        idx = rng.integers(0, len(seq), n)
        out[idx] = ((out[idx] - 1 + rng.integers(1, 4, n)) % 4) + 1
    return out


def build_repeat_genome(rng: np.random.Generator, n: int,
                        log=print) -> np.ndarray:
    """nt6 forward text of length ~n with planted repeat families (the
    generator of tools/repeat_validation.py:54, draw for draw): tandem
    satellite arrays of a 171 bp monomer (~3% of the bases), 5'-truncated
    LINE-like copies of a 6 kb consensus (~17%), SINE-like copies of a
    300 bp consensus (~10%), unique sequence between."""
    sat_mono = rng.integers(1, 5, 171, dtype=np.uint8)
    line_cons = rng.integers(1, 5, 6000, dtype=np.uint8)
    sine_cons = rng.integers(1, 5, 300, dtype=np.uint8)
    parts = []
    total = 0
    sat_bp = line_bp = sine_bp = 0
    while total < n:
        r = rng.random()
        if r < 0.00017:                    # satellite array (~3% of bp)
            copies = int(rng.integers(50, 2000))
            arr = [mutate(rng, sat_mono, rng.uniform(0.02, 0.08))
                   for _ in range(copies)]
            seg = np.concatenate(arr)
            sat_bp += len(seg)
        elif r < 0.184:                    # LINE-like (~17%)
            ln = min(6000, max(80, int(rng.exponential(900))))
            seg = mutate(rng, line_cons[-ln:], rng.uniform(0.08, 0.20))
            line_bp += len(seg)
        elif r < 0.697:                    # SINE-like (~10%)
            seg = mutate(rng, sine_cons[:int(rng.integers(80, 301))],
                         rng.uniform(0.05, 0.15))
            sine_bp += len(seg)
        else:                              # unique sequence
            seg = rng.integers(1, 5, int(rng.integers(500, 4000)),
                               dtype=np.uint8)
        parts.append(seg.astype(np.uint8))
        total += len(seg)
    text = np.concatenate(parts)[:n]
    log(f"[repeat] genome {len(text)} bp: satellite {sat_bp/n:.1%}, "
        f"LINE-like {line_bp/n:.1%}, SINE-like {sine_bp/n:.1%}")
    return text


# --------------------------------------------------------- cached stages

class StaleArtifact(RuntimeError):
    """A cached artifact was built under another generation scheme."""


class Workdir:
    """A tool's cached stages. Artifact `name` is complete when its stamp
    (`name`.scheme.json, written after it) exists: a stamp equal to the
    scheme it is asked under makes it reusable, a different one is refused
    (StaleArtifact: delete it or pick another --workdir), and an artifact
    without a stamp is unfinished and built again."""

    def __init__(self, path: str, scheme: dict):
        self.root = path
        self.scheme = scheme
        os.makedirs(path, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def ready(self, name: str, scheme: Optional[dict] = None) -> bool:
        want = self.scheme if scheme is None else scheme
        sp = self.path(name) + ".scheme.json"
        if not os.path.exists(sp):
            return False
        with open(sp) as f:
            got = json.load(f)
        if got != want:
            raise StaleArtifact(
                f"{self.path(name)} was built under another scheme ({got} "
                f"!= {want}); delete it or pass another --workdir")
        return os.path.exists(self.path(name))

    def stamp(self, name: str, scheme: Optional[dict] = None) -> None:
        with open(self.path(name) + ".scheme.json", "w") as f:
            json.dump(self.scheme if scheme is None else scheme, f)


def save_arrays(path: str, arrays: Dict[str, np.ndarray],
                meta: dict) -> None:
    """A directory of .npy files (one an array, so a worker can map them
    read-only) plus meta.json, written to a temporary name and moved."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, a in arrays.items():
        np.save(os.path.join(tmp, name + ".npy"), a)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_arrays(path: str, mmap: bool = True
                ) -> Tuple[Dict[str, np.ndarray], dict]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrays = {f[:-4]: np.load(os.path.join(path, f),
                              mmap_mode="r" if mmap else None)
              for f in os.listdir(path) if f.endswith(".npy")}
    return arrays, meta


_WIDE_OPTIONAL = ("leftidx", "heavy_keys", "heavy_offs", "heavy_poslist",
                  "heavy_leftperm")


def save_wide(path: str, widx: AnchorIndexWide) -> None:
    """Wide tables without their text (the genome artifact holds it)."""
    arrays = {"cnts": widx.cnts, "aux": widx.aux, "poslist": widx.poslist}
    arrays.update({f"level_{j}": bm for j, bm in widx.levels.items()})
    arrays.update({f: getattr(widx, f) for f in _WIDE_OPTIONAL
                   if getattr(widx, f) is not None})
    save_arrays(path, arrays, {
        "k": widx.k, "j0": widx.j0, "cmax": widx.cmax,
        "heavy_rate": widx.heavy_rate, "right_sorted": widx.right_sorted,
        "levels": sorted(int(j) for j in widx.levels)})


def load_wide(path: str, text: np.ndarray,
              mmap: bool = True) -> AnchorIndexWide:
    a, m = load_arrays(path, mmap)
    return AnchorIndexWide(
        text=text, k=m["k"], j0=m["j0"], cnts=a["cnts"], aux=a["aux"],
        poslist=a["poslist"],
        levels={j: a[f"level_{j}"] for j in m["levels"]}, cmax=m["cmax"],
        heavy_rate=m["heavy_rate"], right_sorted=m["right_sorted"],
        **{f: a[f] for f in _WIDE_OPTIONAL if f in a})


def save_fmd(path: str, index: FMDIndex) -> None:
    save_arrays(path, {"C": index.C, "occ": index.occ,
                       "bwt_words": index.bwt_words}, {"n": index.n})


def load_fmd(path: str, mmap: bool = True) -> FMDIndex:
    a, m = load_arrays(path, mmap)
    return FMDIndex.from_parts(m["n"], np.asarray(a["C"]), a["occ"],
                               a["bwt_words"])


# ----------------------------------------------------------------- report

class Report(dict):
    """The tool's report, rewritten whole (through a temporary file) at
    every flush, so the numbers of finished stages survive a cut run. A
    report already at `path` is read first: a resumed run adds to it."""

    def __init__(self, path: str, fresh: Dict):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                self.update(json.load(f))
        self.update(fresh)
        self.setdefault("stages", {})

    def flush(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self, f, indent=1)
        os.replace(tmp, self.path)


def rss_gib() -> float:
    """The process's resident memory, GiB: /proc/self/statm, else VmRSS of
    /proc/self/status, else (where /proc has neither) the high-water
    mark so far."""
    try:
        with open("/proc/self/statm") as f:
            return (int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
                    / 2 ** 30)
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2 ** 20
    except (OSError, ValueError, IndexError):
        pass
    return process_peak_rss_gib()


def process_peak_rss_gib() -> float:
    """The process's resident-memory high-water mark so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


class RssSampler:
    """The largest resident memory seen over a stage, sampled every
    `period` seconds by a thread (not every /proc lets a process reset
    its high-water mark, and some have none)."""

    def __init__(self, period: float = 0.05):
        self.period = period
        self.peak = rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, rss_gib())

    def __enter__(self) -> "RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_gib())


@contextlib.contextmanager
def stage(report: Report, name: str, log=print):
    """Time a host stage and record its seconds, the peak resident memory
    sampled over it and the process's high-water mark so far in
    report["stages"][name]; flush the report after it."""
    t0 = time.time()
    log(f"[{name}] ...")
    with RssSampler() as rss:
        yield
    rec = {"s": time.time() - t0, "peak_rss_gib": rss.peak,
           "process_peak_rss_gib": process_peak_rss_gib()}
    report["stages"][name] = rec
    log(f"[{name}] {rec['s']:.1f}s, peak RSS {rec['peak_rss_gib']:.2f} GiB")
    report.flush()


def _cmd(argv: List[str]) -> str:
    try:
        return subprocess.run(argv, capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable: {exc}"


def host_info(workdir: str) -> dict:
    """The host's memory (free -g), cores (nproc) and the work directory's
    disk (df -h)."""
    return {"free_g": _cmd(["free", "-g"]), "nproc": _cmd(["nproc"]),
            "df_h_workdir": _cmd(["df", "-h", workdir])}


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(dev),
            "gpu": _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"])}


NOT_MEASURED = "not measured"


def device_number(dev: torch.device, name: str, value) -> dict:
    """{name: value} for a number taken on the card ("not measured" where
    it gave none: value None); from a CPU run {name: "not measured",
    "cpu_" + name: value}, so that no CPU number stands under a device
    metric's name."""
    if dev.type == "cuda":
        return {name: NOT_MEASURED if value is None else value}
    return {name: NOT_MEASURED, "cpu_" + name: value}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls of fn on the card, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least time of a kernel: the larger of its bytes over the HBM
    rate and its integer operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fm_bytes_ops(index, lens, steps: int, n_sfs, jump_table=None,
                 jump_rows: int = 0, k: int = 0) -> Tuple[int, int]:
    """(bytes, operations) the FM search (K2) of the reads `lens` needs:
    each read's symbols, its sentinel and its length once, a 192 B fused
    row a rank step (at most the table), with jumps 16 B a table row read
    (at most the table), 8 B an emission written and the per-lane results;
    200 operations a rank step and k x 4 + 8 a jump-table row."""
    Q = lens.numel()
    nbytes = (int((lens.long() + 1).sum()) + 4 * Q
              + min(index.fused.numel() * 4, 192 * steps)
              + (min(jump_table.numel() * 4, 16 * jump_rows)
                 if jump_table is not None else 0)
              + 8 * int(n_sfs.sum()) + 6 * Q + 4)
    return nbytes, (steps * OPS_PER_RANK_STEP
                    + jump_rows * (k * OPS_PER_KEY_SYMBOL + 8))


def jump_table_work(index, k: int) -> Tuple[int, Dict[str, int]]:
    """What K6 reads building the k-mer table: the fused rows its levels
    touch (each counted once; a parent reads its rows at lo = x0 and
    hi = x0 + size, row 0 when absent), and its parents by kind (absent,
    both ends in one row, in two rows), from the plain levels."""
    from ..ops import fmd
    touched = torch.zeros(index.fused.shape[0], dtype=torch.bool,
                          device=index.device)
    rows = fmd.level_one(index)
    kinds = {"absent": 0, "one_row": 0, "two_rows": 0}
    for _ in range(1, k):
        live = rows[:, 2] > 0
        lo = torch.where(live, rows[:, 0], 0)
        hi = lo + torch.where(live, rows[:, 2], 0)
        touched[(lo >> 7).long()] = True
        touched[(hi >> 7).long()] = True
        one = live & ((lo >> 7) == (hi >> 7))
        kinds["absent"] += int((~live).sum())
        kinds["one_row"] += int(one.sum())
        kinds["two_rows"] += int((live & ~one).sum())
        rows = fmd.jump_level_plain(index, rows)
    return int(touched.sum()), kinds


def jump_bytes_ops(index, k: int, rows_touched: int, parents: int
                   ) -> Tuple[int, int]:
    """(bytes, operations) of K6's table: the rows its levels touch, C and
    the table written once; 1,952 operations a parent."""
    return (192 * rows_touched + 4 * 8 + 16 * 4 ** k,
            parents * OPS_PER_JUMP_PARENT)


def anchor_bytes_ops(didx, lens_t, work, n_sfs, scalars: int):
    """(bytes, operations) the narrow anchor work (K3, K4) of the reads
    `lens_t` needs: each read's symbols and length once, the table rows
    (16 B) and text rows (64 B) its rounds touched (each up to its table),
    the emissions written (8 B each; the zeroed rest of each [cap] row is
    left out, nothing reads it) and `scalars` bytes of per-read results;
    60 operations a round and 4 a compared symbol. `work` holds the
    WORK_FIELDS counts."""
    rounds, rows, text_rows, syms = work
    nbytes = (int((lens_t.long() + 1).sum()) + 4 * lens_t.numel()
              + min(didx.small.numel() * 4, 16 * rows)
              + min(didx.text_words.numel() * 4, 64 * text_rows)
              + 8 * int(n_sfs.sum()) + scalars)
    return nbytes, (rounds * OPS_PER_ANCHOR_ROUND
                    + syms * OPS_PER_COMPARED_SYMBOL)


def wide_bytes_ops(didx, lens_t, work, emitted: int) -> Tuple[int, int]:
    """(bytes, operations) the wide anchor work (K5) of the reads `lens_t`
    needs: each read's symbols and length once, its lane state read and
    written back, a 32-bit word a table row read (at most the tables),
    2 bits a compared text symbol and a badrow word a text row (at most
    the text), 8 B an emission written and the round count; 60 operations
    a round and 4 a compared symbol. `work` holds the WORK_FIELDS counts,
    `emitted` the emissions."""
    rounds, rows, text_rows, syms = work
    Q = lens_t.numel()
    tables = sum(t.numel() * 4 for t in (didx.ct, didx.aux, didx.pospairs,
                                         didx.bms, didx.lperm))
    text = (didx.text2.numel() + didx.badrow.numel()) * 4
    nbytes = (int((lens_t.long() + 1).sum()) + 4 * Q
              + 2 * 4 * len(aw.STATE) * Q + min(tables, 4 * rows)
              + min(text, -(-syms // 4) + 4 * text_rows) + 8 * emitted + 4)
    return nbytes, (rounds * OPS_PER_ANCHOR_ROUND
                    + syms * OPS_PER_COMPARED_SYMBOL)


# ------------------------------------------------------------- the oracle

def read_oracle(root: str) -> Dict[int, Optional[list]]:
    """Every oracle line under `root` (oracle.*.jsonl): read index -> its
    SFS list, or None where the oracle itself needs the fallback."""
    got: Dict[int, Optional[list]] = {}
    if not os.path.isdir(root):
        return got
    for f in sorted(os.listdir(root)):
        if f.startswith("oracle.") and f.endswith(".jsonl"):
            with open(os.path.join(root, f)) as fh:
                for line in fh:
                    if line.endswith("\n"):          # a whole line
                        i, want = json.loads(line)
                        got[int(i)] = None if want is None else \
                            [tuple(p) for p in want]
    return got


def oracle_lines(root: str, a: int, b: int, reads: Iterable[int], fn,
                 log=print) -> None:
    """Worker side: run `fn(i)` (a list of pairs, or None) for each read i
    of [a, b) not yet under `root`, one flushed JSON line each."""
    done = read_oracle(root)
    t0 = time.time()
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"oracle.{a}-{b}.jsonl"), "a") as f:
        for i in reads:
            if a <= i < b and i not in done:
                f.write(json.dumps([int(i), jsonable(fn(i))]) + "\n")
                f.flush()
    log(f"[oracle] reads [{a},{b}) in {time.time() - t0:.0f}s")


def wide_oracle(widx: AnchorIndexWide, reads: np.ndarray, L: int):
    """The wide host oracle with the heavy-k-mer resolver, read i ->
    its SFS list, or None where the oracle itself needs the fallback."""
    resolver = make_heavy_resolver(widx)

    def fn(i):
        try:
            return anchor_search_wide(widx, reads[i, :L], resolver=resolver)
        except NeedsFallback:
            return None
    return fn


def oracle_beside(wd: Workdir, scheme: dict, module: str, argv: List[str],
                  todo: Iterable[int], workers: int, device_fn) -> dict:
    """Start the oracle workers on the reads of `todo` not yet answered
    under wd/oracle, run the device stage `device_fn()` beside them (its
    dump cached as device.json) and wait for them; the dump."""
    done = read_oracle(wd.path("oracle")) if wd.ready("oracle", scheme) \
        else {}
    if not done:
        os.makedirs(wd.path("oracle"), exist_ok=True)
        wd.stamp("oracle", scheme)
    procs = start_oracle_workers(module, argv,
                                 [i for i in todo if i not in done], workers)
    try:
        if wd.ready("device.json", scheme):
            with open(wd.path("device.json")) as f:
                dump = json.load(f)
        else:
            dump = device_fn()
            with open(wd.path("device.json"), "w") as f:
                json.dump(dump, f)
            wd.stamp("device.json", scheme)
    except BaseException:
        wait_workers(procs, kill=True)
        raise
    rcs = wait_workers(procs)
    if any(rcs):
        raise RuntimeError(f"oracle workers failed: {rcs}")
    return dump


def hold_against_oracle(wd: Workdir, got: list, flagged: Iterable[int],
                        fn, verify: int) -> Tuple[int, int, int]:
    """The device's reads in order, the `flagged` ones (redone on the host)
    skipped, against the oracle's lines under wd/oracle (the missing ones
    answered here by `fn` and added), until `verify` are checked:
    (checked, mismatches, reads the oracle itself sends to the
    fallback)."""
    flagged = set(flagged)
    want = read_oracle(wd.path("oracle"))
    checked = mism = oracle_fb = 0
    with open(os.path.join(wd.path("oracle"), "oracle.main.jsonl"),
              "a") as fh:
        for i in range(len(got)):
            if checked >= verify:
                break
            if i in flagged:
                continue
            if i not in want:
                want[i] = fn(i)
                fh.write(json.dumps([i, jsonable(want[i])]) + "\n")
            if want[i] is None:
                oracle_fb += 1
                continue
            checked += 1
            mism += [tuple(p) for p in got[i]] != want[i]
    return checked, mism, oracle_fb


def jsonable(lists):
    """SFS pairs (or None) with plain ints, for JSON."""
    return None if lists is None else [[int(a), int(b)] for a, b in lists]


def start_oracle_workers(module: str, argv: List[str], todo: List[int],
                         workers: int) -> List[subprocess.Popen]:
    """Start up to `workers` processes of `python -m module argv
    --oracle-only A:B` over contiguous slices of `todo` (sorted read
    indices), so the oracle runs beside the device stage."""
    todo = sorted(todo)
    if not todo or workers < 1:
        return []
    env = dict(os.environ)
    env["PYTHONPATH"] = PKG_PARENT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = []
    for part in np.array_split(np.asarray(todo), min(workers, len(todo))):
        a, b = int(part[0]), int(part[-1]) + 1
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--oracle-only",
             f"{a}:{b}"], env=env))
    return procs


def wait_workers(procs: List[subprocess.Popen], kill: bool = False
                 ) -> List[int]:
    """Wait for the workers (ending them first with `kill`); their exit
    codes."""
    if kill:
        for p in procs:
            p.kill()
    return [p.wait() for p in procs]


def result_lists(res) -> Tuple[list, np.ndarray]:
    """A PingPongResult's per-lane SFS lists and its fallback flags
    (overflow | incomplete) on the host."""
    qs, ln = res.qs.cpu().numpy(), res.length.cpu().numpy()
    n = res.n_sfs.cpu().numpy()
    bad = (res.overflow | res.incomplete).cpu().numpy()
    return [list(zip(qs[i, :n[i]].tolist(), ln[i, :n[i]].tolist()))
            for i in range(len(n))], bad


def k5_oneshot(didx, params, seqs, lens, cap: int, dev):
    """Kernel K5 on its own, one shot (no waves) on one batch: (record,
    per-lane SFS lists, fallback flags). The record has the launches, the
    slowest lane's rounds, the work counts, the time (CUDA events, mean of
    3 after a warm-up; on the CPU the plain version's seconds, under
    another name) and the least time of that work (wide_bytes_ops)."""
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    l0 = aw.launches
    t0 = time.time()
    res = aw.batch_search_anchor_wide(didx, params, seqs, lens, cap=cap,
                                      work=work)
    sync(dev)
    out = {"shape": f"Q={seqs.shape[0]} L+1={seqs.shape[1]} cap={cap}",
           "launches": aw.launches - l0, "iters": int(res.iters),
           "work": dict(zip(aw.WORK_FIELDS, work.tolist()))}
    if dev.type == "cuda":
        out["k5_ms"] = event_ms(lambda: aw.batch_search_anchor_wide(
            didx, params, seqs, lens, cap=cap), 3)
        out["us_per_round"] = out["k5_ms"] * 1e3 / max(1, out["iters"])
    else:
        out["plain_s_cpu"] = time.time() - t0
    nbytes, ops = wide_bytes_ops(didx, lens, list(out["work"].values()),
                                 int(res.n_sfs.sum()))
    out["bound_bytes"] = nbytes
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops)
    lists, bad = result_lists(res)
    return out, lists, bad
