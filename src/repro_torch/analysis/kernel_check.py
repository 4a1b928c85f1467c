"""flashprove pass 2: the kernels' resources, the port's counterpart of
`repro.analysis.pallas_check`.

The wrappers pick each kernel's instance at run time (`forward_instance`,
`pass_instance`, the backtrack's plan), and a launch whose dynamic shared
memory exceeds the card's opt-in limit fails on the card long after the
planner said yes.  This pass makes that a gate failure instead, for every
kernel entry the decode stack reaches:

  * **Shared memory (PV202).**  For each of the nine entries, at every K
    the planner serves (`SERVED_K`, every K up to the wrappers' limit with
    ``deep``), the instance the wrapper would pick and the bytes a block of
    it asks for, against `SMEM_BYTES` (227 KB, the card's opt-in limit).
    There is no nvcc here, so the bytes come from a Python mirror of the
    layout arithmetic in ``csrc/cluster.cuh``, ``csrc/viterbi_dp.cu`` and
    ``csrc/beam_stream.cu`` (its constants read from the sources); on the
    card `check_mirror` holds the mirror equal to the C entries
    ``viterbi_fwd_smem_bytes``, ``beam_pass_smem_bytes`` and
    ``viterbi_backtrack_plan`` at every K it is given.

  * **Spills (PV201).**  ptxas's ``-v`` report (the log `kernels.build`
    returns) gives every kernel instance's registers and spill bytes; a
    spill store or load above 0 is a finding.  Without a log (the CPU) the
    check is listed as skipped.

`harvest_kernels` is the counterpart of `harvest_pallas_calls`: for each of
the nine entries, its instance and shared bytes at a K, and its registers
and spills read back from a ptxas log.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from pathlib import Path

from .findings import Finding, ProveReport

__all__ = [
    "SMEM_BYTES", "ENTRIES", "SERVED_K", "BEAM_WIDTHS", "BEAM_BOOKS",
    "HARVEST_K",
    "constants", "fwd_smem_bytes", "forward_instance", "band_smem_bytes",
    "band_instance", "backtrack_plan", "backtrack_smem_bytes",
    "beam_smem_bytes", "beam_instance", "tropical_smem_bytes",
    "parse_ptxas", "KernelResources", "harvest_kernels", "check_mirror",
    "check_forced_instance", "check_kernels", "beam_max_k",
]

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

#: the nine C entries, each with the kernel template its instances come
#: from and, for the beam template, the MODE its instances carry
ENTRIES: dict[str, tuple[str, int | None]] = {
    "viterbi_fwd_batch": ("viterbi_fwd_cluster_kernel", None),
    "viterbi_fwd_batch_masked": ("viterbi_fwd_cluster_kernel", None),
    "viterbi_banded_fwd": ("viterbi_banded_cluster_kernel", None),
    "viterbi_backtrack_batch": ("viterbi_backtrack_cluster_kernel", None),
    "beam_step_batch": ("beam_pass_kernel", 0),
    "bs_initial_pass_batch": ("beam_pass_kernel", 1),
    "bs_segment_decode_batch": ("beam_pass_kernel", 2),
    "bs_chunk_batch": ("beam_pass_kernel", 3),
    "tropical_matmul_batch": ("tropical_tile_kernel", None),
}

#: the K the planner serves in the default tier: the repo's workloads
#: (map matching's 193 and 1024, the alignment heads' 504, the serve's
#: 512), the forward template's instance boundary (665 / 672) and the
#: kernels' edges; ``deep`` walks every K up to the wrappers' limit
SERVED_K: tuple[int, ...] = (1, 2, 3, 8, 16, 24, 64, 100, 128, 193, 200,
                             256, 384, 504, 512, 665, 672, 1000, 1024, 1500,
                             2048, 4096, 8192, 16384, 29055, 29056)
#: the beam widths the planner's ladder and the specs' defaults reach
BEAM_WIDTHS: tuple[int, ...] = (16, 32, 64, 128, 256)
#: bookkeeping words a beam slot carries: the initial pass's P - 1 division
#: states (P in the planner's 16, 8, 4, 1), a tile's midpoint, none
BEAM_BOOKS: tuple[int, ...] = (15, 7, 3, 1, 0)
#: backtrack lengths checked at each K
BACKTRACK_T: tuple[int, ...] = (1, 2, 511, 4095)
#: the K `harvest_kernels` reads each entry at: the serve deployment's
HARVEST_K = 512


@functools.lru_cache(maxsize=None)
def constants() -> dict[str, int]:
    """The layout constants, read from the CUDA sources."""
    def grab(path: Path, name: str) -> int:
        m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;",
                      path.read_text())
        if m is None:
            raise ValueError(f"{path.name}: no constexpr {name}")
        return int(m.group(1))

    cl, dp, bs, tr = (CSRC / n for n in ("cluster.cuh", "viterbi_dp.cu",
                                         "beam_stream.cu", "tropical.cu"))
    return {"kCluster": grab(cl, "kCluster"),
            "kFwdThreads": grab(dp, "kFwdThreads"),
            "kSmemBytes": grab(dp, "kSmemBytes"),
            "kBtThreads": grab(dp, "kBtThreads"),
            "kBtMaxSub": grab(dp, "kBtMaxSub"),
            "kBeamThreads": grab(bs, "kThreads"),
            "kTile": grab(tr, "kTile"), "kChunk": grab(tr, "kChunk"),
            # kARow = kChunk + pad: A rows padded to a 16-byte multiple
            "kARow": grab(tr, "kChunk") + int(re.search(
                r"kARow\s*=\s*kChunk\s*\+\s*(\d+)\s*;",
                tr.read_text()).group(1))}


#: a block's shared memory on the card (227 KB), as the sources declare it
SMEM_BYTES = 232448
_INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# The mirror of the layout arithmetic (csrc/cluster.cuh and the two .cu files)
# ---------------------------------------------------------------------------

def _cols_per_cta(K: int) -> int:
    c = constants()["kCluster"]
    return (K + c - 1) // c


def _lane_width(W: int, threads: int) -> int:
    w = (max(W, 1) + 31) // 32 * 32
    return min(w, threads)


def _align4(words: int) -> int:
    return (words + 3) // 4 * 4


def _cluster_words(K: int, slice_: int, mbars: int) -> int:
    threads = constants()["kFwdThreads"]
    W = _cols_per_cta(K)
    parts = threads // _lane_width(W, threads)
    partial = parts * W if parts > 1 else 0
    o = _align4(slice_)
    o = _align4(o + 2 * K)
    o = _align4(o + partial)
    o = _align4(o + partial)
    return _align4(o + 2 * mbars)


def _clamp(nbytes: int) -> int:
    return min(nbytes, _INT_MAX)


def fwd_smem_bytes(K: int, resident: bool) -> int:
    """`viterbi_fwd_smem_bytes(K, resident)`: a forward block's bytes."""
    slice_ = K * _cols_per_cta(K) if resident else 0
    return _clamp(4 * _cluster_words(K, slice_, 0))


def forward_instance(K: int) -> str:
    """`viterbi_dp.forward_instance`: "resident" if the column slice fits."""
    return "resident" if fwd_smem_bytes(K, True) <= SMEM_BYTES else "global"


def band_smem_bytes(Kb: int, mbars: bool) -> int:
    return 4 * _cluster_words(Kb, 0, 2 if mbars else 0)


def band_instance(Kb: int) -> tuple[str, int]:
    """The banded entry's instance over a Kb-wide window and its bytes:
    "mbarrier" (every CTA owns columns and the mbarriers fit) or
    "barrier" (a cluster barrier a step)."""
    W = _cols_per_cta(Kb)
    all_own = (Kb + W - 1) // W == constants()["kCluster"]
    with_mbars = band_smem_bytes(Kb, True)
    if all_own and with_mbars <= SMEM_BYTES:
        return "mbarrier", with_mbars
    return "barrier", band_smem_bytes(Kb, False)


def _bt_words(T: int, K: int, staged: bool, sub: int) -> int:
    warps = constants()["kBtThreads"] // 32
    R = (T + constants()["kCluster"] - 1) // constants()["kCluster"]
    o = _align4(R * K + 3 if staged else 0)
    o = _align4(o + sub * K)
    o = _align4(o + (K if sub > 1 else 0))
    return _align4(o + 2 * warps + 1)


def backtrack_plan(T: int, K: int) -> tuple[bool, int]:
    """`bt_plan`: (psi rows staged, sub-blocks a CTA)."""
    R = (T + constants()["kCluster"] - 1) // constants()["kCluster"]
    most = 1
    while 2 * most <= constants()["kBtMaxSub"] and 2 * most <= R:
        most *= 2
    s = most
    while s >= 1:
        if 4 * _bt_words(T, K, True, s) <= SMEM_BYTES:
            return True, s
        s //= 2
    s = most
    while s > 1:
        if 4 * _bt_words(T, K, False, s) <= SMEM_BYTES:
            return False, s
        s //= 2
    return False, 1


def backtrack_smem_bytes(T: int, K: int) -> int:
    staged, sub = backtrack_plan(T, K)
    return 4 * _bt_words(T, K, staged, sub)


def beam_smem_bytes(K: int, B: int, book: int, resident: bool) -> int:
    """`beam_pass_smem_bytes(K, B, book, resident)`."""
    c = constants()
    threads = c["kBeamThreads"]
    W = _cols_per_cta(K)
    parts = threads // _lane_width(W, threads)
    cols = (book + c["kCluster"] - 1) // c["kCluster"]
    o = _align4(K * W if resident else 0)
    o = _align4(o + 8 * B)
    o = _align4(o + 2 * c["kCluster"] * W)
    o = _align4(o + 2 * W)
    o = _align4(o + W)
    o = _align4(o + W)
    o = _align4(o + W)
    o = _align4(o + parts * W)
    o = _align4(o + parts * W)
    o = _align4(o + 2 * cols * B)
    o = _align4(o + cols)
    return _clamp(4 * o)


def beam_instance(K: int, B: int, book: int, mode: int) -> tuple[str, int]:
    """The beam template's instance a launch takes and its bytes; the single
    step (mode 0) always reads log_A from L2."""
    if mode != 0 and beam_smem_bytes(K, B, book, True) <= SMEM_BYTES:
        return "resident", beam_smem_bytes(K, B, book, True)
    return "global", beam_smem_bytes(K, B, book, False)


def tropical_smem_bytes() -> int:
    """The tropical kernel's static shared memory: two stages of a
    (kTile x kARow) A tile and a (kChunk x kTile) B tile."""
    c = constants()
    return 2 * (c["kTile"] * c["kARow"] + c["kChunk"] * c["kTile"]) * 4


# ---------------------------------------------------------------------------
# ptxas's report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One kernel instance as ptxas reports it."""
    kernel: str              # the template's name
    args: tuple[str, ...]    # its template arguments, e.g. ("0", "1")
    registers: int
    spill_stores: int
    spill_loads: int
    static_smem: int

    @property
    def instance(self) -> str:
        return f"{self.kernel}<{','.join(self.args)}>"


_ENTRY = re.compile(r"Compiling entry function '(?P<name>[^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_TARG = re.compile(r"L[bi](\d+)E|I13__nv_bfloat16|If")


def _demangle(name: str) -> tuple[str, tuple[str, ...]]:
    """(template name, template arguments) of a mangled kernel name."""
    for kernel, _ in ENTRIES.values():
        i = name.find(kernel)
        if i >= 0:
            tail = name[i + len(kernel):]
            args = []
            for m in _TARG.finditer(tail.split("EEEv")[0] + "EE"):
                tok = m.group(0)
                args.append(m.group(1) if m.group(1) is not None else
                            "bf16" if "bfloat16" in tok else "f32")
            return kernel, tuple(args)
    return name, ()


def parse_ptxas(log: str) -> list[KernelResources]:
    """Every kernel instance in a ptxas ``-v`` log, in order."""
    out: list[KernelResources] = []
    cur = None
    regs = spill = smem = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            if cur is not None and regs is not None:
                out.append(KernelResources(*cur, regs, *spill, smem or 0))
            cur, regs, spill, smem = _demangle(m.group("name")), None, (0, 0), 0
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m:
            regs = int(m.group(1))
            s = _SMEM.search(line)
            smem = int(s.group(1)) if s else 0
    if cur is not None and regs is not None:
        out.append(KernelResources(*cur, regs, *spill, smem or 0))
    return out


def _instances_of(entry: str, found: list[KernelResources]
                  ) -> list[KernelResources]:
    kernel, mode = ENTRIES[entry]
    out = [r for r in found if r.kernel == kernel]
    if mode is not None:
        out = [r for r in out if r.args and r.args[0] == str(mode)]
    if entry == "viterbi_fwd_batch":      # HAS_T = HAS_S = false only
        out = [r for r in out if r.args[:2] == ("0", "0")]
    return out


def _entry_instance(entry: str, K: int, B: int = 128, book: int = 7,
                    T: int = 511) -> tuple[str, int]:
    """(instance, shared bytes a block) of `entry` at K states, as its
    wrapper would pick it."""
    if entry in ("viterbi_fwd_batch", "viterbi_fwd_batch_masked"):
        inst = forward_instance(K)
        return inst, fwd_smem_bytes(K, inst == "resident")
    if entry == "viterbi_banded_fwd":
        return band_instance(K)
    if entry == "viterbi_backtrack_batch":
        staged, sub = backtrack_plan(T, K)
        return (f"{'staged' if staged else 'global'}, {sub} sub-blocks",
                backtrack_smem_bytes(T, K))
    if entry == "tropical_matmul_batch":
        return "static", tropical_smem_bytes()
    mode = ENTRIES[entry][1]
    book = {0: 0, 1: book, 2: 1, 3: 0}[mode]
    return beam_instance(K, min(B, K), book, mode)


def harvest_kernels(log: str | None = None) -> dict[str, dict]:
    """For each of the nine entries: its instance and shared bytes a block
    at the serve's K = `HARVEST_K` (B = 128 and P = 8 for the beam passes,
    T = 511 for the backtrack), and, from a ptxas log, the most registers
    and spill bytes over its instances (None without a log)."""
    K = HARVEST_K
    found = parse_ptxas(log) if log else []
    out = {}
    for entry in ENTRIES:
        inst, smem = _entry_instance(entry, K)
        rs = _instances_of(entry, found)
        out[entry] = {
            "K": K, "instance": inst, "smem_bytes": smem,
            "registers": max((r.registers for r in rs), default=None),
            "spill_bytes": (sum(r.spill_stores + r.spill_loads for r in rs)
                            if rs else None),
            "instances": [r.instance for r in rs],
        }
    return out


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def check_mirror(lib_dp, lib_bs, ks) -> list[str]:
    """Hold the mirror equal to the C entries of the loaded libraries at
    every K in `ks`; returns the disagreements (empty when they agree)."""
    bad = []
    for K in ks:
        for r in (0, 1):
            c, py = lib_dp.viterbi_fwd_smem_bytes(K, r), fwd_smem_bytes(K, r)
            if c != py:
                bad.append(f"viterbi_fwd_smem_bytes({K}, {r}) = {c}, mirror "
                           f"{py}")
        for T in BACKTRACK_T:
            staged, sub = backtrack_plan(T, K)
            c, py = lib_dp.viterbi_backtrack_plan(T, K), 2 * sub + staged
            if c != py:
                bad.append(f"viterbi_backtrack_plan({T}, {K}) = {c}, mirror "
                           f"{py}")
        for B in sorted({min(b, K) for b in BEAM_WIDTHS + (K,)}):
            for book in BEAM_BOOKS:
                for r in (0, 1):
                    c = lib_bs.beam_pass_smem_bytes(K, B, book, r)
                    py = beam_smem_bytes(K, B, book, r)
                    if c != py:
                        bad.append(f"beam_pass_smem_bytes({K}, {B}, {book}, "
                                   f"{r}) = {c}, mirror {py}")
    return bad


def _pv202(report: ProveReport, subject: str, smem: int, what: str) -> None:
    if smem > SMEM_BYTES:
        report.findings.append(Finding(
            "PV202", subject,
            f"{what} asks for {smem:,}B of shared memory a block, over the "
            f"card's {SMEM_BYTES:,}B"))


def check_forced_instance(K: int, resident: bool) -> list[Finding]:
    """PV202 for a forward launch forced into one instance at K (what the
    wrapper's choice guards against)."""
    report = ProveReport()
    inst = "resident" if resident else "global"
    _pv202(report, f"kernel:viterbi_fwd_batch[K={K},{inst}]",
           fwd_smem_bytes(K, resident), f"the {inst} forward instance")
    return report.findings


def check_kernels(log: str | None = None, quick: bool = False,
                  deep: bool = False) -> ProveReport:
    """PV202 over every entry at every served K; PV201 from a ptxas log.

    ``quick`` checks the serve's K alone, ``deep`` every K from 1 to the
    wrappers' limit (`viterbi_dp.MAX_K`).  The beam passes are checked at
    the planner's beam widths and bookkeeping; above `beam_max_k` their
    wrapper refuses the launch (`beam_stream.pass_instance` raises), which
    the report lists under ``skipped`` rather than passing silently.
    """
    from ..kernels.viterbi_dp import MAX_K, SMEM_BYTES as WRAPPER_SMEM

    report = ProveReport()
    if WRAPPER_SMEM != SMEM_BYTES or constants()["kSmemBytes"] != SMEM_BYTES:
        report.findings.append(Finding(
            "PV202", "kernel:limits",
            f"SMEM_BYTES disagree: analysis {SMEM_BYTES}, wrapper "
            f"{WRAPPER_SMEM}, viterbi_dp.cu {constants()['kSmemBytes']}"))
    ks = ((HARVEST_K,) if quick else
          tuple(range(1, MAX_K + 1)) if deep else SERVED_K)
    worst: dict[str, tuple[int, int, str]] = {}

    def note(entry, K, smem, inst, subject):
        _pv202(report, subject, smem, f"the {inst} instance")
        if smem > worst.get(entry, (-1,))[0]:
            worst[entry] = (smem, K, inst)

    beam_top = beam_max_k()
    refused = [K for K in ks if K > beam_top]
    for K in ks:
        for entry in ("viterbi_fwd_batch", "viterbi_fwd_batch_masked",
                      "viterbi_banded_fwd"):
            inst, smem = _entry_instance(entry, K)
            note(entry, K, smem, inst, f"kernel:{entry}[K={K}]")
        for T in BACKTRACK_T:
            inst, smem = _entry_instance("viterbi_backtrack_batch", K, T=T)
            note("viterbi_backtrack_batch", K, smem, inst,
                 f"kernel:viterbi_backtrack_batch[T={T},K={K}]")
        if K > beam_top:
            continue
        for B in sorted({min(b, K) for b in BEAM_WIDTHS}):
            for entry in ("beam_step_batch", "bs_initial_pass_batch",
                          "bs_segment_decode_batch", "bs_chunk_batch"):
                books = BEAM_BOOKS if ENTRIES[entry][1] == 1 else (0,)
                for book in books:
                    inst, smem = _entry_instance(entry, K, B=B, book=book)
                    note(entry, K, smem, inst,
                         f"kernel:{entry}[K={K},B={B},book={book}]")
    if refused:
        report.skipped.append(
            f"kernel:beam passes at K={refused[0]}..{refused[-1]} "
            f"({len(refused)} K): the beam wrapper refuses K above "
            f"{beam_top}, where a planner beam width's global instance "
            f"no longer fits")
    note("tropical_matmul_batch", 0, tropical_smem_bytes(), "static",
         "kernel:tropical_matmul_batch")
    for entry, (smem, K, inst) in worst.items():
        report.stats[f"kernel:{entry}"] = {
            "max_smem_bytes": smem, "at_K": K, "instance": inst,
            "budget_bytes": SMEM_BYTES}
    report.stats["kernel:beam_max_k"] = {"K": beam_top}
    report.checks.extend(f"kernel:{e}" for e in ENTRIES)

    if log is None:
        report.skipped.append("kernel:spills: no ptxas log (needs the "
                              "card's nvcc)")
        return report
    found = parse_ptxas(log)
    for entry in ENTRIES:
        rs = _instances_of(entry, found)
        if not rs:
            report.findings.append(Finding(
                "PV201", f"kernel:{entry}",
                "no instance of this entry's kernel in the ptxas log"))
        for r in rs:
            if r.spill_stores or r.spill_loads:
                report.findings.append(Finding(
                    "PV201", f"kernel:{entry}:{r.instance}",
                    f"{r.spill_stores}B spill stores, {r.spill_loads}B "
                    f"spill loads ({r.registers} registers)"))
        report.stats[f"kernel:{entry}"] = {
            **report.stats.get(f"kernel:{entry}", {}),
            "registers": max((r.registers for r in rs), default=None),
            "spill_bytes": sum(r.spill_stores + r.spill_loads for r in rs)}
    return report


@functools.lru_cache(maxsize=None)
def beam_max_k() -> int:
    """The largest K at which the beam passes' global instance fits at
    every planner beam width and bookkeeping (the instance's bytes grow
    with K), by bisection on the mirror."""
    def fits(K):
        return all(beam_instance(K, min(B, K), book, 1)[1] <= SMEM_BYTES
                   for B in BEAM_WIDTHS for book in BEAM_BOOKS)
    lo, hi = 1, 29056
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo
