"""The launch guard: the port's counterpart of the JAX package's
recompilation guard (`repro.analysis.retrace`).

PyTorch runs eagerly, so the port has no jit caches to watch.  What decides
its speed instead is which kernels a decode launches and how often: a path
that silently falls back to its plain PyTorch version, launches a kernel per
step where one per batch was designed, or launches a kernel it should not,
shows up only as latency.  The wrappers count their launches
(`kernels.launch_counts()`), and this module turns those counts into hard
failures:

  * `launch_departures` / `check_launches` hold a run's counts to an
    expected table (the generalisation of the load test's
    `slot_step_departures` and of the smoke's launch checks);
  * `LaunchGuard(expected)` is a context manager that fails when the block
    it guards launches anything other than `expected`;
  * `expected_launches(spec, K, T)` is what one `spec.run` launches on the
    card, and `check_launch_guard(device)` is the CLI battery: on the card,
    one decode per spec under the guard; on the CPU, where no wrapper
    launches a kernel and every count stays 0, the guard's mechanics alone,
    with counts set by hand (a guard that never fires guards nothing).
"""

from __future__ import annotations

import math

__all__ = ["LaunchError", "LaunchGuard", "launch_departures",
           "check_launches", "expected_launches", "scan_levels",
           "check_launch_guard"]


class LaunchError(AssertionError):
    """A run launched kernels other than the ones its contract names."""


def launch_departures(launches: dict[str, int], expected: dict[str, int]
                      ) -> dict[str, tuple[int, int]]:
    """{kernel: (launched, expected)} for every kernel whose count differs
    from `expected` (a kernel `expected` does not name is expected 0 times);
    empty when the run agrees."""
    names = set(launches) | set(expected)
    out = {}
    for name in sorted(names):
        got, want = launches.get(name, 0), expected.get(name, 0)
        if got != want:
            out[name] = (got, want)
    return out


def check_launches(what: str, launches: dict[str, int],
                   expected: dict[str, int]) -> None:
    """Raise `LaunchError` unless each kernel in `expected` launched that
    many times and every other kernel never."""
    bad = launch_departures(launches, expected)
    if bad:
        detail = ", ".join(f"{n} launched {g} times, expected {w}"
                           for n, (g, w) in bad.items())
        raise LaunchError(f"{what}: {detail}")


class LaunchGuard:
    """Context manager: fail if the guarded block's kernel launches differ
    from `expected`.

        with LaunchGuard({"viterbi_fwd_batch": 1,
                          "viterbi_backtrack_batch": 1}, what="fused"):
            FusedSpec().run(log_pi, log_A, em)

    The counts are read before and after (nothing is reset, so an
    enclosing count stays whole); `launches` holds the block's own.
    """

    def __init__(self, expected: dict[str, int], *, what: str = "block"):
        self.expected = dict(expected)
        self.what = what
        self.launches: dict[str, int] = {}
        self._before: dict[str, int] = {}

    @staticmethod
    def _counts() -> dict[str, int]:
        from ..kernels import launch_counts
        return launch_counts()

    def __enter__(self) -> "LaunchGuard":
        self._before = self._counts()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            return False
        after = self._counts()
        self.launches = {n: after[n] - self._before.get(n, 0) for n in after}
        check_launches(self.what, self.launches, self.expected)
        return False


def scan_levels(n: int) -> list[int]:
    """Pairs combined at each level of an odd-even associative scan over n
    elements (`core.assoc`): the odds, recursively, then the evens (a
    combine of no pairs launches nothing)."""
    if n < 2:
        return []
    half = n // 2
    even = half - 1 if n % 2 == 0 else half
    return [half] + scan_levels(half) + ([even] if even else [])


def expected_launches(spec, K: int, T: int) -> dict[str, int]:
    """Kernel launches of one ``spec.run`` on a (T, K) sequence, T >= 2, on
    the card, by the decode's own structure."""
    from ..core.flash import plan_padding

    method = spec.method
    if method == "fused":
        return {"viterbi_fwd_batch": 1, "viterbi_backtrack_batch": 1}
    if method in ("flash_bs", "beam_static_mp"):   # the latter: chunk = K
        P = spec.parallelism
        lanes = P if spec.lanes == -1 else spec.lanes
        Tp, _ = plan_padding(T, P)
        tiles, s = 0, Tp // P
        while s >= 2:
            tiles += 1 if lanes is None else -(-(Tp // s) // lanes)
            s //= 2
        return {"bs_initial_pass_batch": 1, "bs_segment_decode_batch": tiles}
    if method == "assoc":
        return {"tropical_matmul_batch": len(scan_levels(T - 1)) + 1,
                "viterbi_backtrack_batch": 1}
    if method == "online":
        # the first feed seeds from its first row: it launches only if rows
        # remain; every later feed launches the forward kernel once
        C = spec.stream_chunk
        feeds = math.ceil(T / C)
        return {"viterbi_fwd_batch": feeds - (1 if min(C, T) == 1 else 0)}
    if method == "online_beam":
        return {"bs_chunk_batch": math.ceil(T / spec.stream_chunk)}
    # vanilla, checkpoint, flash and the static beam are plain PyTorch
    return {}


def check_launch_guard(device, K: int = 64, T: int = 96) -> list[str]:
    """The launch battery; returns passed-scenario descriptions and raises
    `LaunchError` on a departure.

    On a CUDA device: one ``spec.run`` per registered spec under
    `LaunchGuard(expected_launches(spec, K, T))`, then a positive control
    (a guard expecting nothing around a fused decode must fire).  On the
    CPU the wrappers launch nothing, so only the guard's mechanics run:
    counts bumped by hand must be seen, and a departure must raise.
    """
    import torch

    from .. import kernels
    from ..core.spec import SPEC_BY_METHOD, FusedSpec
    from .contracts import seeded_hmm

    dev = torch.device(device)
    passed: list[str] = []
    if dev.type != "cuda":
        vdp = kernels.viterbi_dp
        with LaunchGuard({"viterbi_fwd_batch": 1}, what="by hand") as g:
            vdp.launches["viterbi_fwd_batch"] += 1
        seen = {n: c for n, c in g.launches.items() if c}
        passed.append(f"guard sees a count bumped by hand {seen}")
        try:
            with LaunchGuard({}, what="positive control"):
                vdp.launches["viterbi_backtrack_batch"] += 2
        except LaunchError:
            passed.append("positive control: an unexpected count raises")
        else:
            raise LaunchError("positive control failed: a count bumped by "
                              "hand inside a guard expecting none passed")
        finally:
            kernels.reset_launches()
        passed.append("mechanics only: on the CPU no wrapper launches a "
                      "kernel")
        return passed

    log_pi, log_A, em = seeded_hmm(K, T, dev)
    for method in sorted(SPEC_BY_METHOD):
        spec = SPEC_BY_METHOD[method]()
        want = expected_launches(spec, K, T)
        with LaunchGuard(want, what=f"{method} (K={K}, T={T})"):
            spec.run(log_pi, log_A, em)
        passed.append(f"{method}: launches {want or 'none'}")
    try:
        with LaunchGuard({}, what="positive control"):
            FusedSpec().run(log_pi, log_A, em)
    except LaunchError:
        passed.append("positive control: a fused decode under a guard "
                      "expecting no launch raises")
    else:
        raise LaunchError("positive control failed: the fused decode's "
                          "launches went unseen")
    return passed
