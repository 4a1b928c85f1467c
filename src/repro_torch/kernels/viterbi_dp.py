"""Wrappers of the fused Viterbi kernels in ``csrc/viterbi_dp.cu``.

`viterbi_forward_batch` replaces the Pallas TPU kernel `_viterbi_fwd_kernel`
(src/repro/kernels/viterbi_dp.py:45, :74) and `viterbi_forward` is its B = 1
view (:237).  `viterbi_forward_batch_masked` replaces the constraint-masked
Pallas kernel `_viterbi_fwd_masked_kernel` (:120, :175).
`viterbi_banded_forward` replaces the `lax.scan` step loop of
`viterbi_decode_banded` (src/repro/kernels/ops.py:387-411), and
`viterbi_backtrack_batch` the XLA reverse-scan backtracks (ops.py:177-182,
213-220).

The two forward entries are one template: each sequence is owned by a
thread-block cluster of 8 CTAs, CTA r scoring the target columns
[r W, (r + 1) W), W = ceil(K / 8), against every source, with delta
exchanged through distributed shared memory and one cluster barrier a real
step.  Where the column slice fits in shared memory (`forward_instance`:
"resident", K up to 665), each CTA holds its slice of log_A (the
masked entry: of log_A + tmask) for the whole launch; above that it reads
the slice from L2 ("global").  The source comment in the .cu file says what
bounds each kernel on the card and what its design does about it.

The banded kernel runs the same step over a window of Kb states on one
cluster, reading each step's block of log_A from L2, its CTAs trading
delta through remote stores counted on mbarriers instead of a cluster
barrier a step.  Windows that leave a CTA without columns (Kb <= 49 at
most) and the two widest (whose delta buffers fill the shared memory)
keep a cluster barrier a step.

The backtrack runs one cluster per sequence too: CTA r owns a contiguous
block of psi rows, cut into sub-blocks whose backpointer maps (the state
at a sub-block's first row for every state after its last) are composed
for all K states at once; the maps are then stitched across the cluster
through distributed shared memory, and each sub-block walks its own rows
from its end state.  Where a CTA's rows fit beside the maps
(`backtrack_instance`: "staged") they are copied into shared memory
first; else ("global") they are read from L2.

Each wrapper checks device, dtype, shape and strides and raises on what the
kernel does not take.  For tensors on the CPU it runs the plain version in
`ref.py`; for CUDA tensors it launches its kernel (building it at first use)
or raises.  `launches` counts kernel launches, and only those.  Given a
fake tensor (the dry run's, `work.fake`), it returns empty outputs of the
kernel's shapes and dtypes and charges the launch and its work
(`work.charge`) instead; `launches` does not count it.
"""

from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from . import work as _work

#: kernel launches per kernel since the last `reset_launches()`
launches = {"viterbi_fwd_batch": 0, "viterbi_fwd_batch_masked": 0,
            "viterbi_banded_fwd": 0, "viterbi_backtrack_batch": 0}

#: a block's shared memory on the card (227 KB)
SMEM_BYTES = 232448

#: largest K whose two f32 delta rows fit in one block's shared memory
MAX_K = SMEM_BYTES // 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors, True for CUDA ones; raises on anything else."""
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors),
             f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_cuda(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _forward_args(log_A, em, delta0, pad, tmask=None, smask=None) -> bool:
    """Checks the forward kernels' arguments; True if they lie on CUDA."""
    _require(em.dim() == 3, f"em must be (B, T, K), got {tuple(em.shape)}")
    B, T, K = em.shape
    _require(K >= 1, "K must be >= 1")
    _require(log_A.shape == (K, K), f"log_A must be ({K}, {K})")
    _require(delta0.shape == (B, K), f"delta0 must be ({B}, {K})")
    tensors = [x for x in (log_A, em, delta0, pad, tmask, smask)
               if x is not None]
    _require(all(t.dtype == torch.float32 for t in tensors),
             "log_A, em, delta0, pad, tmask and smask must be float32")
    _require(pad is None or pad.shape == (B, T), f"pad must be ({B}, {T})")
    _require(tmask is None or tmask.shape == (K, K),
             f"tmask must be ({K}, {K})")
    _require(smask is None or smask.shape == (T, K),
             f"smask must be ({T}, {K})")
    if not _on_cuda(*tensors):
        return False
    _require(K <= MAX_K, f"K={K} exceeds the kernel's limit of {MAX_K}")
    _require(all(x is None or x.is_contiguous()
                 for x in (log_A, delta0, pad, tmask)),
             "log_A, delta0, pad and tmask must be contiguous")
    _require(em.stride(2) == 1, "em must have unit stride along K")
    _require(smask is None or smask.stride(1) == 1,
             "smask must have unit stride along K")
    return True


def forward_instance(K: int) -> str:
    """The forward template's instance at K states: "resident" (each CTA of
    a cluster holds its column slice of log_A, or of log_A + tmask, in
    shared memory) or "global" (the slice is read from L2).  Loads the
    library."""
    lib = build.load("viterbi_dp")
    fits = lib.viterbi_fwd_smem_bytes(K, 1) <= SMEM_BYTES
    return "resident" if fits else "global"


def backtrack_instance(T: int, K: int) -> tuple[str, int]:
    """The backtrack's instance at T steps and K states: ("staged" (each
    CTA's psi rows copied into shared memory) or "global" (read from L2),
    the sub-blocks a CTA cuts its rows into), by the C entry's own layout
    arithmetic.  Loads the library."""
    plan = build.load("viterbi_dp").viterbi_backtrack_plan(T, K)
    return ("staged" if plan & 1 else "global"), plan >> 1


def _launch_forward(name: str, em: torch.Tensor, *args):
    """Allocates psi and delta_T and launches the C entry `name` with
    ``args + (B, T, K, resident, psi, delta_T, stream)``; counts the
    launch."""
    B, T, K = em.shape
    dev = em.device
    psi = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    delta_T = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0:
        return psi, delta_T
    lib = build.load("viterbi_dp")
    resident = forward_instance(K) == "resident"
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, B, T, K, int(resident),
                                 psi.data_ptr(), delta_T.data_ptr(),
                                 _stream(dev))
    _check_cuda(err, name)
    launches[name] += 1
    return psi, delta_T


def _fake_forward(name: str, em: torch.Tensor, work):
    """(psi, delta_T) empty, for a fake `em`; the launch charged."""
    B, T, K = em.shape
    return _work.fake_outputs(em, name, work, ((B, T, K), torch.int32),
                              ((B, K), torch.float32), launched=B > 0)


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def viterbi_forward_batch(log_A: torch.Tensor, em: torch.Tensor,
                          delta0: torch.Tensor, pad: torch.Tensor | None = None):
    """Batched fused forward pass.

    Args:
      log_A:  (K, K) float32 transition log-probs, contiguous.
      em:     (B, T, K) float32 emissions for steps 1..T; any batch and time
              strides, unit stride along K (``em[:, 1:]`` is taken as is).
      delta0: (B, K) float32 initial DP states, contiguous.
      pad:    optional (B, T) float32, contiguous; entries > 0.5 mark
              tropical-identity steps (delta frozen, identity backpointers).

    Returns:
      (psi (B, T, K) int32, delta_T (B, K) float32).
    """
    if _work.fake(log_A, em, delta0, *([] if pad is None else [pad])):
        return _fake_forward("viterbi_fwd_batch", em, _work.fwd_work(
            *em.shape, em.shape[0] * em.shape[1]))
    if not _forward_args(log_A, em, delta0, pad):
        if pad is None:
            return _ref.viterbi_forward_ref(log_A, em, delta0)
        return _ref.viterbi_forward_masked_ref(log_A, em, delta0, pad > 0.5)
    return _launch_forward(
        "viterbi_fwd_batch", em, log_A.data_ptr(), em.data_ptr(),
        em.stride(0), em.stride(1), delta0.data_ptr(), _ptr(pad))


def viterbi_forward(log_A: torch.Tensor, em: torch.Tensor,
                    delta0: torch.Tensor, pad: torch.Tensor | None = None):
    """Single-sequence fused forward pass (B = 1 view of the batched kernel).

    em (T, K), delta0 (K,), pad optional (T,) -> (psi (T, K) int32, delta_T (K,)).
    """
    psi, delta_T = viterbi_forward_batch(
        log_A, em[None], delta0[None], None if pad is None else pad[None])
    return psi[0], delta_T[0]


def viterbi_forward_batch_masked(log_A: torch.Tensor, em: torch.Tensor,
                                 delta0: torch.Tensor,
                                 pad: torch.Tensor | None = None,
                                 tmask: torch.Tensor | None = None,
                                 smask: torch.Tensor | None = None):
    """Batched fused forward pass with fused constraint penalties.

    Args:
      log_A, em, delta0, pad: as in `viterbi_forward_batch`.
      tmask: optional (K, K) float32 additive transition penalty, contiguous.
      smask: optional (T, K) float32 additive per-step state penalty, shared
             across the batch, unit stride along K; row t masks em[:, t].

    Returns:
      (psi (B, T, K) int32, delta_T (B, K) float32), bit-identical to
      `viterbi_forward_batch(log_A + tmask, em + smask, delta0, pad)`.
    """
    if _work.fake(*(x for x in (log_A, em, delta0, pad, tmask, smask)
                    if x is not None)):
        return _fake_forward("viterbi_fwd_batch_masked", em, _work.masked_work(
            *em.shape, tmask is not None, smask is not None,
            em.shape[0] * em.shape[1]))
    if not _forward_args(log_A, em, delta0, pad, tmask, smask):
        mask = (torch.zeros(em.shape[:2], dtype=torch.bool) if pad is None
                else pad > 0.5)
        return _ref.viterbi_forward_masked_pen_ref(log_A, em, delta0, mask,
                                                   tmask, smask)
    return _launch_forward(
        "viterbi_fwd_batch_masked", em, log_A.data_ptr(), _ptr(tmask),
        em.data_ptr(), em.stride(0), em.stride(1), _ptr(smask),
        0 if smask is None else smask.stride(0), delta0.data_ptr(),
        _ptr(pad))


def viterbi_banded_forward(log_A: torch.Tensor, log_pi: torch.Tensor,
                           em: torch.Tensor, centers: torch.Tensor,
                           starts: torch.Tensor, width: int):
    """Banded forward pass over a window of Kb = min(2*width + 1, K) states.

    Args:
      log_A:   (K, K) float32, contiguous.
      log_pi:  (K,) float32, contiguous.
      em:      (T, K) float32, T >= 1, unit stride along K.
      centers: (T,) int32, contiguous, each in [0, K-1] (already clipped).
      starts:  (T,) int32, contiguous, each in [0, K-Kb]: step t's window is
               states starts[t] .. starts[t] + Kb - 1.
      width:   band half-width; states farther than it from centers[t] get
               a NEG_INF penalty on their emission.

    Returns:
      (psi (T-1, Kb) int32 local window indices, delta_w (Kb,) float32).
    """
    _require(em.dim() == 2, f"em must be (T, K), got {tuple(em.shape)}")
    T, K = em.shape
    _require(T >= 1 and K >= 1, "em must have T >= 1 and K >= 1")
    _require(isinstance(width, int) and width >= 0, "width must be an int >= 0")
    Kb = min(2 * width + 1, K)
    _require(log_A.shape == (K, K), f"log_A must be ({K}, {K})")
    _require(log_pi.shape == (K,), f"log_pi must be ({K},)")
    _require(centers.shape == (T,) and starts.shape == (T,),
             f"centers and starts must be ({T},)")
    _require(all(t.dtype == torch.float32 for t in (log_A, log_pi, em)),
             "log_A, log_pi and em must be float32")
    _require(centers.dtype == torch.int32 and starts.dtype == torch.int32,
             "centers and starts must be int32")
    if _work.fake(log_A, log_pi, em, centers, starts):
        return _work.fake_outputs(
            em, "viterbi_banded_fwd", _work.banded_work(K, T, Kb),
            ((T - 1, Kb), torch.int32), ((Kb,), torch.float32))
    if not _on_cuda(log_A, log_pi, em, centers, starts):
        return _ref.viterbi_banded_forward_ref(log_A, log_pi, em, centers,
                                               starts, width)

    _require(Kb <= MAX_K, f"Kb={Kb} exceeds the kernel's limit of {MAX_K}")
    _require(all(t.is_contiguous() for t in (log_A, log_pi, centers, starts)),
             "log_A, log_pi, centers and starts must be contiguous")
    _require(em.stride(1) == 1, "em must have unit stride along K")
    dev = em.device
    psi = torch.empty((T - 1, Kb), dtype=torch.int32, device=dev)
    delta_w = torch.empty((Kb,), dtype=torch.float32, device=dev)
    lib = build.load("viterbi_dp")
    with torch.cuda.device(dev):
        err = lib.viterbi_banded_fwd(
            log_A.data_ptr(), log_pi.data_ptr(), em.data_ptr(), em.stride(0),
            centers.data_ptr(), starts.data_ptr(), width, T, K, Kb,
            psi.data_ptr(), delta_w.data_ptr(), _stream(dev))
    _check_cuda(err, "viterbi_banded_fwd")
    launches["viterbi_banded_fwd"] += 1
    return psi, delta_w


def viterbi_backtrack_batch(psi: torch.Tensor, delta_T: torch.Tensor):
    """Batched backtrack over forward-pass backpointers.

    psi (B, T, K) int32 and delta_T (B, K) float32, both contiguous ->
    (paths (B, T + 1) int32, scores (B,) float32).  The last state is the
    lowest-index argmax of delta_T[b] (for inputs without NaN), the score
    delta_T[b] at it; identity rows repeat a state.  T = 0 gives the last
    state alone.
    """
    _require(psi.dim() == 3, f"psi must be (B, T, K), got {tuple(psi.shape)}")
    B, T, K = psi.shape
    _require(K >= 1, "K must be >= 1")
    _require(delta_T.shape == (B, K), f"delta_T must be ({B}, {K})")
    _require(psi.dtype == torch.int32 and delta_T.dtype == torch.float32,
             "psi must be int32 and delta_T float32")
    if _work.fake(psi, delta_T):
        return _work.fake_outputs(
            psi, "viterbi_backtrack_batch", _work.backtrack_work(B, T, K),
            ((B, T + 1), torch.int32), ((B,), torch.float32),
            launched=B > 0)
    if not _on_cuda(psi, delta_T):
        return _ref.viterbi_backtrack_ref(psi, delta_T)

    _require(K <= MAX_K, f"K={K} exceeds the kernel's limit of {MAX_K}")
    _require(psi.is_contiguous() and delta_T.is_contiguous(),
             "psi and delta_T must be contiguous")
    dev = psi.device
    paths = torch.empty((B, T + 1), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return paths, scores
    lib = build.load("viterbi_dp")
    with torch.cuda.device(dev):
        err = lib.viterbi_backtrack_batch(
            psi.data_ptr(), delta_T.data_ptr(), B, T, K, paths.data_ptr(),
            scores.data_ptr(), _stream(dev))
    _check_cuda(err, "viterbi_backtrack_batch")
    launches["viterbi_backtrack_batch"] += 1
    return paths, scores


#: The analysis gate's findings this module makes by design (`analysis.findings`
#: has the grammar; PERF.md records the measured ratios).
FLASHPROVE_WAIVERS = {
    "PV104:dispatch:cpu:fused": (
        "on the CPU the plain forward holds a step's (B, K, K) scores beside "
        "psi; on the card the kernels allocate psi, delta and the path "
        "alone, within the model"),
    "PV104:dispatch:cpu:online[": (
        "the plain forward's (1, K, K) step scores beside the chunk's psi, "
        "on the CPU only"),
    "PV104:dispatch:cpu:inflight": (
        "the plain forward's (S, K, K) step scores beside the block's psi, "
        "on the CPU only"),
    "PV104:dispatch:cpu:constrained": (
        "the plain banded forward's (T, Kb) int64 window index tables and "
        "the plain masked forward's (B, T, K) penalised emissions copy, on "
        "the CPU only"),
}

__all__ = ["viterbi_forward", "viterbi_forward_batch",
           "viterbi_forward_batch_masked", "viterbi_banded_forward",
           "viterbi_backtrack_batch", "forward_instance",
           "backtrack_instance", "launches",
           "reset_launches", "MAX_K", "SMEM_BYTES"]
