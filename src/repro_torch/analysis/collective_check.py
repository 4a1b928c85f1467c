"""flashprove pass 3: no collectives in the body of the data-parallel
sharded decode, the port's counterpart of `repro.analysis.collective_check`.

`ViterbiDecoder.decode_sharded` and ``viterbi_decode_batch(mesh=)`` shard
a bucket over a mesh axis with the HMM replicated; sequences are
independent, so each rank's decode of its slice must make no cross-rank
traffic.  A collective in there (a reduction written over the batch, a
stray gather) would serialise every decode on the interconnect.

JAX's walk covers only the `shard_map` body, not the assembly of the
sharded outputs.  The port's sharded decode ends with one all-gather of the
results, which plays the part of `out_specs`.  So the check runs the sharded
paths (`fused`, FLASH-BS and the lexicon-constrained `fused`, through both
entry points) in a gloo world of 2 ranks on the CPU
(`launch.mesh.run_spmd`) and records, in order, every torch.distributed
collective each decode calls (`launch.mesh.count_collectives`): the last
must be the results' one all-gather, and nothing may come before it.  A
second gather, or any collective in the body, is PV301.
"""

from __future__ import annotations

from .findings import Finding, ProveReport

__all__ = ["SHARDED_WORLD", "sharded_cases", "check_collectives"]

#: ranks of the check's world
SHARDED_WORLD = 2
_K, _T, _B = 8, 16, 4


def sharded_cases(K: int = _K):
    """(name, spec) of each sharded path the check runs."""
    from ..core.constraints import LexiconConstraint
    from ..core.spec import FlashBSSpec, FusedSpec

    words = tuple(((2 * w, 2 * w + 1),) for w in range(K // 2))
    return (("fused", FusedSpec()),
            ("flash_bs", FlashBSSpec(beam_width=4, parallelism=2)),
            ("lexicon_fused",
             FusedSpec(constraint=LexiconConstraint(words=words))))


def _rank(device, quick: bool, inject: bool) -> dict[str, list[str]]:
    """One rank: every sharded path's collectives, in call order."""
    import numpy as np
    import torch

    from ..core import batch as batch_mod
    from ..core.batch import viterbi_decode_batch
    from ..core.decoder import ViterbiDecoder
    from ..core.mesh import Mesh
    from ..launch.mesh import count_collectives, world_size

    mesh = Mesh((world_size(),), ("data",))
    rng = np.random.default_rng(0)
    log_pi = torch.log_softmax(torch.from_numpy(rng.standard_normal(_K)), 0)
    log_A = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((_K, _K))), 1)
    ems = torch.from_numpy(rng.standard_normal((_B, _T, _K)))
    log_pi, log_A, ems = (x.to(device=device, dtype=torch.float32)
                          for x in (log_pi, log_A, ems))
    lengths = torch.tensor([_T, _T - 3, 5, 1], dtype=torch.int32)

    if inject:   # the positive control: a reduction inside the body
        plain = batch_mod.viterbi_decode_batch

        def with_reduction(*args, **kwargs):
            out = plain(*args, **kwargs)
            if kwargs.get("mesh") is None:
                mesh.all_reduce_max(out[1], "data")
            return out
        batch_mod.viterbi_decode_batch = with_reduction

    calls: dict[str, list[str]] = {}
    cases = sharded_cases()[:1] if quick else sharded_cases()
    for name, spec in cases:
        dec = ViterbiDecoder(spec, log_pi, log_A, device=device)
        with count_collectives() as seen:
            dec.decode_sharded(ems, lengths, mesh=mesh)
        calls[f"collective:{name}:decode_sharded"] = list(seen)
        with count_collectives() as seen:
            viterbi_decode_batch(ems, log_pi, log_A, lengths,
                                 method=spec.batch_method, mesh=mesh,
                                 constraint=spec.constraint,
                                 **spec.batch_tunables())
        calls[f"collective:{name}:viterbi_decode_batch"] = list(seen)
    return calls


def check_collectives(quick: bool = False, deep: bool = False, *,
                      inject: bool = False) -> ProveReport:
    """Run the sharded paths in a CPU world; PV301 per departure.

    It takes no device, by design: what it counts is the collectives a
    decode calls, which the device does not change, and a gloo world of
    CPU processes runs on any host, where ranks on one card could not
    use NCCL.  So it does not go through `resolve_device`.
    ``quick`` checks one path; ``deep`` equals the default run (the walk is
    exhaustive over the sharded paths already).  ``inject`` adds a
    reduction to each rank's slice decode: the positive control, which
    must be flagged.
    """
    del deep
    from ..launch.mesh import run_spmd

    calls = run_spmd(_rank, SHARDED_WORLD, device="cpu",
                     args=(quick, inject), timeout_s=300.0)
    report = ProveReport()
    for subject, names in calls.items():
        final = names[-1:] == ["all_gather"]
        body = names[:-1] if final else names
        if body:
            report.findings.append(Finding(
                "PV301", subject,
                f"collectives {body} before the results' gather; the "
                f"data-parallel decode of a slice must not touch the "
                f"interconnect"))
        if not final:
            report.findings.append(Finding(
                "PV301", subject,
                f"the decode did not end with the results' one all-gather "
                f"(collectives {names})"))
        report.stats[subject] = {"collectives": names}
        report.checks.append(subject)
    return report
