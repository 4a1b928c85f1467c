"""The port's analysis gate, as `repro.analysis` is the JAX package's: two
tiers, one CLI (``python -m repro_torch.analysis``).

**Tier 1, flashlint** (source level and live contracts):

  * `analysis.lint`: an AST linter with the JAX package's rule codes in
    torch's idiom (FL001..FL007): raw ``torch.distributed`` outside the mesh
    layer, host syncs in the decode stack, ``sys.path`` manipulation,
    string-dispatch `viterbi_decode`, malformed disables, kernel loading
    outside ``kernels/``, manual ``-inf`` masking.  Intentional exceptions
    carry ``# flashlint: disable=FL002(reason)`` comments.
  * `analysis.contracts`: shape and dtype contracts of every registered
    spec, the memory contract (the card's allocator against the planner's
    model) and the streaming contracts.
  * `analysis.retrace`: the launch guard, the counterpart of the JAX
    package's recompilation guard: a decode launches exactly the kernels
    its design says, as often as it says.

**Tier 2, flashprove** (executed decodes and built kernels):

  * `analysis.dispatch_check`: every decode entry under a
    `TorchDispatchMode`: widening (PV101), host syncs (PV102), oversized
    outputs (PV103), peak live bytes against the planner (PV104).
  * `analysis.kernel_check`: every kernel's shared memory at every served K
    (PV202) and ptxas's spills (PV201).
  * `analysis.collective_check`: no collective in the sharded decode's body
    (PV301).

  Intentional exceptions are `FLASHPROVE_WAIVERS` in the module that owns
  the computation (`analysis.findings` has the grammar);
  `analysis.prove.run_prove` runs the passes and applies the waivers.
"""

from __future__ import annotations

from .lint import RULES, Violation, lint_file, lint_paths, lint_source

__all__ = [
    "RULES", "Violation", "lint_source", "lint_file", "lint_paths",
    "ContractError", "ContractReport", "MEMORY_TOLERANCE",
    "check_contracts", "allocated_state_bytes",
    "LaunchError", "LaunchGuard", "check_launches", "check_launch_guard",
    "PROVE_RULES", "Finding", "ProveReport", "collect_waivers",
    "apply_waivers", "run_prove", "check_dispatch", "check_kernels",
    "check_collectives", "harvest_kernels", "peak_live_bytes",
]

# Everything beyond the AST linter pulls in torch; load lazily (PEP 562) so
# ``python -m repro_torch.analysis --lint-only`` stays sub-second.
_LAZY = {
    "ContractError": "contracts", "ContractReport": "contracts",
    "MEMORY_TOLERANCE": "contracts", "check_contracts": "contracts",
    "allocated_state_bytes": "contracts",
    "LaunchError": "retrace", "LaunchGuard": "retrace",
    "check_launches": "retrace", "check_launch_guard": "retrace",
    "PROVE_RULES": "findings", "Finding": "findings",
    "ProveReport": "findings", "collect_waivers": "findings",
    "apply_waivers": "findings",
    "run_prove": "prove",
    "check_dispatch": "dispatch_check", "peak_live_bytes": "dispatch_check",
    "check_kernels": "kernel_check", "harvest_kernels": "kernel_check",
    "check_collectives": "collective_check",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
