"""Model registry, as in `repro.models.registry`: family string -> model
class, built from a `ModelConfig`.

Only the ``transformer`` family is ported.  Griffin (RG-LRU) and xLSTM wait
for the second half of the causal-LM slice (ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

from .transformer import ModelConfig, TransformerLM

_FAMILIES = {"transformer": TransformerLM}
_WAITING = ("griffin", "xlstm")


def build_model(cfg: ModelConfig) -> TransformerLM:
    """The model of `cfg`, without weights (`init` or `load` gives them)."""
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP Queue 1 "
            f"item 11b)")
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}: "
                         f"{list(_FAMILIES) + list(_WAITING)}") from None
    return cls(cfg)


__all__ = ["build_model"]
