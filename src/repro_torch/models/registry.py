"""Model registry, as in `repro.models.registry`: family string -> model
class, built from a `ModelConfig`."""

from __future__ import annotations

from .hybrid import GriffinLM, XLSTMLM
from .transformer import ModelConfig, TransformerLM

_FAMILIES = {
    "transformer": TransformerLM,
    "griffin": GriffinLM,
    "xlstm": XLSTMLM,
}


def build_model(cfg: ModelConfig):
    """The model of `cfg`, without weights (`init` or `load` gives them)."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}: "
                         f"{list(_FAMILIES)}") from None
    return cls(cfg)


__all__ = ["build_model"]
