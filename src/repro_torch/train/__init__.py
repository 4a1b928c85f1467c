"""The train step, as `repro.train`."""

from .train_step import (TrainConfig, abstract_train_state, init_train_state,
                         make_train_step, train_state_specs)

__all__ = ["TrainConfig", "init_train_state", "abstract_train_state",
           "train_state_specs", "make_train_step"]
