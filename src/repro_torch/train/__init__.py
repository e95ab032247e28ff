"""Training substrate of the port: optimizers, train step, gradient
compression (the port of ``repro.train``)."""

from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step, state_shapes
