"""Training on a device: :class:`ShardedTrainer` on a one-device mesh and
its functional optimizers."""

from .trainer import ShardedTrainer, adam_opt, adamw_opt, sgd_opt

__all__ = ["ShardedTrainer", "sgd_opt", "adam_opt", "adamw_opt"]
