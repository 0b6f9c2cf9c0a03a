"""Training-side modules of the port: the optimizer (`optimizer`), the
train, loss, prefill and decode steps (`step`), the checkpoint layout
(`checkpoint`) and the elastic loop (`ft`)."""
from repro_torch.train import checkpoint
from repro_torch.train.ft import ElasticTrainer, StepWatchdog
from repro_torch.train.optimizer import OptConfig, OptState, opt_init, opt_update
from repro_torch.train.step import (cross_entropy, make_decode_step,
                                    make_loss_fn, make_prefill_step,
                                    make_train_step)

__all__ = ["OptConfig", "OptState", "opt_init", "opt_update",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "make_loss_fn", "cross_entropy", "checkpoint", "ElasticTrainer",
           "StepWatchdog"]
