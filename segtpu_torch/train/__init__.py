"""Training of the port: optimizers, engine, loop, checkpoints."""

from segtpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from segtpu_torch.train.engine import TrainEngine, TrainState, get_engine
from segtpu_torch.train.fused_run import run_training_fused
from segtpu_torch.train.loop import (evaluate, plot_training_history,
                                     quick_train, train_epoch, train_model)
from segtpu_torch.train.optim import (EarlyStopping, ReduceLROnPlateau,
                                      make_optimizer)
