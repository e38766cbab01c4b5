from attngan_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from attngan_torch.train.damsm_trainer import DamsmState, DamsmTrainer
from attngan_torch.train.gan_trainer import GanState, GanTrainer

__all__ = [
    "DamsmState", "DamsmTrainer", "GanState", "GanTrainer",
    "latest_checkpoint", "restore_checkpoint", "save_checkpoint",
]
