from attngan_torch.core.config import (
    DamsmConfig,
    DataConfig,
    GanConfig,
    RunConfig,
    replace,
)

__all__ = ["DamsmConfig", "DataConfig", "GanConfig", "RunConfig", "replace"]
