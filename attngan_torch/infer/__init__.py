from attngan_torch.infer.sampler import Sampler, denormalize
from attngan_torch.infer.export import (
    ExportedSampler,
    export_int8_sampler,
    export_sampler,
    save_exported_int8_sampler,
    save_exported_sampler,
)

__all__ = ["Sampler", "denormalize", "ExportedSampler", "export_sampler",
           "export_int8_sampler", "save_exported_sampler",
           "save_exported_int8_sampler"]
