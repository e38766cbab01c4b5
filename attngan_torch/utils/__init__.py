from attngan_torch.utils.imaging import (
    image_grid,
    moving_average,
    plot_history,
    save_attention_maps,
    save_image,
    save_image_grids,
)
from attngan_torch.utils.timing import (
    StepTimer,
    count_parameters,
    profile_trace,
    timer,
)
from attngan_torch.utils.training import (
    noise_vector,
    scale_1_to_255,
    scale_255_to_1,
)

__all__ = [
    "StepTimer", "count_parameters", "image_grid", "moving_average",
    "noise_vector", "plot_history", "profile_trace", "save_attention_maps",
    "save_image", "save_image_grids", "scale_1_to_255", "scale_255_to_1",
    "timer",
]
