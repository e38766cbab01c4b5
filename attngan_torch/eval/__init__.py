from attngan_torch.eval.fid import (
    FIDEvaluator,
    activation_statistics,
    frechet_distance,
)

__all__ = ["FIDEvaluator", "activation_statistics", "frechet_distance"]
