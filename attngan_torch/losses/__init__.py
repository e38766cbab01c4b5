from attngan_torch.losses.damsm import (
    cosine_similarity,
    damsm_loss,
    sentence_loss,
    words_loss,
)
from attngan_torch.losses.gan import (
    kl_loss,
    non_saturating_disc_loss,
    non_saturating_gen_loss,
    standard_disc_loss,
    standard_gen_loss,
)

__all__ = [
    "cosine_similarity", "damsm_loss", "sentence_loss", "words_loss",
    "kl_loss", "non_saturating_disc_loss", "non_saturating_gen_loss",
    "standard_disc_loss", "standard_gen_loss",
]
