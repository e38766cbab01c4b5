from attngan_torch.ops.attention import damsm_attention, word_attention
from attngan_torch.ops.layers import (
    Block3x3LeakyRelu,
    Block3x3Relu,
    DownBlock,
    DownBlockLeakyReLU,
    ImageEncoder16x,
    ResBlock,
    UpBlock,
    UpBlockReLU,
    conv1x1,
    conv3x3,
    conv4x4_down,
    glu,
    upsample_nearest_2x,
)

__all__ = [
    "Block3x3LeakyRelu", "Block3x3Relu", "DownBlock", "DownBlockLeakyReLU",
    "ImageEncoder16x", "ResBlock", "UpBlock", "UpBlockReLU",
    "conv1x1", "conv3x3", "conv4x4_down", "glu", "upsample_nearest_2x",
    "damsm_attention", "word_attention",
]
