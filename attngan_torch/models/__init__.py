from attngan_torch.models.cnn_encoder import (
    CNNEncoder,
    InceptionV3Trunk,
    TinyCNNEncoder,
    make_image_encoder,
)
from attngan_torch.models.discriminators import Discriminator
from attngan_torch.models.generator import (
    CondAugment,
    Generator,
    InitialStage,
    MakeImage,
    NextStage,
)
from attngan_torch.models.resnet import ImageEmbedder, ResNet18
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.models.vae import AutoEncoder, DFCVAE, VAEEmbedder
from attngan_torch.models.vgg import VGG19BNFeatures

__all__ = [
    "AutoEncoder", "BiLSTMEncoder", "CNNEncoder", "CondAugment", "DFCVAE",
    "Discriminator", "Generator", "ImageEmbedder", "InceptionV3Trunk",
    "InitialStage", "MakeImage", "NextStage", "ResNet18", "TinyCNNEncoder",
    "VAEEmbedder", "VGG19BNFeatures", "make_image_encoder",
]
