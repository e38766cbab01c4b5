"""Configuration of serving, both training phases and the entry points.

The port keeps its own copies of the JAX package's ``GanConfig``,
``DamsmConfig``, ``DataConfig``, ``RunConfig`` and ``Config``
(attngan_tpu/core/config.py)
instead of importing them: the port imports nothing of that package. Field
names and model-shape defaults are the same, so a checkpoint's recorded
config reads the same in both. Only the fields the port uses are copied:
``GanConfig``'s ``remat_coupling`` and
``reuse_gen_forward`` have no counterpart: they choose how XLA schedules
the same step, and autograd keeps the one generator forward's graph.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DamsmConfig:
    """DAMSM pretraining (attngan_tpu/core/config.py::DamsmConfig)."""

    emb_dim: int = 256          # joint word / region embedding width
    text_emb_dim: int = 300     # nn.Embedding width
    dropout: float = 0.5        # embedding dropout
    batch_size: int = 64
    lr: float = 0.002
    betas: Tuple[float, float] = (0.5, 0.999)
    rnn_grad_clip: float = 0.25  # gradient-norm clip of the BiLSTM only
    epochs: int = 30
    # DAMSM attention / loss temperatures
    gamma1: float = 4.0
    gamma2: float = 5.0
    gamma3: float = 10.0
    wlambda: float = 5.0
    slambda: float = 5.0
    compute_dtype: str = "bfloat16"  # the frozen trunk's compute dtype
    image_encoder: str = "inception_v3"  # or "tiny" (tests, cheap runs)
    # The JAX package picks its Pallas similarity kernel by backend
    # (attngan_tpu/losses/damsm.py:96-97). In the port the hand-written
    # kernels (ops/cuda_damsm.py) are the words loss on the GPU; False runs
    # the plain vectorised form, differentiated by autograd.
    fused_similarity: bool = True
    # the frozen trunk's features computed once per image and trained
    # against from host memory (fp16); the trunk and its inputs never change
    cache_region_features: bool = False
    # the reference's quirk: its frozen trunk is never put in eval(), so BN
    # normalises by batch statistics and moves the running averages
    trunk_train_mode_bn: bool = False
    # one eval trunk forward at superbatch * batch_size images, then that
    # many sequential batch_size steps: the same steps, one trunk launch
    # sequence instead of K. Incompatible with trunk_train_mode_bn; ignored
    # on the cached path.
    superbatch: int = 1
    # the frozen trunk's convs in int8 (infer/quantize.py), the activation
    # scales calibrated on the first batch; incompatible with
    # trunk_train_mode_bn
    trunk_int8: bool = False


@dataclass(frozen=True)
class GanConfig:
    """Generator / discriminator / text-encoder shapes, the serving switches
    and the GAN step (attngan_tpu/core/config.py::GanConfig)."""

    gf_dim: int = 32            # generator base width
    df_dim: int = 64            # discriminator base width
    emb_dim: int = 256          # text embedding width
    cond_dim: int = 100         # conditioning-augmentation width
    z_dim: int = 100            # noise width
    seq_len: int = 5            # max caption tokens (static shape)
    batch_size: int = 16
    gen_lr: float = 2e-4
    disc_lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    epochs: int = 150
    # DAMSM temperatures of the G-step's DAMSM term
    gamma1: float = 4.0
    gamma2: float = 5.0
    gamma3: float = 10.0
    wlambda: float = 5.0
    slambda: float = 5.0
    num_stages: int = 3         # 1 => 64px only; 2 => +128 attention; 3 => full
    label_smooth: float = 0.8   # low bound of the standard loss's real labels
    loss_variant: str = "non_saturating"  # or "standard"
    compute_dtype: str = "bfloat16"
    image_encoder: str = "inception_v3"  # the DAMSM coupling's; or "tiny"
    # The JAX package leaves both generator kernels off by default because
    # of measurements on a TPU v5e (its config.py:87-95, generator.py:84-88).
    # On the GPU the hand-written kernels ARE the path: on by default, and a
    # CUDA tensor never falls back to the plain PyTorch version.
    fused_attention: bool = True
    # The generator's eval kernels: the UpBlocks at >= 64^2 as K2
    # (ops/cuda_upblock.py) and every eval BN -> GLU and BN -> residual add
    # as K8 (ops/cuda_bn_epilogue.py); False runs PyTorch's chain there.
    # JAX's fused route names (attngan_tpu/ops/layers.py:282-289) all
    # mean True here; cli/infer.py maps them.
    fused_upsample: bool = True
    # The G-step's words loss through the DAMSM kernels (ops/cuda_damsm.py),
    # as DamsmConfig.fused_similarity; False runs the plain form.
    fused_similarity: bool = True
    # the generator family that InferState builds (infer/sampler.py's
    # GENERATORS), one of four: "attngan", the 3-stage attentional
    # generator (models/generator.py); "dmgan", DM-GAN's 3-stage
    # generator, whose next stages read a dynamic memory of the words
    # instead of attending to them (models/dmgan.py: gf_dim is its N_r,
    # 2 gf_dim its memory width); "dfgan", DF-GAN's one-stage 256^2
    # generator (models/dfgan.py: gf_dim is its nf, z_dim + emb_dim its
    # condition; cond_dim and num_stages are not read); or "galip",
    # GALIP's one-stage imsize^2 generator with its CLIP bridge, under
    # CLIP's text transformer in place of the BiLSTM (models/galip.py,
    # models/clip.py: gf_dim is its nf, emb_dim CLIP's embedding width,
    # seq_len CLIP's context). The GAN step trains "attngan" only.
    generator: str = "attngan"
    # GALIP's widths (read by "galip" only), CLIP ViT-B/32's by default:
    # the text transformer's width and heads, the bridge's ViT blocks'
    # (the depths and the image's side are constants of models/clip.py
    # and models/galip.py)
    clip_width: int = 512
    clip_heads: int = 8
    vit_width: int = 768
    vit_heads: int = 12

    @property
    def resolutions(self) -> Tuple[int, ...]:
        if self.generator == "dfgan":
            return (256,)
        if self.generator == "galip":
            return (224,)
        return (64, 128, 256)[: self.num_stages]


# the fields that fix the weights' shapes (a checkpoint records them)
SHAPE_FIELDS = ("gf_dim", "df_dim", "emb_dim", "cond_dim", "z_dim",
                "seq_len", "num_stages", "generator", "clip_width",
                "clip_heads", "vit_width", "vit_heads")


@dataclass(frozen=True)
class DataConfig:
    """The dataset and caption pipeline
    (attngan_tpu/core/config.py::DataConfig)."""

    rootdir: str = ""
    max_images: int = 99999
    captions_path: str = "captionsAndClassIDs.json"
    max_seqlen: int = 8         # captions padded to this static length
    # the HierarchicalClusterer's settings (reference pretrain_damsm.py:55-57)
    latent_dims: int = 128
    min_clusters: int = 5
    max_vocab_size: int = 1000
    cluster_method: str = "agglomerative_complete"
    embed_batch_size: int = 32
    flip_augment: bool = True   # a horizontally flipped copy of each image


@dataclass(frozen=True)
class RunConfig:
    """Process-level knobs shared by the training loops
    (attngan_tpu/core/config.py::RunConfig)."""

    seed: int = 0
    # the ranks' mesh (parallel/mesh.py::make_mesh): () = the most ranks
    # that divide the batch, (n,) = n ranks, (slices, data) = 2-D
    mesh_shape: Tuple[int, ...] = ()
    checkpoint_dir: str = "checkpoints"
    image_dir: str = "generated_images"
    log_every: int = 50
    checkpoint_every_epochs: int = 1
    profile: bool = False  # trace steps 2-7 with torch.profiler


def replace(cfg, **kw):
    """Functional update helper for frozen configs."""
    return dataclasses.replace(cfg, **kw)


class Config:
    """Default filesystem layout of the entry points, each path overridable
    from the environment (attngan_tpu/core/config.py::Config)."""

    DATA_ROOT = os.environ.get("ATTNGAN_DATA_ROOT", "data/images")
    CAPTIONS_JSON = os.environ.get(
        "ATTNGAN_CAPTIONS", "data/captionsAndClassIDs.json")
    CHECKPOINT_DIR = os.environ.get("ATTNGAN_CKPT_DIR", "checkpoints")
    IMAGE_DIR = os.environ.get("ATTNGAN_IMAGE_DIR", "generated_images")
