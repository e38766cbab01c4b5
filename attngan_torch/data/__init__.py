from attngan_torch.data.captioned import (
    csv_caption_dataset,
    folder_caption_dataset,
    tokenize_caption,
)
from attngan_torch.data.captions import CaptionHandler
from attngan_torch.data.clusterer import (
    HierarchicalClusterer,
    determine_k_values,
)
from attngan_torch.data.dataset import (
    Dataset,
    Record,
    decode_image,
    preprocess_pyramid,
    scan_image_paths,
    word_mask,
)
from attngan_torch.data.streaming import StreamingDataset, open_dataset
from attngan_torch.data.synthetic import make_synthetic_dataset
from attngan_torch.data.vocab import Vocab

__all__ = [
    "CaptionHandler", "Dataset", "HierarchicalClusterer", "Record",
    "StreamingDataset", "Vocab", "csv_caption_dataset", "decode_image",
    "determine_k_values", "folder_caption_dataset", "make_synthetic_dataset",
    "open_dataset", "preprocess_pyramid", "scan_image_paths",
    "tokenize_caption", "word_mask",
]
