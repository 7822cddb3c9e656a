"""The networks (parameters as nested dicts of tensors) and their
trainers.  Exported here as the JAX package's ``models/__init__.py``
exports them."""

from .unet3d import UNet3D, unet3_a, unet3_b, unet3_c, get_unet
from .ffn import FFN, init_ffn, ffn_apply, ffn_pair_scores
from .stardist3d import StarDist3DNet, sparse_candidates, upsample_prob_map
from .train_unet import TrainingUNet3D, divide_img, augment_batch
from .train_ffn import TrainFFN, DataGeneratorFFN
from .train_stardist import TrainStarDist3D, augmenter, random_fliprot, \
    random_intensity_change
from .synthesize import affine_transform, add_seg_errors, no_match_points

__all__ = [
    "UNet3D", "unet3_a", "unet3_b", "unet3_c", "get_unet",
    "FFN", "init_ffn", "ffn_apply", "ffn_pair_scores",
    "StarDist3DNet", "sparse_candidates", "upsample_prob_map",
    "TrainingUNet3D", "divide_img", "augment_batch",
    "TrainFFN", "DataGeneratorFFN",
    "TrainStarDist3D", "augmenter", "random_fliprot",
    "random_intensity_change",
    "affine_transform", "add_seg_errors", "no_match_points",
]
