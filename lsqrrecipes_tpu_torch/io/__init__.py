from lsqrrecipes_tpu_torch.io.loaders import (
    load_augmented_matrix,
    load_crosswire_phantom,
    load_tracked_frames,
)

__all__ = [
    "load_augmented_matrix",
    "load_tracked_frames",
    "load_crosswire_phantom",
]
