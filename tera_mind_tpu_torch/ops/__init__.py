from .collage import (
    patchify,
    pixels_to_voxels,
    to_collage,
    unpatchify,
    voxels_to_pixels,
)

__all__ = [
    "patchify",
    "unpatchify",
    "to_collage",
    "pixels_to_voxels",
    "voxels_to_pixels",
]
