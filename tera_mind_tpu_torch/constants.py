"""Dataset constants the port needs, copied from ``tera_mind_tpu/constants.py``
(which mirrors the reference's ``utils/__init__.py`` of CTPLab/Tera-MIND).
The port keeps its own copy: it imports nothing of the JAX package."""

# Per-mouse [max z-slice index, excluded slices] (reference utils/__init__.py:10-12).
MOUSE = {
    "609882": [49, []],
    "609889": [49, []],
    "638850": [49, []],
}

# z-slices per stain in the training image arrays.
NUM_Z_SLICES = 50

# Mouse->human 81-gene index map into the 500-plex panel
# (reference utils/__init__.py:49-57).
M2H = [
    1, 4, 5, 11, 21, 22, 23, 24, 25, 27, 35, 38, 40, 55, 56, 57, 61, 67, 69,
    70, 75, 84, 90, 91, 96, 108, 111, 113, 118, 130, 134, 137, 139, 145, 152,
    155, 158, 165, 170, 171, 179, 180, 189, 191, 206, 215, 223, 229, 230,
    235, 241, 243, 253, 288, 297, 301, 309, 329, 337, 344, 346, 370, 372,
    378, 380, 395, 410, 436, 441, 442, 443, 458, 465, 467, 472, 478, 487,
    492, 493, 494, 496,
]
