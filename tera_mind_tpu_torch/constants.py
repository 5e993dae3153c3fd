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

# Per-mouse region-of-interest definitions for visualization
# (reference utils/__init__.py:73-85).
MROI = {
    "609882": [
        list(range(21, 29)), 128,
        [[160, 1440], [160, 1888], [544, 1152], [512, 2048]],
        [["Slc17a7", "Rasgrp1", "Atp1b2", "Rph3a"],
         ["Slc17a7", "Rasgrp1", "Atp1b2", "Rph3a"],
         ["Slc17a7", "Atp1b2", "Wipf3", "Gfap"],
         ["Slc17a7", "Atp1b2", "Wipf3", "Gfap"]],
    ],
    "609889": [
        list(range(15, 23)), 128,
        [[160, 1440], [160, 1888], [576, 1208], [560, 1960]],
        [["Slc17a7", "Rasgrp1", "Rph3a", "Atp1b2"],
         ["Slc17a7", "Rasgrp1", "Rph3a", "Atp1b2"],
         ["Slc17a7", "Atp1b2", "Grin2a", "Wipf3"],
         ["Slc17a7", "Atp1b2", "Grin2a", "Wipf3"]],
    ],
    "638850": [
        list(range(16, 24)), 128,
        [[672, 920], [672, 2296], [176, 1320], [216, 2096]],
        [["Slc17a7", "Gja1", "C1ql3", "Rasgrp1"],
         ["Slc17a7", "Gja1", "C1ql3", "Rasgrp1"],
         ["Slc17a7", "Rasgrp1", "Rgs4", "Lamp5"],
         ["Slc17a7", "Rasgrp1", "Rgs4", "Lamp5"]],
    ],
}

# Pathway gene pairs for gene-gene attention analysis
# (reference utils/__init__.py:87-89).
MALL = {
    "GLUT": ["Slc17a6", "Slc17a7"],
    "DOPA": ["Nr4a2", "Th"],
    "BLOD": ["Cldn5", "Aqp4"],
}
