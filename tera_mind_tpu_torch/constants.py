"""Dataset constants the port needs, copied from ``tera_mind_tpu/constants.py``
(which mirrors the reference's ``utils/__init__.py`` of CTPLab/Tera-MIND).
The port keeps its own copy: it imports nothing of the JAX package."""

# Per-mouse [max z-slice index, excluded slices] (reference utils/__init__.py:10-12).
MOUSE = {
    "609882": [49, []],
    "609889": [49, []],
    "638850": [49, []],
}

# Slices excluded from training for quality reasons (reference utils/__init__.py:1-7).
MOUSE_EXL = {
    "609882": [59, [0, 3, 6, 21, 29, 30, 35, 39, 54, 57]],
    "609889": [58, [12, 20, 21, 33, 34, 39, 41, 57, 58]],
    "638850": [57, [6, 7, 8, 9, 16, 20, 31, 53]],
}

# z-slices per stain in the training image arrays.
NUM_Z_SLICES = 50

# 307-gene human-brain panel (reference utils/__init__.py:15-47).
HBR = [
    "ABCC9", "ADAM17", "ADAMTS12", "ADAMTS16", "ADAMTS3", "ADRA1A", "ADRA1B",
    "AIF1", "ALK", "ALOX5AP", "ANGPT1", "ANK1", "ANKRD18A", "ANO3", "ANXA1",
    "APH1A", "APOD", "APOE", "APP", "AQP4", "ARHGAP24", "ATP10A", "ATP2C2",
    "B4GALNT1", "BACE1", "BCAN", "BEX1", "BRINP3", "BTBD11", "C1QL3",
    "C1orf162", "C3", "CABP1", "CALCRL", "CAPG", "CAPN3", "CAV1", "CCK",
    "CCL4", "CCL5", "CCN2", "CCNA1", "CCNB2", "CD14", "CD163", "CD2", "CD36",
    "CD3G", "CD4", "CD48", "CD52", "CD68", "CD74", "CD83", "CD86", "CD8A",
    "CDH1", "CDH12", "CDH4", "CDH6", "CDK1", "CEMIP", "CEMIP2", "CENPF",
    "CH25H", "CHI3L1", "CHODL", "CLDN11", "CNDP1", "CNTN2", "CNTNAP3",
    "CNTNAP3B", "COL12A1", "COL1A2", "COL25A1", "CORO1A", "CRHBP", "CRYM",
    "CSPG4", "CTNNA3", "CTSH", "CTSS", "CUX2", "CX3CR1", "CXCL14", "CXCR4",
    "CYTIP", "DCN", "DDR2", "DNER", "DUSP1", "EFHD1", "EGFR", "ELOVL2",
    "ENC1", "EPHA4", "ERBB3", "ERMN", "EYA4", "FASLG", "FBLN1", "FCER1G",
    "FCGBP", "FCGR1A", "FCGR3A", "FGFR2", "FGFR3", "FILIP1", "FLT1", "FSTL4",
    "GAD1", "GAD2", "GAS2L3", "GJA1", "GNLY", "GPNMB", "GPR183", "GPR34",
    "GULP1", "GZMA", "HES1", "HHATL", "HILPDA", "HLA-DMB", "HLA-DQA1",
    "HMOX1", "HPCA", "HS3ST2", "HS3ST4", "HTR2A", "HTR2C", "IDH1", "IDH2",
    "IDO1", "IFITM3", "IGFBP3", "IGFBP4", "IGFBP5", "IGFBP7", "IL7R",
    "IPCEF1", "ITGA8", "ITGAM", "ITGAX", "ITGB2", "KCNAB1", "KCNH5", "KIT",
    "KLF2", "KLF4", "KLK6", "KLRB1", "LAMA2", "LAMP5", "LHX6", "LINGO1",
    "LMO4", "LOX", "LRRK1", "LRRK2", "LY86", "LYPD6", "LYPD6B", "LYVE1",
    "MAF", "MAG", "MAL", "MCTP2", "MEIS2", "MEPE", "MEST", "MGST1", "MKI67",
    "MMD", "MOBP", "MOG", "MS4A6A", "MYO16", "MYO5B", "MYRF", "NCSTN",
    "NDST4", "NES", "NGEF", "NKG7", "NNAT", "NOTCH1", "NPFFR2", "NPNT",
    "NPTX1", "NPTXR", "NPY1R", "NR2F2", "NR4A2", "NRGN", "NRN1", "NRP1",
    "NTNG1", "NTNG2", "NWD2", "NXPH2", "OLIG1", "OLIG2", "OPALIN", "OTOGL",
    "P2RY12", "P2RY13", "PARK7", "PAX6", "PCNA", "PCSK1", "PCSK6", "PDGFD",
    "PDGFRA", "PECAM1", "PHLDB2", "PLCE1", "PLCH1", "PLCXD3", "PLD5",
    "POSTN", "POU6F2", "PRNP", "PROX1", "PSEN1", "PSEN2", "PSENEN", "PTCHD4",
    "PTEN", "PTPRC", "PTPRZ1", "PVALB", "RAPGEF5", "RASGRP1", "RELN",
    "RFTN1", "RGS10", "RGS16", "RGS4", "RGS6", "RIT2", "RNASET2", "RNF144B",
    "RORB", "ROS1", "RSPO2", "RXFP1", "RYR3", "S100A4", "SAMD5", "SDK1",
    "SEMA5A", "SERPINA3", "SFRP2", "SLC11A1", "SLC17A6", "SLC17A7",
    "SLC24A3", "SLC26A4", "SLC6A1", "SLIT3", "SMYD2", "SNCA", "SNCG",
    "SNTB2", "SORCS1", "SOX10", "SOX11", "SOX2", "SOX4", "SOX9", "SPHKAP",
    "SPI1", "SPOCK3", "SPON1", "SST", "ST18", "STAT3", "STK32B", "STXBP2",
    "SULF1", "SV2B", "SYNPR", "SYTL5", "TAC1", "TACR1", "TENM1", "TESPA1",
    "TGFB1", "TGFB2", "TGFBI", "THBS1", "THEMIS", "THSD4", "THSD7B",
    "TMEM132C", "TMIGD3", "TOP2A", "TP53", "TPH2", "TRAC", "TREM2", "TRHDE",
    "TRIL", "TRPC5", "TRPC6", "TSHZ2", "TTYH1", "UGT8", "UNC5B", "VCAN",
    "VIP", "VSIG4", "VWC2", "VWC2L", "WIF1", "WIPF3", "ZBBX", "ZDHHC23",
]

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

# Gene names of the M2H panel, by index into the 500-plex panel.
M2H_NAMES = {
    1: "Tmem132c", 4: "Rorb", 5: "Nr4a2", 11: "Nrn1", 21: "Tshz2",
    22: "Pax6", 23: "Crym", 24: "Vip", 25: "Hs3st4", 27: "Rxfp1",
    35: "Vcan", 38: "Pou6f2", 40: "Rgs6", 55: "Cxcl14", 56: "Nr2f2",
    57: "Rasgrp1", 61: "Igfbp4", 67: "C1ql3", 69: "Gad2", 70: "Rspo2",
    75: "Slc17a6", 84: "Npnt", 90: "Ctss", 91: "Nxph2", 96: "Spock3",
    108: "Chodl", 111: "Rgs4", 113: "Sox10", 118: "Mog", 130: "Trhde",
    134: "Lamp5", 137: "Lypd6", 139: "Ndst4", 145: "Aqp4", 152: "Sema5a",
    155: "Nrp1", 158: "Reln", 165: "Pvalb", 170: "Synpr", 171: "Crhbp",
    179: "Vwc2l", 180: "Gja1", 189: "Cd36", 191: "Slc17a7", 206: "St18",
    215: "Dcn", 223: "Hs3st2", 229: "Mal", 230: "Nnat", 235: "Rgs16",
    241: "Slc26a4", 243: "Pld5", 253: "Cd83", 288: "Fbln1", 297: "Cemip",
    301: "Gad1", 309: "Prox1", 329: "Npy1r", 337: "Cux2", 344: "Egfr",
    346: "Col25a1", 370: "Pcsk1", 372: "Unc5b", 378: "Ank1", 380: "Slc6a1",
    395: "Thsd7b", 410: "Brinp3", 436: "Lypd6b", 441: "Cspg4",
    442: "Adamts3", 443: "Sytl5", 458: "Tac1", 465: "Arhgap24", 467: "Lhx6",
    472: "Alk", 478: "Htr2c", 487: "Ptprc", 492: "Ano3", 493: "Sulf1",
    494: "Cdh12", 496: "Wipf3",
}

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

# Pathway colormaps (reference utils/__init__.py:93-95).
CM = {
    "GLUT": [(0, 1, 0.82), (0.69, 1, 0), (0.89, 0, 1)],
    "DOPA": [(1, 0, 0.4), (1, 0.4, 0), (1, 1, 0.4)],
    "BLOD": [(1, 0.43, 1), (1, 0.2, 0.49)],
}

# Whole-brain tile-grid geometry (reference dataset_util.py:21-23,
# test_brn.py:321-328): 256 px tiles; full atlas 288x416 tiles incl. border,
# generation grid 286x414 starting at tile (1, 1).
TILE_SIZE = 256
BRAIN_GRID_FULL = (288, 416)
BRAIN_GRID_GEN = (286, 414)
BRAIN_GRID_START = (256, 256)  # hst, wst in pixels
