"""Training: the trainer (``harness``) and its metric writer (``tb``)."""
