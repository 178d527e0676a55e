"""Mesh paths over torch.distributed ranks (counterpart of maus_tpu/parallel/)."""
