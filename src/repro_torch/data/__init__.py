"""Synthetic data: token batches, CNN images, and the training pipeline."""
from .pipeline import DataPipeline, make_pipeline, synthetic_batch, synthetic_images

__all__ = ["DataPipeline", "make_pipeline", "synthetic_batch", "synthetic_images"]
