"""The HTTP tagging server (``python -m vae_tagger_tpu_torch.serve``)."""

from .server import BatchingWorker, QueueFullError, TaggerServer

__all__ = ["BatchingWorker", "QueueFullError", "TaggerServer"]
