"""models of the PyTorch/CUDA port: ``EmbeddingBag``, the DLRM tower and
the quotient-remainder bag."""

from cuembed_tpu_torch.models.dlrm import DLRM, DLRMConfig
from cuembed_tpu_torch.models.embedding_bag import EmbeddingBag
from cuembed_tpu_torch.models.qr_embedding import QREmbeddingBag

__all__ = ["EmbeddingBag", "DLRM", "DLRMConfig", "QREmbeddingBag"]
