"""Data operators of the port: the synthetic token pipeline
(``pipeline``) and near-duplicate removal by the self-join (``dedup``)."""
from repro_torch.data.dedup import (dedup_batch, dedup_embeddings,
                                    embed_ngrams, guard_embeddings)
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline", "dedup_batch", "dedup_embeddings",
           "embed_ngrams", "guard_embeddings"]
