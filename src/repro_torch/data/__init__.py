"""Data operators of the port: near-duplicate removal by the self-join
(``dedup``). The token pipeline of ``repro.data`` belongs to the LM substrate
(ROADMAP A17)."""
from repro_torch.data.dedup import (dedup_batch, dedup_embeddings,
                                    embed_ngrams, guard_embeddings)

__all__ = ["dedup_batch", "dedup_embeddings", "embed_ngrams",
           "guard_embeddings"]
