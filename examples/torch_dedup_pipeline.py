"""The self-join as a data-pipeline operator on the PyTorch port:
embedding-based near-duplicate removal on COSINE similarity, then the
deduped corpus served as an index for incoming documents.

The counterpart of ``dedup_pipeline.py``, with the same data and asserts.
Stage 1 (the cosine self-join): documents are sketched into a 6-D embedding
(hashed bigram counts and a random projection, the paper's low-dimensional
regime) and deduped at cosine similarity >= MIN_COS by
``repro_torch.data.dedup_embeddings``: unit rows, the grid self-join at the
equal chord radius, and one representative a cluster. All-zero and NaN rows
(an encoder's timeout or overflow) are quarantined by the guard and kept.

Stage 2 (the external-query join): the deduped corpus becomes the indexed
set and incoming documents are screened against it with
``repro_torch.epsilon_join(metric="cosine")``: counts say which incoming
documents duplicate the corpus, pairs say which corpus document each one
duplicates.

Run:  PYTHONPATH=src python examples/torch_dedup_pipeline.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import epsilon_join
from repro_torch.data import dedup_embeddings, embed_ngrams, guard_embeddings

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="CUDA by default; 'cpu' runs the plain versions")
device = ap.parse_args().device

rng = np.random.default_rng(0)
N_DIMS = 6      # sketch dimensionality (the paper's <= 6-D regime)
MIN_COS = 0.997  # near-dup threshold: above the densest unrelated pair
                 # (cos 0.995 on this seed), below the lightest near-dup
                 # (cos 0.9988 -- 2 of 256 tokens edited)

# a batch of 66 "documents": 48 unique + 8 exact dups + 8 near-dups,
# plus 2 rows whose encoder "failed" (zero vector / NaN)
unique = rng.integers(0, 5000, (48, 256))
dups = unique[:8].copy()
near = unique[8:16].copy()
near[:, ::128] += 1         # light token noise (2 of 256 tokens)
batch = np.concatenate([unique, dups, near])

emb = embed_ngrams(batch, n_dims=N_DIMS)
emb = np.concatenate([emb, np.zeros((1, N_DIMS)),          # encoder timeout
                      np.full((1, N_DIMS), np.nan)])       # encoder overflow
keep, valid = dedup_embeddings(emb, min_cos=MIN_COS, device=device)

print(f"documents           : {emb.shape[0]}")
print(f"quarantined encodes : {int((~valid).sum())} (kept, not joined)")
print(f"kept after dedup    : {int(keep.sum())}")
assert not valid[64:].any() and valid[:64].all(), valid
assert keep[64:].all(), "guarded rows must be kept for re-encoding"
assert keep[:64].sum() == 48, keep[:64].sum()
assert keep[:48].all() and not keep[48:64].any()
print("cosine dedup kept the 48 unique documents + 2 quarantined rows")

# --- stage 2: screen an incoming stream against the kept corpus ----------
corpus_emb = emb[keep & valid]
incoming = np.concatenate([
    unique[20:24],                      # 4 near-dups of corpus docs
    rng.integers(0, 5000, (4, 256)),    # 4 genuinely new docs
])
incoming[:4, ::128] += 1                # light noise on the dup half
inc_emb = embed_ngrams(incoming, n_dims=N_DIMS)
assert guard_embeddings(inc_emb).all()  # real encodes pass the guard
res = epsilon_join(inc_emb, corpus_emb, MIN_COS, metric="cosine",
                   device=device)
is_dup = res.counts > 0
print(f"incoming screened   : {incoming.shape[0]} "
      f"({int(is_dup.sum())} duplicate the corpus)")
for qi, doc_id in res.pairs:
    print(f"  incoming[{qi}] duplicates corpus doc {doc_id}")
assert is_dup[:4].all() and not is_dup[4:].any(), is_dup
# the pairs name the exact corpus representatives (unique[20:24] kept
# their original positions 20..23 in the deduped corpus)
assert np.array_equal(res.pairs[:, 1], np.arange(20, 24)), res.pairs
print("cosine external-query join flagged exactly the 4 incoming duplicates")
