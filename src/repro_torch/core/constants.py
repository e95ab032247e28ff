"""Shared constants for the set-similarity core."""

import numpy as np

# Padding token for packed (padded) token arrays. Sorted sets keep pads at the
# end because PAD is the largest int32.
PAD_TOKEN: int = np.iinfo(np.int32).max

# Similarity function identifiers (Table 1 of the paper).
OVERLAP = "overlap"
JACCARD = "jaccard"
COSINE = "cosine"
DICE = "dice"

SIM_FUNCTIONS = (OVERLAP, JACCARD, COSINE, DICE)

# Bitmap generation methods (Section 3.2).
BITMAP_SET = "set"
BITMAP_XOR = "xor"
BITMAP_NEXT = "next"
BITMAP_COMBINED = "combined"

BITMAP_METHODS = (BITMAP_SET, BITMAP_XOR, BITMAP_NEXT)
