"""Independent 63-bit seeds for each input stream of a run, from its seed."""

import numpy as np

STREAMS = ("weights", "images", "order", "augment", "bank", "val")


def streams(seed: int) -> dict:
    words = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint64)
    return {name: int(w) >> 1 for name, w in zip(STREAMS, words)}
