"""Inputs from the seed: every call's points come from (seed, call number)
alone, so the reference can make any call's points again."""
import numpy as np


def call_seed(seed: int, call: int, stream: int = 0) -> int:
    """A 63-bit generator seed for call ``call`` of a run with ``seed``
    (any whole number, negative or past 64 bits included); ``stream`` 0
    is the points', others the harness's own draws."""
    words = np.random.SeedSequence(
        [seed % 2**64, stream, call]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def make_points(generator, config: dict, seed: int, call: int, device):
    """The points of one call: ``generator.make`` of the configuration."""
    return generator.make(config, call_seed(seed, call), device)
