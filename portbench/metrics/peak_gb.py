"""peak_gb (GB of 1e9 bytes, the allocator's count): the most device
memory any call of the window held, by ``torch.cuda.max_memory_allocated``
reset before each call, less the results the harness keeps for the check.
It counts the call's input points, its working memory and its result."""


def read(record):
    peak = record.window.join_peak_bytes
    return peak / 1e9 if peak else None
