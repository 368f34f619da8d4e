"""join_s (s, host clock): the window's elapsed time over the calls it
completed; a call completes when its pairs are ready after a
``torch.cuda.synchronize()``."""


def read(record):
    w = record.window
    return w.elapsed_s / w.calls if w.calls else None
