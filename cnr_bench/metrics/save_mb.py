"""The store's ``bytes_written`` counter (the program's ``StoreCounters``)
from the window's start to its last commit, over the saves committed in
the window, in MB (10^6 bytes): chunks, dense blobs and manifests."""


def read(run):
    return run.window_bytes / len(run.saves) / 1e6 if run.saves else None
