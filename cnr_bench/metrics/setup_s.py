"""Process start to the start of the window (host clock): imports, the
state made on the card, the kernels' build, the warm steps, the first
(full) save committed."""


def read(run):
    return run.setup_s
