"""Every sample trained in the window over the whole window (host clock):
stalls, waits for the previous save and saves in flight included."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 and run.samples else None
