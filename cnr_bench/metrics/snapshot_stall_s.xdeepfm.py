"""Mean of ``Trainer.stall_times`` over the window's saves: the program's
host clock around the device-to-host copy of the tables, their optimizer
state and the dense part, the only part of a save that stops training."""


def read(run):
    return sum(run.stalls) / len(run.stalls) if run.stalls else None
