"""Mean, over the saves that commit in the window, of the time from the
start of the save's snapshot to its manifest's commit (host clock): how old
a checkpoint is when it becomes durable. It swings too widely from run to
run to bound, so it is a per-layer metric."""


def read(run):
    ages = [s["t_commit"] - s["t_start"] for s in run.saves]
    return sum(ages) / len(ages) if ages else None
