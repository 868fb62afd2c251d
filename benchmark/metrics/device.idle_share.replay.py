"""Device: the traced window's idle share, 100 x (1 - the union of the
device's busy intervals over the window), where the replay's rate is
measured."""


def read(run):
    return run.idle_share()
