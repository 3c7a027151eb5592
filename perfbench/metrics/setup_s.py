"""setup_s: seconds from the process's start to the window's (host
clock): the imports, the program's kernels loaded (built on a checkout's
first run), the weights made on the card, every shape of the traffic
warmed, and for training the checked first steps."""


def read(run):
    return run.setup_s
