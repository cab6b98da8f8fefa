"""setup_s: from the start of the process to the first timed batch:
imports, the dataset, the program's set-up, the kernel library's load (its
build on a checkout's first run) and the warm pass."""


def read(run):
    return run.setup_s
