"""setup_s (s): from the harness's first line to the end of the warm
build: the process's imports, the card's start, the kernels built or
loaded, the strings made and one build of the cell's own shape."""


def read(run):
    return run.setup_s
