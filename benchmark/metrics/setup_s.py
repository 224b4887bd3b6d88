"""Process start to the window's start (s): loading, the map build, the
kernels' builds, the inputs and the warm-up."""


def read(m):
    return m.setup_s
