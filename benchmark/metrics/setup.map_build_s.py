"""Host seconds of the program's map build: the BVH and the bins."""


def read(m):
    xs = m.spans.get("setup.map_build")
    return xs[0] if xs else None
