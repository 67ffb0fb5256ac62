"""``setup_s``: seconds from process start to the first timed call (inputs
drawn, the index built, the kernels built and the cell's shapes warmed up)."""


def read(rec):
    return rec.setup_s
