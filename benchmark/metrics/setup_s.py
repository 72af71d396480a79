"""Process start to the first timed call: imports, the encoding's tables
or matrices, the coefficients made on the card, the kernels' build where
the checkout has none yet, and one warm-up cycle of the traffic."""


def read(run):
    return run.setup_s
