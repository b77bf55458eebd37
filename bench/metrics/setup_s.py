"""Seconds from the process's start to the first timed step: imports,
the kernels built or loaded, weights and batches made on the card, and
the first steps that warm every shape the window uses."""


def read(rec):
    return rec["setup_s"]
