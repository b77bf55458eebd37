"""The memory a step adds to what stays resident: the peak less the
bytes allocated when the window starts (parameters, optimizer state,
batches), in GiB: the model's saved tensors and the step's
temporaries."""


def read(rec):
    if not rec["peak_bytes"]:
        return None
    return (rec["peak_bytes"] - rec["resident_bytes"]) / 2 ** 30
